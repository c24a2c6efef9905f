"""Phase timers of the port (counterpart of the JAX package's
utils/profiling.py, without JAX).

    from ark_bulletproofs_tpu_torch.utils.profiling import phase, report

    with phase("prove:ipa"):
        ...
    print(report())

Each phase is also a `torch.profiler.record_function` range, so a
`torch.profiler` trace of a prove shows the protocol phases around the
kernels they launch.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_TIMES: dict[str, list[float]] = defaultdict(list)


def reset() -> None:
    _TIMES.clear()


@contextlib.contextmanager
def phase(name: str):
    """Time a protocol phase on the host clock (work queued on the card
    counts only as far as the phase waits for it)."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _TIMES[name].append(time.perf_counter() - t0)


def report() -> str:
    lines = []
    for name in sorted(_TIMES):
        ts = _TIMES[name]
        lines.append(
            f"{name:40s} n={len(ts):4d} total={sum(ts)*1e3:9.1f} ms "
            f"mean={sum(ts)/len(ts)*1e3:8.2f} ms"
        )
    return "\n".join(lines)


def total(name: str) -> float:
    """Seconds spent in phase `name` since the last reset."""
    return sum(_TIMES.get(name, ()))
