"""Host <-> torch limb conversion for 256-bit field elements.

Counterpart of ark_bulletproofs_tpu/ops/limbs.py. The boundary layout of
every port function is 16 canonical little-endian 16-bit limbs held in
int32, LIMB-MAJOR: a batch of m elements is a (16, m) tensor, a row of
points is (rows, 16, lanes). On a GPU neighbouring threads (lanes) then
read neighbouring addresses. int32 rather than uint32: torch's CPU
uint32 has no add, shift or compare, and every limb value fits.
"""

from __future__ import annotations

import numpy as np
import torch

N_LIMBS = 16
LIMB_BITS = 16
MASK = 0xFFFF


def int_to_limbs(x: int) -> torch.Tensor:
    """One 256-bit int -> (16,) int32 limbs."""
    return ints_to_limbs([x])[:, 0]


def ints_to_limbs(xs, device=None) -> torch.Tensor:
    """m 256-bit ints -> (16, m) int32 limb-major tensor."""
    m = len(xs)
    buf = b"".join(x.to_bytes(32, "little") for x in xs)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(m, N_LIMBS)
    t = torch.from_numpy(u16.astype(np.int32).T.copy())
    return t if device is None else t.to(device)


def limbs_to_ints(t: torch.Tensor) -> list[int]:
    """(16, m) or (16,) limb tensor -> list of m ints."""
    a = t.detach().to("cpu", torch.int32).numpy()
    if a.ndim == 1:
        a = a[:, None]
    u16 = np.ascontiguousarray(a.T).astype("<u2").tobytes()
    return [
        int.from_bytes(u16[32 * i: 32 * (i + 1)], "little")
        for i in range(a.shape[1])
    ]


def limbs_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """(m, 16) point-major uint32 limbs (the JAX package's layout) ->
    (16, m) int32 limb-major tensor."""
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.int32).T))
    return t if device is None else t.to(device)
