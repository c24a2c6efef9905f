"""Elementwise group-law kernel: 2^k * P + Q (CUDA, csrc/msm_kernels.cu).

Replaces ark_bulletproofs_tpu/ops/kernels.py::rcb_double_k_add_tiled (the
v2 MSM's stage-G Horner step) and, with k = 0, ::rcb_add_tiled (the
complete adds of the MSM glue and of the ragged driver's chunk sum). `k`
is a runtime argument, so one kernel serves both.

The wrapper takes points in the boundary layout, (3, 16, m) int32
(coordinate, limb, lane). On a CPU tensor it runs the plain version
below; on a CUDA tensor it launches the kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import proj
from .limbs import N_LIMBS


def check_tensor(t: torch.Tensor, shape: tuple, name: str) -> None:
    """Raise unless t is a contiguous int32 tensor of `shape` on the CPU
    or a CUDA device."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return dev


def launch(name: str, spec, dev: torch.device, *args) -> None:
    """Launch kernel `name` (abtpu_<name> of csrc/*.cu) on `dev`'s current
    stream with the constants of `spec` (a CurveSpec, or a FieldSpec for
    the field kernels); raise on a CUDA error."""
    fn = getattr(_build.lib(), f"abtpu_{name}")
    words = _build.curve_words(spec)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, words.ctypes.data_as(ctypes.c_void_p),
                 ctypes.c_void_p(stream))
    _build.check(err, name)


# Lanes per call of the plain versions on a CPU: lanes are independent,
# and slices of this width keep the int64 temporaries of a stacked group
# operation in cache (twice the speed of one wide call). On a card one
# call takes all lanes: there the cost is per launch, not per element.
PLAIN_CPU_LANES = 1024


def lane_slices(L: int, device: torch.device) -> list[slice]:
    step = PLAIN_CPU_LANES if device.type == "cpu" else max(L, 1)
    return [slice(o, min(o + step, L)) for o in range(0, L, step)]


def rcb_double_k_add_plain(spec, P: torch.Tensor, Q: torch.Tensor,
                           k: int) -> torch.Tensor:
    return torch.cat([
        proj.double_k_add(spec, P[..., sl], Q[..., sl], k)
        for sl in lane_slices(P.shape[-1], P.device)
    ], dim=-1).to(torch.int32)


def rcb_double_k_add(spec, P: torch.Tensor, Q: torch.Tensor,
                     k: int) -> torch.Tensor:
    """2^k * P + Q lane-wise; P, Q: (3, 16, m) int32."""
    m = P.shape[-1]
    check_tensor(P, (3, N_LIMBS, m), "rcb_double_k_add P")
    check_tensor(Q, (3, N_LIMBS, m), "rcb_double_k_add Q")
    if not 0 <= k < (1 << 31):
        raise ValueError(f"rcb_double_k_add: k={k} out of range")
    dev = same_device(P, Q)
    if dev.type == "cpu":
        return rcb_double_k_add_plain(spec, P, Q, k)
    if m == 0:
        raise ValueError("rcb_double_k_add: empty input")
    out = torch.empty_like(P)
    launch("rcb_double_k_add", spec, dev, P.data_ptr(), Q.data_ptr(),
           out.data_ptr(), m, k)
    rcb_double_k_add.launches += 1
    return out


rcb_double_k_add.launches = 0


def rcb_add(spec, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Complete P + Q: the k = 0 case of `rcb_double_k_add`."""
    return rcb_double_k_add(spec, P, Q, 0)
