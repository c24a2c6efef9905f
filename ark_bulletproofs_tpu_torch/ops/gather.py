"""A row gather of 64-byte rows (CUDA, csrc/gather_kernels.cu).

  row_gather <- tools/probe_dma_gather.py:67, the JAX package's per-row
      DMA gather probe (one async copy a row, issued from the TPU's scalar
      core): out[k] = tbl[idx[k]] for an (n, 16) 32-bit table.

Like its counterpart it is a probe, on no path: it stands beside the v2
MSM's stage B (ops/msm2.py::_stage_gather, a torch index over the sorted
points), the first bottleneck of the n = 2^20 MSM, and the smoke run
times it against `index_select` at stage B's row count. Switching stage B
to it is a separate change, worth making only if it wins.

On a CPU tensor the wrapper runs its plain version, `index_select`; on a
CUDA tensor it launches its kernel, or raises.
"""

from __future__ import annotations

import torch

from .kernels import launch, same_device
from .limbs import N_LIMBS


def row_gather_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[k] = tbl[idx[k]]."""
    return tbl.index_select(0, idx)


def row_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl: (n, 16) int32, contiguous; idx: (K,) int64 or int32 in [0, n)
    (an index outside it fails the kernel's device-side assert). Returns
    (K, 16) int32 rows."""
    if tbl.dtype != torch.int32 or tbl.dim() != 2 or tbl.shape[1] != N_LIMBS:
        raise ValueError(f"row_gather tbl: expected an int32 (n, {N_LIMBS}) "
                         f"tensor, got {tbl.dtype} {tuple(tbl.shape)}")
    if idx.dtype not in (torch.int64, torch.int32) or idx.dim() != 1:
        raise ValueError(f"row_gather idx: expected an int64 or int32 (K,) "
                         f"tensor, got {idx.dtype} {tuple(idx.shape)}")
    if not (tbl.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather: tensors must be contiguous")
    dev = same_device(tbl, idx)
    if dev.type == "cpu":
        return row_gather_plain(tbl, idx)
    if dev.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {dev}")
    if tbl.data_ptr() % 16:
        raise ValueError("row_gather tbl: rows must be 16-byte aligned")
    K, n = idx.shape[0], tbl.shape[0]
    if K == 0 or n == 0:
        raise ValueError("row_gather: empty input")
    out = torch.empty(K, N_LIMBS, dtype=torch.int32, device=dev)
    launch("row_gather", None, dev, tbl.data_ptr(), idx.data_ptr(),
           out.data_ptr(), K, n, int(idx.dtype == torch.int64))
    row_gather.launches += 1
    return out


row_gather.launches = 0
