"""Host-facing device MSM (counterpart of ops/msm.py `msm`, `msm_many`
and `msm_many_tabled`).

Affine int points and int scalars in, affine points out. The base axis
goes through the ragged driver (parallel/msm.py), so protocol-shaped
MSMs are split into power-of-two chunks instead of padded;
`msm_many_tabled` runs over rows of a cached device table instead.
"""

from __future__ import annotations

import torch

from .. import engine
from ..parallel.msm import msm_device_mapped, msm_device_ragged
from .curve import affine_to_device, point_batch_to_host, spec_for
from .limbs import N_LIMBS, ints_to_limbs


def scalars_to_device(curve, scalar_sets, device) -> torch.Tensor:
    """B lists of n int scalars -> (B, 16, n) int32 canonical limbs."""
    B, n = len(scalar_sets), len(scalar_sets[0])
    p = curve.fr.p
    flat = [s % p for ks in scalar_sets for s in ks]
    if len(flat) != B * n:
        raise ValueError("scalar sets differ in length")
    limbs = ints_to_limbs(flat).reshape(N_LIMBS, B, n).permute(1, 0, 2)
    return limbs.contiguous().to(device)


def msm_many(curve, bases: list, scalar_sets: list[list[int]],
             device=None) -> list:
    """B MSMs over shared bases in one device run; B affine points."""
    n = len(bases)
    if n == 0 or not scalar_sets:
        return [curve.zero() for _ in scalar_sets]
    if any(len(ks) != n for ks in scalar_sets):
        raise ValueError("each scalar set needs one scalar per base")
    dev = engine.torch_device() if device is None else torch.device(device)
    spec = spec_for(curve)
    X, Y, inf = affine_to_device(curve, list(bases), dev)
    scal = scalars_to_device(curve, scalar_sets, dev)
    return point_batch_to_host(curve, msm_device_ragged(spec, X, Y, inf,
                                                        scal))


def msm(curve, bases: list, scalars: list[int], device=None):
    """sum_i scalars[i] * bases[i] on the device; affine out."""
    if len(bases) != len(scalars):
        raise ValueError("one scalar per base")
    return msm_many(curve, bases, [scalars], device)[0]


def msm_many_tabled(curve, table, scalar_sets, index_map) -> list:
    """B MSMs over rows of a cached device table (no base marshal).

    table: (X, Y, inf, ...) on the device (ops/cache.py::full_table);
    scalar_sets: B lists of k ints; index_map: k table rows, shared by
    the sets. One batched base_map MSM; B affine points out."""
    X, Y, inf = table[:3]
    dev = X.device
    k = len(index_map)
    if any(len(ks) != k for ks in scalar_sets):
        raise ValueError("each scalar set needs one scalar per index")
    scal = scalars_to_device(curve, scalar_sets, dev)
    bm = torch.as_tensor(index_map, dtype=torch.int64, device=dev)
    bm = bm.expand(len(scalar_sets), k)
    return point_batch_to_host(
        curve, msm_device_mapped(spec_for(curve), X, Y, inf, scal, bm))
