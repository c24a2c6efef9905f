"""The row gathers (CUDA, csrc/gather_kernels.cu).

  stage_gather <- tools/probe_dma_gather.py:67, the JAX package's per-row
      DMA gather probe, written to decide whether the v2 MSM's stage B
      should switch to it; here it is stage B: the sorted affine points
      written into stage C's (2, R, 16, L) limb-major rows straight from
      the sort order (ops/msm2.py::_stage_gather calls it). On the card
      it is two launches: `stage_table` packs the table's rows, then its
      own kernel writes the output.
  row_gather <- the same probe in its flat form: out[k] = tbl[idx[k]] for
      an (n, 16) 32-bit table; on no path.

On a CPU tensor each wrapper runs its plain version (`stage_gather_plain`,
the torch index and permute the v2 MSM ran before; `stage_table_plain`;
`index_select`); on a CUDA tensor it launches its kernel, or raises.
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


def stage_gather_plain(X, Y, inf, order, R: int, C: int, W: int,
                       base_map=None) -> torch.Tensor:
    """The v2 MSM's stage B in torch: sorted affine points -> (2, R, 16,
    L), L = BW C, identity rows with y = 0. Sorted flat index i = col * R +
    r; lane = row * C + col.

    base_map (B, n), optional: scalar j of set b multiplies table row
    base_map[b, j] of a table that may be wider than n. It is composed
    into the sort order (the table row of sorted slot i in row b * W + w
    is base_map[b, order[i]]), so the one gather below stays the only
    pass over the table and no gathered table is materialised."""
    BW = order.shape[0]
    L = BW * C
    Yz = torch.where(inf, 0, Y)
    table = torch.stack([X, Yz]).permute(2, 0, 1).contiguous()  # (m, 2, 16)
    if base_map is not None:
        bm = base_map.long().repeat_interleave(W, dim=0)  # (BW, n)
        order = torch.gather(bm, 1, order)
    ord_r = order.reshape(BW, C, R).permute(2, 0, 1).reshape(R, L)
    return table[ord_r].permute(2, 0, 3, 1).contiguous()


def stage_table_plain(X, Y, inf) -> torch.Tensor:
    """(m, 16) int32 rows x | y << 16 of the 16-bit limbs, y = 0 on
    identity rows (the JAX package's packing)."""
    return (X | (torch.where(inf, 0, Y) << 16)).t().contiguous()


def _check_points(who: str, X, Y, inf) -> int:
    """Raise unless X, Y are (16, m) int32 and inf (m,) bool; returns m."""
    for name, t in (("X", X), ("Y", Y)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != N_LIMBS:
            raise ValueError(f"{who} {name}: expected an int32 "
                             f"({N_LIMBS}, m) tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    m = X.shape[1]
    if Y.shape != X.shape or inf.dtype != torch.bool or inf.shape != (m,):
        raise ValueError(f"{who}: Y {tuple(Y.shape)} and inf "
                         f"{inf.dtype} {tuple(inf.shape)} must match X "
                         f"{tuple(X.shape)}")
    return m


def stage_table(X, Y, inf) -> torch.Tensor:
    """The stage-B gather's table: X, Y (16, m) int32 affine limbs (16
    bits each, any row stride), inf (m,) bool. Returns (m, 16) int32 rows
    x | y << 16, y = 0 on identity rows."""
    m = _check_points("stage_table", X, Y, inf)
    dev = same_device(X, Y, inf)
    if dev.type == "cpu":
        return stage_table_plain(X, Y, inf)
    if dev.type != "cuda":
        raise ValueError(f"stage_table: unsupported device {dev}")
    if m == 0:
        raise ValueError("stage_table: empty input")
    X, Y = (t if t.stride(1) == 1 else t.contiguous() for t in (X, Y))
    inf = inf.contiguous()
    tbl = torch.empty(m, N_LIMBS, dtype=torch.int32, device=dev)
    launch("stage_table", None, dev, X.data_ptr(), Y.data_ptr(),
           inf.data_ptr(), X.stride(0), Y.stride(0), m, tbl.data_ptr())
    stage_table.launches += 1
    return tbl


def stage_gather(X, Y, inf, order, R: int, C: int, W: int,
                 base_map=None) -> torch.Tensor:
    """X, Y: (16, m) int32 affine limbs (16 bits each); inf: (m,) bool;
    order: (BW, n) int64 or int32, contiguous, n = R C, each row a
    permutation of table rows in [0, m) (with base_map, of scalar slots in
    [0, n)); base_map: (BW / W, n) integer table rows, optional. Returns
    (2, R, 16, BW C) int32: lane bw * C + col, row r holds the point of
    sorted slot col * R + r of row bw (an index outside the table fails
    the kernel's device-side assert). On the card `stage_table` packs the
    rows (its launch counted there), then the gather kernel writes the
    output (counted here)."""
    m = _check_points("stage_gather", X, Y, inf)
    if order.dtype not in (torch.int64, torch.int32) or order.dim() != 2:
        raise ValueError(f"stage_gather order: expected an int64 or int32 "
                         f"(BW, n) tensor, got {order.dtype} "
                         f"{tuple(order.shape)}")
    BW, n = order.shape
    if R < 1 or C < 1 or W < 1 or n != R * C or BW % W or m == 0:
        raise ValueError(f"stage_gather: order {tuple(order.shape)} is not "
                         f"(a multiple of W={W}, R={R} x C={C}) over {m} "
                         f"table rows")
    if base_map is not None and (
            base_map.dtype not in (torch.int64, torch.int32)
            or base_map.shape != (BW // W, n)):
        raise ValueError(f"stage_gather base_map: expected an integer "
                         f"({BW // W}, {n}) tensor, got {base_map.dtype} "
                         f"{tuple(base_map.shape)}")
    if not order.is_contiguous():
        raise ValueError("stage_gather: order must be contiguous")
    maps = () if base_map is None else (base_map,)
    dev = same_device(X, Y, inf, order, *maps)
    if dev.type == "cpu":
        return stage_gather_plain(X, Y, inf, order, R, C, W, base_map)
    if dev.type != "cuda":
        raise ValueError(f"stage_gather: unsupported device {dev}")
    tbl = stage_table(X, Y, inf)
    bm = None
    if base_map is not None:
        bm = base_map.to(torch.int32).contiguous()
    out = torch.empty(2, R, N_LIMBS, BW * C, dtype=torch.int32, device=dev)
    launch("stage_gather", None, dev, tbl.data_ptr(), order.data_ptr(),
           0 if bm is None else bm.data_ptr(), out.data_ptr(), m, n, R, C,
           W, BW, int(order.dtype == torch.int64))
    stage_gather.launches += 1
    return out


row_gather.launches = 0
stage_table.launches = 0
stage_gather.launches = 0
