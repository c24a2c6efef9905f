"""Row-scan kernels of the v2 MSM (CUDA, csrc/msm_kernels.cu).

Replace the TPU mega-kernels of ark_bulletproofs_tpu/ops/kernels2.py:

  suffix_madd_scan <- suffix_madd_scan: stage C, per-column inclusive
      suffix sums of the sorted affine points (the W * n mixed adds; on a
      twisted-Edwards curve its body is the one of kernels.py's
      te_madd_tiled);
  suffix_jac_scan  <- suffix_jac_scan: stage D, per-column exclusive
      suffix sums plus totals over rows of projective points;
  rowsum           <- rowsum_jac: stage F, row sums down to totals.

Layout: limb-major int32, (rows, 16, lanes) per coordinate, coordinates
stacked first: affine input (2, R, 16, L) holds x then y, a row with
y = 0 is the identity; point arrays are (NC, R, 16, L), NC = 3 for the
RCB projective points of a short-Weierstrass curve and 4 for the extended
points of a twisted-Edwards one (the kernel's model, and its plain
version's group law, follow the spec). The TPU packed x | y << 16 into one
u32 plane to halve its gather row count; on the GPU the gather is a plain
torch index, so x and y stay separate planes.

Each wrapper runs the plain version on a CPU tensor and launches its
kernel on a CUDA tensor, or raises.
"""

from __future__ import annotations

import torch

from . import field as df
from . import proj
from .curve import n_coords
from .kernels import check_tensor, lane_slices, launch
from .limbs import N_LIMBS

NL = N_LIMBS


# --- plain versions ---------------------------------------------------------


def suffix_madd_scan_plain(spec, xy: torch.Tensor) -> torch.Tensor:
    _, R, _, L = xy.shape
    out = torch.empty(n_coords(spec), R, NL, L, dtype=torch.int32,
                      device=xy.device)
    for sl in lane_slices(L, xy.device):
        acc = proj.point_zero(spec, sl.stop - sl.start, xy.device)
        for r in range(R - 1, -1, -1):
            qx, qy = xy[0, r, :, sl], xy[1, r, :, sl]
            acc = proj.add_mixed(spec, acc, qx, qy, df.is_zero(qy))
            out[:, r, :, sl] = acc
    return out


def suffix_jac_scan_plain(spec, T: torch.Tensor):
    nc, R, _, L = T.shape
    excl = torch.empty(nc, R, NL, L, dtype=torch.int32, device=T.device)
    tot = torch.empty(nc, NL, L, dtype=torch.int32, device=T.device)
    for sl in lane_slices(L, T.device):
        acc = proj.point_zero(spec, sl.stop - sl.start, T.device)
        for r in range(R - 1, -1, -1):
            excl[:, r, :, sl] = acc
            acc = proj.add(spec, acc, T[:, r, :, sl])
        tot[..., sl] = acc
    return excl, tot


def rowsum_plain(spec, T: torch.Tensor) -> torch.Tensor:
    nc, K, _, L = T.shape
    out = torch.empty(nc, NL, L, dtype=torch.int32, device=T.device)
    for sl in lane_slices(L, T.device):
        acc = proj.point_zero(spec, sl.stop - sl.start, T.device)
        for r in range(K):
            acc = proj.add(spec, acc, T[:, r, :, sl])
        out[..., sl] = acc
    return out


# --- wrappers ----------------------------------------------------------------


def suffix_madd_scan(spec, xy: torch.Tensor) -> torch.Tensor:
    """(2, R, 16, L) affine rows -> (NC, R, 16, L) inclusive suffix sums:
    out[:, r] = sum over rows r' >= r."""
    _, R, _, L = xy.shape
    check_tensor(xy, (2, R, NL, L), "suffix_madd_scan xy")
    if xy.device.type == "cpu":
        return suffix_madd_scan_plain(spec, xy)
    if R == 0 or L == 0:
        raise ValueError("suffix_madd_scan: empty input")
    out = torch.empty(n_coords(spec), R, NL, L, dtype=torch.int32,
                      device=xy.device)
    launch("suffix_madd_scan", spec, xy.device, xy.data_ptr(),
           out.data_ptr(), R, L)
    suffix_madd_scan.launches += 1
    return out


def suffix_jac_scan(spec, T: torch.Tensor):
    """(NC, R, 16, L) points -> (excl (NC, R, 16, L), tot (NC, 16, L)):
    excl[:, r] = sum over rows r' > r, tot = sum over all rows."""
    nc = n_coords(spec)
    _, R, _, L = T.shape
    check_tensor(T, (nc, R, NL, L), "suffix_jac_scan T")
    if T.device.type == "cpu":
        return suffix_jac_scan_plain(spec, T)
    if R == 0 or L == 0:
        raise ValueError("suffix_jac_scan: empty input")
    excl = torch.empty_like(T)
    tot = torch.empty(nc, NL, L, dtype=torch.int32, device=T.device)
    launch("suffix_jac_scan", spec, T.device, T.data_ptr(), excl.data_ptr(),
           tot.data_ptr(), R, L)
    suffix_jac_scan.launches += 1
    return excl, tot


def rowsum(spec, T: torch.Tensor) -> torch.Tensor:
    """(NC, K, 16, L) points -> (NC, 16, L) row totals, added in row
    order."""
    nc = n_coords(spec)
    _, K, _, L = T.shape
    check_tensor(T, (nc, K, NL, L), "rowsum T")
    if T.device.type == "cpu":
        return rowsum_plain(spec, T)
    if K == 0 or L == 0:
        raise ValueError("rowsum: empty input")
    out = torch.empty(nc, NL, L, dtype=torch.int32, device=T.device)
    launch("rowsum", spec, T.device, T.data_ptr(), out.data_ptr(), K, L)
    rowsum.launches += 1
    return out


suffix_madd_scan.launches = 0
suffix_jac_scan.launches = 0
rowsum.launches = 0
