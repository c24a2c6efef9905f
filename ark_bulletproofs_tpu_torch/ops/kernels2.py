"""Row-scan kernels of the v2 MSM (CUDA, csrc/msm_kernels.cu).

Replace the TPU mega-kernels of ark_bulletproofs_tpu/ops/kernels2.py:

  suffix_madd_scan <- suffix_madd_scan: stage C, per-column inclusive
      suffix sums of the sorted affine points (the W * n mixed adds; on a
      twisted-Edwards curve its body is the one of kernels.py's
      te_madd_tiled);
  suffix_jac_scan  <- suffix_jac_scan: stage D, per-column exclusive
      suffix sums plus totals over rows of projective points;
  rowsum           <- rowsum_jac: stage F, row sums down to totals;
      both are a chain of complete adds a lane, in the JAX kernels' row
      order, shared by a group of threads (csrc/group.cuh) below
      CHAIN_ONE_THREAD_MIN_LANES lanes and run by one thread a lane from
      it;
  horner_windows   <- horner_windows: acc = 2^c acc + part[w] over the
      window axis in one launch, the window Horner of both MSM engines
      (v2's stage G on RCB or extended points; v1's on extended points),
      and `jac_horner_windows` the same on the Jacobian points of v1 on a
      short-Weierstrass curve; a group of threads shares each scalar
      set's chain (csrc/group.cuh).

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
from .curve import _sw_add, _sw_double, n_coords, point_zero
from .kernels import (_check_model, check_tensor, lane_slices, launch,
                      same_device)
from .limbs import N_LIMBS

NL = N_LIMBS
# csrc/msm_kernels.cu's lane count from which suffix_jac_scan and rowsum
# run one thread a lane instead of a thread group (the H100's crossover,
# PERF.md; tests/test_torch_msm_plan.py ties the two).
CHAIN_ONE_THREAD_MIN_LANES = 16384


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


def horner_windows_plain(spec, parts: torch.Tensor, c: int,
                         acc0: torch.Tensor) -> torch.Tensor:
    """The plain version of `horner_windows`: from acc0, W steps of c
    doublings and an add (`proj.double_k_add`), top window first."""
    acc = acc0
    for w in range(parts.shape[-1] - 1, -1, -1):
        acc = proj.double_k_add(spec, acc, parts[..., w], c)
    return acc.to(torch.int32)


def jac_horner_windows_plain(spec, parts: torch.Tensor, c: int,
                             acc0: torch.Tensor) -> torch.Tensor:
    """The plain version of `jac_horner_windows`: the same steps on the
    Jacobian law (`curve._sw_double`, `curve._sw_add`)."""
    acc = acc0
    for w in range(parts.shape[-1] - 1, -1, -1):
        for _ in range(c):
            acc = _sw_double(spec, acc)
        acc = _sw_add(spec, acc, parts[..., w])
    return acc.to(torch.int32)


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


def _window_stride(parts: torch.Tensor, shape: tuple, name: str) -> int:
    """Raise unless parts is an int32 (NC, 16, B, W) slice, along its last
    axis, of a contiguous (NC, 16, B, Ws) tensor; return Ws."""
    nc, _, B, W = shape
    if parts.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {parts.dtype}")
    if tuple(parts.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(parts.shape)}")
    if parts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {parts.device}")
    Ws = parts.stride(1) // max(B, 1)
    want = (NL * B * Ws, B * Ws, Ws, 1)
    if Ws < W or any(n > 1 and st != wst for n, st, wst in
                     zip(parts.shape, parts.stride(), want)):
        raise ValueError(f"{name}: windows must be the innermost axis of a "
                         f"contiguous tensor (strides {parts.stride()})")
    return Ws


def _horner(wrapper, plain, kernel: str, ident, spec, parts, c: int,
            acc0):
    """Checks, then the plain version (CPU) or the launcher `kernel`
    (CUDA), counted on the wrapper."""
    name = wrapper.__name__
    nc = n_coords(spec)
    if parts.dim() != 4:
        raise ValueError(f"{name}: parts must be (NC, 16, B, W)")
    B, W = parts.shape[2], parts.shape[3]
    Ws = _window_stride(parts, (nc, NL, B, W), f"{name} parts")
    if acc0 is None:
        acc0 = ident(spec, B, parts.device).to(torch.int32)
    check_tensor(acc0, (nc, NL, B), f"{name} acc0")
    if not 0 <= c < (1 << 31):
        raise ValueError(f"{name}: c={c} out of range")
    dev = same_device(parts, acc0)
    if dev.type == "cpu":
        return plain(spec, parts, c, acc0)
    if B == 0 or W == 0:
        raise ValueError(f"{name}: empty input")
    out = torch.empty_like(acc0)
    launch(kernel, spec, dev, parts.data_ptr(), acc0.data_ptr(),
           out.data_ptr(), B, W, Ws, c)
    wrapper.launches += 1
    return out


def horner_windows(spec, parts: torch.Tensor, c: int,
                   acc0: torch.Tensor | None = None) -> torch.Tensor:
    """acc = 2^c acc + part[w] for w = W - 1 down to 0, from acc0 (None:
    the identity, as the JAX kernel starts), on RCB projective or, on a
    twisted-Edwards curve, extended points. parts: (NC, 16, B, W) int32,
    window w of set b at [..., b, w], the windows innermost (a slice of
    the window axis of a contiguous tensor is read in place); acc0 and the
    result: (NC, 16, B). Kernel `abtpu_horner`, one launch."""
    return _horner(horner_windows, horner_windows_plain, "horner",
                   proj.point_zero, spec, parts, c, acc0)


def jac_horner_windows(spec, parts: torch.Tensor, c: int,
                       acc0: torch.Tensor | None = None) -> torch.Tensor:
    """`horner_windows` on Jacobian short-Weierstrass points (identity
    (0, 0, 0)). Kernel `abtpu_jac_horner`, one launch."""
    _check_model("jac_horner_windows", spec, te=False)
    return _horner(jac_horner_windows, jac_horner_windows_plain,
                   "jac_horner", point_zero, spec, parts, c, acc0)


suffix_madd_scan.launches = 0
suffix_jac_scan.launches = 0
rowsum.launches = 0
horner_windows.launches = 0
jac_horner_windows.launches = 0
