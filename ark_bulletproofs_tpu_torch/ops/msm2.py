"""v2 Pippenger MSM on four kernels (counterpart of ops/msm2.py).

Same contract and stages as ark_bulletproofs_tpu/ops/msm2.py::msm2_impl,
for n a power of two >= V2_MIN_N and B >= 1 scalar sets over shared
bases:

  A. digits of all W windows at once;
  B. one sort per window row on int64 keys digit << lg n | index (c + lg n
     reaches 32 bits at n = 2^20, c = 12, so 32-bit keys would overflow):
     the sorted digits and the permutation from a single torch.sort;
  C. the sorted points gathered into the (2, R, 16, L) layout, L = B W C
     lanes of R = n / C rows, by one `stage_gather` launch that reads the
     sort order (and the base map) directly, and suffix-summed per column
     by `suffix_madd_scan` (W n mixed adds, the Pippenger work floor);
  D. column carries, two levels: `suffix_jac_scan` over the c2 columns of
     each chunk, then over the c1 chunk totals, joined by one add;
  E. the window sum sum_j j B_j telescopes to sum_{j >= 1} T[pos_j], T the
     global suffix sum and pos_j = searchsorted(digits, j): a gather and
     one add per bucket;
  F. `rowsum` collapses the S = 2^c bucket terms in two passes;
  G. Horner over windows, acc = 2^c acc + part_w, all W windows in one
     `horner_windows` launch (the JAX package's stage G launched one
     double-k-add a window; its own all-windows kernel was slower on the
     TPU and had no caller).

The glue between the kernels is plain torch. What the JAX version did
only for the TPU is re-decided: the x | y << 16 packed gather rows stay
(on the H100 they halve the gather's random reads; the kernel unpacks
them as it writes), while the 16-ary searchsorted pyramid, the
one-hot-matmul bucket select and the C <= 64 carry layout are gone
(C >= 256 here, so only the two-level carry and the gather paths
exist), and the small Hillis-Steele chunk-carry suffix is a second
`suffix_jac_scan`. PyTorch runs eagerly, so there is
no fused-vs-staged split.

The column plan (`plan_columns`) is this card's, not the TPU's. The W n
mixed adds of stage C do not depend on C; its serial depth R = n / C and
stage D's depth c1 + c2 (c1 c2 = C) do, and so does how full the card is:
the scan runs one thread a lane, each a chain of R dependent mixed adds,
and the card holds its SMs x SCAN_MIN_BLOCKS x SCAN_THREADS of them at
once (`fill_lanes`). So C starts at min(C_COLS, n) (the JAX package's
plan, which the port keeps for n <= C_COLS) and doubles while the lanes
leave the card under-filled and the doubled plan's scan stays at least
DEPTH_RATIO times deeper than stage D. At n = 2^20, B = 1 that gives
C = 4096, R = 256, L = 90,112 lanes and c1 = c2 = 64; the JAX plan was
C = 1024, R = 1024, L = 22,528 on about one block an SM. On the H100 the
n = 2^20 MSM took 40.5 / 41.3 / 43.9 ms (secq256k1) at C = 4096 / 2048 /
1024 (PERF.md, PR 7).

Points are (NC, 16, lanes) int32 throughout: RCB projective, NC = 3, on
a short-Weierstrass curve; HWCD extended, NC = 4, on a twisted-Edwards
one (`curve.n_coords`). The result is (NC, 16, B).
"""

from __future__ import annotations

import torch

from . import gather
from . import kernels as kk
from . import kernels2 as k2
from . import proj
from .curve import n_coords
from .limbs import N_LIMBS

NL = N_LIMBS
SCALAR_BITS = 256
# The column plan (plan_columns): C starts at min(C_COLS, n), the JAX
# package's cap, and doubles while the B * W * C lanes are fewer than the
# scan threads the card keeps resident at once (fill_lanes), and the
# doubled plan keeps R >= DEPTH_RATIO * (c1 + c2). SCAN_THREADS and
# SCAN_MIN_BLOCKS are csrc/msm_kernels.cu's launch bounds of the scan
# (tests/test_torch_msm_plan.py ties the two); PLAN_SMS, the H100's SM
# count, stands in for the card's when the plan is made for CPU tensors.
C_COLS = 1024
DEPTH_RATIO = 2
SCAN_THREADS = 128
SCAN_MIN_BLOCKS = 3
PLAN_SMS = 132
V2_MIN_N = 256


def _log2(x: int) -> int:
    return x.bit_length() - 1


def window_bits(n: int) -> int:
    """Window size c (same choice as the JAX package, so both run the
    same W and S at a given n)."""
    lg = _log2(n)
    if n >= (1 << 18):
        c = 12
    elif n >= (1 << 13):
        c = 10
    elif n >= (1 << 10):
        c = 8
    else:
        c = max(4, lg - 4)
    return min(c, 32 - lg)


def column_split(C: int) -> tuple[int, int]:
    """(c1, c2) with c1 * c2 = C, c1 >= c2, both powers of two: stage D
    scans c2 rows over B W c1 lanes, then c1 rows over B W lanes, so the
    near-square split keeps its depth c1 + c2 least."""
    c1 = 1 << ((_log2(C) + 1) // 2)
    return c1, C // c1


def fill_lanes(device) -> int:
    """The scan threads `device` keeps resident at once: its SMs (PLAN_SMS
    off the card) x SCAN_MIN_BLOCKS x SCAN_THREADS."""
    device = torch.device(device)
    sms = PLAN_SMS
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * SCAN_MIN_BLOCKS * SCAN_THREADS


def plan_columns(n: int, c: int, B: int, fill: int) -> int:
    """Stage C's column count C for B sets of n scalars in c-bit windows:
    min(C_COLS, n), doubled while the scan's B W C lanes under-fill the
    card (fewer than `fill`) and the doubled plan's R = n / C stays at
    least DEPTH_RATIO (c1 + c2)."""
    W = -(-SCALAR_BITS // c)
    C = min(C_COLS, n)
    while 2 * C <= n and B * W * C < fill:
        c1, c2 = column_split(2 * C)
        if n // (2 * C) < DEPTH_RATIO * (c1 + c2):
            break
        C *= 2
    return C


class _Cfg:
    """Shape plan for one (n, c, B) instantiation on `device`."""

    __slots__ = ("n", "c", "B", "lg", "W", "BW", "C", "c1", "c2", "R",
                 "L", "S")

    def __init__(self, n: int, c: int, B: int, device="cpu"):
        lg = _log2(n)
        if n != 1 << lg or n < V2_MIN_N:
            raise ValueError(f"msm2: n={n} must be a power of two "
                             f">= {V2_MIN_N}")
        if not 1 <= c <= 16:
            raise ValueError(f"msm2: window c={c} must be in [1, 16]")
        self.n, self.c, self.B, self.lg = n, c, B, lg
        self.W = -(-SCALAR_BITS // c)
        self.BW = B * self.W
        self.C = plan_columns(n, c, B, fill_lanes(device))
        self.c1, self.c2 = column_split(self.C)
        self.R = n // self.C
        self.L = self.BW * self.C
        self.S = 1 << c


def _digits_all(scal: torch.Tensor, c: int, W: int) -> torch.Tensor:
    """(B, 16, n) canonical scalar limbs -> (B * W, n) int64 digits, row
    b * W + w. Windows may straddle two 16-bit limbs."""
    B, _, n = scal.shape
    s = torch.nn.functional.pad(scal.long(), (0, 0, 0, 1))  # 17th limb
    lo = torch.arange(W, device=scal.device) * c
    l0, off = lo >> 4, (lo & 15)[:, None]
    v = (s[:, l0] >> off) | (s[:, l0 + 1] << (16 - off))  # (B, W, n)
    return (v & ((1 << c) - 1)).reshape(B * W, n)


def _stage_sort(g: _Cfg, scal: torch.Tensor):
    """Digits + one int64 key sort -> (order, sorted digits), (BW, n)."""
    digits = _digits_all(scal, g.c, g.W)
    iota = torch.arange(g.n, device=scal.device)
    keys = torch.sort((digits << g.lg) | iota, dim=1).values
    return keys & (g.n - 1), keys >> g.lg


def _stage_gather(g: _Cfg, X, Y, inf, order, base_map=None):
    """Sorted affine points -> (2, R, 16, L), identity rows with y = 0:
    one `stage_gather` launch, straight from the sort order (base_map
    composed in the kernel)."""
    return gather.stage_gather(X, Y, inf, order, g.R, g.C, g.W, base_map)


def _stage_carries(g: _Cfg, spec, locs: torch.Tensor) -> torch.Tensor:
    """Exclusive column-carry suffix -> (NC, 16, BW * C), lane b * C +
    col, col = i1 * c2 + i2."""
    c1, c2, BW = g.c1, g.c2, g.BW
    nc = n_coords(spec)
    tot = locs[:, 0].reshape(nc, NL, BW, c1, c2)
    lvl_a = tot.permute(0, 4, 1, 2, 3).reshape(nc, c2, NL, BW * c1)
    excl, ct = k2.suffix_jac_scan(spec, lvl_a.contiguous())
    lvl_b = ct.reshape(nc, NL, BW, c1).permute(0, 3, 1, 2).contiguous()
    ce, _ = k2.suffix_jac_scan(spec, lvl_b)  # (NC, c1, 16, BW)
    e2 = (excl.reshape(nc, c2, NL, BW, c1).permute(0, 2, 3, 4, 1)
          .reshape(nc, NL, g.L))
    ceb = (ce.permute(0, 2, 3, 1).unsqueeze(-1).expand(nc, NL, BW, c1, c2)
           .reshape(nc, NL, g.L))
    return kk.add(spec, e2.contiguous(), ceb.contiguous())


def _bucket_pos(sd: torch.Tensor, S: int) -> torch.Tensor:
    """pos[b, j] = #{i : sd[b, i] < j} for j in [0, S) over sorted rows."""
    BW = sd.shape[0]
    js = torch.arange(S, device=sd.device).expand(BW, S).contiguous()
    return torch.searchsorted(sd, js)


def _stage_buckets(g: _Cfg, spec, sd, excl_col, locs) -> torch.Tensor:
    """Bucket terms T[pos_j] for j in [0, S) -> (NC, 16, BW * S), lane
    b * S + j; slot 0 and empty slots are the identity."""
    S, n, R, C, BW = g.S, g.n, g.R, g.C, g.BW
    nc = n_coords(spec)
    dev = sd.device
    pos = _bucket_pos(sd, S)
    js = torch.arange(S, device=dev)
    valid = ((js >= 1) & (pos < n)).reshape(-1)
    posc = pos.clamp(max=n - 1)
    colj, rj = posc // R, posc % R
    lanej = torch.arange(BW, device=dev)[:, None] * C + colj
    T1 = locs.permute(0, 2, 1, 3)[:, :, rj, lanej].reshape(nc, NL, BW * S)
    EC = excl_col.reshape(nc, NL, BW * C)[:, :, lanej].reshape(nc, NL,
                                                               BW * S)
    ident = proj.point_zero(spec, BW * S, dev).to(torch.int32)
    T1 = proj.select(valid, T1, ident).contiguous()
    EC = proj.select(valid, EC, ident).contiguous()
    return kk.add(spec, T1, EC)


def _stage_rowsum(g: _Cfg, spec, U: torch.Tensor) -> torch.Tensor:
    """Two-pass collapse of the S bucket terms -> (NC, 16, BW)."""
    S, BW = g.S, g.BW
    nc = n_coords(spec)
    K1 = (16 if S <= 1024 else 64) if S >= 16 else S
    M1 = S // K1
    p1 = U.reshape(nc, NL, BW, K1, M1).permute(0, 3, 1, 2, 4)
    part1 = k2.rowsum(spec, p1.reshape(nc, K1, NL, BW * M1).contiguous())
    p2 = part1.reshape(nc, NL, BW, M1).permute(0, 3, 1, 2).contiguous()
    return k2.rowsum(spec, p2)


def _stage_horner(g: _Cfg, spec, wsum: torch.Tensor) -> torch.Tensor:
    """acc = 2^c acc + part_w over descending windows -> (NC, 16, B): one
    `horner_windows` launch from the top window over the other W - 1, read
    in place, as the JAX package's stage G starts (an identity start gives
    the same affine point in other projective coordinates)."""
    h = wsum.reshape(n_coords(spec), NL, g.B, g.W)
    return k2.horner_windows(spec, h[..., :g.W - 1], g.c,
                             h[..., g.W - 1].contiguous())


def msm2_impl(spec, c: int, X, Y, inf, scal,
              base_map=None) -> torch.Tensor:
    """v2 Pippenger. X, Y: (16, m) affine Montgomery limbs; inf: (m,)
    bool; scal: (B, 16, n) canonical scalar limbs; all int32 but inf, on
    one device. Without base_map m = n and scalar j multiplies point j;
    with base_map (B, n) it multiplies table row base_map[b, j]. Returns
    the B sums as an (NC, 16, B) point tensor."""
    g = _Cfg(scal.shape[-1], c, scal.shape[0], scal.device)
    order, sd = _stage_sort(g, scal)
    xy = _stage_gather(g, X, Y, inf, order, base_map)
    del order
    locs = k2.suffix_madd_scan(spec, xy)
    del xy
    excl_col = _stage_carries(g, spec, locs)
    U = _stage_buckets(g, spec, sd, excl_col, locs)
    del locs, excl_col
    wsum = _stage_rowsum(g, spec, U)
    return _stage_horner(g, spec, wsum)
