"""Device MSMs (counterpart of ops/msm.py): the v1 Pippenger and the
host-facing `msm`, `msm_many` and `msm_many_tabled`.

`msm_impl` is the v1 Pippenger of ark_bulletproofs_tpu/ops/msm.py, the
engine the JAX package's router (parallel/msm.py) gives every MSM below
the v2 MSM's widths. Its contract, per window of c bits:

  1. digits of the window, a stable sort of them (ties keep the index
     order, as `jnp.argsort`), the points gathered in sorted order into R
     rows of C columns (R = min(n, 32)), an optional base_map composed
     into the gather;
  2. a row scan of mixed adds (`kernels.madd_scan`: one `jac_madd`
     launch over the R rows, or one `te_madd` launch on a
     twisted-Edwards curve) gives each column's suffix sums, and a
     Hillis-Steele suffix over the C column totals (log2 C adds) their
     carries;
  3. telescoping: the window sum  sum_j j B_j  is  sum_i delta_i T_i  over
     the S <= 2^c segment starts i of the sorted digits (delta_i the digit
     step, T_i the suffix sum there, found by a top-k of the starts in
     ascending position);
  4. the delta bits select the T_i into (c, S) leaves, a halving tree sums
     each bit's leaves (log2 S adds), and a Horner over the bits (c steps
     of `double_k_add` at k = 1) gives the window sum;

then a Horner over the W windows, top window first, from the identity:
one launch of `jac_horner_windows` / `horner_windows` (ops/kernels2.py),
which the JAX version ran as W double-k-add steps at k = c. Points stay
in the model coordinates of the JAX package's group law: Jacobian
(identity Z = 0) on a short-Weierstrass curve, extended on a
twisted-Edwards one; every other add and double-k-add is one launch of
`jac_double_k_add` / `te_double_k_add` (`kernels.model_double_k_add`).

What the JAX version did only for the TPU is dropped: it scanned over
groups of G = min(B W, 8) windows to bound VMEM and compile size. Here
all B W windows run in one pass (B W C lanes in the row scan), split only
when G n would pass V1_MAX_WINDOW_TERMS, so an MSM is about 1 + log2 C +
1 + log2 S + c + 1 launches whatever B is, on either curve model.
Windows are independent, so
every window's coordinates are those of the JAX version.

The host-facing functions take affine int points and int scalars and
return affine points; the base axis goes through the ragged driver
(parallel/msm.py), which routes each piece to v1 or to the v2 MSM
(ops/msm2.py) as the JAX package does; `msm_many_tabled` runs over rows
of a cached device table instead.
"""

from __future__ import annotations

import torch

from .. import engine
from ..parallel import msm as router
from . import kernels as kk
from . import kernels2 as k2
from .curve import (affine_to_device, is_te, n_coords,
                    point_batch_to_host, point_zero, spec_for)
from .limbs import N_LIMBS, ints_to_limbs

SCALAR_BITS = 256
# Window-terms (windows x n) of one pass of msm_impl; more are split over
# the window axis, which bounds the temporaries (about 1.3 GB of gathered
# and scanned points at this width).
V1_MAX_WINDOW_TERMS = 1 << 22


def _window_bits(n: int) -> int:
    """The v1 window size (the JAX package's choice; it divides 16)."""
    return 8 if n >= 4096 else 4


def _digits_for_windows(scal: torch.Tensor, ws: torch.Tensor,
                        c: int) -> torch.Tensor:
    """(G, n) int64 digits for window indices ws (G,). scal is (16, n)
    canonical limbs of one scalar set, or (B, 16, n) for B sets, where
    window w is window w % W of set w // W (W = 256 / c)."""
    per = 16 // c
    w = ws.long()
    if scal.dim() == 3:
        W = SCALAR_BITS // c
        limb = scal[w // W, (w % W) // per]  # (G, n)
        w = w % W
    else:
        limb = scal[w // per]
    shift = ((w % per) * c)[:, None]
    return (limb.long() >> shift) & ((1 << c) - 1)


def _ident(spec, lanes: int, device) -> torch.Tensor:
    return point_zero(spec, lanes, device).to(torch.int32)


def _add(spec, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """P + Q over (NC, 16, ...) points of one shape, one launch."""
    nc = P.shape[0]
    shape = P.shape
    out = kk.model_double_k_add(spec, P.reshape(nc, N_LIMBS, -1).contiguous(),
                                Q.reshape(nc, N_LIMBS, -1).contiguous(), 0)
    return out.reshape(shape)


def _hs_suffix(spec, P: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along the last axis of (NC, 16, G, C) points,
    Hillis-Steele: log2 C full-width steps, slot c adding slot c + 2^k or,
    past the end, the identity."""
    nc, _, G, C = P.shape
    idx = torch.arange(C, device=P.device)
    ident = _ident(spec, G * C, P.device).reshape(nc, N_LIMBS, G, C)
    for k in range(max(C - 1, 0).bit_length()):
        sh = 1 << k
        part = P[..., (idx + sh).clamp(max=C - 1)]
        part = torch.where((idx + sh < C).expand(G, C).unsqueeze(-3), part,
                           ident)
        P = _add(spec, P, part)
    return P


def _tree_reduce(spec, P: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis of (NC, 16, ..., S) points by halving: slot
    j < S / 2^(k+1) adds slot j + S / 2^(k+1). The JAX version keeps the
    full width and adds the identity to the upper slots, which are never
    read again; only the live slots are computed here. (NC, 16, ...)."""
    S = P.shape[-1]
    while S > 1:
        S //= 2
        P = _add(spec, P[..., :S], P[..., S:2 * S])
    return P[..., 0]


def _window_sums(spec, c: int, X, Y, inf, scal, base_map,
                 ws: torch.Tensor) -> torch.Tensor:
    """The sums  sum_i digit_w(k_i) P_i  of the windows ws: (NC, 16, G)."""
    dev = scal.device
    nc = n_coords(spec)
    n = scal.shape[-1]
    G = ws.shape[0]
    S = min(1 << c, n)
    R = min(n, 32)
    C = n // R
    digits = _digits_for_windows(scal, ws, c)  # (G, n)
    sd, order = torch.sort(digits, dim=-1, stable=True)
    if base_map is not None:
        W = SCALAR_BITS // c
        order = torch.gather(base_map.long()[ws.long() // W], 1, order)
    # sorted index i = col * R + r -> row r, lane g * C + col
    idx = order.reshape(G, C, R).permute(2, 0, 1).reshape(R, G * C)
    cX = X[:, idx].permute(1, 0, 2).contiguous()  # (R, 16, G C)
    cY = Y[:, idx].permute(1, 0, 2).contiguous()
    cI = inf[idx].contiguous()  # (R, G C)

    local = kk.madd_scan(spec, _ident(spec, G * C, dev), cX, cY, cI)
    acc = local[:, 0]  # the column totals
    del cX, cY, cI

    # exclusive suffix of the column totals
    incl = _hs_suffix(spec, acc.reshape(nc, N_LIMBS, G, C))
    cidx = torch.arange(C, device=dev)
    excl = torch.where((cidx + 1 < C).expand(G, C).unsqueeze(-3),
                       incl[..., (cidx + 1).clamp(max=C - 1)],
                       _ident(spec, G * C, dev).reshape(nc, N_LIMBS, G, C))

    # segment starts (delta > 0), their first S positions in order
    delta = sd - torch.nn.functional.pad(sd[:, :-1], (1, 0))
    iota = torch.arange(n, device=dev)
    key = torch.where(delta > 0, n - iota, 0)
    vals = torch.topk(key, S, dim=-1, sorted=True).values  # descending
    valid = vals > 0
    pos = torch.where(valid, n - vals, 0)
    dsel = torch.where(valid, torch.gather(delta, 1, pos), 0)  # (G, S)

    # the suffix sum T at each selected position
    lane = torch.arange(G, device=dev)[:, None] * C + pos // R
    T_loc = local.permute(0, 2, 1, 3)[:, :, pos % R, lane]  # (NC,16,G,S)
    T_car = excl.reshape(nc, N_LIMBS, G * C)[:, :, lane]
    del local
    Ts = _add(spec, T_loc, T_car)

    # sum_j dsel_j Ts_j over the bits of dsel
    bit = torch.arange(c, device=dev)[None, :, None]
    mask = ((dsel[:, None, :] >> bit) & 1) > 0  # (G, c, S)
    leaves = torch.where(
        mask.unsqueeze(-4), Ts.unsqueeze(-2).expand(nc, N_LIMBS, G, c, S),
        _ident(spec, 1, dev).reshape(nc, N_LIMBS, 1, 1, 1))
    bitsums = _tree_reduce(spec, leaves)  # (NC, 16, G, c)
    acc = _ident(spec, G, dev)
    for t in range(c - 1, -1, -1):
        acc = kk.model_double_k_add(spec, acc, bitsums[..., t].contiguous(),
                                    1)
    return acc


def msm_impl(spec, c: int, X, Y, inf, scal, base_map=None) -> torch.Tensor:
    """The v1 Pippenger. X, Y: (16, m) int32 affine Montgomery limbs; inf:
    (m,) bool; scal: (16, n) int32 canonical limbs of one scalar set or
    (B, 16, n) of B sets over the same bases; n a power of two, c a
    divisor of 16. Without base_map m = n; with base_map (B, n) scalar j
    of set b multiplies table row base_map[b, j] (m may be wider). Returns
    the B sums (B = 1 for one set) as an (NC, 16, B) int32 tensor in the
    model coordinates: Jacobian on a short-Weierstrass curve, extended on
    a twisted-Edwards one."""
    if scal.dim() == 2:
        scal = scal.unsqueeze(0)
    B, _, n = scal.shape
    if n < 1 or n & (n - 1):
        raise ValueError(f"msm_impl: n={n} must be a power of two")
    if 16 % c:
        raise ValueError(f"msm_impl: window c={c} must divide 16")
    if base_map is None and X.shape[-1] != n:
        raise ValueError("msm_impl: one point per scalar without base_map")
    dev = scal.device
    W = SCALAR_BITS // c
    step = max(1, min(B * W, V1_MAX_WINDOW_TERMS // n))
    wsum = torch.cat([
        _window_sums(spec, c, X, Y, inf, scal, base_map,
                     torch.arange(o, min(o + step, B * W), device=dev))
        for o in range(0, B * W, step)
    ], dim=-1)
    horner = k2.horner_windows if is_te(spec) else k2.jac_horner_windows
    return horner(spec, wsum.reshape(n_coords(spec), N_LIMBS, B, W), c)


def scalars_to_device(curve, scalar_sets, device) -> torch.Tensor:
    """B lists of n int scalars -> (B, 16, n) int32 canonical limbs."""
    B, n = len(scalar_sets), len(scalar_sets[0])
    p = curve.fr.p
    flat = [s % p for ks in scalar_sets for s in ks]
    if len(flat) != B * n:
        raise ValueError("scalar sets differ in length")
    limbs = ints_to_limbs(flat).reshape(N_LIMBS, B, n).permute(1, 0, 2)
    return limbs.contiguous().to(device)


def _device_sums(curve, bases: list, scal_of, device) -> torch.Tensor:
    dev = engine.torch_device() if device is None else torch.device(device)
    X, Y, inf = affine_to_device(curve, list(bases), dev)
    return router.msm_device_ragged(spec_for(curve), X, Y, inf,
                                    scal_of(dev))


def msm_many(curve, bases: list, scalar_sets: list[list[int]],
             device=None) -> list:
    """B MSMs over shared bases in one device run (a batch of B scalar
    sets); B affine points."""
    n = len(bases)
    if n == 0 or not scalar_sets:
        return [curve.zero() for _ in scalar_sets]
    if any(len(ks) != n for ks in scalar_sets):
        raise ValueError("each scalar set needs one scalar per base")
    return point_batch_to_host(curve, _device_sums(
        curve, bases, lambda d: scalars_to_device(curve, scalar_sets, d),
        device))


def msm(curve, bases: list, scalars: list[int], device=None):
    """sum_i scalars[i] * bases[i] on the device (one scalar set); affine
    out."""
    if len(bases) != len(scalars):
        raise ValueError("one scalar per base")
    if not bases:
        return curve.zero()
    return point_batch_to_host(curve, _device_sums(
        curve, bases, lambda d: scalars_to_device(curve, [scalars], d)[0],
        device))[0]


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
        curve, router.msm_device_mapped(spec_for(curve), X, Y, inf, scal,
                                        bm))
