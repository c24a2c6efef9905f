"""Device pipeline of the verification scalars (counterpart of
ark_bulletproofs_tpu/ops/verify.py).

The reference verifier assembles a (2n + ~20)-long scalar vector per
proof on the CPU (reference src/r1cs/verifier.rs:462-540): the IPA
s-vector, the powers y^-i and the g/h scalar formulas. Here that O(n)
work runs on the device in Montgomery form from the lg n challenges and
feeds the mega-MSM directly, so no O(n) host big-int arithmetic and no
O(n) host <-> device scalar conversion is left on the verify path (the
w vectors of the constraints still come from the host, as canonical
limbs).

Both the s-vector
  s[i] = allinv * prod_k (bit_k(i) ? u_sq[lg_n - 1 - k] : 1)
(reference src/inner_product_proof.rs:302-311) and the powers y^-i
decompose over the bits of i, so each is lg n masked products. Every
product is one launch of the Montgomery-product kernel on the card
(field.mont_mul), and every modular add, subtraction and sum one launch
of the field kernels (field.add / sub, sum_mod), none of which
synchronises with the host.

Vectors are (..., 16, n) limbs: (16, n) for one proof, (B, 16, n) for B
proofs of one padded size (the JAX package's vmap becomes this batch
axis); per-proof scalars are (..., 16, 1). `ipa_gh_msm` is the device
half of the standalone IPA verifier (ipp.py).

Under an engine mesh `gh_scalars` shards a large proof's g/h vectors
(padded_n >= GH_SHARD_MIN_N, D dividing it; the JAX package's gate): the
formulas are elementwise, so device d makes columns [lo, lo + b) of every
vector, the y-powers and the s-vector from the global lane index (`lo`),
rev(s) at the complement of that index, and the outputs stay there as a
Pieces that the sharded mega-MSM reads in place.
"""

from __future__ import annotations

import collections

import torch

from .. import engine
from ..parallel.mesh import Pieces
from ..parallel.msm import msm_v1, msm_v2
from . import cache as dcache
from . import field as df
from .curve import point_to_host, spec_for
from .limbs import ints_to_limbs, limbs_to_ints
from .proj import from_jacobian


# Smallest padded_n whose g/h vectors shard over a mesh (the JAX
# package's).
GH_SHARD_MIN_N = 4096


def _pow_vector(fr, base: torch.Tensor, n: int, lg_n: int,
                lo: int = 0) -> torch.Tensor:
    """[base^lo, ..., base^(lo + n - 1)] in Montgomery form, (..., 16, n),
    for a (..., 16, 1) Montgomery `base`: lg_n squarings give base^(2^k),
    then lg_n masked products over the bits of the lane index."""
    idx = torch.arange(lo, lo + n, device=base.device)
    one = df.mont_one(fr, n, base.device)
    v = one
    pw = base
    for k in range(lg_n):
        mask = ((idx >> k) & 1) > 0
        v = df.mont_mul(fr, v, df.select(mask, pw.expand(*pw.shape[:-1], n),
                                         one))
        if k + 1 < lg_n:
            pw = df.mont_mul(fr, pw, pw)
    return v


def _s_vector(fr, u_sq: torch.Tensor, allinv: torch.Tensor, n: int,
              lg_n: int, lo: int = 0, rev: bool = False) -> torch.Tensor:
    """The IPA s-vector at lanes [lo, lo + n), (..., 16, n) Montgomery,
    from u_sq (..., 16, lg_n) and allinv (..., 16, 1) Montgomery: bit k of
    i selects u_sq of round lg_n - 1 - k. With rev, rev(s) there: s at
    2^lg_n - 1 - i, the complement of i's bits."""
    idx = torch.arange(lo, lo + n, device=u_sq.device)
    if rev:
        idx = (1 << lg_n) - 1 - idx
    one = df.mont_one(fr, n, u_sq.device)
    v = allinv.expand(*allinv.shape[:-1], n)
    for k in range(lg_n):
        mask = ((idx >> k) & 1) > 0
        j = lg_n - 1 - k
        usq = u_sq[..., j:j + 1]
        v = df.mont_mul(fr, v, df.select(mask, usq.expand(*usq.shape[:-1], n),
                                         one))
    return v


def _gh_formulas(fr, padded_n: int, lg_n: int, wLm, wRm, wOm, y_inv_m, u_m,
                 x_m, a_m, b_m, u_sq_m, allinv_m, n1, lo: int = 0):
    """The g/h scalar formulas, all Montgomery in and out, for one proof
    ((16, w) vectors, (16, 1) scalars, int n1) or a batch ((B, 16, w),
    (B, 16, 1), (B,) n1), over lanes [lo, lo + w) of padded_n (all of
    them when w = padded_n). Returns (g, h, yneg_wR):

      g = u_or_1 * (x * y^-i wR - a * s)
      h = u_or_1 * (y^-i * (x * wL + wO - b * rev(s)) - 1)

    with u_or_1 = 1 on the n1 phase-1 lanes and u after them."""
    dev = wLm.device
    w = wLm.shape[-1]
    y_inv_vec = _pow_vector(fr, y_inv_m, w, lg_n, lo)
    s = _s_vector(fr, u_sq_m, allinv_m, w, lg_n, lo)
    s_rev = (s.flip(-1) if w == padded_n
             else _s_vector(fr, u_sq_m, allinv_m, w, lg_n, lo, rev=True))
    yneg_wR = df.mont_mul(fr, wRm, y_inv_vec)
    idx = torch.arange(lo, lo + w, device=dev)
    n1 = torch.as_tensor(n1, device=dev)
    one = df.mont_one(fr, w, dev).long()
    u_or_1 = df.select(idx < n1[..., None], one,
                       u_m.long().expand(*u_m.shape[:-1], w))
    x_ywr, a_s, x_wL, b_srev = df.mont_mul(
        fr, torch.stack([yneg_wR.to(torch.int32), s.to(torch.int32),
                         wLm.to(torch.int32),
                         s_rev.to(torch.int32)]),
        torch.stack([x_m, a_m, x_m, b_m]).to(torch.int32))
    g = df.mont_mul(fr, u_or_1, df.sub(fr, x_ywr, a_s))
    inner = df.sub(fr, df.add(fr, x_wL, wOm), b_srev)
    h = df.mont_mul(fr, u_or_1,
                    df.sub(fr, df.mont_mul(fr, y_inv_vec, inner), one))
    return g, h, yneg_wR


def _to_mont_all(fr, *xs):
    """Canonical limb tensors to Montgomery form, one product launch for
    those of one shape."""
    return df.to_mont(fr, torch.stack(xs)).unbind(0)


def _gh_scalars(fr, padded_n: int, lg_n: int, wL, wR, wO, y_inv, u, x, a,
                b, u_sq, allinv, n1, mont_out: bool = False,
                with_delta: bool = True, lo: int = 0):
    """g/h scalar vectors and delta of one proof on the device. wL, wR,
    wO: (16, w) canonical limbs (zero-padded), lanes [lo, lo + w) of
    padded_n; y_inv, u, x, a, b, allinv: (16, 1) canonical; u_sq: (16,
    lg_n) canonical; n1 the phase-1 multiplier count. Returns (g, h)
    canonical, or Montgomery with mont_out, and delta = <y^-i wR, wL>
    over those lanes (16, 1) canonical, or None without with_delta (the
    caller's fetch of it synchronises with the host)."""
    wLm, wRm, wOm = _to_mont_all(fr, wL, wR, wO)
    y_inv_m, u_m, x_m, a_m, b_m, allinv_m = _to_mont_all(
        fr, y_inv, u, x, a, b, allinv)
    g, h, yneg_wR = _gh_formulas(fr, padded_n, lg_n, wLm, wRm, wOm, y_inv_m,
                                 u_m, x_m, a_m, b_m, df.to_mont(fr, u_sq),
                                 allinv_m, n1, lo)
    delta = (df.from_mont(fr, df.dot_mod(fr, yneg_wR, wLm)) if with_delta
             else None)
    if mont_out:
        return g, h, delta
    g, h = df.from_mont(fr, torch.stack([g, h])).unbind(0)
    return g, h, delta


def _gh_scalars_batch_accum(fr, padded_n: int, lg_n: int, wL, wR, wO, y_inv,
                            u, x, a, b, u_sq, allinv, n1, alpha):
    """B proofs' g/h vectors, each scaled by its alpha and summed: (g_acc,
    h_acc) Montgomery (16, padded_n), sum_b alpha_b * {g, h}_b. wL, wR,
    wO: (B, 16, padded_n) canonical; y_inv, u, x, a, b, allinv: (B, 16,
    1) canonical; u_sq (B, 16, lg_n) canonical; n1 (B,) ints; alpha (B,
    16, 1) Montgomery. The batch is a leading axis of every launch; the
    sum over it is one `sum_mod` over the B lanes of (2, n, 16, B)."""
    g, h, _ = _gh_formulas(fr, padded_n, lg_n, *_to_mont_all(fr, wL, wR, wO),
                           *_to_mont_all(fr, y_inv, u, x, a, b),
                           df.to_mont(fr, u_sq), df.to_mont(fr, allinv), n1)
    gh = df.mont_mul(fr, torch.stack([g.to(torch.int32), h.to(torch.int32)]),
                     alpha.to(torch.int32))  # (2, B, 16, n)
    acc = df.sum_mod(fr, gh.permute(0, 3, 2, 1).contiguous())  # (2,n,16,1)
    return acc[..., 0].transpose(1, 2).unbind(0)


def _col(xs, device) -> torch.Tensor:
    """Ints -> (len, 16, 1) limbs (one column each)."""
    return ints_to_limbs(list(xs), device).T.unsqueeze(-1).contiguous()


def _rows(vecs, n: int, device) -> torch.Tensor:
    """B int vectors, each zero-padded to n -> (B, 16, n) limbs."""
    flat = [x for v in vecs for x in list(v) + [0] * (n - len(v))]
    t = ints_to_limbs(flat, device).reshape(16, len(vecs), n)
    return t.permute(1, 0, 2).contiguous()


def gh_scalars(curve, padded_n: int, wL, wR, wO, y_inv: int, u: int, x: int,
               a: int, b: int, u_sq: list[int], allinv: int, n1: int,
               mont_out: bool = False, delta_host: bool = False,
               device=None):
    """Int inputs -> (g, h) (16, padded_n) limbs on the device, canonical
    unless mont_out, for the mega-MSM, and delta as a host int.
    delta_host computes delta = <y^-i wR, wL> (reference verifier.rs:473)
    with host ints (`compute_delta_host`) instead of fetching the
    device's, which would synchronise with the card.

    Under an engine mesh of D devices, from padded_n >= GH_SHARD_MIN_N
    with D dividing it, g and h come back as Pieces of D blocks, block d
    made on mesh.devices[d]; a device delta is the sum of the blocks'
    partials, added in block order on mesh.devices[0]."""
    dev = engine.torch_device() if device is None else torch.device(device)
    fr = df.spec_for(curve.fr)
    lg_n = padded_n.bit_length() - 1
    if len(u_sq) != lg_n:
        raise ValueError(f"gh_scalars: {len(u_sq)} challenges for "
                         f"padded_n = {padded_n}")
    p = curve.fr.p
    mesh = engine.active_mesh()
    D = 1 if mesh is None else mesh.size
    shard = D > 1 and padded_n >= GH_SHARD_MIN_N and padded_n % D == 0
    devs = mesh.devices if shard else (dev,)
    b_n = padded_n // len(devs)
    cols = [y_inv % p, u % p, x % p, a % p, b % p, allinv % p]
    gs, hs, delta = [], [], None
    for d, on in enumerate(devs):
        lo = d * b_n
        c = _col(cols, on).unbind(0)
        g, h, part = _gh_scalars(
            fr, padded_n, lg_n,
            *_rows([v[lo:lo + b_n] for v in (wL, wR, wO)], b_n,
                   on).unbind(0),
            *c[:5], ints_to_limbs(list(u_sq), on), c[5], n1, mont_out,
            not delta_host, lo)
        gs.append(g)
        hs.append(h)
        if part is not None:
            part = part.to(devs[0])
            delta = part if delta is None else df.add(fr, delta, part)
    if shard:
        g, h = Pieces(gs), Pieces(hs)
    if delta_host:
        return g, h, compute_delta_host(p, wL, wR, y_inv)
    return g, h, limbs_to_ints(delta)[0]


def compute_delta_host(p: int, wL, wR, y_inv: int) -> int:
    """delta = <y^-i wR, wL> with host ints (reference verifier.rs:473):
    O(n) products of small ints, cheaper than a synchronising fetch of the
    device's value."""
    acc, yi = 0, 1
    for wRi, wLi in zip(wR, wL):
        acc = (acc + wRi * yi % p * wLi) % p
        yi = yi * y_inv % p
    return acc


def _scale_accumulate(fr, acc_g, acc_h, g, h, alpha):
    """(acc_g + alpha g, acc_h + alpha h), all Montgomery (16, m); alpha
    (16, 1)."""
    ab = df.mont_mul(fr, torch.stack([g, h]), alpha)
    return df.add(fr, acc_g, ab[0]), df.add(fr, acc_h, ab[1])


# --- standalone IPA verification (device big-MSM route) -----------------
#
# `InnerProductProof.verify` (ipp.py; reference
# src/inner_product_proof.rs:321-382) would assemble its whole
# (2n + 2 lg n + 1)-term MSM on the host: O(n) big-int scalar math and a
# fresh upload of the 2n generator points and 2n scalars a call. Here
# the [G | H] table and the factor vectors stay on the device across
# calls, the s-vector and the g/h scalars are made on the device from the
# lg n challenges, and only the [Q | L | R] tail (2 lg n + 1 points) runs
# on the host's Pippenger.

# The Montgomery factor vectors, least recently used first, keyed by
# their whole content; the oldest is dropped past IPA_VERIFY_CACHE_SIZE.
_IPA_VERIFY_CACHE: "collections.OrderedDict" = collections.OrderedDict()
IPA_VERIFY_CACHE_SIZE = 8


def _cached_mont_vector(fr, xs, p: int, R: int, device):
    """Montgomery limbs of the ints xs on device, kept by the content of
    xs (a tuple key: a dict lookup compares every element, so two vectors
    that differ anywhere never share an entry)."""
    key = (fr.p, tuple(xs), str(device))
    hit = _IPA_VERIFY_CACHE.get(key)
    if hit is None:
        hit = ints_to_limbs([x % p * R % p for x in xs], device)
        _IPA_VERIFY_CACHE[key] = hit
        while len(_IPA_VERIFY_CACHE) > IPA_VERIFY_CACHE_SIZE:
            _IPA_VERIFY_CACHE.popitem(last=False)
    else:
        _IPA_VERIFY_CACHE.move_to_end(key)
    return hit


def ipa_gh_msm(curve, n: int, a: int, b: int, u_sq, allinv, G_factors,
               H_factors, G_vec, H_vec, device=None):
    """<a s Gf, G> + <b rev(s) Hf, H> on the device -> host affine point.
    The [G | H] table (ops/cache.py::ipa_table, shared with the device
    IPA prover) and the Montgomery factor vectors are cached by content
    and device, so fresh lists of the same values hit and any other
    values miss."""
    dev = engine.torch_device() if device is None else torch.device(device)
    fr = df.spec_for(curve.fr)
    p, R = curve.fr.p, curve.fr.R
    lg_n = n.bit_length() - 1
    X, Y, inf = dcache.ipa_table(curve, G_vec, H_vec, dev)
    gf = _cached_mont_vector(fr, G_factors, p, R, dev)
    hf = _cached_mont_vector(fr, H_factors, p, R, dev)
    u_sq_m = ints_to_limbs([v * R % p for v in u_sq], dev)
    allinv_m, a_m, b_m = _col([allinv * R % p, a % p * R % p,
                               b % p * R % p], dev).unbind(0)
    out = _ipa_gh_msm_dev(fr, spec_for(curve), n, lg_n, X, Y, inf, gf, hf,
                          u_sq_m, allinv_m, a_m, b_m)
    return point_to_host(curve, out)


# The device IPA verifier's engine gate (the JAX package's, on the TPU):
# the v2 MSM from 2n terms up, the v1 Pippenger below.
IPA_GH_V2_MIN = 1024


def _ipa_gh_msm_dev(fr, spec, n: int, lg_n: int, X, Y, inf, gf, hf, u_sq_m,
                    allinv_m, a_m, b_m) -> torch.Tensor:
    """The g/h scalars and their 2n-term MSM over [G | H], one scalar set:
    (NC, 16, 1) in the device coordinates."""
    s = _s_vector(fr, u_sq_m, allinv_m, n, lg_n)
    gh = df.mont_mul(fr, torch.stack([s, s.flip(-1)]).to(torch.int32),
                     torch.stack([gf, hf]))
    gh = df.mont_mul(fr, gh, torch.stack([a_m, b_m]))
    scal = df.from_mont(fr, gh).to(torch.int32).transpose(0, 1).reshape(
        16, 2 * n).unsqueeze(0).contiguous()
    if 2 * n >= IPA_GH_V2_MIN:
        return msm_v2(spec, X, Y, inf, scal)
    return from_jacobian(spec, msm_v1(spec, X, Y, inf, scal)).to(torch.int32)
