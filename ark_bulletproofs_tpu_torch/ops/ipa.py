"""Device-resident inner-product-argument prover state (counterpart of
ark_bulletproofs_tpu/ops/ipa.py, the single-proof compact path).

The reference's IPA (src/inner_product_proof.rs:76-231) folds generator
vectors every round with per-element 2-point MSMs. Here the O(n) state
stays on the device across rounds: the witness halves a, b and
per-original-index fold weights gm, hm over the FIXED base table
[G | H]. Each round is

  device: the compact round scalars (one 6-row product launch), one
          batched 2-set base_map MSM for L and R;
  host:   the c * Q terms (native fixed-base path), transcript append of
          L and R, challenge u (Fiat-Shamir is a host chain);
  device: fold a, b and update the weights (two product launches).

Compact rounds: in each of the L and R rows exactly one of (G_i, H_i) has
a nonzero scalar, so a round is an N-term MSM over a per-round choice of
G_i or H_i: an N-wide scalar row plus a base_map into [G | H]. The Q term
leaves the MSM and is added on the host. Once N / cur >= 128 segments
share a live slot, `_shrink` materialises the folded table at width cur
(one batched base_map MSM) and later rounds run cur-term MSMs. Group math
is exact, so L, R and the proof bytes equal the host route's.

Vectors are (16, N) limbs (Montgomery unless said otherwise), or (P, 16,
N) for P proofs in lockstep: `_round_scalars_compact` and `_fold` take
leading batch axes. On the card every field product is one launch of the
Montgomery-product kernel (field.mont_mul).

The on-device Fiat-Shamir route (`ipa_prove_fs`, `ipa_prove_fs_batch`)
keeps the whole round on the card: the Q term c * Q as a masked tree over
a 2^i Q table (`_q_doubles`, `_mul_point_dev`; Jacobian points and the
`jac_double_k_add` / `jac_double` kernels on a short-Weierstrass curve,
`te_double_k_add` / `te_double` on a twisted-Edwards one), S = MSM + c *
Q, then one `fs_round` launch (ops/fs.py: affine L and R, the Merlin
appends, the challenge u and its inverse), and the fold. The transcript
position stays on the host; the rounds make no device-to-host round trip
of their own, and one fetch at the end brings L, R, the challenges, a, b
and the final state back for a host replay of the transcript, which
advances the live transcript and checks the card's bytes. Between
segments of rounds the table shrinks on the card (`_shrink_fs_dev`).

`IpaBatchProver` is the per-round route for P proofs in lockstep: one
2P-set MSM a round and one host Fiat-Shamir step per proof. Not ported:
the JAX package's fused `_round_step` programs (they only save TPU
dispatches).

Under an engine mesh of D > 1 devices dividing N (the JAX package's
sharded rounds) `IpaDeviceProver` keeps a, b, gm and hm as Pieces of the
mesh's blocks, and the table as the blocks' [G_d | H_d], each on its
device: `_round_scalars_sharded` and `_fold_sharded` run each block on
its device with the static round width cur, reading the live prefix
[0, cur) of a and b, copied to each block's device (O(cur) bytes, the
data GSPMD moved), and the rounds are full width: [gw_d | hw_d] over
[G_d | H_d], an MSM of 2N terms that the router's mesh branch runs block
by block where it lies (a base_map would read across blocks). c_L and
c_R are per-block partials added in block order, and c * Q stays on the
host; the table never shrinks. `IpaBatchProver` keeps its vectors on
one device under a mesh but runs full-width rows (`_round_scalars_full`)
over the [G | H] table cut into the mesh's blocks.
"""

from __future__ import annotations

import torch

from .. import engine, native
from ..parallel import mesh as pmesh
from ..transcript import protocol
from . import cache as dcache
from . import field as df
from . import fs
from . import kernels as kk
from . import proj
from .curve import (affine_to_device, is_te, n_coords, point_batch_to_host,
                    point_zero, spec_for)
from .limbs import N_LIMBS, ints_to_limbs, limbs_to_ints
from ..parallel.msm import (msm_device_mapped, msm_device_maybe_sharded,
                            msm_v1, msm_v2, shard_width)

# The table shrinks once N / cur >= SHRINK_T segments share a live slot
# (0 never shrinks); the shrink's MSM runs SHRINK_SETS scalar sets at a
# time, which bounds its temporaries at large N. The JAX package's
# defaults.
SHRINK_T = 128
SHRINK_SETS = 1024
# The FS route's segment plan (the JAX package's ABTPU_IPA_FS_SEG and
# ABTPU_IPA_FS_SEG_MIN): FS_SEG rounds at full width, then the table
# shrinks on the card by 2^FS_SEG, while the width is above FS_SEG_MIN.
# The JAX package shrinks by 2^4, each shrink set then a 16-term MSM on
# its v2 MSM (its `_shrink_fs_chunk` runs msm2 at window_bits(16)); the
# port's v2 MSM pads a set to 256 terms, so it shrinks by 2^7 = SHRINK_T
# as the per-round route does (at n = 2^16 on the H100 the 2^4 plan took
# 1.13 s against the per-round route's 0.57 s, chip_smoke.py).
FS_SEG = 7
FS_SEG_MIN = 8192
# The FS routes' engine gates (the JAX package's `use_v2` and `v2_w`):
# a round's compact MSM runs on the v2 MSM from a table width of
# FS_V2_MIN (one proof) or FS_BATCH_V2_MIN (a lockstep batch), on the v1
# Pippenger below. The JAX package applies them on the TPU only; the port
# applies them on every device, so a CPU run takes the card's engines.
FS_V2_MIN = 128
FS_BATCH_V2_MIN = 16


def _masks(N: int, m: int, cur: int, device):
    idx = torch.arange(N, device=device)
    i = idx & (cur - 1)
    return idx, i, i >= m, idx < m


def _fold(fr, a, b, gm, hm, u, u_inv, m: int, cur: int):
    """Fold the witness halves and update the base weights after
    challenge u (cur: the round's width, m = cur / 2; u, u_inv: (16, 1)
    Montgomery, or (P, 16, 1) for (P, 16, N) vectors): a' = a u +
    a[i + m] u^-1, b' = b u^-1 + b[i + m] u, the weights by u or u^-1 by
    half. Two product launches, the second with the first's a u and
    b u^-1 added in its registers."""
    N = a.shape[-1]
    idx, _, right, active = _masks(N, m, cur, a.device)
    up = (idx + m).clamp(max=N - 1)
    return _fold_math(fr, a, b, gm, hm, u, u_inv, a[..., up], b[..., up],
                      right, active)


def _fold_math(fr, a, b, gm, hm, u, u_inv, a_up, b_up, right, active):
    """The fold's products on one block, given a[i + m], b[i + m] and the
    masks."""
    shape = (*u.shape[:-1], a.shape[-1])
    p4 = df.mont_mul(fr, torch.stack([a, b, gm, hm]), torch.stack([
        u.expand(shape), u_inv.expand(shape), df.select(right, u, u_inv),
        df.select(right, u_inv, u)]))
    ab = df.mont_mul(fr, torch.stack([a_up, b_up]),
                     torch.stack([u_inv, u]), p4[:2])
    zero = torch.zeros_like(ab[0])
    a_new = df.select(active, ab[0], zero)
    b_new = df.select(active, ab[1], zero)
    return a_new, b_new, p4[2], p4[3]


def _round_scalars_compact(fr, a, b, gm, hm, qw, m: int, cur: int):
    """One round's compact MSM inputs: (rows (2, 16, N) canonical,
    base_map (2, N) into [G | H], cq (2, 16, 1) canonical Q scalars c_L
    qw, c_R qw). With (P, 16, N) vectors and qw (P, 16, 1), rows are (2,
    P, 16, N) and cq (2, P, 16, 1)."""
    N = a.shape[-1]
    idx, i, right, active = _masks(N, m, cur, a.device)
    up = (i + m).clamp(max=N - 1)
    dn = (i - m).clamp(min=0)
    a_up, b_up, a_dn, b_dn = a[..., up], b[..., up], a[..., dn], b[..., dn]
    prods = df.mont_mul(fr, torch.stack([a_dn, b_up, a_up, b_dn, a, a_up]),
                        torch.stack([gm, hm, gm, hm, b_up, b]))
    # row_L: a_dn * gm on right-half slots (base G_i), b_up * hm on
    # left-half slots (base H_i): exactly one per index. row_R is the
    # complement.
    row_L = df.select(right, prods[0], prods[1])
    row_R = df.select(right, prods[3], prods[2])
    bm = torch.stack([torch.where(right, idx, idx + N),
                      torch.where(right, idx + N, idx)])
    c = df.sum_mod(fr, df.select(active, prods[4:6], 0))  # (2, 16, 1)
    cq = df.from_mont(fr, df.mont_mul(fr, c, qw))
    rows = df.from_mont(fr, torch.stack([row_L, row_R]))
    return rows, bm, cq


def _round_scalars_compact_batch(fr, A, Bv, GM, HM, QW, m: int, cur: int):
    """The compact round of P lockstep proofs ((P, 16, N) vectors, QW (P,
    16, 1)): (scal (2P, 16, N), base_map (2P, N), cq (2P, 16, 1)), set 2b
    the L of proof b and set 2b + 1 its R."""
    rows, bm, cq = _round_scalars_compact(fr, A, Bv, GM, HM, QW, m, cur)
    P, N = A.shape[0], A.shape[-1]
    return (rows.transpose(0, 1).reshape(2 * P, N_LIMBS, N),
            bm.repeat(P, 1), cq.transpose(0, 1).reshape(2 * P, N_LIMBS, 1))


def _full_rows(fr, a, b, gm, hm, pa, pb, idx, m: int, cur: int):
    """Full-width round rows over the lanes idx (global indices) of one
    block: (rows (2, ..., 16, 2 w) canonical, [gw_L | hw_L] and [gw_R |
    hw_R] for the block's [G | H] bases, c (2, ..., 16, 1) the block's
    Montgomery c_L, c_R), reading a[i +- m] and b[i +- m], i = idx mod
    cur, from pa, pb: a prefix of a and b at least cur wide."""
    i = idx & (cur - 1)
    right, active = i >= m, idx < m
    up = (i + m).clamp(max=pa.shape[-1] - 1)
    dn = (i - m).clamp(min=0)
    a_up, b_up, a_dn, b_dn = pa[..., up], pb[..., up], pa[..., dn], pb[..., dn]
    prods = df.mont_mul(fr, torch.stack([a_dn, b_up, a_up, b_dn, a, a_up]),
                        torch.stack([gm, hm, gm, hm, b_up, b]))
    zero = torch.zeros_like(prods[0])
    row_L = torch.cat([df.select(right, prods[0], zero),
                       df.select(right, zero, prods[1])], dim=-1)
    row_R = torch.cat([df.select(right, zero, prods[2]),
                       df.select(right, prods[3], zero)], dim=-1)
    c = df.sum_mod(fr, df.select(active, prods[4:6], 0))
    return df.from_mont(fr, torch.stack([row_L, row_R])), c


def _round_scalars_full(fr, a, b, gm, hm, qw, m: int, cur: int):
    """One round's full-width rows on one device: (scal (2, 16, 2N)
    canonical over [G | H], cq (2, 16, 1) canonical c_L qw, c_R qw); with
    (P, 16, N) vectors and qw (P, 16, 1), (2P, 16, 2N) and (2P, 16, 1),
    set 2b the L of proof b and 2b + 1 its R."""
    idx = torch.arange(a.shape[-1], device=a.device)
    rows, c = _full_rows(fr, a, b, gm, hm, a, b, idx, m, cur)
    cq = df.from_mont(fr, df.mont_mul(fr, c, qw))
    if a.dim() == 3:
        rows = rows.transpose(0, 1).reshape(-1, N_LIMBS, rows.shape[-1])
        cq = cq.transpose(0, 1).reshape(-1, N_LIMBS, 1)
    return rows.to(torch.int32), cq


def _round_scalars_sharded(fr, mesh, a, b, gm, hm, qw, cur: int):
    """One round over the mesh's blocks (a, b, gm, hm: Pieces of D blocks
    of (16, N / D) Montgomery limbs; qw (16, 1) on mesh.devices[0]):
    (rows, a Pieces of the blocks' (2, 16, 2 N / D) canonical [gw_d |
    hw_d] rows; cq (2, 16, 1) canonical c_L qw, c_R qw on
    mesh.devices[0]). Each block reads the live prefix [0, cur) of a and
    b, copied to its device; c_L and c_R are the blocks' partials added in
    block order."""
    root = mesh.devices[0]
    bsz = pmesh.width(a) // mesh.size
    rows, c = [], None
    for d, dev in enumerate(mesh.devices):
        idx = torch.arange(d * bsz, (d + 1) * bsz, device=dev)
        r, part = _full_rows(fr, a.parts[d], b.parts[d], gm.parts[d],
                             hm.parts[d], pmesh.take(a, dev, 0, cur),
                             pmesh.take(b, dev, 0, cur), idx, cur // 2, cur)
        rows.append(r.to(torch.int32))
        part = part.to(root)
        c = part if c is None else df.add(fr, c, part)
    return pmesh.Pieces(rows), df.from_mont(fr, df.mont_mul(fr, c, qw))


def _fold_sharded(fr, mesh, a, b, gm, hm, u, u_inv, cur: int):
    """`_fold` over the mesh's blocks (Pieces in and out; u, u_inv (16, 1)
    Montgomery): each block reads a[i + m], b[i + m] from the live prefix
    [0, cur), copied to its device."""
    bsz = pmesh.width(a) // mesh.size
    m = cur // 2
    out = []
    for d, dev in enumerate(mesh.devices):
        idx = torch.arange(d * bsz, (d + 1) * bsz, device=dev)
        up = (idx + m).clamp(max=cur - 1)
        out.append(_fold_math(
            fr, a.parts[d], b.parts[d], gm.parts[d], hm.parts[d],
            u.to(dev), u_inv.to(dev), pmesh.take(a, dev, 0, cur)[..., up],
            pmesh.take(b, dev, 0, cur)[..., up], (idx & (cur - 1)) >= m,
            idx < m))
    return tuple(pmesh.Pieces(v) for v in zip(*out))


def _cq_ints(curve, rows: torch.Tensor) -> list[int]:
    """(K, 16, 1) canonical Fr limbs -> K ints."""
    p = curve.fr.p
    return [x % p for x in limbs_to_ints(rows.reshape(-1, N_LIMBS).T)]


def _host_q_jacs(curve, Q, values: list[int]) -> list:
    """[v * Q] as host internal (Jacobian, or TE extended) int tuples,
    through the native fixed-base window tables when available; else the
    exact host double-and-add (twisted-Edwards curves: two scalar
    multiplications a round)."""
    if (
        len(values) >= 2
        and getattr(curve, "b", None) is not None
        and native.set_curve_native(curve)
    ):
        jacs = native.commit_many_native(
            Q, Q, values, [0] * len(values), curve.fr.p
        )
        if jacs is not None:
            return jacs
    return [curve.to_proj(curve.mul(Q, v)) for v in values]


def _mont(curve, xs, device) -> torch.Tensor:
    """Scalars as (16, n) Montgomery limbs on `device` (device tensors from
    the vector phase pass through; its Pieces are gathered there)."""
    if isinstance(xs, pmesh.Pieces):
        return pmesh.gather(xs, device)
    if isinstance(xs, torch.Tensor):
        return xs
    p, R = curve.fr.p, curve.fr.R
    return ints_to_limbs([x % p * R % p for x in xs], device)


def _mont_rows(curve, rows, device) -> torch.Tensor:
    """P lists of n scalars -> (P, 16, n) Montgomery limbs."""
    P, n = len(rows), len(rows[0])
    flat = _mont(curve, [x for row in rows for x in row], device)
    return flat.reshape(N_LIMBS, P, n).permute(1, 0, 2).contiguous()


def _shrink_msm(spec, fr, X, Y, inf, gm, hm, cur: int,
                msm=msm_device_mapped) -> torch.Tensor:
    """The folded table at width cur: G'_j = sum_t gm[j + t cur] G[j + t
    cur] (and H'), as base_map MSMs of 2 cur sets of T = N / cur terms,
    SHRINK_SETS sets at a time, through `msm` (the router, or `msm_v2`).
    (NC, 16, 2 cur) points in the device coordinates."""
    N = gm.shape[-1]
    T = N // cur
    # set j's scalars are gm[j], gm[j + cur], ..., gm[j + (T-1) cur]
    gm_r = gm.reshape(N_LIMBS, T, cur).permute(2, 0, 1)
    hm_r = hm.reshape(N_LIMBS, T, cur).permute(2, 0, 1)
    scal = df.from_mont(fr, torch.cat([gm_r, hm_r]))  # (2 cur, 16, T)
    dev = gm.device
    bm = (torch.arange(cur, device=dev)[:, None]
          + torch.arange(T, device=dev)[None, :] * cur)
    bm = torch.cat([bm, bm + N])  # (2 cur, T)
    return torch.cat([
        msm(spec, X, Y, inf, scal[s:s + SHRINK_SETS].to(torch.int32)
            .contiguous(), bm[s:s + SHRINK_SETS])
        for s in range(0, 2 * cur, SHRINK_SETS)
    ], dim=-1)


class IpaDeviceProver:
    """Holds the device-resident state for one IPA proof creation: on
    `device`, or under an engine mesh whose D > 1 devices divide N on the
    mesh's blocks (the module note)."""

    def __init__(self, curve, Q, G_vec, H_vec, G_factors, H_factors,
                 a_vec, b_vec, device):
        self.curve = curve
        self.spec = spec_for(curve)
        self.fr = df.spec_for(curve.fr)
        self.N = N = len(G_vec)
        self.Q = Q  # host affine; the c * Q terms are added on the host
        mesh = engine.active_mesh()
        self.mesh = (mesh if mesh is not None and mesh.size > 1
                     and N % mesh.size == 0 else None)
        if self.mesh is None:
            self.device = device
            self.X, self.Y, self.inf = dcache.ipa_table(curve, G_vec, H_vec,
                                                        device)
            self.a, self.b, self.gm, self.hm = (
                _mont(curve, v, device)
                for v in (a_vec, b_vec, G_factors, H_factors))
        else:
            self.device = self.mesh.devices[0]
            b = N // self.mesh.size
            tabs = [dcache.ipa_table(curve, G_vec[d * b:(d + 1) * b],
                                     H_vec[d * b:(d + 1) * b], dev)
                    for d, dev in enumerate(self.mesh.devices)]
            self.X, self.Y, self.inf = (pmesh.Pieces(t) for t in zip(*tabs))
            self.a, self.b, self.gm, self.hm = (
                pmesh.shard_rows(self.mesh, v if isinstance(
                    v, (torch.Tensor, pmesh.Pieces)) else _mont(curve, v,
                                                                "cpu"))
                for v in (a_vec, b_vec, G_factors, H_factors))
        self._one_q = df.mont_one(self.fr, 1, self.device)

    def _u_limbs(self, u: int, u_inv: int):
        p, R = self.curve.fr.p, self.curve.fr.R
        lim = ints_to_limbs([u * R % p, u_inv * R % p], self.device)
        return lim[:, :1], lim[:, 1:]

    def _host_lr(self, pts: torch.Tensor, cq: torch.Tensor):
        """(NC, 16, 2) L, R partials and their (2, 16, 1) Q scalars ->
        host affine (L, R) with the c * Q terms added."""
        c = self.curve
        lr = point_batch_to_host(c, pts)
        qj = _host_q_jacs(c, self.Q, _cq_ints(c, cq))
        return tuple(c.batch_to_affine(
            [c.proj_add(c.to_proj(lr[j]), qj[j]) for j in range(2)]))

    def _shrinkable(self, cur: int) -> bool:
        return (self.mesh is None and SHRINK_T > 0 and cur >= 16
                and self.N // cur >= SHRINK_T)

    def _shrink(self, cur: int) -> None:
        """Materialise the folded table at width `cur` (`_shrink_msm`),
        one host affine round trip, weights reset to one. N and the table
        shrink to cur as in the JAX package, so later rounds run cur-term
        MSMs."""
        pts = _shrink_msm(self.spec, self.fr, self.X, self.Y, self.inf,
                          self.gm, self.hm, cur)
        aff = point_batch_to_host(self.curve, pts)
        dev = self.device
        self.X, self.Y, self.inf = affine_to_device(self.curve, aff, dev)
        self.a = self.a[:, :cur]
        self.b = self.b[:, :cur]
        self.gm = df.mont_one(self.fr, cur, dev)
        self.hm = df.mont_one(self.fr, cur, dev)
        self.N = cur

    def round_commit(self, cur: int):
        """(L, R) host affine points for the round of width `cur`."""
        if self.mesh is not None:
            rows, cq = _round_scalars_sharded(
                self.fr, self.mesh, self.a, self.b, self.gm, self.hm,
                self._one_q, cur)
            return self._host_lr(msm_device_maybe_sharded(
                self.spec, self.X, self.Y, self.inf, rows), cq)
        if self._shrinkable(cur):
            self._shrink(cur)
        rows, bm, cq = _round_scalars_compact(
            self.fr, self.a, self.b, self.gm, self.hm, self._one_q,
            cur // 2, cur)
        pts = msm_device_mapped(self.spec, self.X, self.Y, self.inf,
                                rows.to(torch.int32).contiguous(), bm)
        return self._host_lr(pts, cq)

    def fold(self, cur: int, u: int, u_inv: int) -> None:
        u_l, ui_l = self._u_limbs(u, u_inv)
        state = (self.a, self.b, self.gm, self.hm, u_l, ui_l)
        if self.mesh is None:
            out = _fold(self.fr, *state, cur // 2, cur)
        else:
            out = _fold_sharded(self.fr, self.mesh, *state, cur)
        self.a, self.b, self.gm, self.hm = out

    def final_ab(self) -> tuple[int, int]:
        Rinv = self.curve.fr.R_inv
        p = self.curve.fr.p
        a0, b0 = limbs_to_ints(torch.cat([pmesh.take(self.a, self.device, 0,
                                                     1),
                                          pmesh.take(self.b, self.device, 0,
                                                     1)], dim=1))
        return a0 * Rinv % p, b0 * Rinv % p


class IpaBatchProver:
    """Device state of P proofs created in lockstep over one shared base
    table [G | H], with Q_b = w_b B (the R1CS shape, reference
    src/r1cs/prover.rs:777-779): each round is one 2P-set compact MSM and
    one fetch, the Q terms c w_b B are added on the host through the
    native fixed-base path, and the host runs each proof's Fiat-Shamir
    step (the JAX package's IpaBatchProver, compact path). Under an engine
    mesh that cuts the 2N-point table into blocks (`shard_width`) the
    rounds are full width over those blocks (the JAX package's `_compact
    = False`); where the table is too narrow to cut they stay compact."""

    def __init__(self, curve, base_B, ws, G_vec, H_vec, G_factors_list,
                 H_factors_list, a_list, b_list, device):
        self.curve = curve
        self.spec = spec_for(curve)
        self.fr = df.spec_for(curve.fr)
        self.device = device
        self.P = len(a_list)
        self.base_B = base_B
        self.X, self.Y, self.inf = dcache.ipa_table(curve, G_vec, H_vec,
                                                    device)
        self.A = _mont_rows(curve, a_list, device)
        self.B = _mont_rows(curve, b_list, device)
        self.GM = _mont_rows(curve, G_factors_list, device)
        self.HM = _mont_rows(curve, H_factors_list, device)
        self.QW = _mont(curve, ws, device).T.unsqueeze(-1).contiguous()
        mesh = engine.active_mesh()
        self._compact = not shard_width(mesh, self.X.shape[-1])
        if not self._compact:
            self.X, self.Y, self.inf = (pmesh.shard_rows(mesh, t)
                                        for t in (self.X, self.Y, self.inf))

    def round_commit(self, cur: int) -> list:
        """[(L_b, R_b)] host affine points for the round of width cur."""
        c = self.curve
        if self._compact:
            scal, bm, cq = _round_scalars_compact_batch(
                self.fr, self.A, self.B, self.GM, self.HM, self.QW,
                cur // 2, cur)
            pts = msm_device_mapped(self.spec, self.X, self.Y, self.inf,
                                    scal.to(torch.int32).contiguous(), bm)
        else:
            scal, cq = _round_scalars_full(self.fr, self.A, self.B, self.GM,
                                           self.HM, self.QW, cur // 2, cur)
            pts = msm_device_maybe_sharded(self.spec, self.X, self.Y,
                                           self.inf, scal)
        lr = point_batch_to_host(c, pts)
        qj = _host_q_jacs(c, self.base_B, _cq_ints(c, cq))
        aff = c.batch_to_affine([c.proj_add(c.to_proj(lr[k]), qj[k])
                                 for k in range(2 * self.P)])
        return [(aff[2 * b], aff[2 * b + 1]) for b in range(self.P)]

    def fold(self, cur: int, us: list[int], u_invs: list[int]) -> None:
        U = _mont(self.curve, us, self.device).T.unsqueeze(-1)
        Ui = _mont(self.curve, u_invs, self.device).T.unsqueeze(-1)
        self.A, self.B, self.GM, self.HM = _fold(
            self.fr, self.A, self.B, self.GM, self.HM, U, Ui, cur // 2, cur)

    def final_ab(self) -> list[tuple[int, int]]:
        Rinv, p = self.curve.fr.R_inv, self.curve.fr.p
        ab = limbs_to_ints(torch.cat([self.A[:, :, 0].T, self.B[:, :, 0].T],
                                     dim=1))
        return [(ab[b] * Rinv % p, ab[self.P + b] * Rinv % p)
                for b in range(self.P)]


# --- on-device Fiat-Shamir ------------------------------------------------


def _q_doubles(curve, Q, device) -> torch.Tensor:
    """(NC, 16, 256) int32 model coordinates of 2^i Q, i < 256, the JAX
    package's 256-step scan: one `jac_double` launch of 255 steps, or one
    `te_double` launch on a twisted-Edwards curve."""
    spec = spec_for(curve)
    f = curve.fq
    x, y = Q
    te = is_te(spec)
    coords = [x, y, x * y % f.p, 1] if te else [x, y, 1]
    P = ints_to_limbs([v * f.R % f.p for v in coords], device)
    P = P.T.reshape(len(coords), N_LIMBS, 1).contiguous()
    dbl = kk.te_double if te else kk.jac_double
    return dbl(spec, P, 255).reshape(len(coords), N_LIMBS, 256)


def _mul_point_dev(spec, p2: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k_b * Q for (B, 16, 1) canonical scalars from the 2^i Q table p2:
    a per-bit select into (NC, 16, 256, B), then 8 halving steps, each one
    model-add launch adding slot j + h to slot j < h (the JAX package's
    masked tree, whose other lanes are never read). (NC, 16, B)."""
    B = k.shape[0]
    nc = n_coords(spec)
    j = torch.arange(256, device=k.device)
    bits = ((k[:, :, 0].long().T[j // 16] >> (j % 16)[:, None]) & 1).bool()
    ident = point_zero(spec, 1, k.device).to(torch.int32)
    acc = torch.where(bits, p2[..., None], ident[..., None])  # (NC,16,256,B)
    h = 256
    while h > 1:
        h //= 2
        lo = acc[:, :, :h].reshape(nc, N_LIMBS, h * B).contiguous()
        hi = acc[:, :, h:].reshape(nc, N_LIMBS, h * B).contiguous()
        acc = kk.model_double_k_add(spec, lo, hi, 0).reshape(
            nc, N_LIMBS, h, B)
    return acc[:, :, 0]


def _shrink_fs_dev(spec, fr, X, Y, inf, gm, hm, cur: int):
    """The segmented shrink on the card: `_shrink_msm` on the v2 MSM (as
    the JAX package's `_shrink_fs_chunk`), then the affine table (X / Z,
    Y / Z in Montgomery form; an RCB identity, Z = 0, as X = Y = 0 marked
    in inf) by one batch inversion (on the card one launch for the
    inverses and the products), with no host round trip."""
    fq = spec.fq
    pts = _shrink_msm(spec, fr, X, Y, inf, gm, hm, cur, msm_v2)
    z = pts[-1]
    xa, ya = fs.mont_inv_batch(fq, z, pts[:2])  # 0 where Z = 0
    return xa.to(torch.int32), ya.to(torch.int32), df.is_zero(z)


def _round_msm(spec, X, Y, inf, scal, bm, v2: bool) -> torch.Tensor:
    """A round's compact MSM in Jacobian (or TE extended) coordinates, on
    the v2 MSM or on the v1 Pippenger, as the FS route's gate says."""
    scal = scal.to(torch.int32).contiguous()
    if v2:
        return proj.to_jacobian(spec, msm_v2(spec, X, Y, inf, scal, bm))
    return msm_v1(spec, X, Y, inf, scal, bm)


def _fs_rounds(spec, fr, rounds: int, X, Y, inf, a, b, gm, hm, qw, p2, st,
               pos: int, pb: int, outs: list, v2: bool):
    """`rounds` IPA rounds with the Fiat-Shamir step on the card, from the
    width of a (P = 1: (16, N) vectors, qw (16, 1); P lockstep proofs: (P,
    16, N) and (P, 16, 1)), the compact MSMs on the v2 MSM or not (`v2`).
    Appends each round's (xy, u, flags) of `fs.fs_round` to outs; returns
    (a, b, gm, hm, st, pos, pb)."""
    N = a.shape[-1]
    batch = a.dim() == 3
    for r in range(rounds):
        cur = N >> r
        m = cur // 2
        if batch:
            scal, bm, cq = _round_scalars_compact_batch(fr, a, b, gm, hm, qw,
                                                        m, cur)
        else:
            scal, bm, cq = _round_scalars_compact(fr, a, b, gm, hm, qw, m,
                                                  cur)
        pts = _round_msm(spec, X, Y, inf, scal, bm, v2)
        S = kk.model_double_k_add(spec, pts.to(torch.int32).contiguous(),
                                  _mul_point_dev(spec, p2, cq), 0)
        xy, u, st, flags, pos, pb = fs.fs_round(spec, fr, S, st, pos, pb)
        if batch:
            U, Ui = (u[i].T.unsqueeze(-1) for i in range(2))
        else:
            U, Ui = u[0], u[1]
        a, b, gm, hm = _fold(fr, a, b, gm, hm, U, Ui, m, cur)
        outs.append((xy, u[0], flags))
    return a, b, gm, hm, st, pos, pb


def _state_of(strobes, device) -> torch.Tensor:
    return torch.tensor([list(s.state) for s in strobes], dtype=torch.int32,
                        device=device)


def _fetch(outs, a0, b0, st):
    """One device-to-host copy of every round's output and the finals:
    (xy (rounds, 2, 16, 2P), u (rounds, 16, P), flags (rounds, 3, P), a0,
    b0 (16, P), st (P, 200)) on the host."""
    parts = [torch.stack([o[i].to(torch.int32) for o in outs])
             for i in range(3)] + [a0, b0, st]
    flat = torch.cat([t.reshape(-1).to(torch.int32) for t in parts]).cpu()
    out, off = [], 0
    for t in parts:
        out.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


def _replay(curve, transcripts, xy, us, flags, pos: int, pb: int, st_dev):
    """Host replay of the card's rounds on the live transcripts: appends L
    and R and squeezes each challenge, as the per-round route does. Returns
    the L and R vectors per proof; raises when a challenge or a final
    state differs from the card's (the card draws `Fp::rand` to the end,
    so a difference is a fault, not a rejection)."""
    te = is_te(spec_for(curve))
    p, Rinv = curve.fr.p, curve.fr.R_inv
    rounds = us.shape[0]
    out = []
    for bi, t in enumerate(transcripts):
        vecs = ([], [])
        for r in range(rounds):
            for side in range(2):
                x, y = limbs_to_ints(xy[r, :, :, 2 * bi + side].T)
                pt = None if flags[r, side, bi] and not te else (x, y)
                vecs[side].append(pt)
            protocol.append_point(t, curve, b"L", vecs[0][r])
            protocol.append_point(t, curve, b"R", vecs[1][r])
            u_host = protocol.challenge_scalar(t, curve, b"u")
            if u_host != limbs_to_ints(us[r, :, bi])[0] * Rinv % p:
                raise RuntimeError("device Fiat-Shamir challenge differs "
                                   "from the host replay")
        s = t._strobe
        if (bytes(s.state) != bytes(st_dev[bi].tolist()) or s.pos != pos
                or s.pos_begin != pb):
            raise RuntimeError("device Fiat-Shamir state diverged from the "
                               "host replay")
        out.append(vecs)
    return out


def _finish(curve, transcripts, outs, a0, b0, st, pos: int, pb: int):
    """Fetch, check and replay: [(L_vec, R_vec, a, b)] per transcript, or
    None (transcripts unchanged) if a draw of `Fp::rand` found no
    candidate in RAND_BLOCKS ChaCha20 blocks (about 2^-128 a draw)."""
    xy, us, flags, a0, b0, st = _fetch(outs, a0, b0, st)
    if not bool(flags[:, 2].all()):
        return None
    vecs = _replay(curve, transcripts, xy, us, flags, pos, pb, st)
    p, Rinv = curve.fr.p, curve.fr.R_inv
    A0, B0 = limbs_to_ints(a0), limbs_to_ints(b0)
    return [(L, R, A0[i] * Rinv % p, B0[i] * Rinv % p)
            for i, (L, R) in enumerate(vecs)]


def ipa_prove_fs(transcript, curve, Q, G_factors, H_factors, G_vec, H_vec,
                 a_vec, b_vec, device):
    """One IPA proof with the Fiat-Shamir step on the card (the JAX
    package's `ipa_prove_fs`). Segment plan: FS_SEG rounds at full width,
    then `_shrink_fs_dev` to width / 2^FS_SEG, while the width is above
    FS_SEG_MIN; the rest in one segment. Returns (L_vec, R_vec, a, b), the
    live transcript advanced exactly as the per-round route advances it,
    or None with the transcript unchanged (see `_finish`); raises if the
    card's challenges or transcript state differ from the host replay."""
    spec, fr = spec_for(curve), df.spec_for(curve.fr)
    N = len(G_vec)
    lg_n = N.bit_length() - 1
    X, Y, inf = dcache.ipa_table(curve, G_vec, H_vec, device)
    a, b = _mont(curve, a_vec, device), _mont(curve, b_vec, device)
    gm, hm = _mont(curve, G_factors, device), _mont(curve, H_factors, device)
    one_q = df.mont_one(fr, 1, device)
    p2 = _q_doubles(curve, Q, device)
    s = transcript._strobe
    st, pos, pb = _state_of([s], device), s.pos, s.pos_begin
    outs = []
    width, done = N, 0
    while done < lg_n:
        shrink = (FS_SEG > 0 and width > FS_SEG_MIN
                  and lg_n - done > FS_SEG and (width >> FS_SEG) >= 16)
        rounds = FS_SEG if shrink else lg_n - done
        a, b, gm, hm, st, pos, pb = _fs_rounds(
            spec, fr, rounds, X, Y, inf, a, b, gm, hm, one_q, p2, st, pos,
            pb, outs, width >= FS_V2_MIN)
        done += rounds
        if shrink:
            width >>= FS_SEG
            X, Y, inf = _shrink_fs_dev(spec, fr, X, Y, inf, gm, hm, width)
            a, b = a[:, :width], b[:, :width]
            gm = hm = df.mont_one(fr, width, device)
    res = _finish(curve, [transcript], outs, a[:, :1], b[:, :1], st, pos, pb)
    return None if res is None else res[0]


def ipa_prove_fs_batch(transcripts, curve, base_B, ws, G_factors_list,
                       H_factors_list, G_vec, H_vec, a_list, b_list, device):
    """P proofs in lockstep with the Fiat-Shamir step on the card (the
    JAX package's `ipa_prove_fs_batch`), Q_b = ws[b] base_B: P STROBE
    states share one host position, every round is one 2P-set MSM, one
    Q-term tree over the cached 2^i base_B table and one `fs_round` launch
    over P threads. Returns [(L_vec, R_vec, a, b)], or None when the
    transcripts are not in lockstep or as `ipa_prove_fs`."""
    strobes = [t._strobe for t in transcripts]
    if len({(s.pos, s.pos_begin) for s in strobes}) != 1:
        return None
    spec, fr = spec_for(curve), df.spec_for(curve.fr)
    X, Y, inf = dcache.ipa_table(curve, G_vec, H_vec, device)
    A, Bv = (_mont_rows(curve, v, device) for v in (a_list, b_list))
    GM, HM = (_mont_rows(curve, v, device)
              for v in (G_factors_list, H_factors_list))
    QW = _mont(curve, ws, device).T.unsqueeze(-1).contiguous()
    p2 = dcache.keyed(("ipa q", curve.name, base_B, str(device)),
                      lambda: _q_doubles(curve, base_B, device))
    st = _state_of(strobes, device)
    outs = []
    A, Bv, GM, HM, st, pos, pb = _fs_rounds(
        spec, fr, len(G_vec).bit_length() - 1, X, Y, inf, A, Bv, GM, HM, QW,
        p2, st, strobes[0].pos, strobes[0].pos_begin, outs,
        len(G_vec) >= FS_BATCH_V2_MIN)
    return _finish(curve, transcripts, outs, A[:, :, 0].T, Bv[:, :, 0].T, st,
                   pos, pb)
