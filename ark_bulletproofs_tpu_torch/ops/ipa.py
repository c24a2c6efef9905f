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

Vectors are (16, N) limbs (Montgomery unless said otherwise); on the card
every field product is one launch of the Montgomery-product kernel
(field.mont_mul). Not ported: the JAX package's fused `_round_step` (it
only saves TPU dispatches), the sharded functions, the on-device
Fiat-Shamir provers and the batch prover.
"""

from __future__ import annotations

import torch

from .. import native
from . import field as df
from .curve import affine_to_device, point_batch_to_host, spec_for
from .limbs import N_LIMBS, ints_to_limbs, limbs_to_ints
from ..parallel.msm import msm_device_mapped

# The table shrinks once N / cur >= SHRINK_T segments share a live slot
# (0 never shrinks); the shrink's MSM runs SHRINK_SETS scalar sets at a
# time, which bounds its temporaries at large N. The JAX package's
# defaults.
SHRINK_T = 128
SHRINK_SETS = 1024


def _masks(N: int, m: int, cur: int, device):
    idx = torch.arange(N, device=device)
    i = idx & (cur - 1)
    return idx, i, i >= m, idx < m


def _fold(fr, a, b, gm, hm, u, u_inv, m: int, cur: int):
    """Fold the witness halves and update the base weights after
    challenge u (cur: the round's width, m = cur / 2; u, u_inv: (16, 1)
    Montgomery). Two product launches."""
    N = a.shape[-1]
    idx, _, right, active = _masks(N, m, cur, a.device)
    up = (idx + m).clamp(max=N - 1)
    p4 = df.mont_mul(fr, torch.stack([a, a[:, up], b, b[:, up]]),
                     torch.stack([u, u_inv, u_inv, u]))
    p2 = df.mont_mul(fr, torch.stack([gm, hm]), torch.stack([
        df.select(right, u, u_inv), df.select(right, u_inv, u)]))
    zero = torch.zeros_like(a, dtype=torch.int64)
    a_new = df.select(active, df.add(fr, p4[0], p4[1]), zero)
    b_new = df.select(active, df.add(fr, p4[2], p4[3]), zero)
    return a_new, b_new, p2[0], p2[1]


def _round_scalars_compact(fr, a, b, gm, hm, qw, m: int, cur: int):
    """One round's compact MSM inputs: (rows (2, 16, N) canonical,
    base_map (2, N) into [G | H], cq (2, 16, 1) canonical Q scalars)."""
    N = a.shape[-1]
    idx, i, right, active = _masks(N, m, cur, a.device)
    up = (i + m).clamp(max=N - 1)
    dn = (i - m).clamp(min=0)
    a_up, b_up, a_dn, b_dn = a[:, up], b[:, up], a[:, dn], b[:, dn]
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


class IpaDeviceProver:
    """Holds the device-resident state for one IPA proof creation."""

    def __init__(self, curve, Q, G_vec, H_vec, G_factors, H_factors,
                 a_vec, b_vec, device):
        self.curve = curve
        self.spec = spec_for(curve)
        self.fr = df.spec_for(curve.fr)
        self.device = device
        self.N = len(G_vec)
        self.Q = Q  # host affine; the c * Q terms are added on the host
        self.X, self.Y, self.inf = affine_to_device(
            curve, list(G_vec) + list(H_vec), device)
        p, R = curve.fr.p, curve.fr.R

        def mont(xs):
            if isinstance(xs, torch.Tensor):
                return xs  # already a device Montgomery limb tensor
            return ints_to_limbs([x % p * R % p for x in xs], device)

        self.a = mont(a_vec)
        self.b = mont(b_vec)
        self.gm = mont(G_factors)
        self.hm = mont(H_factors)
        self._one_q = df.mont_one(self.fr, 1, device)

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
        return SHRINK_T > 0 and cur >= 16 and self.N // cur >= SHRINK_T

    def _shrink(self, cur: int) -> None:
        """Materialise the folded table at width `cur`: one batched
        base_map MSM over the T = N / cur segments per live slot, one host
        affine round trip, weights reset to one. N and the table shrink
        to cur as in the JAX package, so later rounds run cur-term MSMs."""
        N, T = self.N, self.N // cur
        # set j's scalars are gm[j], gm[j + cur], ..., gm[j + (T-1) cur]
        gm_r = self.gm.reshape(N_LIMBS, T, cur).permute(2, 0, 1)
        hm_r = self.hm.reshape(N_LIMBS, T, cur).permute(2, 0, 1)
        scal = df.from_mont(self.fr, torch.cat([gm_r, hm_r]))  # (2cur,16,T)
        dev = self.device
        bm = (torch.arange(cur, device=dev)[:, None]
              + torch.arange(T, device=dev)[None, :] * cur)
        bm = torch.cat([bm, bm + N])  # (2 cur, T)
        pts = torch.cat([
            msm_device_mapped(
                self.spec, self.X, self.Y, self.inf,
                scal[s:s + SHRINK_SETS].to(torch.int32).contiguous(),
                bm[s:s + SHRINK_SETS])
            for s in range(0, 2 * cur, SHRINK_SETS)
        ], dim=-1)
        aff = point_batch_to_host(self.curve, pts)
        self.X, self.Y, self.inf = affine_to_device(self.curve, aff, dev)
        self.a = self.a[:, :cur]
        self.b = self.b[:, :cur]
        self.gm = df.mont_one(self.fr, cur, dev)
        self.hm = df.mont_one(self.fr, cur, dev)
        self.N = cur

    def round_commit(self, cur: int):
        """(L, R) host affine points for the round of width `cur`."""
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
        self.a, self.b, self.gm, self.hm = _fold(
            self.fr, self.a, self.b, self.gm, self.hm, u_l, ui_l,
            cur // 2, cur)

    def final_ab(self) -> tuple[int, int]:
        Rinv = self.curve.fr.R_inv
        p = self.curve.fr.p
        a0, b0 = limbs_to_ints(torch.cat([self.a[:, :1], self.b[:, :1]],
                                         dim=1))
        return a0 * Rinv % p, b0 * Rinv % p
