"""Device pipeline for the R1CS prover's vector phase (counterpart of
ark_bulletproofs_tpu/ops/prove.py).

The reference prover builds the blinded vector polynomials l(x), r(x)
and their special inner product t(x) on the CPU (reference
src/r1cs/prover.rs:671-756, src/util.rs:75-109). Here the O(n) work runs
on the device in Montgomery form:

  l(x) = l1*x + l2*x^2 + l3*x^3        (l0 = 0)
  r(x) = r0 + r1*x + r3*x^3            (r2 = 0)
  l1 = aL + y^-i o wR   l2 = aO        l3 = sL
  r0 = wO - y^i         r1 = y^i o aR + wL      r3 = y^i o sR

Working on the PADDED length with zero-padded witness vectors makes the
reference's r-padding (-y^i for i >= n, prover.rs:753-756) fall out of
the formulas: beyond n every term but -y^i vanishes.

The six t-coefficients (util.rs:75-93, exploiting l0 = r2 = 0):
  t1 = <l1,r0>  t2 = <l1,r1>+<l2,r0>  t3 = <l2,r1>+<l3,r0>
  t4 = <l1,r3>+<l3,r1>  t5 = <l2,r3>  t6 = <l3,r3>

Every field product is one `field.mont_mul` call (the CUDA kernel on the
card), fused with the add that is its only use where there is one (l1,
r1 and r3 one launch; l(x) and r(x) by Horner side by side, three
launches); the other adds are `field.add` / `sub` (a kernel each, no
device-to-host sync), and the nine dot products are one (9, 16, n)
product launch and one `sum_mod`. The coefficient
vectors stay on the device between the two transcript syncs and the
evaluated l, r feed the device IPA (ops/ipa.py) directly.

Under an engine mesh of D devices dividing padded_n (the JAX package's
sharded vector phase) device d runs the pipeline on columns [lo, lo + b)
(the y-powers from the global lane index), the nine dot products are
per-block `sum_mod` partials added mod p in block order on
mesh.devices[0], and l(x), r(x) come back as Pieces of the blocks, where
the sharded IPA reads them in place.

`pedersen_commit_many_dev` is the device batch of Pedersen commitments
v B + r B_blinding for a twisted-Edwards curve, which the native host
library does not cover (generators.py::PedersenGens.commit_many routes
to it): the cached 2^i B | 2^i B_blinding table (ops/cache.py), a
per-bit select and a halving tree of adds (reference
src/generators.rs:39-44).
"""

from __future__ import annotations

import torch

from .. import engine
from ..parallel.mesh import Pieces
from . import field as df
from . import kernels as kk
from . import proj
from .cache import commit_table
from .curve import point_batch_to_host, spec_for
from .limbs import N_LIMBS, ints_to_limbs, limbs_to_ints
from .verify import _pow_vector


def _poly_phase(fr, padded_n: int, lg_n: int,
                aL, aR, aO, sL, sR, wL, wR, wO, y, y_inv):
    """Canonical (16, padded_n) vectors and (16, 1) y, y^-1 -> (t
    coefficients (6, 16, 1) canonical, (l1, l2, l3, r0, r1, r3) Montgomery
    (16, padded_n))."""
    sums, coeffs = _poly_block(fr, lg_n, 0, aL, aR, aO, sL, sR, wL, wR, wO,
                               y, y_inv)
    return _t_coeffs(fr, sums), coeffs


def _poly_block(fr, lg_n: int, lo: int,
                aL, aR, aO, sL, sR, wL, wR, wO, y, y_inv):
    """Columns [lo, lo + w) of the pipeline ((16, w) canonical vectors):
    (the nine dot products over them (9, 16, 1) Montgomery, (l1, l2, l3,
    r0, r1, r3) Montgomery (16, w))."""
    vecs = df.to_mont(fr, torch.stack([aL, aR, aO, sL, sR, wL, wR, wO]))
    aLm, aRm, aOm, sLm, sRm, wLm, wRm, wOm = vecs.unbind(0)
    y_m, y_inv_m = df.to_mont(fr, torch.stack([y, y_inv])).unbind(0)

    w = aL.shape[-1]
    y_vec = _pow_vector(fr, y_m, w, lg_n, lo)
    y_inv_vec = _pow_vector(fr, y_inv_m, w, lg_n, lo)

    # l1 = y^-i wR + aL, r1 = y^i aR + wL, r3 = y^i sR (+ 0): one launch
    l1, r1, r3 = df.mont_mul(fr, torch.stack([y_inv_vec, y_vec, y_vec]),
                             torch.stack([wRm, aRm, sRm]),
                             torch.stack([aLm, wLm, torch.zeros_like(wLm)]))
    l2, l3 = aOm, sLm
    r0 = df.sub(fr, wOm, y_vec)

    # nine inner products in one product launch, then per-dot sums
    lhs = torch.stack([l1, l1, l2, l2, l3, l3, l1, l2, l3])
    rhs = torch.stack([r0, r1, r1, r0, r0, r1, r3, r3, r3])
    return df.dot_mod(fr, lhs, rhs), (l1, l2, l3, r0, r1, r3)


def _t_coeffs(fr, sums):
    """The nine dot products (9, 16, 1) Montgomery -> t1..t6 (6, 16, 1)
    canonical."""
    t234 = df.add(fr, sums[[1, 2, 6]], sums[[3, 4, 5]])  # one launch
    t = torch.stack([sums[0], *t234.unbind(0), sums[7], sums[8]])
    return df.from_mont(fr, t)


def _eval_phase(fr, coeffs, x):
    """l(x), r(x) as Montgomery (16, padded_n) vectors; x (16, 1)
    canonical."""
    l1, l2, l3, r0, r1, r3 = coeffs
    x_m = df.to_mont(fr, x)
    # Horner, l and r side by side, each product fused with its add:
    # l = ((l3 x + l2) x + l1) x, r = ((r3 x + 0) x + r1) x + r0.
    zero = torch.zeros_like(l2)
    t = df.mont_mul(fr, torch.stack([l3, r3]), x_m, torch.stack([l2, zero]))
    t = df.mont_mul(fr, t, x_m, torch.stack([l1, r1]))
    l_vec, r_vec = df.mont_mul(fr, t, x_m, torch.stack([zero, r0]))
    return l_vec, r_vec


class ProverVectorPhase:
    """Device-resident l/r/t pipeline for one proof: on `device`, or under
    an engine mesh whose D devices divide padded_n on the mesh's blocks."""

    def __init__(self, curve, padded_n: int, aL, aR, aO, sL, sR,
                 wL, wR, wO, y: int, y_inv: int, device):
        self.curve = curve
        self.fr = df.spec_for(curve.fr)
        self.padded_n = padded_n
        lg_n = max((padded_n - 1).bit_length(), 1)
        mesh = engine.active_mesh()
        shard = (mesh is not None and mesh.size > 1
                 and padded_n % mesh.size == 0)
        self.devices = mesh.devices if shard else (device,)
        b = padded_n // len(self.devices)

        self.coeffs, sums = [], None
        for d, dev in enumerate(self.devices):
            lo = d * b

            def vec(v):
                v = list(v[lo:lo + b])
                return ints_to_limbs(v + [0] * (b - len(v)), dev)

            part, coeffs = _poly_block(
                self.fr, lg_n, lo,
                vec(aL), vec(aR), vec(aO), vec(sL), vec(sR),
                vec(wL), vec(wR), vec(wO),
                ints_to_limbs([y], dev), ints_to_limbs([y_inv], dev))
            self.coeffs.append(coeffs)
            part = part.to(self.devices[0])
            sums = part if sums is None else df.add(self.fr, sums, part)
        t = _t_coeffs(self.fr, sums)
        self.t = limbs_to_ints(t.reshape(6, 16).T)  # [t1..t6]

    def eval_lr(self, x: int):
        """Device Montgomery l(x), r(x) after challenge x: (16, padded_n)
        tensors, or under the mesh Pieces of its blocks."""
        lr = [_eval_phase(self.fr, c, ints_to_limbs([x], dev))
              for c, dev in zip(self.coeffs, self.devices)]
        if len(lr) == 1:
            return lr[0]
        return Pieces([v[0] for v in lr]), Pieces([v[1] for v in lr])


COMMIT_CHUNK = 2048  # commitments per halving tree (the JAX package's)


def _commit_chunk(spec, tab: torch.Tensor, kv, kr) -> torch.Tensor:
    """kv, kr: (16, P) canonical scalar limbs -> (4, 16, P) extended
    sum_j bit_j 2^j B + bit'_j 2^j Bb: the per-bit select of table lanes,
    then 9 halving steps, each one `te_double_k_add` (k = 0) launch adding
    slot j + h to slot j < h (the pairing of the JAX `_commit_many_prog`)."""
    dev = tab.device
    P = kv.shape[-1]
    k = torch.cat([kv, kr]).long()  # (32, P): bits 0-255 v, 256-511 r
    j = torch.arange(512, device=dev)
    bits = ((k[j // 16] >> (j % 16)[:, None]) & 1).bool()  # (512, P)
    ident = proj.point_zero(spec, 1, dev).to(torch.int32)
    acc = torch.where(bits, tab[..., None], ident[..., None])  # (4,16,512,P)
    h = 512
    while h > 1:
        h //= 2
        lo = acc[:, :, :h].reshape(4, N_LIMBS, h * P).contiguous()
        hi = acc[:, :, h:].reshape(4, N_LIMBS, h * P).contiguous()
        acc = kk.te_double_k_add(spec, lo, hi, 0).reshape(4, N_LIMBS, h, P)
    return acc[:, :, 0]


def pedersen_commit_many_dev(pc_gens, values, blinds, device) -> list:
    """[v_i B + r_i B_blinding] for pc_gens on a twisted-Edwards curve, on
    `device`, in chunks of COMMIT_CHUNK; affine host points out, equal to
    PedersenGens.commit (one fetch and one batch inversion per chunk)."""
    curve = pc_gens.curve
    spec = spec_for(curve)
    tab = commit_table(pc_gens, device)
    frp = curve.fr.p
    out = []
    for s in range(0, len(values), COMMIT_CHUNK):
        kv = ints_to_limbs([v % frp for v in values[s:s + COMMIT_CHUNK]],
                           device)
        kr = ints_to_limbs([r % frp for r in blinds[s:s + COMMIT_CHUNK]],
                           device)
        out += point_batch_to_host(curve, _commit_chunk(spec, tab, kv, kr))
    return out
