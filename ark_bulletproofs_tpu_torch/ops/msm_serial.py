"""Bit-serial MSM (counterpart of ark_bulletproofs_tpu/ops/msm_serial.py).

Horner over the 256 scalar bits, top bit first: for bit t the points
whose bit t is set are selected (the others become the identity), a
halving tree of `kk.add` launches sums them, and one `kk.double_k_add`
at k = 1 folds the sum into the accumulator, acc = 2 acc + sum_t. The
JAX package kept it for its XLA compile time (about three group-law
instantiations against the Pippenger's ten); here it completes the API
(`parallel/msm.py::msm_sharded_serial`, `multihost.msm_multihost(kind=
"serial")`) on kernels the port already has, and no default route takes
it. The selections and trees of up to SERIAL_LANES / n bits run side by
side (each bit's tree is the JAX body's; only the launches are shared).

Points are in the device coordinates (ops/curve.py): RCB projective on a
short-Weierstrass curve (`rcb_double_k_add`), extended on a
twisted-Edwards one (`te_double_k_add`); the JAX body kept Jacobian
points. Group addition is exact, so the affine sum equals any other
engine's.
"""

from __future__ import annotations

import torch

from . import field as df
from . import kernels as kk
from . import proj
from .curve import is_te
from .limbs import LIMB_BITS, N_LIMBS

SCALAR_BITS = 256
# Selected points (bits x sets x terms) of one pass of trees.
SERIAL_LANES = 1 << 20


def _points(spec, X, Y, inf) -> torch.Tensor:
    """Affine Montgomery (X, Y, inf) -> (NC, 16, n) int32 device points:
    (x : y : 1), or (x : y : x y : 1) extended; the identity where inf."""
    fq = spec.fq
    n = X.shape[-1]
    one = df.mont_one(fq, n, X.device).to(X.dtype)
    coords = [X, Y, df.mont_mul(fq, X, Y).to(X.dtype), one] if is_te(spec) \
        else [X, Y, one]
    P = torch.stack(coords)
    ident = proj.point_zero(spec, 1, X.device).to(P.dtype)
    return proj.select(inf, ident, P).to(torch.int32)


def _tree(spec, P: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis (a power of two) of (NC, 16, G, n) points
    by halving: slot j adds slot j + h. (NC, 16, G)."""
    nc = P.shape[0]
    while P.shape[-1] > 1:
        h = P.shape[-1] // 2
        G = P.shape[2]
        lo = P[..., :h].reshape(nc, N_LIMBS, G * h).contiguous()
        hi = P[..., h:].reshape(nc, N_LIMBS, G * h).contiguous()
        P = kk.add(spec, lo, hi).reshape(nc, N_LIMBS, G, h)
    return P[..., 0]


def msm_serial_impl(spec, X, Y, inf, scal) -> torch.Tensor:
    """X, Y: (16, n) affine Montgomery limbs; inf: (n,) bool; scal: (16,
    n) or (B, 16, n) canonical scalar limbs; n a power of two, all on one
    device. Returns the B sums as (NC, 16, B) device points."""
    sets = scal if scal.dim() == 3 else scal.unsqueeze(0)
    B, _, n = sets.shape
    if n < 1 or n & (n - 1) or X.shape[-1] != n:
        raise ValueError(f"msm_serial: n={n} must be a power of two, one "
                         "point per scalar")
    dev = sets.device
    nc = 4 if is_te(spec) else 3
    P = _points(spec, X, Y, inf)
    ident = proj.point_zero(spec, 1, dev).to(torch.int32)
    per = max(1, SERIAL_LANES // (B * n))  # bits a pass
    acc = proj.point_zero(spec, B, dev).to(torch.int32)
    for top in range(SCALAR_BITS - 1, -1, -per):
        ts = torch.arange(top, max(top - per, -1), -1, device=dev)
        bits = (sets.long()[:, ts // LIMB_BITS]
                >> (ts % LIMB_BITS)[None, :, None]) & 1  # (B, T, n)
        sel = torch.where(bits.bool().reshape(1, 1, -1, n),
                          P[:, :, None, :], ident[..., None])
        tot = _tree(spec, sel).reshape(nc, N_LIMBS, B, len(ts))
        for j in range(len(ts)):
            acc = kk.double_k_add(spec, acc, tot[..., j].contiguous(), 1)
    return acc
