"""Curve constants and host <-> torch point conversion.

Counterpart of ark_bulletproofs_tpu/ops/curve.py for short-Weierstrass
curves (secq256k1, secp256k1, zorro). Points on the torch side are
homogeneous projective (X : Y : Z) in Montgomery form, held as one
(3, ..., 16, L) tensor: coordinate, leading axes, limbs, lanes. The
identity is (0 : R mod p : 0). Affine tables are (X, Y, inf) with X and
Y (16, n) int32 and inf (n,) bool.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import field as df
from .field import FieldSpec, _limbs_of
from .limbs import ints_to_limbs, limbs_to_ints


@dataclass(frozen=True)
class CurveSpec:
    """Short-Weierstrass y^2 = x^3 + a x + b, RCB complete formulas."""

    name: str
    fq: FieldSpec
    a: int
    is_a_zero: bool
    a_mont_limbs: tuple  # a * R mod p
    b3_mont_limbs: tuple  # 3b * R mod p
    # When the PLAIN constant is small (< 2^14) it is applied by
    # double-and-add instead of a full Montgomery product, as in the
    # JAX package (the values are the same either way).
    a_small: int | None
    b3_small: int | None

    @classmethod
    def create(cls, name: str, fq: FieldSpec, a: int, b: int) -> "CurveSpec":
        R = fq.R
        a_, b3 = a % fq.p, 3 * b % fq.p
        return cls(
            name=name,
            fq=fq,
            a=a,
            is_a_zero=(a_ == 0),
            a_mont_limbs=_limbs_of(a_ * R % fq.p),
            b3_mont_limbs=_limbs_of(b3 * R % fq.p),
            a_small=(a if 0 < a < (1 << 14) else None),
            b3_small=(3 * b if 0 < b < (1 << 14) else None),
        )


_SPECS: dict[str, CurveSpec] = {}


def spec_for(curve) -> CurveSpec:
    """CurveSpec for a short-Weierstrass curve of the port's curves."""
    s = _SPECS.get(curve.name)
    if s is None:
        if not hasattr(curve, "b"):
            raise NotImplementedError(
                f"{curve.name}: twisted-Edwards curves are not ported yet "
                "(ROADMAP Queue B: the te_* kernels for the curve25519 MSM)"
            )
        s = CurveSpec.create(curve.name, df.spec_for(curve.fq), curve.a,
                             curve.b)
        _SPECS[curve.name] = s
    return s


def affine_to_device(curve, points, device=None):
    """Host affine int points (None = identity) -> (X, Y, inf):
    (16, n) int32 Montgomery limbs and an (n,) bool identity mask.
    Identity rows hold X = Y = 0."""
    f = curve.fq
    R = f.R
    xs, ys, inf = [], [], []
    for P in points:
        if P is None:
            xs.append(0)
            ys.append(0)
            inf.append(True)
        else:
            xs.append(P[0] * R % f.p)
            ys.append(P[1] * R % f.p)
            inf.append(False)
    return (
        ints_to_limbs(xs, device),
        ints_to_limbs(ys, device),
        torch.tensor(inf, dtype=torch.bool, device=device),
    )


def point_batch_to_host(curve, P: torch.Tensor) -> list:
    """(3, 16, B) projective Montgomery point tensor -> B host affine
    points (None = identity)."""
    f = curve.fq
    Rinv = f.R_inv
    X, Y, Z = (limbs_to_ints(P[i]) for i in range(3))
    out = []
    for x, y, z in zip(X, Y, Z):
        x, y, z = x * Rinv % f.p, y * Rinv % f.p, z * Rinv % f.p
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, f.p)
        out.append((x * zi % f.p, y * zi % f.p))
    return out


def point_to_host(curve, P: torch.Tensor):
    """One projective point, (3, 16) or (3, 16, 1) -> host affine."""
    return point_batch_to_host(curve, P.reshape(3, 16, -1)[:, :, :1])[0]
