"""Curve constants and host <-> torch point conversion.

Counterpart of ark_bulletproofs_tpu/ops/curve.py. Points on the torch
side are held in Montgomery form as one (NC, ..., 16, L) tensor:
coordinate, leading axes, limbs, lanes, with NC = `n_coords(spec)`:

  short-Weierstrass (secq256k1, secp256k1, zorro): homogeneous projective
      (X : Y : Z), NC = 3, identity (0 : R mod p : 0);
  twisted-Edwards (curve25519): extended (X : Y : T : Z) with T = XY / Z,
      NC = 4, identity (0 : R : 0 : R), the ordinary affine point (0, 1).

Affine tables are (X, Y, inf) with X and Y (16, n) int32 and inf (n,)
bool; the identity (None for SW, (0, 1) for TE) is marked in `inf` and
stored as X = Y = 0.
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


@dataclass(frozen=True)
class TECurveSpec:
    """Twisted-Edwards a x^2 + y^2 = 1 + d x^2 y^2, unified HWCD extended
    formulas. a and d are applied as full Montgomery products."""

    name: str
    fq: FieldSpec
    a_mont_limbs: tuple  # a * R mod p
    d_mont_limbs: tuple  # d * R mod p

    @classmethod
    def create(cls, name: str, fq: FieldSpec, a: int,
               d: int) -> "TECurveSpec":
        R = fq.R
        return cls(
            name=name,
            fq=fq,
            a_mont_limbs=_limbs_of(a % fq.p * R % fq.p),
            d_mont_limbs=_limbs_of(d % fq.p * R % fq.p),
        )


_SPECS: dict = {}


def spec_for(curve):
    """CurveSpec (short-Weierstrass) or TECurveSpec (twisted-Edwards) of
    one of the port's curves."""
    s = _SPECS.get(curve.name)
    if s is None:
        fq = df.spec_for(curve.fq)
        if hasattr(curve, "b"):
            s = CurveSpec.create(curve.name, fq, curve.a, curve.b)
        else:
            s = TECurveSpec.create(curve.name, fq, curve.a, curve.d)
        _SPECS[curve.name] = s
    return s


def is_te(spec) -> bool:
    return isinstance(spec, TECurveSpec)


def n_coords(spec) -> int:
    """Coordinates of a device point: 4 for TE extended, 3 for SW."""
    return 4 if is_te(spec) else 3


def affine_to_device(curve, points, device=None):
    """Host affine int points -> (X, Y, inf): (16, n) int32 Montgomery
    limbs and an (n,) bool identity mask. The identity (None, or (0, 1)
    on a TE curve) is marked in inf and stored as X = Y = 0."""
    f = curve.fq
    R = f.R
    ident = None if hasattr(curve, "b") else curve.zero()
    xs, ys, inf = [], [], []
    for P in points:
        if P is None or P == ident:
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
    """(NC, 16, B) Montgomery point tensor -> B host affine points: SW
    projective (None = identity), or TE extended ((0, 1) = identity; one
    batch inversion of the Z coordinates)."""
    f = curve.fq
    Rinv = f.R_inv
    P = P.detach().cpu()  # one fetch
    if P.shape[0] == 4:
        X, Y, T, Z = ([v * Rinv % f.p for v in limbs_to_ints(P[i])]
                      for i in range(4))
        if 0 in Z:  # no point of the unified (complete) law has Z = 0
            raise ValueError(f"{curve.name}: extended point with Z = 0")
        return curve.batch_to_affine(list(zip(X, Y, T, Z)))
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
    """One device point, (NC, 16) or (NC, 16, 1) -> host affine."""
    nc = P.shape[0]
    return point_batch_to_host(curve, P.reshape(nc, 16, -1)[:, :, :1])[0]
