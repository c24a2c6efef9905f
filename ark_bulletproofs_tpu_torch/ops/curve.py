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

The on-device Fiat-Shamir IPA (ops/ipa.py) adds its Q terms in the JAX
package's model coordinates instead: Jacobian (X, Y, Z) = (x Z^2, y Z^3)
on a short-Weierstrass curve, identity Z = 0 (`point_zero` is
(0, 0, 0)), and TE extended as above; so does the v1 Pippenger
(ops/msm.py::msm_impl). `_sw_double`, `_sw_add` and `_sw_add_mixed` are
the Jacobian law in plain PyTorch, the plain versions of csrc/jac.cuh:
they follow the kernel bodies `_k_sw_double` / `_k_sw_add` / `_k_sw_madd`
of ark_bulletproofs_tpu/ops/kernels.py operation for operation
(dbl-2007-bl; add-2007-bl and madd-2007-bl with the unconditional
doubling and the selects doubling, cancel, P = O, Q = O in that order),
stacking independent products into one call, which changes no value.
They return int64.
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
    b_mont_limbs: tuple  # b * R mod p (the generator farm's curve equation)

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
            b_mont_limbs=_limbs_of(b % fq.p * R % fq.p),
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


def point_zero(spec, lanes: int, device) -> torch.Tensor:
    """(NC, 16, lanes) int64 model identity: Jacobian (0, 0, 0), or TE
    (0 : R : 0 : R)."""
    P = torch.zeros(n_coords(spec), 16, lanes, dtype=torch.int64,
                    device=device)
    if is_te(spec):
        P[1] = P[3] = df.const(spec.fq.r_limbs, device)
    return P


def is_zero(spec, P: torch.Tensor) -> torch.Tensor:
    """Lane mask of the identity: Z = 0 (Jacobian), or X = 0 and Y = Z
    (TE extended)."""
    if is_te(spec):
        return df.is_zero(P[0]) & (P[1] == P[3]).all(dim=-2)
    return df.is_zero(P[2])


def _mm(fs, *pairs):
    """Independent Montgomery products in one plain call."""
    return df.mont_mul_plain(fs, torch.stack([a.long() for a, _ in pairs]),
                             torch.stack([b.long() for _, b in pairs])
                             ).unbind(0)


def _sw_double(spec: CurveSpec, P: torch.Tensor) -> torch.Tensor:
    """Jacobian doubling, `_k_sw_double` (dbl-2007-bl): 8 products, 10
    for a != 0 (M += a ZZ^2, a as a full product). The identity (Z = 0)
    doubles to Z = 0."""
    fs = spec.fq
    X1, Y1, Z1 = P.long()
    XX, YY, ZZ = _mm(fs, (X1, X1), (Y1, Y1), (Z1, Z1))
    xpyy = df.add_plain(fs, X1, YY)
    ypz = df.add_plain(fs, Y1, Z1)
    YYYY, xpyy2, ypz2 = _mm(fs, (YY, YY), (xpyy, xpyy), (ypz, ypz))
    S = df.sub_plain(fs, xpyy2, df.add_plain(fs, XX, YYYY))
    S = df.add_plain(fs, S, S)
    M = df.add_plain(fs, df.add_plain(fs, XX, XX), XX)
    if not spec.is_a_zero:
        (ZZ2,) = _mm(fs, (ZZ, ZZ))
        (aZZ2,) = _mm(fs, (df.const(spec.a_mont_limbs, P.device)
                           .expand_as(ZZ2), ZZ2))
        M = df.add_plain(fs, M, aZZ2)
    (M2,) = _mm(fs, (M, M))
    X3 = df.sub_plain(fs, M2, df.add_plain(fs, S, S))
    (MSX,) = _mm(fs, (M, df.sub_plain(fs, S, X3)))
    Y3 = df.sub_plain(fs, MSX, df.mul_small(fs, YYYY, 8))
    Z3 = df.sub_plain(fs, ypz2, df.add_plain(fs, YY, ZZ))
    return torch.stack([X3, Y3, Z3])


def _sw_add(spec: CurveSpec, P: torch.Tensor,
            Q: torch.Tensor) -> torch.Tensor:
    """Complete Jacobian P + Q, `_k_sw_add` (add-2007-bl): 16 products
    and the doubling of P, computed on every lane, then the selects."""
    fs = spec.fq
    P, Q = P.long(), Q.long()
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    p_inf = df.is_zero(Z1)
    q_inf = df.is_zero(Z2)
    Z1Z1, Z2Z2 = _mm(fs, (Z1, Z1), (Z2, Z2))
    U1, U2, A, B = _mm(fs, (X1, Z2Z2), (X2, Z1Z1), (Y1, Z2), (Y2, Z1))
    S1, S2 = _mm(fs, (A, Z2Z2), (B, Z1Z1))
    H = df.sub_plain(fs, U2, U1)
    rr0 = df.sub_plain(fs, S2, S1)
    x_eq = df.is_zero(H)
    y_eq = df.is_zero(rr0)
    rr = df.add_plain(fs, rr0, rr0)
    twoH = df.add_plain(fs, H, H)
    (I,) = _mm(fs, (twoH, twoH))
    J, V, rr2 = _mm(fs, (H, I), (U1, I), (rr, rr))
    X3 = df.sub_plain(fs, rr2, df.add_plain(fs, J, df.add_plain(fs, V, V)))
    (S1J,) = _mm(fs, (S1, J))
    (t1,) = _mm(fs, (rr, df.sub_plain(fs, V, X3)))
    Y3 = df.sub_plain(fs, t1, df.add_plain(fs, S1J, S1J))
    zpz = df.add_plain(fs, Z1, Z2)
    (zpz2,) = _mm(fs, (zpz, zpz))
    w = df.sub_plain(fs, zpz2, df.add_plain(fs, Z1Z1, Z2Z2))
    (Z3,) = _mm(fs, (w, H))
    R = torch.stack([X3, Y3, Z3])
    finite = ~p_inf & ~q_inf
    both = x_eq & y_eq
    # As in csrc/jac.cuh, the doubling is computed only where a lane keeps
    # it (P == Q, both finite): on every other lane a later select
    # overwrites it, so the output is the body's.
    if bool((both & finite).any()):
        R = df.select(both, _sw_double(spec, P), R)
    cancel = x_eq & ~y_eq & finite
    R[2] = df.select(cancel, torch.zeros_like(R[2]), R[2])
    R = df.select(p_inf, Q, R)
    return df.select(q_inf, P, R)


def _sw_add_mixed(spec: CurveSpec, P: torch.Tensor, Qx: torch.Tensor,
                  Qy: torch.Tensor, q_inf: torch.Tensor) -> torch.Tensor:
    """Complete Jacobian P + affine (Qx, Qy), `_k_sw_madd`
    (madd-2007-bl): 12 products and the doubling of P, then the selects;
    P = O gives (Qx, Qy, R), or Z = 0 where q_inf too; q_inf lanes give
    P."""
    fs = spec.fq
    P = P.long()
    Qx, Qy = Qx.long(), Qy.long()
    X1, Y1, Z1 = P
    p_inf = df.is_zero(Z1)
    (Z1Z1,) = _mm(fs, (Z1, Z1))
    U2, B = _mm(fs, (Qx, Z1Z1), (Qy, Z1))
    (S2,) = _mm(fs, (B, Z1Z1))
    H = df.sub_plain(fs, U2, X1)
    rr0 = df.sub_plain(fs, S2, Y1)
    x_eq = df.is_zero(H)
    y_eq = df.is_zero(rr0)
    rr = df.add_plain(fs, rr0, rr0)
    twoH = df.add_plain(fs, H, H)
    zph = df.add_plain(fs, Z1, H)
    I, rr2, zph2, HH = _mm(fs, (twoH, twoH), (rr, rr), (zph, zph), (H, H))
    J, V = _mm(fs, (H, I), (X1, I))
    X3 = df.sub_plain(fs, rr2, df.add_plain(fs, J, df.add_plain(fs, V, V)))
    t1, S1J = _mm(fs, (rr, df.sub_plain(fs, V, X3)), (Y1, J))
    Y3 = df.sub_plain(fs, t1, df.add_plain(fs, S1J, S1J))
    Z3 = df.sub_plain(fs, zph2, df.add_plain(fs, Z1Z1, HH))
    R = torch.stack([X3, Y3, Z3])
    finite = ~p_inf & ~q_inf
    both = x_eq & y_eq
    # The doubling only where a lane keeps it, as in `_sw_add`.
    if bool((both & finite).any()):
        R = df.select(both, _sw_double(spec, P), R)
    cancel = x_eq & ~y_eq & finite
    R[2] = df.select(cancel, torch.zeros_like(R[2]), R[2])
    one = df.const(fs.r_limbs, P.device).expand_as(Qx)
    Q = torch.stack([Qx, Qy, df.select(q_inf, torch.zeros_like(one), one)])
    R = df.select(p_inf, Q, R)
    return df.select(q_inf, P, R)


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
