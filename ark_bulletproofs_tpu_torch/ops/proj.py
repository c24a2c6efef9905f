"""Complete group laws, plain PyTorch: the plain versions of the CUDA
bodies in csrc/rcb.cuh and csrc/te.cuh.

Short-Weierstrass curves (CurveSpec): the complete projective formulas
of Renes-Costello-Batina, counterpart of ark_bulletproofs_tpu/ops/proj.py
and of the in-kernel bodies `_k_rcb_add` / `_k_rcb_madd` /
`_k_rcb_double` of ark_bulletproofs_tpu/ops/kernels.py: Alg 1/2/3 for
general a (zorro), Alg 7/8/9 for a = 0 (secq256k1). A point is one
(3, ..., 16, L) tensor (X, Y, Z); the identity is (0 : R mod p : 0).

Twisted-Edwards curves (TECurveSpec, curve25519): the unified extended
addition of Hisil-Wong-Carter-Dawson, counterpart of the kernel bodies
`_k_te_add` / `_k_te_madd` / `_k_te_double` (kernels.py) and of the host
model's TECurve.proj_add. A point is one (4, ..., 16, L) tensor
(X, Y, T, Z); the identity is (0 : R : 0 : R). Doubling is add(P, P).

Both follow the kernel bodies operation for operation, with the same
field operations on the same operands. Independent operations of a
formula are stacked into one call (`_mul`, `_add`, `_sub` take several
operand pairs), which changes no value and cuts the torch calls per point
operation about threefold. Every field result is canonical, so the
coordinates are bit-equal to the JAX package's and to the CUDA bodies.
The public functions dispatch on the spec's type. They return int64.
"""

from __future__ import annotations

import torch

from . import field as df
from .curve import CurveSpec, TECurveSpec, is_te, n_coords
from .limbs import N_LIMBS


def point_zero(spec, lanes: int, device) -> torch.Tensor:
    """(NC, 16, lanes) identity: (0 : R : 0) or, TE, (0 : R : 0 : R)."""
    P = torch.zeros(n_coords(spec), N_LIMBS, lanes, dtype=torch.int64,
                    device=device)
    one = df.const(spec.fq.r_limbs, device)
    P[1] = one
    if is_te(spec):
        P[3] = one
    return P


def select(mask: torch.Tensor, P: torch.Tensor, Q: torch.Tensor):
    """where(mask, P, Q) lane-wise; mask has P's shape without the
    coordinate and limb axes."""
    return torch.where(mask.unsqueeze(-2), P, Q)


def _stack(pairs, i):
    return torch.stack([p[i].long() for p in pairs])


def _mul(fs, *pairs):
    return df.mont_mul_plain(fs, _stack(pairs, 0),
                             _stack(pairs, 1)).unbind(0)


def _add(fs, *pairs):
    return df.add_plain(fs, _stack(pairs, 0), _stack(pairs, 1)).unbind(0)


def _sub(fs, *pairs):
    return df.sub_plain(fs, _stack(pairs, 0), _stack(pairs, 1)).unbind(0)


def _mul_const(fs, xs, mont_limbs, small):
    """[x * c for x in xs] for a curve constant c: double-and-add when its
    plain value is small, else a product with its Montgomery form."""
    x = torch.stack([v.long() for v in xs])
    if small is not None:
        return df.mul_small(fs, x, small).unbind(0)
    return df.mont_mul_plain(fs, x,
                             df.const(mont_limbs, x.device)).unbind(0)


def _tail(spec: CurveSpec, t0, t1, t2, t3, t4, t5) -> torch.Tensor:
    """The common second half of Alg 7/8 (a = 0) and Alg 1/2: t0 = X1X2,
    t1 = Y1Y2, t2 = Z1Z2 (Z1 for the mixed add), t3 = X1Y2 + X2Y1,
    t4 = X1Z2 + X2Z1, t5 = Y1Z2 + Y2Z1."""
    fs = spec.fq
    b3 = (spec.b3_mont_limbs, spec.b3_small)
    if spec.is_a_zero:
        X3, Y3 = _mul_const(fs, [t2, t4], *b3)  # b3 t2, b3 t4
        t03 = df.mul_small(fs, t0, 3)
        (Z3,) = _add(fs, (t1, X3))
        (t1,) = _sub(fs, (t1, X3))
        X3, t2, Y3, t1, t03, Z3 = _mul(
            fs, (t5, Y3), (t3, t1), (Y3, t03), (t1, Z3), (t03, t3), (Z3, t5)
        )
        (X3,) = _sub(fs, (t2, X3))
        Y3, Z3 = _add(fs, (t1, Y3), (Z3, t03))
        return torch.stack([X3, Y3, Z3])
    a = (spec.a_mont_limbs, spec.a_small)
    Z3, at2 = _mul_const(fs, [t4, t2], *a)  # a t4, a t2
    X3, t4b = _mul_const(fs, [t2, t4], *b3)  # b3 t2, b3 t4
    (Z3,) = _add(fs, (X3, Z3))
    (X3,) = _sub(fs, (t1, Z3))
    (Z3,) = _add(fs, (t1, Z3))
    t1 = df.mul_small(fs, t0, 3)
    (t1,) = _add(fs, (t1, at2))
    (t2,) = _sub(fs, (t0, at2))
    (t2,) = _mul_const(fs, [t2], *a)
    (t4,) = _add(fs, (t4b, t2))
    Y3, m0, m1, X3, m3, Z3 = _mul(
        fs, (X3, Z3), (t1, t4), (t5, t4), (t3, X3), (t3, t1), (t5, Z3)
    )
    (Y3,) = _add(fs, (Y3, m0))
    (X3,) = _sub(fs, (X3, m1))
    (Z3,) = _add(fs, (Z3, m3))
    return torch.stack([X3, Y3, Z3])


def _rcb_add(spec: CurveSpec, P, Q) -> torch.Tensor:
    """Complete P + Q (RCB Alg 1 general a / Alg 7 for a = 0)."""
    fs = spec.fq
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0, t1, t2 = _mul(fs, (X1, X2), (Y1, Y2), (Z1, Z2))
    s = _add(fs, (X1, Y1), (X2, Y2), (X1, Z1), (X2, Z2), (Y1, Z1), (Y2, Z2))
    t3, t4, t5 = _mul(fs, (s[0], s[1]), (s[2], s[3]), (s[4], s[5]))
    u = _add(fs, (t0, t1), (t0, t2), (t1, t2))
    t3, t4, t5 = _sub(fs, (t3, u[0]), (t4, u[1]), (t5, u[2]))
    return _tail(spec, t0, t1, t2, t3, t4, t5)


def _rcb_add_mixed(spec: CurveSpec, P, Qx, Qy, q_inf) -> torch.Tensor:
    """Complete P + affine Q (RCB Alg 2 / Alg 8); q_inf lanes pass P."""
    fs = spec.fq
    X1, Y1, Z1 = P
    sq, sp = _add(fs, (Qx, Qy), (X1, Y1))
    t0, t1, t3, m1, m2 = _mul(
        fs, (X1, Qx), (Y1, Qy), (sq, sp), (Qx, Z1), (Qy, Z1)
    )
    u, t4, t5 = _add(fs, (t0, t1), (m1, X1), (m2, Y1))
    (t3,) = _sub(fs, (t3, u))
    R = _tail(spec, t0, t1, Z1.long(), t3, t4, t5)
    return select(q_inf, P.long(), R)


def _rcb_double(spec: CurveSpec, P) -> torch.Tensor:
    """Complete projective doubling (RCB Alg 3 / Alg 9)."""
    fs = spec.fq
    X1, Y1, Z1 = P
    b3 = (spec.b3_mont_limbs, spec.b3_small)
    if spec.is_a_zero:  # Alg 9
        t0, t1, t2, txy = _mul(fs, (Y1, Y1), (Y1, Z1), (Z1, Z1), (X1, Y1))
        Z3 = df.mul_small(fs, t0, 8)
        (t2,) = _mul_const(fs, [t2], *b3)
        (Y3,) = _add(fs, (t0, t2))
        t2x3 = df.mul_small(fs, t2, 3)
        (t0,) = _sub(fs, (t0, t2x3))
        X3, Z3, Y3, X3b = _mul(fs, (t2, Z3), (t1, Z3), (t0, Y3), (t0, txy))
        (Y3,) = _add(fs, (X3, Y3))
        (X3,) = _add(fs, (X3b, X3b))
        return torch.stack([X3, Y3, Z3])
    a = (spec.a_mont_limbs, spec.a_small)
    t0, t1, t2, t3, Z3, t2y = _mul(
        fs, (X1, X1), (Y1, Y1), (Z1, Z1), (X1, Y1), (X1, Z1), (Y1, Z1)
    )
    t3, Z3, t2y = _add(fs, (t3, t3), (Z3, Z3), (t2y, t2y))
    X3, t2a = _mul_const(fs, [Z3, t2], *a)  # a Z3, a t2
    Y3, Z3b = _mul_const(fs, [t2, Z3], *b3)  # b3 t2, b3 Z3
    (Y3,) = _add(fs, (X3, Y3))
    (X3,) = _sub(fs, (t1, Y3))
    (Y3,) = _add(fs, (t1, Y3))
    (t3n,) = _sub(fs, (t0, t2a))
    (t3n,) = _mul_const(fs, [t3n], *a)
    (t3n,) = _add(fs, (t3n, Z3b))
    Z3 = df.mul_small(fs, t0, 3)
    (t0,) = _add(fs, (Z3, t2a))
    Y3, X3, t0, m0, Z3 = _mul(
        fs, (X3, Y3), (t3, X3), (t0, t3n), (t2y, t3n), (t2y, t1)
    )
    (Y3,) = _add(fs, (Y3, t0))
    (X3,) = _sub(fs, (X3, m0))
    Z3 = df.mul_small(fs, Z3, 4)
    return torch.stack([X3, Y3, Z3])


def _te_add_core(spec: TECurveSpec, P, X2, Y2, T2, Z2) -> torch.Tensor:
    """Unified extended P + (X2 : Y2 : T2 : Z2), `_k_te_add`'s operations;
    Z2 None stands for Z2 = 1 (the mixed add: D = Z1, one product less).
    11 field products with Z2, 10 without."""
    fs = spec.fq
    X1, Y1, T1, Z1 = P
    s1, s2 = _add(fs, (X1, Y1), (X2, Y2))
    pairs = [(X1, X2), (Y1, Y2), (T1, T2), (s1, s2)]
    if Z2 is not None:
        pairs.append((Z1, Z2))
    A, B, TT, E0, *D = _mul(fs, *pairs)
    D = D[0] if D else Z1.long()
    dev = A.device
    # d and a as full Montgomery products, as `_k_mul_const(..., None)`
    C, aA = df.mont_mul_plain(fs, torch.stack([TT, A]), torch.stack([
        df.const(spec.d_mont_limbs, dev), df.const(spec.a_mont_limbs, dev)
    ])).unbind(0)
    (AB,) = _add(fs, (A, B))
    E, F, H = _sub(fs, (E0, AB), (D, C), (B, aA))
    (G,) = _add(fs, (D, C))
    return torch.stack(_mul(fs, (E, F), (G, H), (E, H), (F, G)))


def _te_add_mixed(spec: TECurveSpec, P, Qx, Qy, q_inf) -> torch.Tensor:
    """P + affine (Qx, Qy) with T2 = Qx Qy computed here and Z2 = 1
    (`_k_te_madd`); q_inf lanes pass P through. (The JAX package's XLA
    `_te_add_mixed` adds (0, 1) on those lanes instead: the same affine
    point in other projective coordinates.)"""
    (T2,) = _mul(spec.fq, (Qx, Qy))
    R = _te_add_core(spec, P, Qx.long(), Qy.long(), T2, None)
    return select(q_inf, P.long(), R)


def add(spec, P, Q) -> torch.Tensor:
    """Complete P + Q."""
    if is_te(spec):
        return _te_add_core(spec, P, *Q)
    return _rcb_add(spec, P, Q)


def add_mixed(spec, P, Qx, Qy, q_inf) -> torch.Tensor:
    """Complete P + affine Q; q_inf lanes pass P through."""
    if is_te(spec):
        return _te_add_mixed(spec, P, Qx, Qy, q_inf)
    return _rcb_add_mixed(spec, P, Qx, Qy, q_inf)


def double(spec, P) -> torch.Tensor:
    """Complete doubling (TE: the unified add(P, P))."""
    if is_te(spec):
        return _te_add_core(spec, P, *P)
    return _rcb_double(spec, P)


def double_k_add(spec, P, Q, k: int) -> torch.Tensor:
    """2^k * P + Q: k doublings, then one complete add."""
    for _ in range(k):
        P = double(spec, P)
    return add(spec, P, Q)


def to_jacobian(spec, P: torch.Tensor) -> torch.Tensor:
    """RCB (X : Y : Z) -> the same point in Jacobian coordinates (XZ, YZ^2,
    Z), three products through `df.mont_mul` (the kernel on the card); the
    identity (0 : R : 0) maps to (0, 0, 0). TE extended points pass
    through (ark_bulletproofs_tpu/ops/proj.py::to_jacobian)."""
    if is_te(spec):
        return P
    fs = spec.fq
    X, Y, Z = P
    Z2 = df.mont_mul(fs, Z, Z)
    XZ, YZ2 = df.mont_mul(fs, torch.stack([X, Y]),
                          torch.stack([Z.to(Z2.dtype), Z2]))
    return torch.stack([XZ, YZ2, Z.to(XZ.dtype)])


def from_jacobian(spec, P: torch.Tensor) -> torch.Tensor:
    """Jacobian (X, Y, Z) -> the same point in RCB projective coordinates
    (XZ : Y : Z^3), three products through `df.mont_mul` (the kernel on
    the card); an identity (Z = 0) becomes (0 : R : 0). TE extended points
    pass through. The inverse of `to_jacobian` up to the choice of Z."""
    if is_te(spec):
        return P
    fs = spec.fq
    X, Y, Z = P
    Z2 = df.mont_mul(fs, Z, Z)
    XZ, Z3 = df.mont_mul(fs, torch.stack([X, Z2.to(X.dtype)]),
                         torch.stack([Z, Z]))
    one = df.const(fs.r_limbs, P.device).to(Y.dtype)
    Y = torch.where(df.is_zero(Z).unsqueeze(-2), one, Y)
    return torch.stack([XZ, Y.to(XZ.dtype), Z3])
