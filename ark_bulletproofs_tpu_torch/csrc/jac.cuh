// Complete short-Weierstrass group law in Jacobian coordinates (X, Y, Z) =
// (x Z^2, y Z^3), identity Z = 0 (stored as (0, 0, 0)).
//
// Replaces the TPU kernel bodies _k_sw_double, _k_sw_add and _k_sw_madd
// (ark_bulletproofs_tpu/ops/kernels.py), followed operation for
// operation, and through them the elementwise kernels sw_double_tiled,
// sw_add_tiled, sw_double_k_add_tiled and sw_madd_tiled: dbl-2007-bl,
// add-2007-bl and madd-2007-bl (EFD). AZ selects a = 0 (secq256k1) at compile time; for
// a != 0 (zorro) the doubling adds a ZZ^2 with a as a full product of
// CurveConst::a_mont, as _k_sw_double does. The plain PyTorch versions are
// ops/curve.py::_sw_double, ::_sw_add and ::_sw_add_mixed.
//
// The add is complete by selects, in _k_sw_add's order: P == Q takes the
// doubling of P, P == -Q (both finite) sets Z = 0, P = O gives Q, Q = O
// gives P. The TPU body computes the doubling on every lane; here it runs
// only on the lanes that keep it (equal, finite operands), which changes
// no output: every other lane's doubling is overwritten by a later select.
//
// The mixed add (affine Q, Z2 = 1) is complete the same way, in
// _k_sw_madd's order: doubling, cancel, P = O gives (qx, qy, 1) (or Z = 0
// when Q = O too), Q = O gives P.
//
// Cost: 8 field products a doubling (10 for a != 0), 16 an add and 12 a
// mixed add (8 or 10 more on a doubling lane), against RCB's 8, 12 and
// 11. Callers: the IPA's Q-term tree and 2^i Q table (ops/ipa.py::
// _mul_point_dev, _q_doubles: the doubling chain) and the v1 Pippenger
// (ops/msm.py::msm_impl: the mixed add in its row scan, the add in its
// carries and trees, the double-k-add in its Horner steps).
#pragma once
#include "rcb.cuh"

__device__ __forceinline__ Pt jac_identity() {
  Pt r;
  r.X = fe_zero();
  r.Y = fe_zero();
  r.Z = fe_zero();
  return r;
}

template <bool AZ>
__device__ __forceinline__ Pt jac_double(const Pt& P, const CurveConst& cc) {
  Fe XX = fe_mul(P.X, P.X, cc);
  Fe YY = fe_mul(P.Y, P.Y, cc);
  Fe ZZ = fe_mul(P.Z, P.Z, cc);
  Fe YYYY = fe_mul(YY, YY, cc);
  Fe xpyy = fe_add(P.X, YY, cc);
  Fe S = fe_sub(fe_mul(xpyy, xpyy, cc), fe_add(XX, YYYY, cc), cc);
  S = fe_add(S, S, cc);
  Fe M = fe_add(fe_add(XX, XX, cc), XX, cc);
  if (!AZ) {
    Fe ZZ2 = fe_mul(ZZ, ZZ, cc);
    M = fe_add(M, fe_mul(fe_from(cc.a_mont), ZZ2, cc), cc);
  }
  Fe M2 = fe_mul(M, M, cc);
  Pt R;
  R.X = fe_sub(M2, fe_add(S, S, cc), cc);
  Fe e8 = fe_add(YYYY, YYYY, cc);
  e8 = fe_add(e8, e8, cc);
  e8 = fe_add(e8, e8, cc);
  R.Y = fe_sub(fe_mul(M, fe_sub(S, R.X, cc), cc), e8, cc);
  Fe ypz = fe_add(P.Y, P.Z, cc);
  R.Z = fe_sub(fe_mul(ypz, ypz, cc), fe_add(YY, ZZ, cc), cc);
  return R;
}

template <bool AZ>
__device__ __forceinline__ Pt jac_add(const Pt& P, const Pt& Q,
                                      const CurveConst& cc) {
  bool p_inf = fe_is_zero(P.Z);
  bool q_inf = fe_is_zero(Q.Z);
  Fe Z1Z1 = fe_mul(P.Z, P.Z, cc);
  Fe Z2Z2 = fe_mul(Q.Z, Q.Z, cc);
  Fe U1 = fe_mul(P.X, Z2Z2, cc);
  Fe U2 = fe_mul(Q.X, Z1Z1, cc);
  Fe S1 = fe_mul(fe_mul(P.Y, Q.Z, cc), Z2Z2, cc);
  Fe S2 = fe_mul(fe_mul(Q.Y, P.Z, cc), Z1Z1, cc);
  Fe H = fe_sub(U2, U1, cc);
  Fe rr0 = fe_sub(S2, S1, cc);
  bool x_eq = fe_is_zero(H);
  bool y_eq = fe_is_zero(rr0);
  Fe rr = fe_add(rr0, rr0, cc);
  Fe twoH = fe_add(H, H, cc);
  Fe I = fe_mul(twoH, twoH, cc);
  Fe J = fe_mul(H, I, cc);
  Fe V = fe_mul(U1, I, cc);
  Fe rr2 = fe_mul(rr, rr, cc);
  Pt R;
  R.X = fe_sub(rr2, fe_add(J, fe_add(V, V, cc), cc), cc);
  Fe S1J = fe_mul(S1, J, cc);
  R.Y = fe_sub(fe_mul(rr, fe_sub(V, R.X, cc), cc), fe_add(S1J, S1J, cc),
               cc);
  Fe zpz = fe_add(P.Z, Q.Z, cc);
  Fe w = fe_sub(fe_mul(zpz, zpz, cc), fe_add(Z1Z1, Z2Z2, cc), cc);
  R.Z = fe_mul(w, H, cc);
  bool finite = !p_inf && !q_inf;
  if (x_eq && y_eq && finite) R = jac_double<AZ>(P, cc);
  if (x_eq && !y_eq && finite) R.Z = fe_zero();
  if (p_inf) R = Q;
  if (q_inf) R = P;
  return R;
}

// P + affine (qx, qy), madd-2007-bl (_k_sw_madd): 12 products.
template <bool AZ>
__device__ __forceinline__ Pt jac_madd(const Pt& P, const Fe& qx,
                                       const Fe& qy, bool q_inf,
                                       const CurveConst& cc) {
  bool p_inf = fe_is_zero(P.Z);
  Fe Z1Z1 = fe_mul(P.Z, P.Z, cc);
  Fe U2 = fe_mul(qx, Z1Z1, cc);
  Fe S2 = fe_mul(fe_mul(qy, P.Z, cc), Z1Z1, cc);
  Fe H = fe_sub(U2, P.X, cc);
  Fe rr0 = fe_sub(S2, P.Y, cc);
  bool x_eq = fe_is_zero(H);
  bool y_eq = fe_is_zero(rr0);
  Fe rr = fe_add(rr0, rr0, cc);
  Fe twoH = fe_add(H, H, cc);
  Fe HH = fe_mul(H, H, cc);
  Fe I = fe_mul(twoH, twoH, cc);
  Fe J = fe_mul(H, I, cc);
  Fe V = fe_mul(P.X, I, cc);
  Fe rr2 = fe_mul(rr, rr, cc);
  Pt R;
  R.X = fe_sub(rr2, fe_add(J, fe_add(V, V, cc), cc), cc);
  Fe S1J = fe_mul(P.Y, J, cc);
  R.Y = fe_sub(fe_mul(rr, fe_sub(V, R.X, cc), cc), fe_add(S1J, S1J, cc),
               cc);
  Fe zph = fe_add(P.Z, H, cc);
  R.Z = fe_sub(fe_mul(zph, zph, cc), fe_add(Z1Z1, HH, cc), cc);
  bool finite = !p_inf && !q_inf;
  if (x_eq && y_eq && finite) R = jac_double<AZ>(P, cc);
  if (x_eq && !y_eq && finite) R.Z = fe_zero();
  if (p_inf) {
    R.X = qx;
    R.Y = qy;
    R.Z = q_inf ? fe_zero() : fe_from(cc.one);
  }
  if (q_inf) R = P;
  return R;
}

// jac_double and jac_add dealt out over a thread group (group.cuh), for
// the window Horner. Doubling levels: X^2, Y^2, Z^2, (Y + Z)^2; then
// YY^2, (X + YY)^2 and M^2 (a = 0) or ZZ^2, a ZZ^2 (double-and-add when
// a is small) and M^2; then M (S - X3). Add levels: 5, 4, 3, 2, 2
// products. The selects of jac_add follow; its doubling lanes take the
// group doubling (a group's threads hold the same values, so they branch
// together). The values are those of jac_double / jac_add.
template <bool AZ, int G>
__device__ __forceinline__ Pt jac_double_grp(Grp<G>& gr, const Pt& P,
                                             const CurveConst& cc) {
  Fe ypz = fe_add(P.Y, P.Z, cc);
  Fe m[4];  // XX, YY, ZZ, (Y + Z)^2
  grp_mul<4>(gr, m, {P.X, P.Y, P.Z, ypz}, {P.X, P.Y, P.Z, ypz}, cc);
  Fe M = fe_add(fe_add(m[0], m[0], cc), m[0], cc);
  Fe xpyy = fe_add(P.X, m[1], cc);
  Fe n[3];  // YYYY, (X + YY)^2, and M^2 (a = 0) or ZZ^2
  Fe M2;
  if (AZ) {
    grp_mul<3>(gr, n, {m[1], xpyy, M}, {m[1], xpyy, M}, cc);
    M2 = n[2];
  } else {
    grp_mul<3>(gr, n, {m[1], xpyy, m[2]}, {m[1], xpyy, m[2]}, cc);
    M = fe_add(M, grp_mul_const(gr, n[2], cc.a_mont, cc.a_small, cc), cc);
    Fe q[1];
    grp_mul<1>(gr, q, {M}, {M}, cc);
    M2 = q[0];
  }
  Fe S = fe_sub(n[1], fe_add(m[0], n[0], cc), cc);
  S = fe_add(S, S, cc);
  Pt R;
  R.X = fe_sub(M2, fe_add(S, S, cc), cc);
  Fe r[1];
  grp_mul<1>(gr, r, {M}, {fe_sub(S, R.X, cc)}, cc);
  Fe e8 = fe_add(n[0], n[0], cc);
  e8 = fe_add(e8, e8, cc);
  e8 = fe_add(e8, e8, cc);
  R.Y = fe_sub(r[0], e8, cc);
  R.Z = fe_sub(m[3], fe_add(m[1], m[2], cc), cc);
  return R;
}

template <bool AZ, int G>
__device__ __forceinline__ Pt jac_add_grp(Grp<G>& gr, const Pt& P,
                                          const Pt& Q, const CurveConst& cc) {
  bool p_inf = fe_is_zero(P.Z);
  bool q_inf = fe_is_zero(Q.Z);
  Fe zpz = fe_add(P.Z, Q.Z, cc);
  Fe m[5];  // Z1Z1, Z2Z2, Y1 Z2, Y2 Z1, (Z1 + Z2)^2
  grp_mul<5>(gr, m, {P.Z, Q.Z, P.Y, Q.Y, zpz}, {P.Z, Q.Z, Q.Z, P.Z, zpz},
             cc);
  Fe n[4];  // U1, U2, S1, S2
  grp_mul<4>(gr, n, {P.X, Q.X, m[2], m[3]}, {m[1], m[0], m[1], m[0]}, cc);
  Fe H = fe_sub(n[1], n[0], cc);
  Fe rr0 = fe_sub(n[3], n[2], cc);
  bool x_eq = fe_is_zero(H);
  bool y_eq = fe_is_zero(rr0);
  Fe rr = fe_add(rr0, rr0, cc);
  Fe twoH = fe_add(H, H, cc);
  Fe w = fe_sub(m[4], fe_add(m[0], m[1], cc), cc);
  Fe q[3];  // I, rr^2, Z3
  grp_mul<3>(gr, q, {twoH, rr, w}, {twoH, rr, H}, cc);
  Fe s[2];  // J, V
  grp_mul<2>(gr, s, {H, n[0]}, {q[0], q[0]}, cc);
  Pt R;
  R.X = fe_sub(q[1], fe_add(s[0], fe_add(s[1], s[1], cc), cc), cc);
  Fe u[2];  // S1 J, rr (V - X3)
  grp_mul<2>(gr, u, {n[2], rr}, {s[0], fe_sub(s[1], R.X, cc)}, cc);
  R.Y = fe_sub(u[1], fe_add(u[0], u[0], cc), cc);
  R.Z = q[2];
  bool finite = !p_inf && !q_inf;
  if (x_eq && y_eq && finite) R = jac_double_grp<AZ>(gr, P, cc);
  if (x_eq && !y_eq && finite) R.Z = fe_zero();
  if (p_inf) R = Q;
  if (q_inf) R = P;
  return R;
}

// jac_madd dealt out over a thread group, for the v1 row scan
// (madd_scan_kernel). Levels: Z1^2, qy Z1 | U2, S2 | HH, I, rr^2,
// (Z1 + H)^2 | J, V | S1 J, rr (V - X3): 5 levels of at most 4 products,
// so a group of 4 waits on 5 product latencies against one thread's 12.
// The selects of jac_madd follow in its order; its doubling lanes take
// jac_double_grp. The values are those of jac_madd.
template <bool AZ, int G>
__device__ __forceinline__ Pt jac_madd_grp(Grp<G>& gr, const Pt& P,
                                           const Fe& qx, const Fe& qy,
                                           bool q_inf, const CurveConst& cc) {
  bool p_inf = fe_is_zero(P.Z);
  Fe m[2];  // Z1Z1, qy Z1
  grp_mul<2>(gr, m, {P.Z, qy}, {P.Z, P.Z}, cc);
  Fe n[2];  // U2, S2
  grp_mul<2>(gr, n, {qx, m[1]}, {m[0], m[0]}, cc);
  Fe H = fe_sub(n[0], P.X, cc);
  Fe rr0 = fe_sub(n[1], P.Y, cc);
  bool x_eq = fe_is_zero(H);
  bool y_eq = fe_is_zero(rr0);
  Fe rr = fe_add(rr0, rr0, cc);
  Fe twoH = fe_add(H, H, cc);
  Fe zph = fe_add(P.Z, H, cc);
  Fe q[4];  // HH, I, rr^2, (Z1 + H)^2
  grp_mul<4>(gr, q, {H, twoH, rr, zph}, {H, twoH, rr, zph}, cc);
  Fe s[2];  // J, V
  grp_mul<2>(gr, s, {H, P.X}, {q[1], q[1]}, cc);
  Pt R;
  R.X = fe_sub(q[2], fe_add(s[0], fe_add(s[1], s[1], cc), cc), cc);
  Fe u[2];  // S1 J, rr (V - X3)
  grp_mul<2>(gr, u, {P.Y, rr}, {s[0], fe_sub(s[1], R.X, cc)}, cc);
  R.Y = fe_sub(u[1], fe_add(u[0], u[0], cc), cc);
  R.Z = fe_sub(q[3], fe_add(m[0], q[0], cc), cc);
  bool finite = !p_inf && !q_inf;
  if (x_eq && y_eq && finite) R = jac_double_grp<AZ>(gr, P, cc);
  if (x_eq && !y_eq && finite) R.Z = fe_zero();
  if (p_inf) {
    R.X = qx;
    R.Y = qy;
    R.Z = q_inf ? fe_zero() : fe_from(cc.one);
  }
  if (q_inf) R = P;
  return R;
}
