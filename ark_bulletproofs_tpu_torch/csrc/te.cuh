// Unified twisted-Edwards group law (Hisil-Wong-Carter-Dawson, ASIACRYPT
// 2008) on extended coordinates (X : Y : T : Z), T = XY / Z, identity
// (0 : R : 0 : R) -- the ordinary affine point (0, 1).
//
// Replaces the TPU kernel bodies _k_te_add, _k_te_madd and _k_te_double
// (ark_bulletproofs_tpu/ops/kernels.py), followed operation for operation,
// and through them the elementwise kernels te_add_tiled, te_double_tiled,
// te_double_k_add_tiled and te_madd_tiled (here the v1 row scan over it). One formula covers the identity
// and doubling (complete for curve25519's a and d, the host model's law,
// curves/models.py::TECurve.proj_add). a and d are applied as full
// Montgomery products (the JAX package's _k_mul_const(..., None)). The
// plain PyTorch versions are in ops/proj.py (_te_add_core, _te_add_mixed).
//
// Cost: 11 field products for an add, a mixed add (T2 = x y is the
// eleventh) or a doubling, against 12 / 11 / 8 for the a = 0 RCB law. A
// point is 4 x 8 words, one more coordinate than RCB, so the running point
// of a scan holds 32 registers.
#pragma once
#include "field.cuh"
#include "group.cuh"

struct Pt4 {
  Fe X, Y, T, Z;
};

__device__ __forceinline__ Pt4 te_identity(const CurveConst& cc) {
  Pt4 r;
  r.X = fe_zero();
  r.Y = fe_from(cc.one);
  r.T = fe_zero();
  r.Z = fe_from(cc.one);
  return r;
}

// P + (X2 : Y2 : T2 : Z2); Z2_ONE stands for Z2 = 1 (D = Z1, one product
// less), as _k_te_add with Q[3] = None.
template <bool Z2_ONE>
__device__ __forceinline__ Pt4 te_add_core(const Pt4& P, const Fe& X2,
                                           const Fe& Y2, const Fe& T2,
                                           const Fe& Z2,
                                           const CurveConst& cc) {
  Fe A = fe_mul(P.X, X2, cc);
  Fe B = fe_mul(P.Y, Y2, cc);
  Fe C = fe_mul(fe_mul(P.T, T2, cc), fe_from(cc.d_mont), cc);
  Fe D = Z2_ONE ? P.Z : fe_mul(P.Z, Z2, cc);
  Fe E = fe_sub(fe_mul(fe_add(P.X, P.Y, cc), fe_add(X2, Y2, cc), cc),
                fe_add(A, B, cc), cc);
  Fe F = fe_sub(D, C, cc);
  Fe G = fe_add(D, C, cc);
  Fe H = fe_sub(B, fe_mul(A, fe_from(cc.a_mont), cc), cc);
  Pt4 R;
  R.X = fe_mul(E, F, cc);
  R.Y = fe_mul(G, H, cc);
  R.T = fe_mul(E, H, cc);
  R.Z = fe_mul(F, G, cc);
  return R;
}

__device__ __forceinline__ Pt4 te_add(const Pt4& P, const Pt4& Q,
                                      const CurveConst& cc) {
  return te_add_core<false>(P, Q.X, Q.Y, Q.T, Q.Z, cc);
}

// P + affine (qx, qy), T2 = qx qy computed here; q_inf passes P through
// (an identity row of the affine input has y = 0: a point with y = 0 has
// order 4 and is never in the prime-order subgroup).
__device__ __forceinline__ Pt4 te_madd(const Pt4& P, const Fe& qx,
                                       const Fe& qy, bool q_inf,
                                       const CurveConst& cc) {
  Fe t2 = fe_mul(qx, qy, cc);
  Pt4 R = te_add_core<true>(P, qx, qy, t2, qx, cc);
  if (q_inf) return P;
  return R;
}

// 2P as the unified add(P, P) (_k_te_double).
__device__ __forceinline__ Pt4 te_double(const Pt4& P, const CurveConst& cc) {
  return te_add(P, P, cc);
}

// te_add dealt out over a thread group (group.cuh), for the window
// Horner: its products in three levels of 5, 2 and 4 (A, B, T1 T2, Z1 Z2,
// (X1 + Y1)(X2 + Y2); C = T1 T2 d and a A; the four outputs), the adds on
// every thread. The values are te_add's; a doubling is this add of P and P.
template <int G>
__device__ __forceinline__ Pt4 te_add_grp(Grp<G>& gr, const Pt4& P,
                                          const Pt4& Q, const CurveConst& cc) {
  Fe m[5];
  grp_mul<5>(gr, m, {P.X, P.Y, P.T, P.Z, fe_add(P.X, P.Y, cc)},
             {Q.X, Q.Y, Q.T, Q.Z, fe_add(Q.X, Q.Y, cc)}, cc);
  Fe k[2];
  grp_mul<2>(gr, k, {m[2], m[0]}, {fe_from(cc.d_mont), fe_from(cc.a_mont)},
             cc);
  Fe E = fe_sub(m[4], fe_add(m[0], m[1], cc), cc);
  Fe F = fe_sub(m[3], k[0], cc);
  Fe Gs = fe_add(m[3], k[0], cc);
  Fe H = fe_sub(m[1], k[1], cc);
  Fe n[4];
  grp_mul<4>(gr, n, {E, Gs, E, F}, {F, H, H, Gs}, cc);
  Pt4 R;
  R.X = n[0];
  R.Y = n[1];
  R.T = n[2];
  R.Z = n[3];
  return R;
}

// te_madd dealt out over a thread group (group.cuh), for the v1 row scan
// (madd_scan_kernel, point_kernels.cuh): t2 = qx qy, which depends on the
// row alone, comes in computed one add ahead, so the chain waits on three
// product levels: A = X1 qx, B = Y1 qy, T1 t2, (X1 + Y1)(qx + qy); then
// C = (T1 t2) d and a A, beside which the group computes the next row's
// t2 (nqx nqy into nt2), a level with a free thread at G = 4; then the
// four outputs (D = Z1: no fourth product in the first level). Every
// thread takes part in every level whatever q_inf says; the select comes
// after them. The values are te_madd's.
template <int G>
__device__ __forceinline__ Pt4 te_madd_grp(Grp<G>& gr, const Pt4& P,
                                           const Fe& qx, const Fe& qy,
                                           const Fe& t2, bool q_inf,
                                           const Fe& nqx, const Fe& nqy,
                                           Fe& nt2, const CurveConst& cc) {
  Fe m[4];
  grp_mul<4>(gr, m, {P.X, P.Y, P.T, fe_add(P.X, P.Y, cc)},
             {qx, qy, t2, fe_add(qx, qy, cc)}, cc);
  Fe k[3];
  grp_mul<3>(gr, k, {m[2], m[0], nqx},
             {fe_from(cc.d_mont), fe_from(cc.a_mont), nqy}, cc);
  nt2 = k[2];
  Fe E = fe_sub(m[3], fe_add(m[0], m[1], cc), cc);
  Fe F = fe_sub(P.Z, k[0], cc);
  Fe Gs = fe_add(P.Z, k[0], cc);
  Fe H = fe_sub(m[1], k[1], cc);
  Fe n[4];
  grp_mul<4>(gr, n, {E, Gs, E, F}, {F, H, H, Gs}, cc);
  if (q_inf) return P;
  Pt4 R;
  R.X = n[0];
  R.Y = n[1];
  R.T = n[2];
  R.Z = n[3];
  return R;
}

// Points in the boundary layout: coordinate c of a (4, rows, 16, L) array
// starts at base + c * rows * 16 * L.
__device__ __forceinline__ Pt4 pt4_load(const int32_t* base, size_t rows,
                                        size_t row, size_t L, size_t lane) {
  size_t cs = rows * 16 * L;
  Pt4 r;
  r.X = fe_load(base, row, L, lane);
  r.Y = fe_load(base + cs, row, L, lane);
  r.T = fe_load(base + 2 * cs, row, L, lane);
  r.Z = fe_load(base + 3 * cs, row, L, lane);
  return r;
}

__device__ __forceinline__ void pt4_store(int32_t* base, size_t rows,
                                          size_t row, size_t L, size_t lane,
                                          const Pt4& P) {
  size_t cs = rows * 16 * L;
  fe_store(base, row, L, lane, P.X);
  fe_store(base + cs, row, L, lane, P.Y);
  fe_store(base + 2 * cs, row, L, lane, P.T);
  fe_store(base + 3 * cs, row, L, lane, P.Z);
}
