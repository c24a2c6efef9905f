// Complete projective group law of Renes-Costello-Batina (EUROCRYPT 2016)
// on short-Weierstrass curves, homogeneous (X : Y : Z), identity
// (0 : R mod p : 0).
//
// Replaces the TPU kernel bodies _k_rcb_add, _k_rcb_madd and _k_rcb_double
// (ark_bulletproofs_tpu/ops/kernels.py), followed operation for operation:
// Alg 1/2/3 for general a (zorro, a = 6), Alg 7/8/9 for a = 0 (secq256k1).
// AZ selects the branch at compile time, so each kernel is instantiated
// once per branch and carries no dead registers for the other. The plain
// PyTorch versions are in ops/proj.py.
#pragma once
#include "field.cuh"
#include "group.cuh"

struct Pt {
  Fe X, Y, Z;
};

__device__ __forceinline__ Pt pt_identity(const CurveConst& cc) {
  Pt r;
  r.X = fe_zero();
  r.Y = fe_from(cc.one);
  r.Z = fe_zero();
  return r;
}

__device__ __forceinline__ Fe mul_b3(const Fe& x, const CurveConst& cc) {
  return fe_mul_const(x, cc.b3_mont, cc.b3_small, cc);
}

__device__ __forceinline__ Fe mul_a(const Fe& x, const CurveConst& cc) {
  return fe_mul_const(x, cc.a_mont, cc.a_small, cc);
}

__device__ __forceinline__ Fe times3(const Fe& x, const CurveConst& cc) {
  return fe_add(fe_add(x, x, cc), x, cc);
}

// P + Q (Alg 1 / Alg 7).
template <bool AZ>
__device__ __forceinline__ Pt rcb_add(const Pt& P, const Pt& Q,
                                      const CurveConst& cc) {
  Fe t0 = fe_mul(P.X, Q.X, cc);
  Fe t1 = fe_mul(P.Y, Q.Y, cc);
  Fe t2 = fe_mul(P.Z, Q.Z, cc);
  Fe t3 = fe_mul(fe_add(P.X, P.Y, cc), fe_add(Q.X, Q.Y, cc), cc);
  t3 = fe_sub(t3, fe_add(t0, t1, cc), cc);
  Fe t4 = fe_mul(fe_add(P.X, P.Z, cc), fe_add(Q.X, Q.Z, cc), cc);
  t4 = fe_sub(t4, fe_add(t0, t2, cc), cc);
  Fe t5 = fe_mul(fe_add(P.Y, P.Z, cc), fe_add(Q.Y, Q.Z, cc), cc);
  t5 = fe_sub(t5, fe_add(t1, t2, cc), cc);
  Pt R;
  if (AZ) {
    Fe X3 = mul_b3(t2, cc);
    Fe Z3 = fe_add(t1, X3, cc);
    t1 = fe_sub(t1, X3, cc);
    Fe Y3 = mul_b3(t4, cc);
    Fe t03 = times3(t0, cc);
    X3 = fe_mul(t5, Y3, cc);
    t2 = fe_mul(t3, t1, cc);
    X3 = fe_sub(t2, X3, cc);
    Y3 = fe_mul(Y3, t03, cc);
    t1 = fe_mul(t1, Z3, cc);
    Y3 = fe_add(t1, Y3, cc);
    t03 = fe_mul(t03, t3, cc);
    Z3 = fe_mul(Z3, t5, cc);
    Z3 = fe_add(Z3, t03, cc);
    R.X = X3;
    R.Y = Y3;
    R.Z = Z3;
  } else {
    Fe Z3 = mul_a(t4, cc);
    Fe X3 = mul_b3(t2, cc);
    Z3 = fe_add(X3, Z3, cc);
    X3 = fe_sub(t1, Z3, cc);
    Z3 = fe_add(t1, Z3, cc);
    Fe Y3 = fe_mul(X3, Z3, cc);
    t1 = times3(t0, cc);
    t2 = mul_a(t2, cc);
    t4 = mul_b3(t4, cc);
    t1 = fe_add(t1, t2, cc);
    t2 = fe_sub(t0, t2, cc);
    t2 = mul_a(t2, cc);
    t4 = fe_add(t4, t2, cc);
    t0 = fe_mul(t1, t4, cc);
    Y3 = fe_add(Y3, t0, cc);
    t0 = fe_mul(t5, t4, cc);
    X3 = fe_mul(t3, X3, cc);
    X3 = fe_sub(X3, t0, cc);
    t0 = fe_mul(t3, t1, cc);
    Z3 = fe_mul(t5, Z3, cc);
    Z3 = fe_add(Z3, t0, cc);
    R.X = X3;
    R.Y = Y3;
    R.Z = Z3;
  }
  return R;
}

// P + affine (qx, qy) (Alg 2 / Alg 8); q_inf passes P through.
template <bool AZ>
__device__ __forceinline__ Pt rcb_madd(const Pt& P, const Fe& qx,
                                       const Fe& qy, bool q_inf,
                                       const CurveConst& cc) {
  Fe t0 = fe_mul(P.X, qx, cc);
  Fe t1 = fe_mul(P.Y, qy, cc);
  Fe t3 = fe_mul(fe_add(qx, qy, cc), fe_add(P.X, P.Y, cc), cc);
  t3 = fe_sub(t3, fe_add(t0, t1, cc), cc);
  Fe t4 = fe_add(fe_mul(qx, P.Z, cc), P.X, cc);
  Fe t5 = fe_add(fe_mul(qy, P.Z, cc), P.Y, cc);
  Pt R;
  if (AZ) {
    Fe t03 = times3(t0, cc);
    Fe t2 = mul_b3(P.Z, cc);
    Fe Z3 = fe_add(t1, t2, cc);
    t1 = fe_sub(t1, t2, cc);
    Fe Y3 = mul_b3(t4, cc);
    Fe X3 = fe_mul(t5, Y3, cc);
    t2 = fe_mul(t3, t1, cc);
    X3 = fe_sub(t2, X3, cc);
    Y3 = fe_mul(Y3, t03, cc);
    t1 = fe_mul(t1, Z3, cc);
    Y3 = fe_add(t1, Y3, cc);
    t03 = fe_mul(t03, t3, cc);
    Z3 = fe_mul(Z3, t5, cc);
    Z3 = fe_add(Z3, t03, cc);
    R.X = X3;
    R.Y = Y3;
    R.Z = Z3;
  } else {
    Fe Z3 = mul_a(t4, cc);
    Fe X3 = mul_b3(P.Z, cc);
    Z3 = fe_add(X3, Z3, cc);
    X3 = fe_sub(t1, Z3, cc);
    Z3 = fe_add(t1, Z3, cc);
    Fe Y3 = fe_mul(X3, Z3, cc);
    t1 = times3(t0, cc);
    Fe t2 = mul_a(P.Z, cc);
    t4 = mul_b3(t4, cc);
    t1 = fe_add(t1, t2, cc);
    t2 = fe_sub(t0, t2, cc);
    t2 = mul_a(t2, cc);
    t4 = fe_add(t4, t2, cc);
    t0 = fe_mul(t1, t4, cc);
    Y3 = fe_add(Y3, t0, cc);
    t0 = fe_mul(t5, t4, cc);
    X3 = fe_mul(t3, X3, cc);
    X3 = fe_sub(X3, t0, cc);
    t0 = fe_mul(t3, t1, cc);
    Z3 = fe_mul(t5, Z3, cc);
    Z3 = fe_add(Z3, t0, cc);
    R.X = X3;
    R.Y = Y3;
    R.Z = Z3;
  }
  if (q_inf) return P;
  return R;
}

// 2P (Alg 3 / Alg 9).
template <bool AZ>
__device__ __forceinline__ Pt rcb_double(const Pt& P, const CurveConst& cc) {
  Pt R;
  if (AZ) {
    Fe t0 = fe_mul(P.Y, P.Y, cc);
    Fe Z3 = fe_add(t0, t0, cc);
    Z3 = fe_add(Z3, Z3, cc);
    Z3 = fe_add(Z3, Z3, cc);  // 8 Y^2
    Fe t1 = fe_mul(P.Y, P.Z, cc);
    Fe t2 = fe_mul(P.Z, P.Z, cc);
    t2 = mul_b3(t2, cc);
    Fe X3 = fe_mul(t2, Z3, cc);
    Fe Y3 = fe_add(t0, t2, cc);
    Z3 = fe_mul(t1, Z3, cc);
    t2 = times3(t2, cc);
    t0 = fe_sub(t0, t2, cc);
    Y3 = fe_mul(t0, Y3, cc);
    Y3 = fe_add(X3, Y3, cc);
    t1 = fe_mul(P.X, P.Y, cc);
    X3 = fe_mul(t0, t1, cc);
    X3 = fe_add(X3, X3, cc);
    R.X = X3;
    R.Y = Y3;
    R.Z = Z3;
  } else {
    Fe t0 = fe_mul(P.X, P.X, cc);
    Fe t1 = fe_mul(P.Y, P.Y, cc);
    Fe t2 = fe_mul(P.Z, P.Z, cc);
    Fe t3 = fe_mul(P.X, P.Y, cc);
    t3 = fe_add(t3, t3, cc);
    Fe Z3 = fe_mul(P.X, P.Z, cc);
    Z3 = fe_add(Z3, Z3, cc);
    Fe X3 = mul_a(Z3, cc);
    Fe Y3 = mul_b3(t2, cc);
    Y3 = fe_add(X3, Y3, cc);
    X3 = fe_sub(t1, Y3, cc);
    Y3 = fe_add(t1, Y3, cc);
    Y3 = fe_mul(X3, Y3, cc);
    X3 = fe_mul(t3, X3, cc);
    Z3 = mul_b3(Z3, cc);
    t2 = mul_a(t2, cc);
    t3 = fe_sub(t0, t2, cc);
    t3 = mul_a(t3, cc);
    t3 = fe_add(t3, Z3, cc);
    Z3 = fe_add(t0, t0, cc);
    t0 = fe_add(Z3, t0, cc);
    t0 = fe_add(t0, t2, cc);
    t0 = fe_mul(t0, t3, cc);
    Y3 = fe_add(Y3, t0, cc);
    t2 = fe_mul(P.Y, P.Z, cc);
    t2 = fe_add(t2, t2, cc);
    t0 = fe_mul(t2, t3, cc);
    X3 = fe_sub(X3, t0, cc);
    Z3 = fe_mul(t2, t1, cc);
    Z3 = fe_add(Z3, Z3, cc);
    Z3 = fe_add(Z3, Z3, cc);
    R.X = X3;
    R.Y = Y3;
    R.Z = Z3;
  }
  return R;
}

// The same laws dealt out over a thread group (group.cuh), for the window
// Horner: the products of one level of Alg 9 / 3 / 7 / 1 in one round, the
// adds on every thread. The values are those of rcb_double / rcb_add
// above (every field operation is exact and canonical, so their order and
// whether a small constant goes by double-and-add or by a product do not
// change a bit). Levels, a = 0: doubling 4 + 4 products, add 6 + 6; a != 0
// (a applied by double-and-add when small, 3b by products): doubling
// 6 + 4 + 5, add 6 + 4 + 6.

// The 6 products of Alg 1 / 7's first level, with t3, t4, t5 formed.
template <int G>
__device__ __forceinline__ void rcb_add_level1_grp(Grp<G>& gr, const Pt& P,
                                                   const Pt& Q, Fe (&t)[6],
                                                   const CurveConst& cc) {
  grp_mul<6>(gr, t,
             {P.X, P.Y, P.Z, fe_add(P.X, P.Y, cc), fe_add(P.X, P.Z, cc),
              fe_add(P.Y, P.Z, cc)},
             {Q.X, Q.Y, Q.Z, fe_add(Q.X, Q.Y, cc), fe_add(Q.X, Q.Z, cc),
              fe_add(Q.Y, Q.Z, cc)},
             cc);
  t[3] = fe_sub(t[3], fe_add(t[0], t[1], cc), cc);
  t[4] = fe_sub(t[4], fe_add(t[0], t[2], cc), cc);
  t[5] = fe_sub(t[5], fe_add(t[1], t[2], cc), cc);
}

template <bool AZ, int G>
__device__ __forceinline__ Pt rcb_add_grp(Grp<G>& gr, const Pt& P,
                                          const Pt& Q, const CurveConst& cc) {
  Fe t[6];
  rcb_add_level1_grp(gr, P, Q, t, cc);
  Fe n[6];
  Pt R;
  if (AZ) {
    Fe X3 = grp_mul_const(gr, t[2], cc.b3_mont, cc.b3_small, cc);
    Fe Z3 = fe_add(t[1], X3, cc);
    Fe t1 = fe_sub(t[1], X3, cc);
    Fe Y3 = grp_mul_const(gr, t[4], cc.b3_mont, cc.b3_small, cc);
    Fe t03 = times3(t[0], cc);
    grp_mul<6>(gr, n, {t[5], t[3], Y3, t1, t03, Z3},
               {Y3, t1, t03, Z3, t[3], t[5]}, cc);
    R.X = fe_sub(n[1], n[0], cc);
    R.Y = fe_add(n[3], n[2], cc);
    R.Z = fe_add(n[5], n[4], cc);
  } else {
    Fe k[4];  // a t4, 3b t2, a t2, 3b t4
    Fe a = fe_from(cc.a_mont), b3 = fe_from(cc.b3_mont);
    grp_mul<4>(gr, k, {t[4], t[2], t[2], t[4]}, {a, b3, a, b3}, cc);
    Fe Z3 = fe_add(k[1], k[0], cc);
    Fe X3 = fe_sub(t[1], Z3, cc);
    Z3 = fe_add(t[1], Z3, cc);
    Fe t1 = fe_add(times3(t[0], cc), k[2], cc);
    Fe t4 = fe_add(k[3], grp_mul_const(gr, fe_sub(t[0], k[2], cc),
                                       cc.a_mont, cc.a_small, cc),
                   cc);
    grp_mul<6>(gr, n, {X3, t1, t[5], t[3], t[3], t[5]},
               {Z3, t4, t4, X3, t1, Z3}, cc);
    R.X = fe_sub(n[3], n[2], cc);
    R.Y = fe_add(n[0], n[1], cc);
    R.Z = fe_add(n[5], n[4], cc);
  }
  return R;
}

template <bool AZ, int G>
__device__ __forceinline__ Pt rcb_double_grp(Grp<G>& gr, const Pt& P,
                                             const CurveConst& cc) {
  Pt R;
  if (AZ) {
    Fe m[4];  // Y^2, Y Z, Z^2, X Y
    grp_mul<4>(gr, m, {P.Y, P.Y, P.Z, P.X}, {P.Y, P.Z, P.Z, P.Y}, cc);
    Fe Z3 = fe_add(m[0], m[0], cc);
    Z3 = fe_add(Z3, Z3, cc);
    Z3 = fe_add(Z3, Z3, cc);  // 8 Y^2
    Fe t2 = grp_mul_const(gr, m[2], cc.b3_mont, cc.b3_small, cc);
    Fe Y3 = fe_add(m[0], t2, cc);
    Fe t0 = fe_sub(m[0], times3(t2, cc), cc);
    Fe n[4];
    grp_mul<4>(gr, n, {t2, m[1], t0, t0}, {Z3, Z3, Y3, m[3]}, cc);
    R.X = fe_add(n[3], n[3], cc);
    R.Y = fe_add(n[0], n[2], cc);
    R.Z = n[1];
  } else {
    Fe m[6];  // X^2, Y^2, Z^2, X Y, X Z, Y Z
    grp_mul<6>(gr, m, {P.X, P.Y, P.Z, P.X, P.X, P.Y},
               {P.X, P.Y, P.Z, P.Y, P.Z, P.Z}, cc);
    Fe t3 = fe_add(m[3], m[3], cc);
    Fe Z3 = fe_add(m[4], m[4], cc);
    Fe k[4];  // a Z3, 3b Z^2, 3b Z3, a Z^2
    Fe a = fe_from(cc.a_mont), b3 = fe_from(cc.b3_mont);
    grp_mul<4>(gr, k, {Z3, m[2], Z3, m[2]}, {a, b3, b3, a}, cc);
    Fe Y3 = fe_add(k[0], k[1], cc);
    Fe X3 = fe_sub(m[1], Y3, cc);
    Y3 = fe_add(m[1], Y3, cc);
    Fe t3b = fe_add(grp_mul_const(gr, fe_sub(m[0], k[3], cc), cc.a_mont,
                                  cc.a_small, cc),
                    k[2], cc);
    Fe t0 = fe_add(times3(m[0], cc), k[3], cc);
    Fe yz2 = fe_add(m[5], m[5], cc);
    Fe n[5];
    grp_mul<5>(gr, n, {X3, t3, t0, yz2, yz2}, {Y3, X3, t3b, t3b, m[1]}, cc);
    R.X = fe_sub(n[1], n[3], cc);
    R.Y = fe_add(n[0], n[2], cc);
    Fe Z = fe_add(n[4], n[4], cc);
    R.Z = fe_add(Z, Z, cc);
  }
  return R;
}

// Points in the boundary layout: coordinate c of a (3, rows, 16, L) array
// starts at base + c * rows * 16 * L.
__device__ __forceinline__ Pt pt_load(const int32_t* base, size_t rows,
                                      size_t row, size_t L, size_t lane) {
  size_t cs = rows * 16 * L;
  Pt r;
  r.X = fe_load(base, row, L, lane);
  r.Y = fe_load(base + cs, row, L, lane);
  r.Z = fe_load(base + 2 * cs, row, L, lane);
  return r;
}

__device__ __forceinline__ void pt_store(int32_t* base, size_t rows,
                                         size_t row, size_t L, size_t lane,
                                         const Pt& P) {
  size_t cs = rows * 16 * L;
  fe_store(base, row, L, lane, P.X);
  fe_store(base + cs, row, L, lane, P.Y);
  fe_store(base + 2 * cs, row, L, lane, P.Z);
}
