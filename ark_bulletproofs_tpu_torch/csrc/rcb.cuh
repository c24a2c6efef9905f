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
