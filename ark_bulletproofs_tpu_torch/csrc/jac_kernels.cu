// The group-law kernels on Jacobian short-Weierstrass points (jac.cuh),
// for Hopper (sm_90a): the on-device Fiat-Shamir IPA's Q terms
// (ops/ipa.py) and the v1 Pippenger MSM (ops/msm.py).
//
// Replaces the TPU kernels:
//   jac_double_k_add  <- ark_bulletproofs_tpu/ops/kernels.py::sw_add_tiled
//                        (k = 0) and ::sw_double_k_add_tiled (k > 0)
//   jac_double        <- ark_bulletproofs_tpu/ops/kernels.py::sw_double_tiled
//                        (and the JAX package's scan of it over a 2^i Q
//                        table: a chain of doublings in one launch)
//   jac_madd          <- ark_bulletproofs_tpu/ops/kernels.py::sw_madd_tiled
//                        (and the v1 Pippenger's scan of it over its rows:
//                        the row scan in one launch)
//   jac_horner        <- ark_bulletproofs_tpu/ops/kernels2.py::horner_windows
//                        on Jacobian points
//
// JacModel<AZ> (a = 0: secq256k1; general a: zorro) instantiates
// point_kernels.cuh's double-k-add, Horner, doubling chain and row scan.
// The launchers follow msm_kernels.cu's conventions: extern "C", device
// pointers and the stream as void*, the curve constants as a pointer to
// 45 host words, cudaGetLastError() returned (cudaErrorInvalidValue,
// without a launch, for a twisted-Edwards curve).
#include "jac.cuh"
#include "point_kernels.cuh"

// Jacobian short-Weierstrass points (X, Y, Z) = (x Z^2, y Z^3), identity
// (0, 0, 0), not RCB's (0, R, 0).
template <bool AZ>
struct JacModel {
  using P = Pt;
  static __device__ __forceinline__ P identity(const CurveConst&) {
    return jac_identity();
  }
  static __device__ __forceinline__ P add(const P& a, const P& b,
                                          const CurveConst& cc) {
    return jac_add<AZ>(a, b, cc);
  }
  static __device__ __forceinline__ P madd(const P& a, const Fe& qx,
                                           const Fe& qy, bool q_inf,
                                           const CurveConst& cc) {
    return jac_madd<AZ>(a, qx, qy, q_inf, cc);
  }
  static __device__ __forceinline__ P dbl(const P& a, const CurveConst& cc) {
    return jac_double<AZ>(a, cc);
  }
  // The Horner's and jac_double's chain's group: doubling levels of 4, 3,
  // 1 (and 1, 1 on a != 0).
  static constexpr int GRP = 4;
  // jac_double_k_add's group: add levels of 5, 4, 3, 2, 2 products.
  static constexpr int ADD_GRP = 8;
  // jac_double_k_add's bands, as RcbModel's; its one-thread band runs
  // double_k_add_kernel.
  static constexpr int64_t DKA_GROUP4_MIN_LANES = 4096;
  static constexpr int64_t DKA_ONE_THREAD_MIN_LANES = 24576;
  static constexpr bool DKA_WIDE = false;
  // jac_madd's row scan (launch_madd_scan; ops/kernels.py mirrors the
  // edges in MADD_BANDS, tests/test_torch_msm_plan.py ties the two): a
  // group of MADD_GRP threads a lane (mixed-add levels of 2, 2, 4, 2, 2
  // products) below MADD_GROUP2_MIN_LANES lanes, of 2 below
  // MADD_ONE_THREAD_MIN_LANES, one thread a lane from it under launch
  // bounds that keep MADD_MIN_BLOCKS blocks an SM resident. On the H100 at
  // 32 rows a group of 4 took 0.142-0.170 ms at 1-4,096 lanes (one thread
  // 0.249-0.382, a group of 2 0.152-0.199, of 8 0.155-0.288), a group of
  // 2 0.207-0.579 ms at 8,192-32,768 (4: 0.262-0.970; one thread:
  // 0.395-0.602), one thread from 65,536 lanes. Its resident blocks are
  // the most that ptxas fits without a spill: 3 (168 registers) on a = 0,
  // which beat 1, 2 and 4 at the paths' 98,304 lanes; 2 (210) on zorro,
  // whose add spills 8 bytes at 3 (PERF.md, bench_kernels.py).
  static constexpr int MADD_GRP = 4;
  static constexpr int64_t MADD_GROUP2_MIN_LANES = 8192;
  static constexpr int64_t MADD_ONE_THREAD_MIN_LANES = 65536;
  static constexpr int MADD_MIN_BLOCKS = AZ ? 3 : 2;
  // The mixed add reads nothing of a row computed ahead (TeModel's t2).
  static constexpr bool MADD_AHEAD = false;
  // The doubling chain keeps its group at every lane count.
  static constexpr bool DBL_WIDE = false;
  template <int G>
  static __device__ __forceinline__ P gadd(Grp<G>& gr, const P& a,
                                           const P& b, const CurveConst& cc) {
    return jac_add_grp<AZ>(gr, a, b, cc);
  }
  template <int G>
  static __device__ __forceinline__ P gdbl(Grp<G>& gr, const P& a,
                                           const CurveConst& cc) {
    return jac_double_grp<AZ>(gr, a, cc);
  }
  template <int G>
  static __device__ __forceinline__ P gmadd(Grp<G>& gr, const P& a,
                                            const Fe& qx, const Fe& qy,
                                            bool q_inf, const CurveConst& cc) {
    return jac_madd_grp<AZ>(gr, a, qx, qy, q_inf, cc);
  }
  static __device__ __forceinline__ P load(const int32_t* base, size_t rows,
                                           size_t row, size_t L,
                                           size_t lane) {
    return pt_load(base, rows, row, L, lane);
  }
  static __device__ __forceinline__ void store(int32_t* base, size_t rows,
                                               size_t row, size_t L,
                                               size_t lane, const P& a) {
    pt_store(base, rows, row, L, lane, a);
  }
};

// 2^k P + Q on Jacobian points (k = 0: sw_add_tiled's complete add).
extern "C" int abtpu_jac_double_k_add(const void* P, const void* Q, void* out,
                                      int64_t m, int32_t k, const void* words,
                                      void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    launch_double_k_add<JacModel<true>>(P, Q, out, m, k, cc, s);
  else
    launch_double_k_add<JacModel<false>>(P, Q, out, m, k, cc, s);
  return (int)cudaGetLastError();
}

// `steps` doublings of Jacobian points (sw_double_tiled), each stored:
// the (NC, 16, steps + keep, m) table of double_chain_kernel.
extern "C" int abtpu_jac_double(const void* P, void* out, int64_t m,
                                int32_t steps, int32_t keep,
                                const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    launch_double_chain<JacModel<true>>(P, out, m, steps, keep, cc, s);
  else
    launch_double_chain<JacModel<false>>(P, out, m, steps, keep, cc, s);
  return (int)cudaGetLastError();
}

// P + the suffix sums of R rows of affine Q on Jacobian points
// (sw_madd_tiled, scanned over the rows; R = 1: the elementwise add).
extern "C" int abtpu_jac_madd(const void* P, const void* qx, const void* qy,
                              const void* q_inf, void* out, int64_t R,
                              int64_t m, const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    launch_madd_scan<JacModel<true>>(P, qx, qy, q_inf, out, R, m, cc, s);
  else
    launch_madd_scan<JacModel<false>>(P, qx, qy, q_inf, out, R, m, cc, s);
  return (int)cudaGetLastError();
}

// The same Horner on Jacobian points (the v1 Pippenger's window sums on a
// short-Weierstrass curve).
extern "C" int abtpu_jac_horner(const void* parts, const void* acc0,
                                void* out, int64_t B, int64_t W, int64_t Ws,
                                int32_t c, const void* words,
                                void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    launch_horner<JacModel<true>>(parts, acc0, out, B, W, Ws, c, cc, s);
  else
    launch_horner<JacModel<false>>(parts, acc0, out, B, W, Ws, c, cc, s);
  return (int)cudaGetLastError();
}
