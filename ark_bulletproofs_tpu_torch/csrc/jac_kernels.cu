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
// point_kernels.cuh's double-k-add, Horner and doubling chain, and this
// file's row scan. The launchers follow msm_kernels.cu's conventions:
// extern "C", device pointers and the stream as void*, the curve
// constants as a pointer to 45 host words, cudaGetLastError() returned
// (cudaErrorInvalidValue, without a launch, for a twisted-Edwards curve).
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

// The v1 Pippenger's row scan in one launch: out[:, r] = P + sum_{j >= r}
// (qx, qy)[j] per lane, added from row R - 1 down to row 0 (the suffix
// order of the JAX package's lax.scan over sw_madd_tiled). P: (NC, 1, 16,
// m); qx, qy: (R, 16, m) affine Montgomery coordinates; q_inf: (R, m)
// bytes, a nonzero row adds the identity; out: (NC, R, 16, m). The
// accumulator stays in registers across the rows, each row's partial sum
// is stored as it is made, and the next row's point and flag, which do
// not depend on the chain, are loaded one add ahead.
//
// G = 1: one thread a lane (M::madd), the band of many lanes, where the
// card is bound by the products' instructions once enough warps hide
// their latency; __launch_bounds__ keeps M::MADD_MIN_BLOCKS blocks an SM
// resident. G > 1: a group of G threads a lane (M::gmadd, group.cuh),
// where few lanes leave the card idle and one thread would wait on each
// of the mixed add's 12 products in turn: the group waits on its 5 product
// levels; thread 0 stores.
template <class M, int G>
__global__ void __launch_bounds__(HG_THREADS,
                                  G == 1 ? M::MADD_MIN_BLOCKS : 1)
    madd_scan_kernel(const int32_t* __restrict__ P,
                     const int32_t* __restrict__ qx,
                     const int32_t* __restrict__ qy,
                     const uint8_t* __restrict__ q_inf,
                     int32_t* __restrict__ out, int64_t R, int64_t m,
                     CurveConst cc) {
  __shared__ uint4 slots[G == 1 ? 1 : HG_THREADS / G][4 * GRP_SLOTS];
  const int tid = threadIdx.x;
  const size_t lane = ((size_t)blockIdx.x * HG_THREADS + tid) / G;
  if (lane >= (size_t)m) return;  // whole groups only: HG_THREADS % G == 0
  Grp<G> gr = grp_of<G>(slots, tid);
  typename M::P acc = M::load(P, 1, 0, m, lane);
  Fe nx = fe_load(qx, R - 1, m, lane);
  Fe ny = fe_load(qy, R - 1, m, lane);
  bool ni = q_inf[(size_t)(R - 1) * m + lane] != 0;
  for (int64_t r = R - 1; r >= 0; --r) {
    Fe x = nx, y = ny;
    bool inf = ni;
    const int64_t r1 = r > 0 ? r - 1 : 0;
    nx = fe_load(qx, r1, m, lane);
    ny = fe_load(qy, r1, m, lane);
    ni = q_inf[(size_t)r1 * m + lane] != 0;
    if constexpr (G == 1)
      acc = M::madd(acc, x, y, inf, cc);
    else
      acc = M::template gmadd<G>(gr, acc, x, y, inf, cc);
    if (gr.g == 0) M::store(out, R, r, m, lane, acc);
  }
}

// The row scan: a group of M::MADD_GRP threads a lane below
// M::MADD_GROUP2_MIN_LANES lanes, of 2 below M::MADD_ONE_THREAD_MIN_LANES,
// one thread a lane from it.
template <class M>
static void launch_madd_scan(const void* P, const void* qx, const void* qy,
                             const void* q_inf, void* out, int64_t R,
                             int64_t m, const CurveConst& cc,
                             cudaStream_t s) {
  constexpr int G = M::MADD_GRP;
  static_assert(HG_THREADS % G == 0 && 32 % G == 0, "group size");
  const int32_t* p = (const int32_t*)P;
  const int32_t* x = (const int32_t*)qx;
  const int32_t* y = (const int32_t*)qy;
  const uint8_t* inf = (const uint8_t*)q_inf;
  int32_t* o = (int32_t*)out;
  if (m >= M::MADD_ONE_THREAD_MIN_LANES)
    madd_scan_kernel<M, 1><<<group_blocks(m, 1), HG_THREADS, 0, s>>>(
        p, x, y, inf, o, R, m, cc);
  else if (m >= M::MADD_GROUP2_MIN_LANES)
    madd_scan_kernel<M, 2><<<group_blocks(m, 2), HG_THREADS, 0, s>>>(
        p, x, y, inf, o, R, m, cc);
  else
    madd_scan_kernel<M, G><<<group_blocks(m, G), HG_THREADS, 0, s>>>(
        p, x, y, inf, o, R, m, cc);
}

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
