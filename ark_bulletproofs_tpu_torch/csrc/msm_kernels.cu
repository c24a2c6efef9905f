// The group-law kernels on RCB projective and twisted-Edwards extended
// points: the v2 Pippenger MSM (ops/msm2.py) and the device Pedersen batch
// (ops/prove.py), for Hopper (sm_90a). The Jacobian kernels are in
// jac_kernels.cu; the double-k-add, the Horner, the doubling chain and
// the v1 row scan, which both files instantiate, in point_kernels.cuh.
//
// Replaces the TPU kernels:
//   suffix_madd_scan  <- ark_bulletproofs_tpu/ops/kernels2.py::suffix_madd_scan
//                        (its TE body: ops/kernels.py::te_madd_tiled's)
//   suffix_jac_scan   <- ark_bulletproofs_tpu/ops/kernels2.py::suffix_jac_scan
//   rowsum            <- ark_bulletproofs_tpu/ops/kernels2.py::rowsum_jac
//   rcb_double_k_add  <- ark_bulletproofs_tpu/ops/kernels.py::rcb_double_k_add_tiled
//                        and, with k = 0, ::rcb_add_tiled
//   te_double_k_add   <- ark_bulletproofs_tpu/ops/kernels.py::te_double_k_add_tiled
//                        and, with k = 0, ::te_add_tiled
//   te_double         <- ark_bulletproofs_tpu/ops/kernels.py::te_double_tiled
//                        (and the JAX package's scan of it over a 2^i Q
//                        table: a chain of doublings in one launch)
//   rcb_double        <- ark_bulletproofs_tpu/ops/kernels.py::rcb_double_tiled
//                        (the doubling chain at one step: a group of
//                        RcbModel::GRP threads a lane, one thread from
//                        DBL_ONE_THREAD_MIN_LANES lanes)
//   te_madd           <- ark_bulletproofs_tpu/ops/kernels.py::te_madd_tiled
//                        (and the v1 Pippenger's scan of it over its rows:
//                        the row scan of point_kernels.cuh in one launch;
//                        the body also runs in the TE suffix_madd_scan)
//   horner            <- ark_bulletproofs_tpu/ops/kernels2.py::horner_windows
//                        (RCB, and here also TE extended points)
//
// Each kernel is a template over a point model: RcbModel<true> (RCB, a = 0:
// secq256k1), RcbModel<false> (RCB, general a: zorro) and TeModel (HWCD
// extended: curve25519). The launchers pick it from the constants (te,
// a_zero), so each kernel is compiled once per model and carries no dead
// registers of another. A 3-coordinate model reads and writes (3, rows,
// 16, L) arrays, TeModel (4, rows, 16, L).
//
// Design of the scans: one thread per lane (stages D and F below their
// crossover: a group of threads, see below), the running point in
// registers. On the TPU the row loop was the grid's sequential dimension
// with a VMEM scratch carry; on Hopper blocks run in no order, so the loop
// over rows moves into the thread. Lanes are columns of independent sums,
// so no block needs another's result.
//
// What bounds the scans: integer multiply throughput, once enough chains
// run at a time to hide each product's latency. One mixed add is 11
// Montgomery products (csrc/field.cuh) against 2 x 64 bytes read and 3 x 64
// bytes written; at the n = 2^20 MSM the scan reads 2.9 GB and writes
// 4.4 GB, about 2.2 ms of HBM time against 4.0 ms of multiplies. The loads
// and stores are limb-major, so the 32 threads of a warp touch 32
// consecutive int32 (one 128-byte line) per limb. The scan's parallelism is
// its lane count, a plan choice (ops/msm2.py::plan_columns): the JAX plan's
// 22,528 lanes at n = 2^20 were 176 blocks of 128 on 132 SMs, one or two
// warps a scheduler, which cannot hide the multiply-carry latency. The
// port's plan doubles the columns while the lanes under-fill the card:
// 90,112 lanes, 704 blocks against 396 resident at 3 blocks an SM
// (__launch_bounds__(128, 3): at most 170 registers, no spill; at 4 the
// RCB a = 0 scan spills).
//
// Stages D and F (suffix_jac_scan, rowsum) are chains of complete adds,
// one a lane, in the JAX kernels' row order (which fixes the projective
// coordinates the tests hold bit for bit, so no tree over the rows), on
// few lanes: 64 rows of 1,408 and of 22 lanes at n = 2^20, 16 or 1 row of
// 64 to 1,024 at n = 256. One thread a lane waits about 9 us an add on
// its 11 or 12 products, with the card nearly idle. So a group of
// M::ADD_GRP = 8 threads shares each lane's chain as in the Horner
// (point_kernels.cuh): an add costs its product levels (2 on RCB a = 0, 3
// on zorro and HWCD, each level one product at G = 8) plus the field adds
// every thread repeats, 2.6 to 4.4 us an add on the H100. G = 8 beat G = 4
// at every shape of the one-set MSMs; G = 4 was faster only at 16 x 8,192,
// a B = 128 batch's level B (PERF.md, PR 8). The row a chain adds next
// does not depend on it and is loaded one add ahead. From
// CHAIN_ONE_THREAD_MIN_LANES lanes the card is throughput-bound and the
// G-fold repeated adds lose: at 16 rows of 131,072 lanes one thread a
// lane took 1.03 ms against the group's 2.17 (RCB a = 0), and the
// on-device Fiat-Shamir IPA's table shrink (1024 sets at n = 256) sends
// stage D 16 rows of 1,048,576.
//
// A TE point is 4 x 8 words against 3 x 8: the TE scans write a third
// more bytes (5.9 GB at the n = 2^20 shape) for the same 11 products a
// mixed add.
//
// Each launcher is extern "C", takes device pointers and the stream as
// void*, the curve constants as a pointer to 45 host words, and returns
// cudaGetLastError() (cudaErrorInvalidValue, without a launch, for a
// curve of the wrong model).
#include "point_kernels.cuh"
#include "rcb.cuh"
#include "te.cuh"

// suffix_madd_scan: SCAN_THREADS a block and at least SCAN_MIN_BLOCKS
// resident on an SM (see the note above). ops/msm2.py's column plan reads
// both (tests/test_torch_msm_plan.py ties them).
#define SCAN_THREADS 128
#define SCAN_MIN_BLOCKS 3
// Stages D and F: from this many lanes on, one thread runs each lane's
// chain; below it a group of M::ADD_GRP threads (see the note above;
// ops/kernels2.py mirrors it, tests/test_torch_msm_plan.py ties the two).
#define CHAIN_ONE_THREAD_MIN_LANES 16384

template <bool AZ>
struct RcbModel {
  using P = Pt;
  static __device__ __forceinline__ P identity(const CurveConst& cc) {
    return pt_identity(cc);
  }
  static __device__ __forceinline__ P add(const P& a, const P& b,
                                          const CurveConst& cc) {
    return rcb_add<AZ>(a, b, cc);
  }
  static __device__ __forceinline__ P madd(const P& a, const Fe& qx,
                                           const Fe& qy, bool q_inf,
                                           const CurveConst& cc) {
    return rcb_madd<AZ>(a, qx, qy, q_inf, cc);
  }
  static __device__ __forceinline__ P dbl(const P& a, const CurveConst& cc) {
    return rcb_double<AZ>(a, cc);
  }
  static constexpr int GRP = AZ ? 4 : 8;  // the widest level: 4, or 6
  // An add-only chain (stages D and F): add levels of 6 + 6, or 6 + 4 + 6.
  static constexpr int ADD_GRP = 8;
  // rcb_double_k_add's bands (launch_double_k_add; ops/kernels.py mirrors
  // them, tests/test_torch_msm_plan.py ties the two): the same for both
  // branches on the H100.
  static constexpr int64_t DKA_GROUP4_MIN_LANES = 8192;
  static constexpr int64_t DKA_ONE_THREAD_MIN_LANES = 16384;
  static constexpr bool DKA_WIDE = true;
  // double_k_add_wide_kernel's blocks an SM keeps resident at k = 0: 3
  // (at most 168 registers) for a = 0; 5 (at most 102) for a != 0, which
  // ptxas fits in 96 with no spill.
  static constexpr int DKA_MIN_BLOCKS = AZ ? 3 : 5;
  // rcb_double's band (launch_double_chain at one step; ops/kernels.py
  // mirrors the edge in DBL_BANDS, tests/test_torch_msm_plan.py ties the
  // two): a group of GRP threads a lane (doubling levels of 4 + 4
  // products, or 6 + 4 + 5) below DBL_ONE_THREAD_MIN_LANES lanes, one
  // thread a lane from it (double_wide_kernel) under launch bounds that
  // keep DBL_MIN_BLOCKS blocks an SM resident: the most that ptxas fits
  // without a spill (96 registers on both branches; at 6, a = 0 spills 16
  // bytes and zorro 60). On the H100 the group took 3.8-5.3 us at 1-8,192
  // lanes on a = 0 (the parent's one thread 6.8-7.6), 5.0-11.0 on zorro
  // (11.0-11.6); one thread a lane is as fast from 16,384 lanes on a = 0
  // and faster on zorro (PERF.md, bench_kernels.py).
  static constexpr bool DBL_WIDE = true;
  static constexpr int64_t DBL_ONE_THREAD_MIN_LANES = 16384;
  static constexpr int DBL_MIN_BLOCKS = 5;
  template <int G>
  static __device__ __forceinline__ P gadd(Grp<G>& gr, const P& a,
                                           const P& b, const CurveConst& cc) {
    return rcb_add_grp<AZ>(gr, a, b, cc);
  }
  template <int G>
  static __device__ __forceinline__ P gdbl(Grp<G>& gr, const P& a,
                                           const CurveConst& cc) {
    return rcb_double_grp<AZ>(gr, a, cc);
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

struct TeModel {
  using P = Pt4;
  static __device__ __forceinline__ P identity(const CurveConst& cc) {
    return te_identity(cc);
  }
  static __device__ __forceinline__ P add(const P& a, const P& b,
                                          const CurveConst& cc) {
    return te_add(a, b, cc);
  }
  static __device__ __forceinline__ P madd(const P& a, const Fe& qx,
                                           const Fe& qy, bool q_inf,
                                           const CurveConst& cc) {
    return te_madd(a, qx, qy, q_inf, cc);
  }
  static __device__ __forceinline__ P dbl(const P& a, const CurveConst& cc) {
    return te_double(a, cc);
  }
  // The Horner's and te_double's chain's group: levels of 5, 2 and 4
  // products.
  static constexpr int GRP = 8;
  static constexpr int ADD_GRP = 8;  // the same levels in an add-only chain
  // te_double_k_add's bands, as RcbModel's.
  static constexpr int64_t DKA_GROUP4_MIN_LANES = 4096;
  static constexpr int64_t DKA_ONE_THREAD_MIN_LANES = 16384;
  static constexpr bool DKA_WIDE = true;
  static constexpr int DKA_MIN_BLOCKS = 3;
  // te_madd's row scan (launch_madd_scan; ops/kernels.py mirrors the
  // edges in MADD_BANDS, tests/test_torch_msm_plan.py ties the two): a
  // group of MADD_GRP threads a lane (te_madd_grp: levels of 4, 3 and 4
  // products, the next row's t2 in the second) below MADD_GROUP2_MIN_LANES
  // lanes, of 2 below MADD_ONE_THREAD_MIN_LANES, one thread a lane from it
  // under launch bounds that keep MADD_MIN_BLOCKS blocks an SM resident.
  // On the H100 at 32 rows a group of 4 took 0.091-0.146 ms at 1-8,192
  // lanes (the parent's launch and copy a row 0.281-0.402; a group of 8
  // 0.093-0.271, of 2 0.134-0.168, one thread 0.224-0.279), a group of 2
  // 0.251-0.700 ms at 16,384-49,152 (4: 0.285-0.771), and from 65,536
  // one thread and a group of 2 are within 4%. Its resident blocks: 2,
  // which leave ptxas the 190 registers it takes; 3 (168 registers, no
  // spill) cost up to 20% at 65,536 lanes (a wave tail), 4 spill
  // (PERF.md, bench_kernels.py).
  static constexpr int MADD_GRP = 4;
  static constexpr int64_t MADD_GROUP2_MIN_LANES = 16384;
  static constexpr int64_t MADD_ONE_THREAD_MIN_LANES = 65536;
  static constexpr int MADD_MIN_BLOCKS = 2;
  static constexpr bool MADD_AHEAD = true;  // t2 = qx qy of the next row
  // The doubling chain keeps its group at every lane count.
  static constexpr bool DBL_WIDE = false;
  template <int G>
  static __device__ __forceinline__ P gadd(Grp<G>& gr, const P& a,
                                           const P& b, const CurveConst& cc) {
    return te_add_grp(gr, a, b, cc);
  }
  template <int G>
  static __device__ __forceinline__ P gdbl(Grp<G>& gr, const P& a,
                                           const CurveConst& cc) {
    return te_add_grp(gr, a, a, cc);
  }
  template <int G>
  static __device__ __forceinline__ P gmadd(Grp<G>& gr, const P& a,
                                            const Fe& qx, const Fe& qy,
                                            const Fe& t2, bool q_inf,
                                            const Fe& nqx, const Fe& nqy,
                                            Fe& nt2, const CurveConst& cc) {
    return te_madd_grp(gr, a, qx, qy, t2, q_inf, nqx, nqy, nt2, cc);
  }
  static __device__ __forceinline__ P load(const int32_t* base, size_t rows,
                                           size_t row, size_t L,
                                           size_t lane) {
    return pt4_load(base, rows, row, L, lane);
  }
  static __device__ __forceinline__ void store(int32_t* base, size_t rows,
                                               size_t row, size_t L,
                                               size_t lane, const P& a) {
    pt4_store(base, rows, row, L, lane, a);
  }
};

using RcbA0 = RcbModel<true>;
using RcbA = RcbModel<false>;

// out[:, r] = sum_{r' >= r} (x, y)[r'] per lane, scanned from the last row
// up. xy: (2, R, 16, L) affine Montgomery coords; a row with y = 0 is the
// identity (no point of an odd-order short-Weierstrass curve, and no point
// of curve25519's prime-order subgroup, has y = 0). out: (NC, R, 16, L).
template <class M>
__global__ void __launch_bounds__(SCAN_THREADS, SCAN_MIN_BLOCKS)
    suffix_madd_scan_kernel(const int32_t* __restrict__ xy,
                            int32_t* __restrict__ out, int64_t R, int64_t L,
                            CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)L) return;
  const int32_t* ys = xy + (size_t)R * 16 * L;
  typename M::P acc = M::identity(cc);
  for (int64_t r = R - 1; r >= 0; --r) {
    Fe qx = fe_load(xy, r, L, lane);
    Fe qy = fe_load(ys, r, L, lane);
    acc = M::madd(acc, qx, qy, fe_is_zero(qy), cc);
    M::store(out, R, r, L, lane, acc);
  }
}

// excl[:, r] = sum_{r' > r} in[:, r'], tot = sum over all rows.
// in, excl: (NC, R, 16, L); tot: (NC, 1, 16, L). One thread a lane, from
// CHAIN_ONE_THREAD_MIN_LANES lanes.
template <class M>
__global__ void __launch_bounds__(THREADS)
    suffix_jac_scan_kernel(const int32_t* __restrict__ in,
                           int32_t* __restrict__ excl,
                           int32_t* __restrict__ tot, int64_t R, int64_t L,
                           CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)L) return;
  typename M::P acc = M::identity(cc);
  for (int64_t r = R - 1; r >= 0; --r) {
    M::store(excl, R, r, L, lane, acc);
    acc = M::add(acc, M::load(in, R, r, L, lane), cc);
  }
  M::store(tot, 1, 0, L, lane, acc);
}

// out = in[:, 0] + in[:, 1] + ... + in[:, K-1], added in that order.
// in: (NC, K, 16, L); out: (NC, 1, 16, L). One thread a lane, as above.
template <class M>
__global__ void __launch_bounds__(THREADS)
    rowsum_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                  int64_t K, int64_t L, CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)L) return;
  typename M::P acc = M::identity(cc);
  for (int64_t r = 0; r < K; ++r) {
    acc = M::add(acc, M::load(in, K, r, L, lane), cc);
  }
  M::store(out, 1, 0, L, lane, acc);
}

// suffix_jac_scan_kernel with a group of G threads a lane (group.cuh):
// every thread holds the accumulator, the products of each level of the
// add are dealt out, thread 0 stores. The next row's point, which does not
// depend on the chain, is loaded while the current row's add runs.
template <class M, int G>
__global__ void __launch_bounds__(HG_THREADS, 1)
    suffix_jac_scan_group_kernel(const int32_t* __restrict__ in,
                                 int32_t* __restrict__ excl,
                                 int32_t* __restrict__ tot, int64_t R,
                                 int64_t L, CurveConst cc) {
  __shared__ uint4 slots[HG_THREADS / G][4 * GRP_SLOTS];
  const int tid = threadIdx.x;
  const size_t lane = ((size_t)blockIdx.x * HG_THREADS + tid) / G;
  if (lane >= (size_t)L) return;  // whole groups only: HG_THREADS % G == 0
  Grp<G> gr = grp_of<G>(slots, tid);
  typename M::P acc = M::identity(cc);
  typename M::P nxt = M::load(in, R, R - 1, L, lane);
  for (int64_t r = R - 1; r >= 0; --r) {
    typename M::P cur = nxt;
    nxt = M::load(in, R, r > 0 ? r - 1 : 0, L, lane);
    if (gr.g == 0) M::store(excl, R, r, L, lane, acc);
    acc = M::template gadd<G>(gr, acc, cur, cc);
  }
  if (gr.g == 0) M::store(tot, 1, 0, L, lane, acc);
}

// rowsum_kernel with a group of G threads a lane, as above.
template <class M, int G>
__global__ void __launch_bounds__(HG_THREADS, 1)
    rowsum_group_kernel(const int32_t* __restrict__ in,
                        int32_t* __restrict__ out, int64_t K, int64_t L,
                        CurveConst cc) {
  __shared__ uint4 slots[HG_THREADS / G][4 * GRP_SLOTS];
  const int tid = threadIdx.x;
  const size_t lane = ((size_t)blockIdx.x * HG_THREADS + tid) / G;
  if (lane >= (size_t)L) return;  // whole groups only: HG_THREADS % G == 0
  Grp<G> gr = grp_of<G>(slots, tid);
  typename M::P acc = M::identity(cc);
  typename M::P nxt = M::load(in, K, 0, L, lane);
  for (int64_t r = 0; r < K; ++r) {
    typename M::P cur = nxt;
    nxt = M::load(in, K, r + 1 < K ? r + 1 : r, L, lane);
    acc = M::template gadd<G>(gr, acc, cur, cc);
  }
  if (gr.g == 0) M::store(out, 1, 0, L, lane, acc);
}

// Stages D and F: a group of M::ADD_GRP threads a lane below
// CHAIN_ONE_THREAD_MIN_LANES lanes, one thread a lane from it.
template <class M>
static void launch_suffix_jac_scan(const void* in, void* excl, void* tot,
                                   int64_t R, int64_t L, const CurveConst& cc,
                                   cudaStream_t s) {
  constexpr int G = M::ADD_GRP;
  static_assert(HG_THREADS % G == 0, "group size");
  if (L >= CHAIN_ONE_THREAD_MIN_LANES)
    suffix_jac_scan_kernel<M><<<blocks_for(L), THREADS, 0, s>>>(
        (const int32_t*)in, (int32_t*)excl, (int32_t*)tot, R, L, cc);
  else
    suffix_jac_scan_group_kernel<M, G><<<group_blocks(L, G), HG_THREADS, 0,
                                         s>>>(
        (const int32_t*)in, (int32_t*)excl, (int32_t*)tot, R, L, cc);
}

template <class M>
static void launch_rowsum(const void* in, void* out, int64_t K, int64_t L,
                          const CurveConst& cc, cudaStream_t s) {
  constexpr int G = M::ADD_GRP;
  static_assert(HG_THREADS % G == 0, "group size");
  if (L >= CHAIN_ONE_THREAD_MIN_LANES)
    rowsum_kernel<M><<<blocks_for(L), THREADS, 0, s>>>(
        (const int32_t*)in, (int32_t*)out, K, L, cc);
  else
    rowsum_group_kernel<M, G><<<group_blocks(L, G), HG_THREADS, 0, s>>>(
        (const int32_t*)in, (int32_t*)out, K, L, cc);
}

extern "C" int abtpu_suffix_madd_scan(const void* xy, void* out, int64_t R,
                                      int64_t L, const void* words,
                                      void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  unsigned blocks = (unsigned)((L + SCAN_THREADS - 1) / SCAN_THREADS);
  if (cc.te)
    suffix_madd_scan_kernel<TeModel><<<blocks, SCAN_THREADS, 0, s>>>(
        (const int32_t*)xy, (int32_t*)out, R, L, cc);
  else if (cc.a_zero)
    suffix_madd_scan_kernel<RcbA0><<<blocks, SCAN_THREADS, 0, s>>>(
        (const int32_t*)xy, (int32_t*)out, R, L, cc);
  else
    suffix_madd_scan_kernel<RcbA><<<blocks, SCAN_THREADS, 0, s>>>(
        (const int32_t*)xy, (int32_t*)out, R, L, cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_suffix_jac_scan(const void* in, void* excl, void* tot,
                                     int64_t R, int64_t L, const void* words,
                                     void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te)
    launch_suffix_jac_scan<TeModel>(in, excl, tot, R, L, cc, s);
  else if (cc.a_zero)
    launch_suffix_jac_scan<RcbA0>(in, excl, tot, R, L, cc, s);
  else
    launch_suffix_jac_scan<RcbA>(in, excl, tot, R, L, cc, s);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_rowsum(const void* in, void* out, int64_t K, int64_t L,
                            const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te)
    launch_rowsum<TeModel>(in, out, K, L, cc, s);
  else if (cc.a_zero)
    launch_rowsum<RcbA0>(in, out, K, L, cc, s);
  else
    launch_rowsum<RcbA>(in, out, K, L, cc, s);
  return (int)cudaGetLastError();
}

// `steps` doublings of twisted-Edwards extended points (te_double_tiled),
// each stored: the (4, 16, steps + keep, m) table of double_chain_kernel
// (point_kernels.cuh), a group of TeModel::GRP = 8 threads a lane.
extern "C" int abtpu_te_double(const void* P, void* out, int64_t m,
                               int32_t steps, int32_t keep,
                               const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (!cc.te) return (int)cudaErrorInvalidValue;
  launch_double_chain<TeModel>(P, out, m, steps, keep, cc, s);
  return (int)cudaGetLastError();
}

// 2^k P + Q on RCB projective points (k = 0: rcb_add_tiled's complete add).
extern "C" int abtpu_rcb_double_k_add(const void* P, const void* Q, void* out,
                                      int64_t m, int32_t k, const void* words,
                                      void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    launch_double_k_add<RcbA0>(P, Q, out, m, k, cc, s);
  else
    launch_double_k_add<RcbA>(P, Q, out, m, k, cc, s);
  return (int)cudaGetLastError();
}

// 2^k P + Q on twisted-Edwards extended points (k = 0: te_add_tiled's).
extern "C" int abtpu_te_double_k_add(const void* P, const void* Q, void* out,
                                     int64_t m, int32_t k, const void* words,
                                     void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (!cc.te) return (int)cudaErrorInvalidValue;
  launch_double_k_add<TeModel>(P, Q, out, m, k, cc, s);
  return (int)cudaGetLastError();
}

// P + the suffix sums of R rows of affine Q on twisted-Edwards extended
// points (te_madd_tiled, scanned over the rows; R = 1: the elementwise
// add): the row scan of point_kernels.cuh.
extern "C" int abtpu_te_madd(const void* P, const void* qx, const void* qy,
                             const void* q_inf, void* out, int64_t R,
                             int64_t m, const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (!cc.te) return (int)cudaErrorInvalidValue;
  launch_madd_scan<TeModel>(P, qx, qy, q_inf, out, R, m, cc, s);
  return (int)cudaGetLastError();
}

// Complete RCB doubling on projective points (rcb_double_tiled: Alg 9 for
// a = 0, Alg 3 otherwise): the doubling chain of point_kernels.cuh at one
// step, whose (3, 16, m) output is the elementwise 2P. A twisted-Edwards
// curve is refused, as abtpu_te_double refuses the others.
extern "C" int abtpu_rcb_double(const void* P, void* out, int64_t m,
                                const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    launch_double_chain<RcbA0>(P, out, m, 1, 0, cc, s);
  else
    launch_double_chain<RcbA>(P, out, m, 1, 0, cc, s);
  return (int)cudaGetLastError();
}

// The window Horner over B sets of W windows (window stride Ws) on RCB
// projective or twisted-Edwards extended points, the model picked from
// the constants.
extern "C" int abtpu_horner(const void* parts, const void* acc0, void* out,
                            int64_t B, int64_t W, int64_t Ws, int32_t c,
                            const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te)
    launch_horner<TeModel>(parts, acc0, out, B, W, Ws, c, cc, s);
  else if (cc.a_zero)
    launch_horner<RcbA0>(parts, acc0, out, B, W, Ws, c, cc, s);
  else
    launch_horner<RcbA>(parts, acc0, out, B, W, Ws, c, cc, s);
  return (int)cudaGetLastError();
}
