// The group-law kernels of the v2 Pippenger MSM (ops/msm2.py) and of the
// device Pedersen batch (ops/prove.py), for Hopper (sm_90a).
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
//   jac_double_k_add  <- ark_bulletproofs_tpu/ops/kernels.py::sw_add_tiled
//                        (k = 0) and ::sw_double_k_add_tiled (k > 0)
//   jac_double        <- ark_bulletproofs_tpu/ops/kernels.py::sw_double_tiled
//   rcb_double        <- ark_bulletproofs_tpu/ops/kernels.py::rcb_double_tiled
//   jac_madd          <- ark_bulletproofs_tpu/ops/kernels.py::sw_madd_tiled
//   te_madd           <- ark_bulletproofs_tpu/ops/kernels.py::te_madd_tiled
//                        (its elementwise launcher; the body also runs in
//                        the TE suffix_madd_scan)
//   horner            <- ark_bulletproofs_tpu/ops/kernels2.py::horner_windows
//                        (RCB, and here also TE extended points)
//   jac_horner        <- the same Horner on Jacobian points
//
// Each kernel is a template over a point model: RcbModel<true> (RCB, a = 0:
// secq256k1), RcbModel<false> (RCB, general a: zorro) and TeModel (HWCD
// extended: curve25519); JacModel<AZ> (Jacobian, jac.cuh) instantiates
// only the elementwise double-k-add, doubling and mixed add and the
// window Horner, for the Q terms of the on-device Fiat-Shamir IPA and the
// v1 Pippenger (no scan runs on Jacobian points). A model supplies the point type, its identity,
// add, mixed add, doubling, load and store; the launchers pick it from the
// constants (te, a_zero), so each kernel is compiled once per model and
// carries no dead registers of another. A 3-coordinate model reads and
// writes (3, rows, 16, L) arrays, TeModel (4, rows, 16, L).
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
// The window Horner (horner_group_kernel) is a latency problem instead: at
// v2's stage G one chain of W (c + 1) dependent group operations is the
// whole launch. A group of G threads shares each chain (csrc/group.cuh):
// the independent products of each level of a law go to different threads
// and meet again through shared memory, so an operation costs its levels
// (2 for an RCB a = 0 doubling, 3 for a Jacobian one, 3 for HWCD), not its
// products (8 to 12). __launch_bounds__(128, 1): a chain needs registers,
// not occupancy. The group mapping beat one thread a set on the H100 up
// to 16,384 sets and lost only from 32,768 (PERF.md, PR 7); no caller
// comes near that (the largest is v1's B = 256), so it is the only one.
//
// Stages D and F (suffix_jac_scan, rowsum) are chains of complete adds,
// one a lane, in the JAX kernels' row order (which fixes the projective
// coordinates the tests hold bit for bit, so no tree over the rows), on
// few lanes: 64 rows of 1,408 and of 22 lanes at n = 2^20, 16 or 1 row of
// 64 to 1,024 at n = 256. One thread a lane waits about 9 us an add on
// its 11 or 12 products, with the card nearly idle. So a group of
// M::ADD_GRP = 8 threads shares each lane's chain as in the Horner: an
// add costs its product levels (2 on RCB a = 0, 3 on zorro and HWCD, each
// level one product at G = 8) plus the field adds every thread repeats,
// 2.6 to 4.4 us an add on the H100. G = 8 beat G = 4 at every shape of
// the one-set MSMs; G = 4 was faster only at 16 x 8,192, a B = 128
// batch's level B (PERF.md, PR 8). The row a chain adds next does not
// depend on it and is loaded one add ahead. From
// CHAIN_ONE_THREAD_MIN_LANES lanes the card is throughput-bound and the
// G-fold repeated adds lose: at 16 rows of 131,072 lanes one thread a
// lane took 1.03 ms against the group's 2.17 (RCB a = 0), and the
// on-device Fiat-Shamir IPA's table shrink (1024 sets at n = 256) sends
// stage D 16 rows of 1,048,576.
//
// The elementwise 2^k P + Q (jac_double_k_add, rcb_double_k_add,
// te_double_k_add) spans both regimes, so its launcher picks a mapping by
// the lane count, in bands that are members of the point model (M::DKA_*,
// measured on the H100 for each model). With few lanes it is the same
// latency problem one add deep: the on-device Fiat-Shamir IPA sends the
// Jacobian kernel 2 to 256 lanes a launch for one proof, the TE commit
// tree and c * Q tree send te_double_k_add as few, and the ragged MSM's
// chunk sum adds one lane a set. There a group of M::ADD_GRP = 8 threads
// runs each lane (of 4 from M::DKA_GROUP4_MIN_LANES lanes;
// double_k_add_group_kernel). With many lanes (stages D and E of the v2
// MSM: 90,112 lanes at n = 2^20, up to 16,777,216 in the on-device
// Fiat-Shamir IPA's table shrink) the card is throughput-bound and one
// thread a lane runs from M::DKA_ONE_THREAD_MIN_LANES: for RCB and TE
// points double_k_add_wide_kernel (see its note), for Jacobian points
// double_k_add_kernel.
//
// A TE point is 4 x 8 words against 3 x 8: the TE scans write a third
// more bytes (5.9 GB at the n = 2^20 shape) for the same 11 products a
// mixed add.
//
// Each launcher is extern "C", takes device pointers and the stream as
// void*, the curve constants as a pointer to 45 host words, and returns
// cudaGetLastError() (cudaErrorInvalidValue, without a launch, for a
// curve of the wrong model).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "jac.cuh"
#include "rcb.cuh"
#include "te.cuh"

#define THREADS 128
// suffix_madd_scan: SCAN_THREADS a block and at least SCAN_MIN_BLOCKS
// resident on an SM (see the note above). ops/msm2.py's column plan reads
// both (tests/test_torch_msm_plan.py ties them).
#define SCAN_THREADS 128
#define SCAN_MIN_BLOCKS 3
// The group kernels' block (the Horner, stages D and F): 128 threads, 32 /
// G chains a warp.
#define HG_THREADS 128
// Stages D and F: from this many lanes on, one thread runs each lane's
// chain; below it a group of M::ADD_GRP threads (see the note above;
// ops/kernels2.py mirrors it, tests/test_torch_msm_plan.py ties the two).
#define CHAIN_ONE_THREAD_MIN_LANES 16384
// double_k_add_wide_kernel's block, and the blocks an SM must keep
// resident with the doubling code (k > 0; at k = 0 the model's
// DKA_MIN_BLOCKS): at most 168 registers a thread.
#define DKA_THREADS 128
#define DKA_DBL_MIN_BLOCKS 3

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
  static constexpr int GRP = 8;  // levels of 5, 2 and 4 products
  static constexpr int ADD_GRP = 8;  // the same levels in an add-only chain
  // te_double_k_add's bands, as RcbModel's.
  static constexpr int64_t DKA_GROUP4_MIN_LANES = 4096;
  static constexpr int64_t DKA_ONE_THREAD_MIN_LANES = 16384;
  static constexpr bool DKA_WIDE = true;
  static constexpr int DKA_MIN_BLOCKS = 3;
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
  static constexpr int GRP = 4;  // doubling levels of 4, 3, 1 (and 1, 1)
  // jac_double_k_add's group: add levels of 5, 4, 3, 2, 2 products.
  static constexpr int ADD_GRP = 8;
  // jac_double_k_add's bands, as RcbModel's; its one-thread band runs
  // double_k_add_kernel.
  static constexpr int64_t DKA_GROUP4_MIN_LANES = 4096;
  static constexpr int64_t DKA_ONE_THREAD_MIN_LANES = 24576;
  static constexpr bool DKA_WIDE = false;
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

// out = 2^k * P + Q elementwise; P, Q, out: (NC, 1, 16, m). One thread a
// lane: jac_double_k_add's one-thread band.
template <class M>
__global__ void __launch_bounds__(THREADS)
    double_k_add_kernel(const int32_t* __restrict__ P,
                        const int32_t* __restrict__ Q,
                        int32_t* __restrict__ out, int64_t m, int32_t k,
                        CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)m) return;
  typename M::P acc = M::load(P, 1, 0, m, lane);
  for (int32_t i = 0; i < k; ++i) acc = M::dbl(acc, cc);
  acc = M::add(acc, M::load(Q, 1, 0, m, lane), cc);
  M::store(out, 1, 0, m, lane, acc);
}

// The throughput band of rcb_double_k_add and te_double_k_add: one thread
// a lane, from M::DKA_ONE_THREAD_MIN_LANES lanes (90,112 at the n = 2^20
// MSM's stages D and E, up to 16,777,216). The card is bound there by the
// instructions of the products (12 a lane on RCB a = 0, 11 on TE, about
// 800 SASS instructions each), once enough warps run to hide each
// product's latency. The parent's kernel, double_k_add_kernel with the k
// loop and no minimum of resident blocks, took 0.0875 ms at 90,112 lanes
// on RCB a = 0 (96 registers, a spill): 704 blocks against 660 resident,
// so a second wave of 44 blocks nearly doubled the launch. Here DBL =
// false, k = 0, the main path's only k, leaves out the doubling code, and
// __launch_bounds__ keeps M::DKA_MIN_BLOCKS blocks resident with no spill
// (ptxas: 147-156 registers at 3 blocks, 96 at 5): 0.0458 ms there. On
// RCB a = 0 and TE, 4 and 5 blocks (128 and 96 registers) spill on most
// instantiations, gain at most 3% anywhere and lose up to 16% at 90,112
// lanes; zorro's add fits 5 blocks without a spill and runs up to 1.38
// times faster from 262,144 lanes. A grid of resident blocks striding
// over the lanes was slower at k = 0 at every lane count measured (up to
// 1.9 times) than one block per 128 lanes (PERF.md, bench_kernels.py).
template <class M, bool DBL>
__global__ void __launch_bounds__(DKA_THREADS,
                                  DBL ? DKA_DBL_MIN_BLOCKS : M::DKA_MIN_BLOCKS)
    double_k_add_wide_kernel(const int32_t* __restrict__ P,
                             const int32_t* __restrict__ Q,
                             int32_t* __restrict__ out, int64_t m, int32_t k,
                             CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * DKA_THREADS + threadIdx.x;
  if (lane >= (size_t)m) return;
  typename M::P acc = M::load(P, 1, 0, m, lane);
  if (DBL)
    for (int32_t i = 0; i < k; ++i) acc = M::dbl(acc, cc);
  M::store(out, 1, 0, m, lane, M::add(acc, M::load(Q, 1, 0, m, lane), cc));
}

// double_k_add_kernel with a group of G threads a lane (group.cuh): every
// thread holds the point, the products of each level of the k doublings
// and of the add are dealt out, thread 0 stores. Used below
// M::DKA_ONE_THREAD_MIN_LANES lanes: the on-device Fiat-Shamir IPA's
// c * Q tree and S = MSM + c * Q send 2 to 256 lanes a launch for one
// proof, the v1 Pippenger its adds and bit-Horner steps, the TE commit
// tree and the ragged MSM's chunk sum a few, where one thread a lane
// leaves the card idle and waits on every product of the law in turn
// (16 a Jacobian add, 12 RCB a = 0, 14 zorro, 11 HWCD). A group of 8
// waits on the law's product levels instead (Jacobian 5, RCB a = 0 2,
// zorro and HWCD 3; a doubling 3, 2, 3, 3): on the H100 1 to 2,048
// lanes took 5.8-9.2 us a launch against one thread's 25-35 us on
// Jacobian points, and 4.4-6.2 us against the parent one-thread kernel's
// 16-25 us on RCB and TE points. From M::DKA_GROUP4_MIN_LANES the group's
// repeated field adds cost throughput and a group of 4 is faster
// (PERF.md).
template <class M, int G>
__global__ void __launch_bounds__(HG_THREADS, 1)
    double_k_add_group_kernel(const int32_t* __restrict__ P,
                              const int32_t* __restrict__ Q,
                              int32_t* __restrict__ out, int64_t m, int32_t k,
                              CurveConst cc) {
  __shared__ uint4 slots[HG_THREADS / G][4 * GRP_SLOTS];
  const int tid = threadIdx.x;
  const size_t lane = ((size_t)blockIdx.x * HG_THREADS + tid) / G;
  if (lane >= (size_t)m) return;  // whole groups only: HG_THREADS % G == 0
  Grp<G> gr = grp_of<G>(slots, tid);
  typename M::P acc = M::load(P, 1, 0, m, lane);
  for (int32_t i = 0; i < k; ++i) acc = M::template gdbl<G>(gr, acc, cc);
  acc = M::template gadd<G>(gr, acc, M::load(Q, 1, 0, m, lane), cc);
  if (gr.g == 0) M::store(out, 1, 0, m, lane, acc);
}

// out = P + affine (qx, qy) elementwise; a lane with q_inf[lane] != 0
// adds the identity. P, out: (NC, 1, 16, m); qx, qy: (16, m); q_inf: (m,)
// bytes (a torch bool tensor).
template <class M>
__global__ void __launch_bounds__(THREADS)
    madd_kernel(const int32_t* __restrict__ P, const int32_t* __restrict__ qx,
                const int32_t* __restrict__ qy,
                const uint8_t* __restrict__ q_inf, int32_t* __restrict__ out,
                int64_t m, CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)m) return;
  typename M::P acc = M::load(P, 1, 0, m, lane);
  acc = M::madd(acc, fe_load(qx, 0, m, lane), fe_load(qy, 0, m, lane),
                q_inf[lane] != 0, cc);
  M::store(out, 1, 0, m, lane, acc);
}

// out = 2P elementwise; P, out: (NC, 1, 16, m).
template <class M>
__global__ void __launch_bounds__(THREADS)
    double_kernel(const int32_t* __restrict__ P, int32_t* __restrict__ out,
                  int64_t m, CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)m) return;
  M::store(out, 1, 0, m, lane, M::dbl(M::load(P, 1, 0, m, lane), cc));
}

static inline CurveConst load_cc(const void* words) {
  CurveConst cc;
  memcpy(&cc, words, sizeof cc);
  return cc;
}

static inline unsigned blocks_for(int64_t lanes) {
  return (unsigned)((lanes + THREADS - 1) / THREADS);
}

// Blocks of HG_THREADS for `chains` groups of G threads.
static inline unsigned group_blocks(int64_t chains, int G) {
  return (unsigned)((chains * G + HG_THREADS - 1) / HG_THREADS);
}

// The window Horner of both MSM engines: acc = acc0, then for w = W - 1
// down to 0, c doublings and acc += part[w]; out = acc. parts: (NC, 16,
// B, Ws) with the windows innermost, the layout the engines hold their
// window sums in, of which windows [0, W) are read (Ws >= W: v2 passes
// its top window as acc0 and the other W - 1 as parts, without a copy);
// acc0, out: (NC, 16, B). A group of G = M::GRP threads shares each scalar
// set's chain (group.cuh): W (c + 1) dependent group operations, each as
// long as its product levels (2 for an RCB a = 0 doubling, 3 for a
// Jacobian one), not its products (8). Every thread of a group holds the
// accumulator; thread 0 stores. The strided window reads (stride Ws
// between lanes) are a few KB a set.
template <class M, int G>
__global__ void __launch_bounds__(HG_THREADS, 1)
    horner_group_kernel(const int32_t* __restrict__ parts,
                        const int32_t* __restrict__ acc0,
                        int32_t* __restrict__ out, int64_t B, int64_t W,
                        int64_t Ws, int32_t c, CurveConst cc) {
  __shared__ uint4 slots[HG_THREADS / G][4 * GRP_SLOTS];
  const int tid = threadIdx.x;
  const size_t set = ((size_t)blockIdx.x * HG_THREADS + tid) / G;
  if (set >= (size_t)B) return;  // whole groups only: HG_THREADS % G == 0
  Grp<G> gr = grp_of<G>(slots, tid);
  typename M::P acc = M::load(acc0, 1, 0, B, set);
  for (int64_t w = W - 1; w >= 0; --w) {
    for (int32_t i = 0; i < c; ++i) acc = M::template gdbl<G>(gr, acc, cc);
    acc = M::template gadd<G>(
        gr, acc, M::load(parts, 1, 0, B * Ws, set * Ws + w), cc);
  }
  if (gr.g == 0) M::store(out, 1, 0, B, set, acc);
}

// One Horner launch: a group of M::GRP threads a set.
template <class M>
static void launch_horner(const void* parts, const void* acc0, void* out,
                          int64_t B, int64_t W, int64_t Ws, int32_t c,
                          const CurveConst& cc, cudaStream_t s) {
  constexpr int G = M::GRP;
  static_assert(HG_THREADS % G == 0 && 32 % G == 0, "group size");
  horner_group_kernel<M, G><<<group_blocks(B, G), HG_THREADS, 0, s>>>(
      (const int32_t*)parts, (const int32_t*)acc0, (int32_t*)out, B, W, Ws,
      c, cc);
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

extern "C" int abtpu_te_double(const void* P, void* out, int64_t m,
                               const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (!cc.te) return (int)cudaErrorInvalidValue;
  double_kernel<TeModel><<<blocks_for(m), THREADS, 0, s>>>(
      (const int32_t*)P, (int32_t*)out, m, cc);
  return (int)cudaGetLastError();
}

// 2^k P + Q: a group of M::ADD_GRP threads a lane below
// M::DKA_GROUP4_MIN_LANES lanes, of 4 below M::DKA_ONE_THREAD_MIN_LANES,
// one thread a lane from it (double_k_add_wide_kernel, or for Jacobian
// points double_k_add_kernel).
template <class M>
static void launch_double_k_add(const void* P, const void* Q, void* out,
                                int64_t m, int32_t k, const CurveConst& cc,
                                cudaStream_t s) {
  constexpr int G = M::ADD_GRP;
  static_assert(HG_THREADS % G == 0, "group size");
  const int32_t* p = (const int32_t*)P;
  const int32_t* q = (const int32_t*)Q;
  int32_t* o = (int32_t*)out;
  if (m >= M::DKA_ONE_THREAD_MIN_LANES) {
    if constexpr (!M::DKA_WIDE)
      double_k_add_kernel<M><<<blocks_for(m), THREADS, 0, s>>>(p, q, o, m, k,
                                                               cc);
    else if (k == 0)
      double_k_add_wide_kernel<M, false>
          <<<(unsigned)((m + DKA_THREADS - 1) / DKA_THREADS), DKA_THREADS, 0,
             s>>>(p, q, o, m, k, cc);
    else
      double_k_add_wide_kernel<M, true>
          <<<(unsigned)((m + DKA_THREADS - 1) / DKA_THREADS), DKA_THREADS, 0,
             s>>>(p, q, o, m, k, cc);
  } else if (m >= M::DKA_GROUP4_MIN_LANES) {
    double_k_add_group_kernel<M, 4><<<group_blocks(m, 4), HG_THREADS, 0, s>>>(
        p, q, o, m, k, cc);
  } else {
    double_k_add_group_kernel<M, G><<<group_blocks(m, G), HG_THREADS, 0, s>>>(
        p, q, o, m, k, cc);
  }
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

extern "C" int abtpu_jac_double(const void* P, void* out, int64_t m,
                                const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    double_kernel<JacModel<true>><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (int32_t*)out, m, cc);
  else
    double_kernel<JacModel<false>><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (int32_t*)out, m, cc);
  return (int)cudaGetLastError();
}

// P + affine Q on Jacobian points (sw_madd_tiled).
extern "C" int abtpu_jac_madd(const void* P, const void* qx, const void* qy,
                              const void* q_inf, void* out, int64_t m,
                              const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    madd_kernel<JacModel<true>><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (const int32_t*)qx, (const int32_t*)qy,
        (const uint8_t*)q_inf, (int32_t*)out, m, cc);
  else
    madd_kernel<JacModel<false>><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (const int32_t*)qx, (const int32_t*)qy,
        (const uint8_t*)q_inf, (int32_t*)out, m, cc);
  return (int)cudaGetLastError();
}

// P + affine Q on twisted-Edwards extended points (te_madd_tiled).
extern "C" int abtpu_te_madd(const void* P, const void* qx, const void* qy,
                             const void* q_inf, void* out, int64_t m,
                             const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (!cc.te) return (int)cudaErrorInvalidValue;
  madd_kernel<TeModel><<<blocks_for(m), THREADS, 0, s>>>(
      (const int32_t*)P, (const int32_t*)qx, (const int32_t*)qy,
      (const uint8_t*)q_inf, (int32_t*)out, m, cc);
  return (int)cudaGetLastError();
}

// Complete RCB doubling on projective points (rcb_double_tiled: Alg 9 for
// a = 0, Alg 3 otherwise); a twisted-Edwards curve is refused, as
// abtpu_te_double refuses the others.
extern "C" int abtpu_rcb_double(const void* P, void* out, int64_t m,
                                const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    double_kernel<RcbA0><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (int32_t*)out, m, cc);
  else
    double_kernel<RcbA><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (int32_t*)out, m, cc);
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
