// Kernel templates over a point model that both group-law sources
// instantiate (msm_kernels.cu on RCB projective and TE extended points,
// jac_kernels.cu on Jacobian points): the elementwise 2^k P + Q, the
// window Horner, the doubling chain and the v1 row scan, with their
// launchers, and the launchers' block arithmetic. A model supplies the
// point type, its identity, add, mixed add, doubling, load and store, and
// the group forms gadd / gdbl / gmadd (group.cuh); each source
// instantiates a template only for its models.
//
// The window Horner (horner_group_kernel) is a latency problem: at v2's
// stage G one chain of W (c + 1) dependent group operations is the
// whole launch. A group of G threads shares each chain (csrc/group.cuh):
// the independent products of each level of a law go to different threads
// and meet again through shared memory, so an operation costs its levels
// (2 for an RCB a = 0 doubling, 3 for a Jacobian one, 3 for HWCD), not its
// products (8 to 12). __launch_bounds__(128, 1): a chain needs registers,
// not occupancy. The group mapping beat one thread a set on the H100 up
// to 16,384 sets and lost only from 32,768 (PERF.md, PR 7); no caller
// comes near that (the largest is v1's B = 256), so it is the only one.
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
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "group.cuh"

#define THREADS 128
// The group kernels' block (the Horner, the double-k-add, stages D and F,
// the row scan, the doubling chain): 128 threads, 32 / G chains a warp.
#define HG_THREADS 128
// double_k_add_wide_kernel's block, and the blocks an SM must keep
// resident with the doubling code (k > 0; at k = 0 the model's
// DKA_MIN_BLOCKS): at most 168 registers a thread.
#define DKA_THREADS 128
#define DKA_DBL_MIN_BLOCKS 3

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

// The 2^i P table in one launch: out holds S = steps + keep rows of each
// lane in an (NC, 16, S, m) array (the layout of the on-device
// Fiat-Shamir IPA's (NC, 16, 256) Q table at m = 1): with keep = 1 row 0
// is P and row i is 2^i P; with keep = 0 row i - 1 is 2^i P (steps = 1:
// the elementwise 2P, out (NC, 16, m)). Each step's point is stored as it
// is made. A group of G threads a lane (M::gdbl, group.cuh): a Jacobian
// doubling waits on 3 product levels (4 for a != 0) instead of one
// thread's 8 (10) products, a twisted-Edwards one (the HWCD add of P and
// P) on 3 (5, 2 and 4 products at G = 8) instead of 11, an RCB one on 2
// (a = 0: 4 + 4 products at G = 4) or 3 (a != 0: 6 + 4 + 5 at G = 8)
// instead of 8 or 13, and a 255-step table is a chain of 255 dependent
// doublings; thread 0 stores.
template <class M, int G>
__global__ void __launch_bounds__(HG_THREADS, 1)
    double_chain_kernel(const int32_t* __restrict__ P,
                        int32_t* __restrict__ out, int64_t m, int32_t steps,
                        int32_t keep, CurveConst cc) {
  __shared__ uint4 slots[HG_THREADS / G][4 * GRP_SLOTS];
  const int tid = threadIdx.x;
  const size_t lane = ((size_t)blockIdx.x * HG_THREADS + tid) / G;
  if (lane >= (size_t)m) return;  // whole groups only: HG_THREADS % G == 0
  Grp<G> gr = grp_of<G>(slots, tid);
  const size_t S = (size_t)steps + keep;
  typename M::P acc = M::load(P, 1, 0, m, lane);
  if (keep && gr.g == 0) M::store(out, 1, 0, S * m, lane, acc);
  for (int32_t i = 1; i <= steps; ++i) {
    acc = M::template gdbl<G>(gr, acc, cc);
    if (gr.g == 0)
      M::store(out, 1, 0, S * m, (size_t)(i - 1 + keep) * m + lane, acc);
  }
}

// The one-thread band of the one-step chain (rcb_double from
// M::DBL_ONE_THREAD_MIN_LANES lanes): 2P elementwise, one thread a lane,
// straight-line code under launch bounds that keep M::DBL_MIN_BLOCKS
// blocks an SM resident. Many lanes hide each product's latency there,
// and a group's repeated field adds and shared-memory rounds only cost
// issue slots. The chain kernel run with G = 1 was up to 1.5 times
// slower on zorro's doubling (its loop over the steps; PERF.md).
template <class M>
__global__ void __launch_bounds__(DKA_THREADS, M::DBL_MIN_BLOCKS)
    double_wide_kernel(const int32_t* __restrict__ P,
                       int32_t* __restrict__ out, int64_t m,
                       CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * DKA_THREADS + threadIdx.x;
  if (lane >= (size_t)m) return;
  M::store(out, 1, 0, m, lane, M::dbl(M::load(P, 1, 0, m, lane), cc));
}

// The doubling chain: a group of M::GRP threads a lane, at every lane
// count for Jacobian and twisted-Edwards points (DBL_WIDE = false): the
// paths send them one lane (the 2^i Q table of the on-device Fiat-Shamir
// IPA, JacModel or TeModel) or two (the TE commit table's 2^i B and 2^i
// B_blinding, TeModel), where a chain waits on latency. RCB points
// (rcb_double, which no path calls) run one step from
// M::DBL_ONE_THREAD_MIN_LANES lanes on double_wide_kernel.
template <class M>
static void launch_double_chain(const void* P, void* out, int64_t m,
                                int32_t steps, int32_t keep,
                                const CurveConst& cc, cudaStream_t s) {
  constexpr int G = M::GRP;
  static_assert(HG_THREADS % G == 0 && 32 % G == 0, "group size");
  const int32_t* p = (const int32_t*)P;
  int32_t* o = (int32_t*)out;
  if constexpr (M::DBL_WIDE) {
    if (m >= M::DBL_ONE_THREAD_MIN_LANES && steps == 1 && keep == 0) {
      double_wide_kernel<M>
          <<<(unsigned)((m + DKA_THREADS - 1) / DKA_THREADS), DKA_THREADS, 0,
             s>>>(p, o, m, cc);
      return;
    }
  }
  double_chain_kernel<M, G><<<group_blocks(m, G), HG_THREADS, 0, s>>>(
      p, o, m, steps, keep, cc);
}

// The v1 Pippenger's row scan in one launch: out[:, r] = P + sum_{j >= r}
// (qx, qy)[j] per lane, added from row R - 1 down to row 0 (the suffix
// order of the JAX package's lax.scan over sw_madd_tiled or te_madd_tiled).
// P: (NC, 1, 16, m); qx, qy: (R, 16, m) affine Montgomery coordinates;
// q_inf: (R, m) bytes, a nonzero row adds the identity; out: (NC, R, 16,
// m). The accumulator stays in registers across the rows, each row's
// partial sum is stored as it is made, and the next row's point and flag,
// which do not depend on the chain, are loaded one add ahead.
//
// G = 1: one thread a lane (M::madd), the band of many lanes, where the
// card is bound by the products' instructions once enough warps hide
// their latency; __launch_bounds__ keeps M::MADD_MIN_BLOCKS blocks an SM
// resident. G > 1: a group of G threads a lane (M::gmadd, group.cuh),
// where few lanes leave the card idle and one thread would wait on each
// of the mixed add's products in turn (12 Jacobian, 11 TE): the group
// waits on its product levels (5 Jacobian, 3 TE); thread 0 stores. A
// model with MADD_AHEAD (TeModel) also takes a value of the next row
// alone (TE: t2 = qx qy), which the group computes inside the current
// add (the first row's before the loop, on every thread).
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
  constexpr bool AHEAD = G > 1 && M::MADD_AHEAD;
  typename M::P acc = M::load(P, 1, 0, m, lane);
  Fe nx = fe_load(qx, R - 1, m, lane);
  Fe ny = fe_load(qy, R - 1, m, lane);
  bool ni = q_inf[(size_t)(R - 1) * m + lane] != 0;
  Fe na = AHEAD ? fe_mul(nx, ny, cc) : fe_zero();
  for (int64_t r = R - 1; r >= 0; --r) {
    Fe x = nx, y = ny, a = na;
    bool inf = ni;
    const int64_t r1 = r > 0 ? r - 1 : 0;
    nx = fe_load(qx, r1, m, lane);
    ny = fe_load(qy, r1, m, lane);
    ni = q_inf[(size_t)r1 * m + lane] != 0;
    if constexpr (G == 1)
      acc = M::madd(acc, x, y, inf, cc);
    else if constexpr (AHEAD)
      acc = M::template gmadd<G>(gr, acc, x, y, a, inf, nx, ny, na, cc);
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
