// A group of G threads of one warp that run one chain of group operations
// together (csrc/msm_kernels.cu: the window Horner, horner_group_kernel,
// and the add-only chains of stages D and F, suffix_jac_scan_group_kernel
// and rowsum_group_kernel).
//
// Every thread of the group holds the whole running point and does the
// cheap field adds of each law itself; the products of one level of the
// law's dependency graph, which are independent, are dealt out: thread g
// computes products g, g + G, ..., writes them to the group's slots in
// shared memory, and after a __syncwarp of the group every thread reads
// all of them back. So one level costs one product's latency (ceil(N / G)
// for N products) instead of N, and an operation's critical path is its
// number of levels. The values are the plain law's canonical field
// elements, each computed once by one thread and read by all, so every
// thread's point stays the same and the result is bit-equal to the
// one-thread law.
//
// The slots are double-buffered: round r writes half r % 2 and ends with
// the group's __syncwarp, so a thread can write half (r + 1) % 2 while
// another still reads half r % 2, and no thread reaches round r + 2 before
// every thread has read round r.
#pragma once
#include "field.cuh"

#define GRP_SLOTS 8  // products a round at most

template <int G>
struct Grp {
  uint4* buf;      // this group's 2 x GRP_SLOTS field elements (2 uint4 each)
  int g;           // rank in the group
  unsigned mask;   // the group's lanes of the warp
  int half;        // the half the next round writes
};

// The group of thread `tid` of a block whose consecutive G threads are
// one group each, group k's slots at slots[k]. The block's size must be a
// multiple of G, so that a tail block returns whole groups only.
template <int G>
__device__ __forceinline__ Grp<G> grp_of(uint4 (*slots)[4 * GRP_SLOTS],
                                         int tid) {
  static_assert(G >= 1 && G < 32 && 32 % G == 0, "a group within a warp");
  Grp<G> gr;
  gr.buf = slots[tid / G];
  gr.g = tid % G;
  gr.mask = ((1u << G) - 1u) << ((tid & 31) / G * G);
  gr.half = 0;
  return gr;
}

__device__ __forceinline__ void sh_store(uint4* p, const Fe& a) {
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ Fe sh_load(const uint4* p) {
  uint4 lo = p[0], hi = p[1];
  Fe r;
  r.v[0] = lo.x, r.v[1] = lo.y, r.v[2] = lo.z, r.v[3] = lo.w;
  r.v[4] = hi.x, r.v[5] = hi.y, r.v[6] = hi.z, r.v[7] = hi.w;
  return r;
}

// out[k] = x[k] * y[k] for k < N, from operands every thread of the group
// holds; thread g multiplies k = g, g + G, ...; every thread returns all N.
template <int N, int G>
__device__ __forceinline__ void grp_mul(Grp<G>& gr, Fe (&out)[N],
                                        const Fe (&x)[N], const Fe (&y)[N],
                                        const CurveConst& cc) {
  static_assert(N <= GRP_SLOTS, "too many products for one round");
  uint4* b = gr.buf + gr.half * 2 * GRP_SLOTS;
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += G) {
    Fe xa = x[k0], ya = y[k0];
#pragma unroll
    for (int j = 1; j < G && k0 + j < N; ++j) {
      if (gr.g == j) {
        xa = x[k0 + j];
        ya = y[k0 + j];
      }
    }
    if (k0 + gr.g < N) sh_store(b + 2 * (k0 + gr.g), fe_mul(xa, ya, cc));
  }
  __syncwarp(gr.mask);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = sh_load(b + 2 * k);
  gr.half ^= 1;
}

// x * c for a curve constant inside a group law: double-and-add when its
// plain value is small (every thread, no round), else one product round.
template <int G>
__device__ __forceinline__ Fe grp_mul_const(Grp<G>& gr, const Fe& x,
                                            const uint32_t* mont,
                                            uint32_t small,
                                            const CurveConst& cc) {
  if (small != 0) return fe_mul_small(x, small, cc);
  Fe r[1];
  grp_mul<1>(gr, r, {x}, {fe_from(mont)}, cc);
  return r[0];
}
