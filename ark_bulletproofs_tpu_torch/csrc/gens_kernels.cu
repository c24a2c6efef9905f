// The generator farm's candidate points, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   gen_candidates <- ark_bulletproofs_tpu/ops/kernels.py:303 mont_mul_tiled
//                     as the JAX package's generator farm reaches it
//                     (ops/gens.py:99 pow_bits, one launch a product of the
//                     square-and-multiply scan, through ops/field.py's
//                     mont_mul_fast), with the Tonelli-Shanks tail, the
//                     curve equation and from_mont it ran as XLA ops
//                     around it (ops/gens.py:118-169).
//
// An attempt of the chain (arkworks `Affine::rand`: `Fp::rand`, then one
// sign word) is nine ChaCha20 words: eight raw words of x, which are x's
// Montgomery form (little-endian, already masked to the field's bits by
// the host, which also rejected any x >= p), and a word whose top bit asks
// for the larger root. Per attempt, one thread computes
//   rhs = x^3 + a x + b, w = rhs^((q - 1) / 2) (p - 1 = q 2^s, q odd),
//   r = w rhs, t = w r, the Tonelli-Shanks tail over s - 1 steps
//   (branch-free: selects), ok = (r^2 == rhs), and from_mont of x and r,
// and the root the sign word asks for: r or p - r, whichever is
// lexicographically larger (smaller) when the top bit is 1 (0), as the
// host model's get_point_from_x and the JAX package's candidate_points
// pick it. For a non-square rhs the root is garbage and ok is 0; the plain
// version (ops/gens.py) gives the same garbage, since the tail is the same
// algorithm and w is unique.
//
// Layout: words (m, 9) uint32, out (m, 16) int32 (x canonical in words
// 0-7, y in 8-15, little-endian 32-bit words), ok (m,) bytes.
//
// What bounds it: operations. An attempt reads 36 bytes and writes 65.
// Its bound (chip_smoke.py) counts the multiplies the function needs, from
// the exponent and the field (ops/gens.py::least_muls: squarings at their
// own cost, the fewest sliding-window products, from_mont as a reduction);
// this kernel does more: every square as a full product, fixed windows,
// the whole tail on every lane and the check (ops/gens.py::kernel_products:
// 354 products on secq256k1). The products of one attempt form one
// dependent chain, so the design is the plainest: one thread an attempt,
// every product in registers, thousands of attempts in flight to hide each
// product's latency. The exponent and s are the same in every lane, so
// skipping the product on a zero window and the tail's loop take no
// divergence (the JAX scan multiplied at every bit and selected). The
// exponent runs in fixed windows of POW_WIN bits over a table of a^0 ..
// a^(2^POW_WIN - 1) (in local memory: it is indexed by the window's
// value); w is unique, so any schedule gives the same bits, and
// tests/test_torch_gens.py holds a transcription of this one against pow.
// Windows of 1 to 5 bits (bench_kernels.py --parts gens) ran in the order
// of their product counts on the H100 (times in PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "field.cuh"

#define GEN_THREADS 128
#define POW_WIN 4

// The field's and curve's square-root constants (ops/gens.py::gen_words
// packs exactly these 34 words in this order).
struct GenConst {
  uint32_t b_mont[8];  // b R mod p
  uint32_t c0[8];      // z^q R mod p, z the least non-residue
  uint32_t neg1[8];    // (p - 1) R mod p
  uint32_t e[8];       // (q - 1) / 2, little-endian words
  uint32_t ebits;      // its bit length (at least 1)
  uint32_t s;          // the 2-adicity of p - 1
};

static_assert(sizeof(GenConst) == 34 * 4, "GenConst layout");

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) d |= a.v[i] ^ b.v[i];
  return d == 0;
}

// a < b for values below 2^256: the borrow out of a - b.
__device__ __forceinline__ bool fe_lt(const Fe& a, const Fe& b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t d = (uint64_t)a.v[i] - b.v[i] - borrow;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow != 0;
}

// Window `d` of the exponent (bits [d W, d W + W)).
__device__ __forceinline__ uint32_t exp_window(const GenConst& gc, int d) {
  const int pos = d * POW_WIN, word = pos >> 5, off = pos & 31;
  uint32_t v = gc.e[word] >> off;
  if (off + POW_WIN > 32 && word < 7) v |= gc.e[word + 1] << (32 - off);
  return v & ((1u << POW_WIN) - 1);
}

// a^e, e = gc.e, MSB-first in windows of POW_WIN bits.
__device__ __forceinline__ Fe fe_pow_e(const Fe& a, const GenConst& gc,
                                       const CurveConst& cc) {
  Fe tbl[1 << POW_WIN];
  tbl[0] = fe_from(cc.one);
  tbl[1] = a;
#pragma unroll 1
  for (int j = 2; j < (1 << POW_WIN); j++) tbl[j] = fe_mul(tbl[j - 1], a, cc);
  const int nd = ((int)gc.ebits + POW_WIN - 1) / POW_WIN;
  Fe acc = tbl[exp_window(gc, nd - 1)];
#pragma unroll 1
  for (int d = nd - 2; d >= 0; --d) {
#pragma unroll 1
    for (int k = 0; k < POW_WIN; k++) acc = fe_mul(acc, acc, cc);
    const uint32_t win = exp_window(gc, d);
    if (win) acc = fe_mul(acc, tbl[win], cc);
  }
  return acc;
}

__global__ void __launch_bounds__(GEN_THREADS)
    gen_candidates_kernel(const uint32_t* __restrict__ words,
                          int32_t* __restrict__ out,
                          uint8_t* __restrict__ ok, int64_t m, GenConst gc,
                          CurveConst cc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const uint32_t* w = words + i * 9;
  Fe x;
#pragma unroll
  for (int k = 0; k < 8; k++) x.v[k] = w[k];
  const bool greatest = (w[8] >> 31) != 0;

  Fe rhs = fe_mul(fe_mul(x, x, cc), x, cc);
  if (!cc.a_zero) rhs = fe_add(rhs, fe_mul(fe_from(cc.a_mont), x, cc), cc);
  rhs = fe_add(rhs, fe_from(gc.b_mont), cc);

  // Tonelli-Shanks from one power: r = rhs^((q + 1) / 2), t = rhs^q.
  const Fe wpow = fe_pow_e(rhs, gc, cc);
  Fe r = fe_mul(wpow, rhs, cc);
  Fe t = fe_mul(wpow, r, cc);
  Fe c = fe_from(gc.c0);
  const Fe neg1 = fe_from(gc.neg1);
#pragma unroll 1
  for (int k = (int)gc.s - 1; k > 0; --k) {
    Fe d = t;
#pragma unroll 1
    for (int j = 0; j < k - 1; j++) d = fe_mul(d, d, cc);
    const bool cond = fe_eq(d, neg1);
    r = fe_select(cond, fe_mul(r, c, cc), r);
    c = fe_mul(c, c, cc);
    t = fe_select(cond, fe_mul(t, c, cc), t);
  }
  const bool good = fe_eq(fe_mul(r, r, cc), rhs);

  Fe one = fe_zero();
  one.v[0] = 1;
  Fe y = fe_mul(r, one, cc);
  const Fe xc = fe_mul(x, one, cc);
  const Fe ny = fe_sub(fe_zero(), y, cc);
  y = fe_select(fe_lt(ny, y) == greatest, y, ny);
  int32_t* o = out + i * 16;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    o[k] = (int32_t)xc.v[k];
    o[8 + k] = (int32_t)y.v[k];
  }
  ok[i] = good ? 1 : 0;
}

// gen_words: the 34 words of GenConst (ops/gens.py::gen_words).
extern "C" int abtpu_gen_candidates(const void* words, void* out, void* ok,
                                    int64_t m, const void* gen_words,
                                    const void* curve_words, void* stream) {
  CurveConst cc;
  GenConst gc;
  memcpy(&cc, curve_words, sizeof cc);
  memcpy(&gc, gen_words, sizeof gc);
  const unsigned blocks = (unsigned)((m + GEN_THREADS - 1) / GEN_THREADS);
  gen_candidates_kernel<<<blocks, GEN_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int32_t*)out, (uint8_t*)ok, m, gc, cc);
  return (int)cudaGetLastError();
}
