// 256-bit prime-field core for the MSM kernels (Montgomery form, R = 2^256).
//
// Replaces the in-kernel field helpers of the TPU kernels,
// ark_bulletproofs_tpu/ops/kernels.py: _k_mont_mul, _k_add, _k_sub,
// _k_cond_sub_p, _k_mul_small and _k_mul_const. The TPU kept 16 x 16-bit
// limbs so that every partial product fit a u32 vector lane; here a field
// element lives in registers as 8 x 32-bit words, and the CIOS product uses
// 32 x 32 -> 64-bit multiplies. The boundary layout stays 16 x 16-bit limbs
// in int32 (limb-major, (rows, 16, lanes)); load/store repack two limbs into
// one word. R = 2^256 in both layouts, so the Montgomery values are the same
// integers and the outputs are bit-equal to the plain PyTorch version
// (ops/field.py).
//
// Every result is canonical in [0, p). For secq256k1 and zorro 2p > 2^256,
// so an add or the CIOS tail can carry out of the top word: that carry is
// kept and forces the final subtraction of p, as _k_cond_sub_p(..., extra)
// does on the TPU.
#pragma once
#include <stdint.h>

// Curve and field constants, passed to every kernel by value (kernel
// parameters live in the constant bank; all indices below are compile-time
// after unrolling). The host side packs exactly these 45 words in this order
// (ops/_build.py::curve_words). A short-Weierstrass curve fills a, b3 and
// the flags and leaves d zero; a twisted-Edwards curve fills a_mont and
// d_mont (both applied as full products) and sets te; the field kernels
// read only p, n0 and one.
struct CurveConst {
  uint32_t p[8];        // modulus, little-endian 32-bit words
  uint32_t n0;          // -p^-1 mod 2^32
  uint32_t one[8];      // R mod p (Montgomery one)
  uint32_t a_mont[8];   // a * R mod p
  uint32_t b3_mont[8];  // 3b * R mod p (SW)
  uint32_t a_small;     // plain a when 0 < a < 2^14, else 0 (SW)
  uint32_t b3_small;    // plain 3b when 0 < b < 2^14, else 0 (SW)
  uint32_t a_zero;      // 1 when a == 0 (RCB Alg 7/8/9)
  uint32_t d_mont[8];   // d * R mod p (TE)
  uint32_t te;          // 1 for a twisted-Edwards curve
};

static_assert(sizeof(CurveConst) == 45 * 4, "CurveConst layout");

struct Fe {
  uint32_t v[8];
};

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_from(const uint32_t* w) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = w[i];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i];
  return acc == 0;
}

__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// r + extra * 2^256 (< 2p) -> canonical [0, p).
__device__ __forceinline__ Fe fe_cond_sub_p(const Fe& r, uint32_t extra,
                                            const CurveConst& cc) {
  Fe d;
  uint32_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)r.v[i] - cc.p[i] - br;
    d.v[i] = (uint32_t)t;
    br = (uint32_t)(t >> 63);  // wrapped: borrow
  }
  return fe_select(extra != 0 || br == 0, d, r);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b,
                                     const CurveConst& cc) {
  Fe s;
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a.v[i] + b.v[i] + c;
    s.v[i] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
  return fe_cond_sub_p(s, c, cc);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b,
                                     const CurveConst& cc) {
  Fe d;
  uint32_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a.v[i] - b.v[i] - br;
    d.v[i] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
  Fe e;
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)d.v[i] + cc.p[i] + c;
    e.v[i] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
  return fe_select(br != 0, e, d);
}

// CIOS Montgomery product a * b * 2^-256 mod p for canonical a, b.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b,
                                     const CurveConst& cc) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    uint64_t s = (uint64_t)t[8] + carry;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * cc.n0;
    s = (uint64_t)m * cc.p[0] + t[0];
    carry = (uint32_t)(s >> 32);
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)m * cc.p[j] + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[8] + carry;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = t[i];
  return fe_cond_sub_p(r, t[8], cc);  // t < 2p
}

// x * k for a small plain constant k > 0 (double-and-add, MSB first).
__device__ __forceinline__ Fe fe_mul_small(const Fe& x, uint32_t k,
                                           const CurveConst& cc) {
  Fe acc = x;
  int top = 31 - __clz(k);
  for (int bit = top - 1; bit >= 0; --bit) {
    acc = fe_add(acc, acc, cc);
    if ((k >> bit) & 1u) acc = fe_add(acc, x, cc);
  }
  return acc;
}

// x * c for a curve constant: double-and-add when its plain value is small,
// else a full product with its Montgomery form.
__device__ __forceinline__ Fe fe_mul_const(const Fe& x, const uint32_t* mont,
                                           uint32_t small,
                                           const CurveConst& cc) {
  if (small != 0) return fe_mul_small(x, small, cc);
  return fe_mul(x, fe_from(mont), cc);
}

// Boundary layout: limb i of an element at (row, lane) of a limb-major
// (rows, 16, L) int32 array sits at base[(row * 16 + i) * L + lane].
__device__ __forceinline__ Fe fe_load(const int32_t* base, size_t row,
                                      size_t L, size_t lane) {
  const int32_t* p = base + row * 16 * L + lane;
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t lo = (uint32_t)p[(2 * i) * L];
    uint32_t hi = (uint32_t)p[(2 * i + 1) * L];
    r.v[i] = lo | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* base, size_t row, size_t L,
                                         size_t lane, const Fe& a) {
  int32_t* p = base + row * 16 * L + lane;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    p[(2 * i) * L] = (int32_t)(a.v[i] & 0xFFFFu);
    p[(2 * i + 1) * L] = (int32_t)(a.v[i] >> 16);
  }
}
