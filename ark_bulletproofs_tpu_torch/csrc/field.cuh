// 256-bit prime-field core for the MSM kernels (Montgomery form, R = 2^256).
//
// Replaces the in-kernel field helpers of the TPU kernels,
// ark_bulletproofs_tpu/ops/kernels.py: _k_mont_mul, _k_add, _k_sub,
// _k_cond_sub_p, _k_mul_small and _k_mul_const. The TPU kept 16 x 16-bit
// limbs so that every partial product fit a u32 vector lane; here a field
// element lives in registers as 8 x 32-bit words. The boundary layout stays
// 16 x 16-bit limbs in int32 (limb-major, (rows, 16, lanes)); load/store
// repack two limbs into one word. R = 2^256 in both layouts, so the
// Montgomery values are the same integers and the outputs are bit-equal to
// the plain PyTorch version (ops/field.py).
//
// What bounds it: every kernel of the port inlines these functions, and
// their integer multiply-adds and carries are the kernels' work: a group
// operation is 8-12 products and 10-25 adds or subtractions. The adds are
// PTX carry chains on the condition code: fe_add, fe_sub and
// fe_cond_sub_p each one add.cc / sub.cc sequence over the 8 words inside
// one asm block (a block takes no carry it did not make and leaves none:
// the condition code does not survive between asm statements), and
// fe_sub adds p masked by its borrow word instead of selecting. Against
// the C adds they cut the n = 2^20 MSM from 44.4 to 41.2 ms and
// rowsum and suffix_jac_scan by 27-33% (PERF.md, PR 7). p and n0 come
// from CurveConst, a kernel parameter: ptxas loads them once into uniform
// registers (ULDC), not into each thread's registers.
//
// Every result is canonical in [0, p). For secq256k1 and zorro 2p > 2^256,
// so an add or the CIOS tail can carry out of the top word: that carry is
// kept and forces the final subtraction of p, as _k_cond_sub_p(..., extra)
// does on the TPU. tests/test_torch_field_chains.py runs these asm blocks
// through an interpreter on the CPU against the JAX and plain versions.
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

// The carry chains below are inline PTX on the condition code: add.cc /
// addc.cc, sub.cc / subc.cc, mad.lo.cc / madc.{lo,hi}.cc. The condition
// code is not preserved across asm statements, so every chain starts and
// ends inside one asm block: a block consumes no carry it did not make and
// leaves none behind (its last step is an addc / subc without .cc). The
// operands are plain "r" registers; p and n0 come from CurveConst, a kernel
// parameter, so ptxas reads them from the constant bank.

// d = r - p over 8 words; returns 0 or 0xFFFFFFFF (borrow out).
__device__ __forceinline__ uint32_t fe_sub_p_words(Fe& d, const Fe& r,
                                                   const CurveConst& cc) {
  uint32_t br;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(br)
      : "r"(r.v[0]), "r"(r.v[1]), "r"(r.v[2]), "r"(r.v[3]), "r"(r.v[4]),
        "r"(r.v[5]), "r"(r.v[6]), "r"(r.v[7]), "r"(cc.p[0]), "r"(cc.p[1]),
        "r"(cc.p[2]), "r"(cc.p[3]), "r"(cc.p[4]), "r"(cc.p[5]),
        "r"(cc.p[6]), "r"(cc.p[7]));
  return br;
}

// r + extra * 2^256 (< 2p) -> canonical [0, p).
__device__ __forceinline__ Fe fe_cond_sub_p(const Fe& r, uint32_t extra,
                                            const CurveConst& cc) {
  Fe d;
  uint32_t br = fe_sub_p_words(d, r, cc);
  return fe_select(extra != 0 || br == 0, d, r);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b,
                                     const CurveConst& cc) {
  Fe s;
  uint32_t c;
  asm("add.cc.u32  %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32    %8, 0, 0;"
      : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]),
        "=r"(s.v[4]), "=r"(s.v[5]), "=r"(s.v[6]), "=r"(s.v[7]), "=r"(c)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  return fe_cond_sub_p(s, c, cc);
}

// a - b, then + p where that borrowed (p masked by the borrow word, so no
// select).
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b,
                                     const CurveConst& cc) {
  Fe d;
  uint32_t br;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(br)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]),
        "+r"(d.v[4]), "+r"(d.v[5]), "+r"(d.v[6]), "+r"(d.v[7])
      : "r"(cc.p[0] & br), "r"(cc.p[1] & br), "r"(cc.p[2] & br),
        "r"(cc.p[3] & br), "r"(cc.p[4] & br), "r"(cc.p[5] & br),
        "r"(cc.p[6] & br), "r"(cc.p[7] & br));
  return d;
}

// CIOS Montgomery product a * b * 2^-256 mod p for a < 2^256 and a
// canonical b; t < 2p before the final subtraction, t[8] its `extra`.
// Each step is a 64-bit C expression a_j b_i + t_j + carry, which ptxas
// makes an IMAD.WIDE off the carry path. The product as PTX carry chains
// (16 mul.lo / mul.hi a step, then two add.cc chains) cut registers but
// put the multiplies on the carry path and ran the n = 2^20 MSM 3-4%
// slower and rowsum 1.8 times slower on the H100 (PERF.md, PR 7), so the
// C form stays.
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
