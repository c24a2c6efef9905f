// The field inverse on one thread, for fs_kernels.cu (fs_round: the
// affine Z of L and R, the challenge u) and field_kernels.cu
// (mont_inv_batch: one element a thread, the on-device Fiat-Shamir IPA's
// table shrink).
//
// Bernstein-Yang safegcd, variable time, in the form of
// libsecp256k1's modinv32_var (signed 30-bit limbs, batches of 30
// divsteps on the low words, each batch's 2 x 2 transition matrix then
// applied to (f, g) and to (d, e) mod p), with two changes: every
// update runs over all 9 limbs (no shrinking length, so every array index
// is a compile-time constant and the limbs stay in registers), and a step
// cancels up to 5 bits of g with (3 f) ^ 2, the inverse of f mod 2^5
// (libsecp256k1 looks up 8 bits in a table): 3% more steps than with the
// inverse mod 2^32 by Newton's iteration, each 6 dependent products
// shorter, which made fs_round 8% faster on the H100 (PERF.md).
// Every input is public (L, R and u are parts of the proof, the shrunk
// table's Z come from the public generators), so variable time leaks
// nothing. The inverse is unique, so the result equals the plain
// version's Fermat power (ops/fs.py::mont_pow_pm2) bit for bit.
// tests/test_torch_fs_inverse.py transcribes these functions into Python.
// A random 256-bit inverse takes 17 to 19 batches (about 143 inner steps)
// on the fields of the three curves, against some 380 dependent products
// of the Fermat chain.
#pragma once
#include "field.cuh"

#define M30 0x3FFFFFFF
// Batches at most (a 256-bit input needs at most 25, by Bernstein and
// Yang's bound); the cap only keeps a fault from looping.
#define SG_MAX_BATCHES 40

// The host's constants of the inverse in one field (ops/fs.py::inv_words).
struct InvConst {
  uint32_t r3[8];   // R^3 mod p: a Montgomery product takes (xR)^-1 to x^-1 R
  uint32_t pinv30;  // p^-1 mod 2^30
};

// 8 words -> 9 signed 30-bit limbs (the value is < 2^256, so all >= 0).
__device__ __forceinline__ void sg_from_words(int32_t v[9],
                                              const uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int j = 30 * i / 32, s = 30 * i - 32 * j;
    uint64_t t = w[j];
    if (j + 1 < 8) t |= (uint64_t)w[j + 1] << 32;
    v[i] = (int32_t)((t >> s) & M30);
  }
}

// 9 limbs of a value in [0, 2^256) -> 8 words.
__device__ __forceinline__ Fe sg_to_fe(const int32_t v[9]) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int a = 32 * j / 30, s = 32 * j - 30 * a;
    uint64_t t = (uint32_t)v[a];
    if (a + 1 < 9) t |= (uint64_t)(uint32_t)v[a + 1] << 30;
    if (a + 2 < 9) t |= (uint64_t)(uint32_t)v[a + 2] << 60;
    r.v[j] = (uint32_t)(t >> s);
  }
  return r;
}

// 30 divsteps on the low words f, g (f odd), eta = -delta: returns the
// new eta and the transition matrix t = (u, v, q, r), which maps (f, g)
// to (u f + v g, q f + r g) / 2^30. A run of zero bits of g is shifted out
// at once; then, with eta >= 0, min(eta + 1, steps left, 5) bits of g
// are cancelled by adding w f, w = -g / f mod 2^limit.
__device__ __forceinline__ int32_t sg_divsteps_30(int32_t eta, uint32_t f,
                                                  uint32_t g, int32_t t[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  int i = 30;
  for (int it = 0; it <= 30; ++it) {  // i falls by at least 1 from it = 1
    const int zeros = __ffs(g | (0xFFFFFFFFu << i)) - 1;
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (eta < 0) {  // swap: (f, g) <- (g, -f)
      uint32_t tmp;
      eta = -eta;
      tmp = f, f = g, g = 0u - tmp;
      tmp = u, u = q, q = 0u - tmp;
      tmp = v, v = r, r = 0u - tmp;
    }
    const int limit = min(min(eta + 1, i), 5);
    const uint32_t m = 0xFFFFFFFFu >> (32 - limit);
    const uint32_t fi = (3u * f) ^ 2u;  // f^-1 mod 2^5 (f odd)
    const uint32_t w = (g * (0u - fi)) & m;
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return eta;
}

// (d, e) <- (t [d, e] + p [md, me]) / 2^30, md and me chosen so that the
// division is exact and d, e stay in (-2p, p).
__device__ __forceinline__ void sg_update_de(int32_t d[9], int32_t e[9],
                                             const int32_t t[4],
                                             const int32_t P[9],
                                             uint32_t pinv30) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d[8] >> 31, se = e[8] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
  int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
  md -= (int32_t)((pinv30 * (uint32_t)cd + (uint32_t)md) & M30);
  me -= (int32_t)((pinv30 * (uint32_t)ce + (uint32_t)me) & M30);
  cd += (int64_t)P[0] * md;
  ce += (int64_t)P[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)P[i] * md;
    ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)P[i] * me;
    d[i - 1] = (int32_t)cd & M30;
    e[i - 1] = (int32_t)ce & M30;
    cd >>= 30;
    ce >>= 30;
  }
  d[8] = (int32_t)cd;
  e[8] = (int32_t)ce;
}

// (f, g) <- t [f, g] / 2^30 (exact: the divsteps cleared the low 30 bits).
__device__ __forceinline__ void sg_update_fg(int32_t f[9], int32_t g[9],
                                             const int32_t t[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f[0] + (int64_t)v * g[0];
  int64_t cg = (int64_t)q * f[0] + (int64_t)r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cf += (int64_t)u * f[i] + (int64_t)v * g[i];
    cg += (int64_t)q * f[i] + (int64_t)r * g[i];
    f[i - 1] = (int32_t)cf & M30;
    g[i - 1] = (int32_t)cg & M30;
    cf >>= 30;
    cg >>= 30;
  }
  f[8] = (int32_t)cf;
  g[8] = (int32_t)cg;
}

// d in (-2p, p), negated when `sign` < 0 -> [0, p) with limbs in [0, 2^30).
__device__ __forceinline__ void sg_normalize(int32_t d[9], int32_t sign,
                                             const int32_t P[9]) {
  int32_t add = d[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d[i] += P[i] & add;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d[i] = (d[i] ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d[i + 1] += d[i] >> 30;
    d[i] &= M30;
  }
  add = d[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d[i] += P[i] & add;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d[i + 1] += d[i] >> 30;
    d[i] &= M30;
  }
}

// The inverse of a Montgomery x = aR, in Montgomery form a^-1 R (0 for 0):
// safegcd gives x^-1 = a^-1 R^-1, one product with R^3 makes it a^-1 R.
__device__ __forceinline__ Fe fe_inv_var(const Fe& x, const CurveConst& cc,
                                         const InvConst& ic) {
  int32_t P[9], d[9], e[9], f[9], g[9];
  sg_from_words(P, cc.p);
  sg_from_words(g, x.v);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    f[i] = P[i];
    d[i] = 0;
    e[i] = i == 0;
  }
  int32_t eta = -1;
  for (int b = 0; b < SG_MAX_BATCHES; ++b) {
    int32_t t[4];
    eta = sg_divsteps_30(eta, (uint32_t)f[0], (uint32_t)g[0], t);
    sg_update_de(d, e, t, P, ic.pinv30);
    sg_update_fg(f, g, t);
    int32_t nz = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) nz |= g[i];
    if (nz == 0) break;
  }
  sg_normalize(d, f[8], P);  // f = +-1 (gcd), its sign in the top limb
  return fe_mul(sg_to_fe(d), fe_from(ic.r3), cc);
}
