// The device byte layer of the on-device Fiat-Shamir IPA, one thread per
// transcript: Keccak-f[1600], STROBE-128 and Merlin, ChaCha20 and arkworks
// Fp::rand, the field inverse (Bernstein-Yang safegcd), and arkworks'
// uncompressed point encodings. fs_kernels.cu composes them into one IPA
// round (fs_round_kernel); the plain PyTorch versions are in ops/fs.py.
//
// Keccak and ChaCha follow the port's host C++ (csrc/host/abtpu_host.cpp),
// STROBE and Merlin the host model (transcript/strobe.py, merlin.py). The
// 200-byte state of each transcript lives in shared memory as 25
// little-endian 64-bit lanes, lane-major over the block's threads, where
// the byte position, known only at run time, can index it (in registers
// it would put the state in local memory, as the first form of this
// kernel did: a 336-byte stack frame); the permutation loads the 25 lanes
// into registers, runs its 24 rounds there and stores them back. Holding
// the lane under the position in a register as well measured no faster
// on the H100 (PERF.md): the permutations, not the bytes, take the
// time of the byte layer. The position (pos, pos_begin) is the same in
// every thread (lockstep transcripts), given by the host and advanced here
// exactly as the host advances its copy (ops/fs.py::round_positions).
#pragma once
#include "field.cuh"

#define FS_THREADS 32
#define STROBE_R 166
#define FLAG_I 0x01u
#define FLAG_A 0x02u
#define FLAG_C 0x04u
#define FLAG_M 0x10u
// ChaCha20 blocks Fp::rand may draw from, two candidates a block
// (ops/fs.py::RAND_BLOCKS).
#define RAND_BLOCKS 64

__constant__ uint64_t kKeccakRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t v, int n) {
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

// In-place permutation of the 25 lanes (x + 5 y) at st[0], st[FS_THREADS],
// ..., in registers between one load and one store. Not inlined: the
// absorb and squeeze call it from some twenty places.
__device__ __noinline__ void keccak_f1600(uint64_t* st) {
  const int rot[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                       25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = st[i * FS_THREADS];
  for (int round = 0; round < 24; ++round) {
    uint64_t b[25], c[5], d[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y],
                                                  rot[x + 5 * y]);
#pragma unroll
    for (int y = 0; y < 5; ++y)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^
                       ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= kKeccakRC[round];
  }
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i * FS_THREADS] = a[i];
}

struct Strobe {
  uint64_t* a;  // lane i of this thread's state at a[i * FS_THREADS]
  int pos, pb;
};

__device__ __forceinline__ uint32_t stb_get(const Strobe& s, int i) {
  return (uint32_t)(s.a[(i >> 3) * FS_THREADS] >> (8 * (i & 7))) & 0xFFu;
}

__device__ __forceinline__ void stb_xor(Strobe& s, int i, uint32_t v) {
  s.a[(i >> 3) * FS_THREADS] ^= (uint64_t)(v & 0xFFu) << (8 * (i & 7));
}

__device__ __forceinline__ void stb_run_f(Strobe& s) {
  stb_xor(s, s.pos, (uint32_t)s.pb);
  stb_xor(s, s.pos + 1, 0x04u);
  stb_xor(s, STROBE_R + 1, 0x80u);
  keccak_f1600(s.a);
  s.pos = 0;
  s.pb = 0;
}

__device__ __forceinline__ void stb_absorb(Strobe& s, uint32_t v) {
  stb_xor(s, s.pos, v);
  if (++s.pos == STROBE_R) stb_run_f(s);
}

// PRF: read a byte and zero it.
__device__ __forceinline__ uint32_t stb_squeeze(Strobe& s) {
  uint32_t v = stb_get(s, s.pos);
  s.a[(s.pos >> 3) * FS_THREADS] &= ~(0xFFULL << (8 * (s.pos & 7)));
  if (++s.pos == STROBE_R) stb_run_f(s);
  return v;
}

__device__ __forceinline__ void stb_begin_op(Strobe& s, uint32_t flags,
                                             bool force_f) {
  uint32_t old = (uint32_t)s.pb;
  s.pb = s.pos + 1;
  stb_absorb(s, old);
  stb_absorb(s, flags);
  if (force_f && s.pos != 0) stb_run_f(s);
}

// Merlin's meta-AD of a one-byte label and a little-endian u32.
__device__ __forceinline__ void merlin_meta(Strobe& s, uint32_t label,
                                            uint32_t len) {
  stb_begin_op(s, FLAG_M | FLAG_A, false);
  stb_absorb(s, label);
  for (int i = 0; i < 4; ++i) stb_absorb(s, (len >> (8 * i)) & 0xFFu);
}

// ---------------------------------------------------------------------
// ChaCha20 (djb variant: 64-bit block counter, zero nonce)
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int n) {
  return (v << n) | (v >> (32 - n));
}

#define CHACHA_QR(a, b, c, d) \
  a += b;                     \
  d = rotl32(d ^ a, 16);      \
  c += d;                     \
  b = rotl32(b ^ c, 12);      \
  a += b;                     \
  d = rotl32(d ^ a, 8);       \
  c += d;                     \
  b = rotl32(b ^ c, 7);

__device__ __forceinline__ void chacha20_block(const uint32_t key[8],
                                               uint32_t counter,
                                               uint32_t out[16]) {
  uint32_t init[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                       key[0],      key[1],      key[2],      key[3],
                       key[4],      key[5],      key[6],      key[7],
                       counter,     0u,          0u,          0u};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = init[i];
  for (int i = 0; i < 10; ++i) {
    CHACHA_QR(x[0], x[4], x[8], x[12])
    CHACHA_QR(x[1], x[5], x[9], x[13])
    CHACHA_QR(x[2], x[6], x[10], x[14])
    CHACHA_QR(x[3], x[7], x[11], x[15])
    CHACHA_QR(x[0], x[5], x[10], x[15])
    CHACHA_QR(x[1], x[6], x[11], x[12])
    CHACHA_QR(x[2], x[7], x[8], x[13])
    CHACHA_QR(x[3], x[4], x[9], x[14])
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = x[i] + init[i];
}

// ---------------------------------------------------------------------
// field helpers
// ---------------------------------------------------------------------

// (Both unrolled, so that no index into the words is a run-time value.)
__device__ __forceinline__ int fe_bits(const uint32_t* p) {
  int bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (p[i]) bits = 32 * i + 32 - __clz(p[i]);
  return bits;
}

// a < b on canonical words: the highest word that differs decides.
__device__ __forceinline__ bool fe_lt(const Fe& a, const Fe& b) {
  bool lt = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) lt = a.v[i] == b.v[i] ? lt : a.v[i] < b.v[i];
  return lt;
}

// ---------------------------------------------------------------------
// The field inverse: Bernstein-Yang safegcd, variable time, in the form of
// libsecp256k1's modinv32_var (signed 30-bit limbs, batches of 30
// divsteps on the low words, each batch's 2 x 2 transition matrix then
// applied to (f, g) and to (d, e) mod p), with two changes: every
// update runs over all 9 limbs (no shrinking length, so every array index
// is a compile-time constant and the limbs stay in registers), and a step
// cancels up to 5 bits of g with (3 f) ^ 2, the inverse of f mod 2^5
// (libsecp256k1 looks up 8 bits in a table): 3% more steps than with the
// inverse mod 2^32 by Newton's iteration, each 6 dependent products
// shorter, which made fs_round 8% faster on the H100 (PERF.md).
// L, R and the challenge u are public parts of the proof, so variable time
// leaks nothing. The inverse is unique, so the result equals the plain
// version's Fermat power (ops/fs.py::mont_pow_pm2) bit for bit.
// tests/test_torch_fs_inverse.py transcribes these functions into Python.
// A random 256-bit inverse takes 17 to 19 batches (about 143 inner steps)
// on the fields of the three curves, against some 380 dependent products
// of the Fermat chain.
// ---------------------------------------------------------------------

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
