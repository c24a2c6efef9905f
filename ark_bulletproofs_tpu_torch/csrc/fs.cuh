// The device byte layer of the on-device Fiat-Shamir IPA, one thread per
// transcript: Keccak-f[1600], STROBE-128 and Merlin, ChaCha20 and arkworks
// Fp::rand, and arkworks' uncompressed point encodings (the field inverse,
// Bernstein-Yang safegcd, is in inv.cuh). fs_kernels.cu composes them
// into one IPA round (fs_round_kernel); the plain PyTorch versions are in
// ops/fs.py.
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
#include "inv.cuh"

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
