// One IPA round's Fiat-Shamir step on the card, for Hopper (sm_90a):
// fs_round, one thread per transcript of a lockstep batch.
//
// A port-only kernel: the JAX package runs these steps as XLA ops inside
// its one-program FS prover (ark_bulletproofs_tpu/ops/ipa.py:550-579 and
// :657-687; byte layer ops/fs.py), which has no Pallas kernel. In eager
// PyTorch the same steps would be thousands of launches a round (a Keccak
// permutation is 24 rounds of about 40 tensor ops; an inversion about 330
// products), more than the per-round route's host round trip they remove.
//
// Per transcript b, in one launch: L and R (lanes 2b, 2b + 1 of S) to
// affine (Jacobian: x = X / Z^2, y = Y / Z^3; TE extended: X / Z, Y / Z),
// out of Montgomery form, encoded as arkworks' uncompressed points,
// Merlin append_message "L" and "R", challenge_bytes "u" (32), ChaCha20 and
// Fp::rand with its rejection loop, u^-1. Written out: the affine
// coordinates (canonical), u and u^-1 (Montgomery), the new state bytes,
// and the flags L = O, R = O, ok. The plain version is
// ops/fs.py::fs_round_plain.
//
// What bounds it: the latency of one thread's chain (with P = 128
// transcripts the card runs 4 warps), so the design shortens the chain:
//   * Two inversions a round, each a variable-time safegcd (fs.cuh:
//     17 to 19 batches of 30 divsteps, a few hundred dependent word
//     operations) and one Montgomery product, where the first form ran
//     three Fermat chains of some 380 dependent products each (0.97 ms a
//     round on the H100, PERF.md). L's and R's Z share one fq inversion
//     by Montgomery's trick: 1 / (Z_L Z_R), then two products; a
//     Jacobian identity (Z = 0) enters the product as one and keeps the
//     inverse 0 that the plain version's x^(p-2) gives it.
//   * The STROBE state and the point's words sit in shared memory, where
//     the byte position, known only at run time, can index them; the
//     Keccak lanes are registers during a permutation. Before, the state
//     lived in the thread's local memory (a 336-byte stack frame) and the
//     permutation ran there.
// Three Keccak permutations, a ChaCha20 block and 17 (TE 13) products
// remain per transcript.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fs.cuh"

// Merlin append_message(label, point encoding): x || y, y's last byte
// carrying 1 << 6 (the identity, coordinates zero) or 1 << 7 (-y < y) on a
// short-Weierstrass curve; x || y without flags on a twisted-Edwards one.
// The canonical coordinates are read from `xyw`, this thread's 16 words
// (x then y) in shared memory at stride FS_THREADS.
__device__ __forceinline__ void append_point(Strobe& s, uint32_t label,
                                             const uint32_t* xyw, bool inf,
                                             bool neg, bool te, int bits) {
  int x_size = (bits + 7) / 8;
  int y_size = te ? x_size : (bits + 2 + 7) / 8;
  uint32_t flag = te ? 0u : inf ? (1u << 6) : neg ? (1u << 7) : 0u;
  merlin_meta(s, label, (uint32_t)(x_size + y_size));
  stb_begin_op(s, FLAG_A, false);
  for (int c = 0; c < 2; ++c) {
    const uint32_t* w = xyw + 8 * c * FS_THREADS;
    const int size = c ? y_size : x_size;
    for (int j = 0; j < size; ++j) {
      uint32_t v = inf || j >= 32 ? 0u
                                  : (w[(j >> 2) * FS_THREADS] >> (8 * (j & 3)))
                                        & 0xFFu;
      stb_absorb(s, c && j == size - 1 ? v | flag : v);
    }
  }
}

__global__ void __launch_bounds__(FS_THREADS)
    fs_round_kernel(const int32_t* __restrict__ S,
                    const int32_t* __restrict__ st_in,
                    int32_t* __restrict__ xy, int32_t* __restrict__ u_out,
                    int32_t* __restrict__ st_out,
                    int32_t* __restrict__ flags, int64_t P, int pos, int pb,
                    CurveConst cq, CurveConst cr, InvConst iq,
                    InvConst ir) {
  __shared__ uint64_t lanes[25][FS_THREADS];
  __shared__ uint32_t words[2][16][FS_THREADS];  // L's, R's x then y
  const int tid = threadIdx.x;
  size_t b = (size_t)blockIdx.x * blockDim.x + tid;
  if (b >= (size_t)P) return;
  const bool te = cq.te != 0;
  const size_t L = 2 * (size_t)P;
  const size_t cs = 16 * L;  // coordinate stride of S
  Strobe s;
  s.a = &lanes[0][tid];
  for (int i = 0; i < 25; ++i) {
    uint64_t w = 0;
    for (int j = 0; j < 8; ++j)
      w |= (uint64_t)((uint32_t)st_in[b * 200 + 8 * i + j] & 0xFFu)
           << (8 * j);
    s.a[i * FS_THREADS] = w;
  }
  s.pos = pos;
  s.pb = pb;
  Fe one_plain = fe_zero();
  one_plain.v[0] = 1;
  const int bits = fe_bits(cq.p);
  // 1 / Z_L and 1 / Z_R from one inversion; an identity's inverse is 0.
  const Fe zl = fe_load(S + (te ? 3 : 2) * cs, 0, L, 2 * b);
  const Fe zr = fe_load(S + (te ? 3 : 2) * cs, 0, L, 2 * b + 1);
  const bool zl0 = fe_is_zero(zl), zr0 = fe_is_zero(zr);
  const Fe one = fe_from(cq.one);
  const Fe zl1 = fe_select(zl0, one, zl), zr1 = fe_select(zr0, one, zr);
  const Fe zz = fe_inv_var(fe_mul(zl1, zr1, cq), cq, iq);
  const Fe zis[2] = {fe_select(zl0, fe_zero(), fe_mul(zz, zr1, cq)),
                     fe_select(zr0, fe_zero(), fe_mul(zz, zl1, cq))};
  bool infs[2], negs[2];
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    size_t lane = 2 * b + side;
    Fe X = fe_load(S, 0, L, lane);
    Fe Y = fe_load(S + cs, 0, L, lane);
    const Fe& zi = zis[side];
    Fe xa, ya;
    if (te) {
      xa = fe_mul(X, zi, cq);
      ya = fe_mul(Y, zi, cq);
    } else {
      Fe zi2 = fe_mul(zi, zi, cq);
      xa = fe_mul(X, zi2, cq);
      ya = fe_mul(Y, fe_mul(zi2, zi, cq), cq);
    }
    infs[side] = !te && (side ? zr0 : zl0);
    Fe xc = fe_mul(xa, one_plain, cq);
    Fe yc = fe_mul(ya, one_plain, cq);
    negs[side] = fe_lt(fe_sub(fe_zero(), yc, cq), yc);
    fe_store(xy, 0, L, lane, xc);
    fe_store(xy, 1, L, lane, yc);
    flags[side * P + b] = infs[side] ? 1 : 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      words[side][i][tid] = xc.v[i];
      words[side][8 + i][tid] = yc.v[i];
    }
  }
#pragma unroll
  for (int side = 0; side < 2; ++side)
    append_point(s, side ? 'R' : 'L', &words[side][0][tid], infs[side],
                 negs[side], te, bits);
  // challenge_bytes("u", 32)
  merlin_meta(s, 'u', 32);
  stb_begin_op(s, FLAG_I | FLAG_A | FLAG_C, true);
  uint32_t key[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 32; ++j) key[j >> 2] |= stb_squeeze(s) << (8 * (j & 3));
  // Fp::rand: candidates of four u64 draws, the top limb masked to the
  // field's bits, rejected while >= r.
  const int shave = 256 - fe_bits(cr.p);
  const uint32_t mask = 0xFFFFFFFFu >> shave;
  const Fe r = fe_from(cr.p);
  Fe u = fe_zero();
  bool ok = false;
  for (int blk = 0; blk < RAND_BLOCKS && !ok; ++blk) {
    uint32_t w[16];
    chacha20_block(key, (uint32_t)blk, w);
#pragma unroll
    for (int half = 0; half < 16; half += 8) {
      Fe c;
#pragma unroll
      for (int i = 0; i < 8; ++i) c.v[i] = w[half + i];
      c.v[7] &= mask;
      if (!ok && fe_lt(c, r)) {
        u = c;
        ok = true;
      }
    }
  }
  fe_store(u_out, 0, P, b, u);
  fe_store(u_out, 1, P, b, fe_inv_var(u, cr, ir));
  flags[2 * P + b] = ok ? 1 : 0;
  for (int i = 0; i < 200; ++i) st_out[b * 200 + i] = (int32_t)stb_get(s, i);
}

// inv_words: 18 words, the InvConst of fq then of fr.
extern "C" int abtpu_fs_round(const void* S, const void* st_in, void* xy,
                              void* u, void* st_out, void* flags, int64_t P,
                              int32_t pos, int32_t pb, const void* inv_words,
                              const void* fr_words, const void* words,
                              void* stream) {
  CurveConst cq, cr;
  InvConst iq, ir;
  memcpy(&cq, words, sizeof cq);
  memcpy(&cr, fr_words, sizeof cr);
  memcpy(&iq, inv_words, sizeof iq);
  memcpy(&ir, (const uint32_t*)inv_words + 9, sizeof ir);
  unsigned blocks = (unsigned)((P + FS_THREADS - 1) / FS_THREADS);
  fs_round_kernel<<<blocks, FS_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)S, (const int32_t*)st_in, (int32_t*)xy, (int32_t*)u,
      (int32_t*)st_out, (int32_t*)flags, P, pos, pb, cq, cr, iq, ir);
  return (int)cudaGetLastError();
}
