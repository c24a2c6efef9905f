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
// affine by Z^(p-2) (Jacobian: x = X / Z^2, y = Y / Z^3; TE extended: X / Z,
// Y / Z), out of Montgomery form, encoded as arkworks' uncompressed points,
// Merlin append_message "L" and "R", challenge_bytes "u" (32), ChaCha20 and
// Fp::rand with its rejection loop, u^(r-2). Written out: the affine
// coordinates (canonical), u and u^-1 (Montgomery), the new state bytes,
// and the flags L = O, R = O, ok. The plain version is
// ops/fs.py::fs_round_plain.
//
// What bounds it: operations, of one thread. A round is three inversions
// (about 380 field products each, 264 multiply instructions a product)
// and three Keccak permutations per transcript, a sequential chain; with
// P = 128 transcripts the card runs 4 warps, so the time is one thread's
// latency, not the card's throughput. The kernel is the simple form: the
// state and the Keccak lanes sit in the thread's local memory, the
// position is a kernel argument; spreading a round over more threads is
// work for a later change.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fs.cuh"

#define FS_THREADS 32

// Merlin append_message(label, point encoding): x || y, y's last byte
// carrying 1 << 6 (the identity, coordinates zero) or 1 << 7 (-y < y) on a
// short-Weierstrass curve; x || y without flags on a twisted-Edwards one.
__device__ __forceinline__ void append_point(Strobe& s, uint32_t label,
                                             const Fe& xc, const Fe& yc,
                                             bool inf, bool te, int bits,
                                             const CurveConst& cq) {
  int x_size = (bits + 7) / 8;
  int y_size = te ? x_size : (bits + 2 + 7) / 8;
  uint32_t flag = 0;
  if (!te) flag = inf ? (1u << 6) : (fe_lt(fe_sub(fe_zero(), yc, cq), yc)
                                         ? (1u << 7) : 0u);
  merlin_meta(s, label, (uint32_t)(x_size + y_size));
  stb_begin_op(s, FLAG_A, false);
  for (int j = 0; j < x_size; ++j) stb_absorb(s, inf ? 0u : fe_byte(xc, j));
  for (int j = 0; j < y_size; ++j) {
    uint32_t v = inf ? 0u : fe_byte(yc, j);
    stb_absorb(s, j == y_size - 1 ? v | flag : v);
  }
}

__global__ void __launch_bounds__(FS_THREADS)
    fs_round_kernel(const int32_t* __restrict__ S,
                    const int32_t* __restrict__ st_in,
                    int32_t* __restrict__ xy, int32_t* __restrict__ u_out,
                    int32_t* __restrict__ st_out,
                    int32_t* __restrict__ flags, int64_t P, int pos, int pb,
                    CurveConst cq, CurveConst cr) {
  size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (size_t)P) return;
  const bool te = cq.te != 0;
  const size_t L = 2 * (size_t)P;
  const size_t cs = 16 * L;  // coordinate stride of S
  Strobe s;
  for (int i = 0; i < 25; ++i) s.a[i] = 0;
  for (int i = 0; i < 200; ++i) stb_xor(s, i, (uint32_t)st_in[b * 200 + i]);
  s.pos = pos;
  s.pb = pb;
  Fe one_plain = fe_zero();
  one_plain.v[0] = 1;
  const int bits = fe_bits(cq.p);
  for (int side = 0; side < 2; ++side) {
    size_t lane = 2 * b + side;
    Fe X = fe_load(S, 0, L, lane);
    Fe Y = fe_load(S + cs, 0, L, lane);
    Fe Z = fe_load(S + (te ? 3 : 2) * cs, 0, L, lane);
    Fe zi = fe_inv(Z, cq);
    Fe xa, ya;
    if (te) {
      xa = fe_mul(X, zi, cq);
      ya = fe_mul(Y, zi, cq);
    } else {
      Fe zi2 = fe_mul(zi, zi, cq);
      xa = fe_mul(X, zi2, cq);
      ya = fe_mul(Y, fe_mul(zi2, zi, cq), cq);
    }
    bool inf = !te && fe_is_zero(Z);
    Fe xc = fe_mul(xa, one_plain, cq);
    Fe yc = fe_mul(ya, one_plain, cq);
    fe_store(xy, 0, L, lane, xc);
    fe_store(xy, 1, L, lane, yc);
    flags[side * P + b] = inf ? 1 : 0;
    append_point(s, side ? 'R' : 'L', xc, yc, inf, te, bits, cq);
  }
  // challenge_bytes("u", 32)
  merlin_meta(s, 'u', 32);
  stb_begin_op(s, FLAG_I | FLAG_A | FLAG_C, true);
  uint32_t key[8] = {0, 0, 0, 0, 0, 0, 0, 0};
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
    for (int half = 0; half < 16 && !ok; half += 8) {
      Fe c;
      for (int i = 0; i < 8; ++i) c.v[i] = w[half + i];
      c.v[7] &= mask;
      if (fe_lt(c, r)) {
        u = c;
        ok = true;
      }
    }
  }
  fe_store(u_out, 0, P, b, u);
  fe_store(u_out, 1, P, b, fe_inv(u, cr));
  flags[2 * P + b] = ok ? 1 : 0;
  for (int i = 0; i < 200; ++i) st_out[b * 200 + i] = (int32_t)stb_get(s, i);
}

extern "C" int abtpu_fs_round(const void* S, const void* st_in, void* xy,
                              void* u, void* st_out, void* flags, int64_t P,
                              int32_t pos, int32_t pb, const void* fr_words,
                              const void* words, void* stream) {
  CurveConst cq, cr;
  memcpy(&cq, words, sizeof cq);
  memcpy(&cr, fr_words, sizeof cr);
  unsigned blocks = (unsigned)((P + FS_THREADS - 1) / FS_THREADS);
  fs_round_kernel<<<blocks, FS_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)S, (const int32_t*)st_in, (int32_t*)xy, (int32_t*)u,
      (int32_t*)st_out, (int32_t*)flags, P, pos, pb, cq, cr);
  return (int)cudaGetLastError();
}
