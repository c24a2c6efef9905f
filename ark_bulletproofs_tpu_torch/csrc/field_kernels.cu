// The prover's elementwise field kernels (ops/field.py, ops/fs.py), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
//   mont_mul  <- ark_bulletproofs_tpu/ops/kernels.py::mont_mul_tiled
// which the JAX package reaches through ops/field.py::mont_mul_fast and
// ::from_mont_fast (the IPA fold and round scalars, the table shrink), and
// adds three port-only kernels for what the JAX package runs as fused XLA
// ops around it:
//   add_sub         a + b, a - b and -a mod p (its field.add / sub / neg);
//   sum_mod         the tail of the modular sum over the lanes (its
//                   sum_mod's carry normalisation and reduction);
//   mont_inv_batch  one field inverse a lane (its mont_inv_batch, a
//                   Montgomery's trick and Fermat chain of mont_mul_fast).
// In the port every field product, add and modular sum of the prover's
// device path runs here: the vector phase (ops/prove.py), the IPA
// (ops/ipa.py), the device verify scalars (ops/verify.py).
//
// Why these four: at the prover's shapes (1 to 18,432 elements, 65,536
// at n = 2^16) a launch is a few microseconds of work, so the launch and
// the host work around it cost more than the products. So the product
// kernel takes an optional third operand, out = a * b +- c, and the
// callers fuse each product whose only use is an add into it (the
// vector phase's l1, r1, r3; the evaluation's Horner, three launches for
// six products and five adds; the fold's a', b'). The adds, in plain
// PyTorch, normalised their carries in a loop on `bool(c.any())`, a
// device-to-host sync each that kept the host from queueing the next
// launch ahead of the card: here they are one launch and no sync. The
// modular sum's tail (16 column carries, two products, an add: three
// product launches and a syncing add before) is one launch of one thread
// a row. The table shrink's batch inverse was 2 lg B + about 335
// dependent launches (Montgomery's trick, then a Fermat power on one
// lane); here each lane inverts its own element by safegcd (inv.cuh,
// about 32,000 cycles on one thread), one launch.
//
// out = a * b * R^-1 mod p per element, R = 2^256, with fe_mul of
// field.cuh; the adds with fe_add / fe_sub. The constants are those of the
// field the caller works in (the prover's is the scalar field fr): the host
// passes a CurveConst whose p, n0 and one are that field's and whose curve
// words are zero (ops/_build.py::curve_words). `a` is any value below
// 2^256, b and c canonical, so a * b < p * 2^256 and the CIOS result is
// below 2p before the final subtraction: every output is canonical, so
// any correct formula gives bit-equal limbs and the kernels equal their
// plain versions (ops/field.py) bit for bit. sum_mod relies on this to
// reduce 256-bit column sums.
//
// Layout: a and out are (rows, 16, L) int32, limb-major. b and c are
// (rows_x, 16, L_x) with rows_x in {1, rows} and L_x in {1, L}: a (16, 1)
// operand (a challenge broadcast over a vector) is read with stride 0 and
// never materialised.
//
// What bounds the product: bytes. Each element reads 64 B of a and (unless
// broadcast) 64 B of b and writes 64 B, 3 x 64 B in all, against 264
// 32-bit multiply instructions (8 CIOS steps of 8 wide products for a * b,
// one for m and 8 wide for m * p); at 3.35 TB/s and 132 SMs x 64
// multiplies per clock (1.98 GHz) the bytes take 3.6 times as long. One
// thread an element, MM_THREADS a block: 128 fills 96 blocks at the
// k = 1024 fold's 12,288 elements, where 256 filled 48 of the 132 SMs.
// On the H100 (bench_kernels.py, FIELD_VARIANTS) 128 and 64 threads were
// within 5% of each other at every path shape from 1 to 65,536 elements
// and 256 up to 1.23 times slower (2.71 against 2.20 us at 2,048;
// PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "field.cuh"
#include "inv.cuh"

#define MM_THREADS 128
// mont_inv_batch's block: a lane is one long chain of dependent word
// operations, so small blocks spread the lanes over more SMs.
#define INV_THREADS 32

// An operand broadcast against (rows, 16, L): rows 1 or rows, L 1 or L.
struct Opnd {
  const int32_t* p;
  int64_t rows, L;
};

__device__ __forceinline__ Fe opnd_load(const Opnd& o, size_t row,
                                        size_t lane) {
  return fe_load(o.p, o.rows == 1 ? 0 : row, (size_t)o.L,
                 o.L == 1 ? 0 : lane);
}

static inline unsigned elem_blocks(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// out = a * b (OP = 0), a * b + c (OP = 1) or a * b - c (OP = -1).
template <int OP>
__global__ void __launch_bounds__(MM_THREADS)
    mont_mul_kernel(const int32_t* __restrict__ a, Opnd b, Opnd c,
                    int32_t* __restrict__ out, int64_t rows, int64_t L,
                    CurveConst cc) {
  size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * (size_t)L) return;
  size_t row = e / (size_t)L, lane = e % (size_t)L;
  Fe r = fe_mul(fe_load(a, row, L, lane), opnd_load(b, row, lane), cc);
  if (OP > 0) r = fe_add(r, opnd_load(c, row, lane), cc);
  if (OP < 0) r = fe_sub(r, opnd_load(c, row, lane), cc);
  fe_store(out, row, L, lane, r);
}

// out = a + b (sign > 0) or a - b; a null `a` reads as zero (-b).
__global__ void __launch_bounds__(MM_THREADS)
    add_sub_kernel(const int32_t* __restrict__ a, Opnd b,
                   int32_t* __restrict__ out, int64_t rows, int64_t L,
                   int32_t sign, CurveConst cc) {
  size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * (size_t)L) return;
  size_t row = e / (size_t)L, lane = e % (size_t)L;
  Fe x = a ? fe_load(a, row, L, lane) : fe_zero();
  Fe y = opnd_load(b, row, lane);
  fe_store(out, row, L, lane, sign > 0 ? fe_add(x, y, cc)
                                       : fe_sub(x, y, cc));
}

// The modular sum's tail, one thread a row: cols (rows, 16) int64 holds the
// exact column sums of a row's limbs over its lanes (each below lanes x
// 2^16). The carries make the wide total lo + c 2^256, lo < 2^256, and
// out (rows, 16, 1) = lo mod p + c 2^256 mod p, by the plain version's
// products: from_mont(to_mont(lo)) (to_mont takes any lo < 2^256) and
// c * R^2 R^-1.
__global__ void __launch_bounds__(MM_THREADS)
    sum_mod_kernel(const int64_t* __restrict__ cols,
                   int32_t* __restrict__ out, int64_t rows, Fe r2,
                   CurveConst cc) {
  size_t row = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (size_t)rows) return;
  const int64_t* col = cols + row * 16;
  int64_t carry = 0;
  Fe lo;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t v0 = col[2 * i] + carry;
    int64_t v1 = col[2 * i + 1] + (v0 >> 16);
    carry = v1 >> 16;
    lo.v[i] = (uint32_t)(v0 & 0xFFFF) | ((uint32_t)(v1 & 0xFFFF) << 16);
  }
  Fe c = fe_zero();
  c.v[0] = (uint32_t)carry;
  c.v[1] = (uint32_t)((uint64_t)carry >> 32);
  Fe one = fe_zero();
  one.v[0] = 1;
  Fe r = fe_add(fe_mul(fe_mul(lo, r2, cc), one, cc), fe_mul(c, r2, cc), cc);
  fe_store(out, row, 1, 0, r);
}

// The inverse of each of B Montgomery elements z (16, B), in Montgomery
// form, 0 for 0; with `mul` (rows, 16, B), out = mul[r] * z^-1 per row
// instead (the shrink's affine X / Z and Y / Z).
__global__ void __launch_bounds__(INV_THREADS)
    mont_inv_batch_kernel(const int32_t* __restrict__ z,
                          const int32_t* __restrict__ mul,
                          int32_t* __restrict__ out, int64_t B,
                          int64_t rows, CurveConst cc, InvConst ic) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  Fe x = fe_load(z, 0, B, lane);
  Fe inv = fe_is_zero(x) ? fe_zero() : fe_inv_var(x, cc, ic);
  if (!mul) {
    fe_store(out, 0, B, lane, inv);
    return;
  }
  for (int64_t r = 0; r < rows; ++r)
    fe_store(out, r, B, lane, fe_mul(fe_load(mul, r, B, lane), inv, cc));
}

// sign: 0 for a * b (c unused), > 0 for a * b + c, < 0 for a * b - c.
extern "C" int abtpu_mont_mul(const void* a, const void* b, const void* c,
                              void* out, int64_t rows, int64_t L,
                              int64_t rows_b, int64_t L_b, int64_t rows_c,
                              int64_t L_c, int32_t sign, const void* words,
                              void* stream) {
  CurveConst cc;
  memcpy(&cc, words, sizeof cc);
  const Opnd ob{(const int32_t*)b, rows_b, L_b};
  const Opnd oc{(const int32_t*)c, rows_c, L_c};
  const unsigned blocks = elem_blocks(rows * L, MM_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (sign == 0)
    mont_mul_kernel<0><<<blocks, MM_THREADS, 0, s>>>(
        (const int32_t*)a, ob, oc, (int32_t*)out, rows, L, cc);
  else if (sign > 0)
    mont_mul_kernel<1><<<blocks, MM_THREADS, 0, s>>>(
        (const int32_t*)a, ob, oc, (int32_t*)out, rows, L, cc);
  else
    mont_mul_kernel<-1><<<blocks, MM_THREADS, 0, s>>>(
        (const int32_t*)a, ob, oc, (int32_t*)out, rows, L, cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_add_sub(const void* a, const void* b, void* out,
                             int64_t rows, int64_t L, int64_t rows_b,
                             int64_t L_b, int32_t sign, const void* words,
                             void* stream) {
  CurveConst cc;
  memcpy(&cc, words, sizeof cc);
  add_sub_kernel<<<elem_blocks(rows * L, MM_THREADS), MM_THREADS, 0,
                   (cudaStream_t)stream>>>(
      (const int32_t*)a, Opnd{(const int32_t*)b, rows_b, L_b},
      (int32_t*)out, rows, L, sign, cc);
  return (int)cudaGetLastError();
}

// r2_words: R^2 mod p, 8 host words.
extern "C" int abtpu_sum_mod(const void* cols, void* out, int64_t rows,
                             const void* r2_words, const void* words,
                             void* stream) {
  CurveConst cc;
  Fe r2;
  memcpy(&cc, words, sizeof cc);
  memcpy(&r2, r2_words, sizeof r2);
  sum_mod_kernel<<<elem_blocks(rows, MM_THREADS), MM_THREADS, 0,
                   (cudaStream_t)stream>>>((const int64_t*)cols,
                                           (int32_t*)out, rows, r2, cc);
  return (int)cudaGetLastError();
}

// inv_words: the field's 9-word InvConst (ops/fs.py::inv_words); mul may
// be null (rows unused).
extern "C" int abtpu_mont_inv_batch(const void* z, const void* mul,
                                    void* out, int64_t B, int64_t rows,
                                    const void* inv_words, const void* words,
                                    void* stream) {
  CurveConst cc;
  InvConst ic;
  memcpy(&cc, words, sizeof cc);
  memcpy(&ic, inv_words, sizeof ic);
  mont_inv_batch_kernel<<<elem_blocks(B, INV_THREADS), INV_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)z, (const int32_t*)mul, (int32_t*)out, B, rows, cc,
      ic);
  return (int)cudaGetLastError();
}
