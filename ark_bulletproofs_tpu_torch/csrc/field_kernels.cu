// Elementwise Montgomery product for the prover (ops/field.py::mont_mul),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   mont_mul  <- ark_bulletproofs_tpu/ops/kernels.py::mont_mul_tiled
// which the JAX package reaches through ops/field.py::mont_mul_fast and
// ::from_mont_fast (the IPA fold and round scalars, the table shrink). In
// the port every field product of the prover's device path runs here: the
// vector phase (ops/prove.py), the IPA (ops/ipa.py) and the modular sums
// (ops/field.py::sum_mod).
//
// out = a * b * R^-1 mod p per element, R = 2^256, with fe_mul of
// field.cuh on one thread per element. The constants are those of the
// field the caller multiplies in (the prover's is the scalar field fr):
// the host passes a CurveConst whose p, n0 and one are that field's and
// whose curve words are zero (ops/_build.py::curve_words). `a` is any
// value below 2^256 and `b` is canonical, so a * b < p * 2^256 and the
// CIOS result is below 2p before the final subtraction: the output is
// canonical. sum_mod relies on this to reduce 256-bit column sums.
//
// Layout: a and out are (rows, 16, L) int32, limb-major. b is (rows_b,
// 16, L_b) with rows_b in {1, rows} and L_b in {1, L}: a (16, 1) operand
// (a challenge broadcast over a vector) is read with stride 0 and never
// materialised.
//
// What bounds it: bytes. Each element reads 64 B of a and (unless
// broadcast) 64 B of b and writes 64 B, 3 x 64 B in all, against 264
// 32-bit multiply instructions (8 CIOS steps of 8 wide products for a * b,
// one for m and 8 wide for m * p); at 3.35 TB/s and 132 SMs x 64
// multiplies per clock (1.98 GHz) the bytes take 3.6 times as long. At the
// prover's shapes (6 x 2048 and 9 x 2048 elements at k = 1024) one launch
// is a few microseconds of work, so the launch itself is the larger cost.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "field.cuh"

#define MM_THREADS 256

__global__ void __launch_bounds__(MM_THREADS)
    mont_mul_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, int32_t* __restrict__ out,
                    int64_t rows, int64_t L, int64_t rows_b, int64_t L_b,
                    CurveConst cc) {
  size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * (size_t)L) return;
  size_t row = e / (size_t)L, lane = e % (size_t)L;
  Fe x = fe_load(a, row, L, lane);
  Fe y = fe_load(b, rows_b == 1 ? 0 : row, L_b, L_b == 1 ? 0 : lane);
  fe_store(out, row, L, lane, fe_mul(x, y, cc));
}

extern "C" int abtpu_mont_mul(const void* a, const void* b, void* out,
                              int64_t rows, int64_t L, int64_t rows_b,
                              int64_t L_b, const void* words, void* stream) {
  CurveConst cc;
  memcpy(&cc, words, sizeof cc);
  int64_t n = rows * L;
  unsigned blocks = (unsigned)((n + MM_THREADS - 1) / MM_THREADS);
  mont_mul_kernel<<<blocks, MM_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, rows, L, rows_b,
      L_b, cc);
  return (int)cudaGetLastError();
}
