// The four kernels of the v2 Pippenger MSM (ops/msm2.py), for Hopper (sm_90a).
//
// Replaces the TPU kernels:
//   suffix_madd_scan  <- ark_bulletproofs_tpu/ops/kernels2.py::suffix_madd_scan
//   suffix_jac_scan   <- ark_bulletproofs_tpu/ops/kernels2.py::suffix_jac_scan
//   rowsum            <- ark_bulletproofs_tpu/ops/kernels2.py::rowsum_jac
//   rcb_double_k_add  <- ark_bulletproofs_tpu/ops/kernels.py::rcb_double_k_add_tiled
//                        and, with k = 0, ::rcb_add_tiled
//
// Design: one thread per lane, the running point in registers. On the TPU
// the row loop was the grid's sequential dimension with a VMEM scratch
// carry; on Hopper blocks run in no order, so the loop over rows moves into
// the thread. Lanes are columns of independent sums, so no block needs
// another's result.
//
// What bounds them: integer multiply throughput. One mixed add is ~11
// Montgomery products of 64 32 x 32-bit multiply-adds each plus the
// reduction, against 2 x 64 bytes read and 3 x 64 bytes written; at the
// main path's shape (n = 2^20: R = 1024 rows, L = 22,528 lanes) the scan
// reads 2.9 GB and writes 4.4 GB, well under a second of HBM time, while the
// arithmetic is the larger share. The loads and stores are limb-major, so
// the 32 threads of a warp touch 32 consecutive int32 (one 128-byte line)
// per limb. __launch_bounds__(128): a madd keeps about a dozen field
// elements (~100 registers) live. Occupancy is the first thing a later
// optimisation looks at: 22,528 lanes are ~176 blocks of 128 threads on
// 132 SMs, about one block per SM.
//
// Each launcher is extern "C", takes device pointers and the stream as
// void*, the curve constants as a pointer to 36 host words, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "rcb.cuh"

static_assert(sizeof(CurveConst) == 36 * 4, "CurveConst layout");

#define THREADS 128

// out[:, r] = sum_{r' >= r} (x, y)[r'] per lane, scanned from the last row
// up. xy: (2, R, 16, L) affine Montgomery coords; a row with y = 0 is the
// identity (no point of an odd-order short-Weierstrass curve has y = 0).
// out: (3, R, 16, L).
template <bool AZ>
__global__ void __launch_bounds__(THREADS)
    suffix_madd_scan_kernel(const int32_t* __restrict__ xy,
                            int32_t* __restrict__ out, int64_t R, int64_t L,
                            CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)L) return;
  const int32_t* ys = xy + (size_t)R * 16 * L;
  Pt acc = pt_identity(cc);
  for (int64_t r = R - 1; r >= 0; --r) {
    Fe qx = fe_load(xy, r, L, lane);
    Fe qy = fe_load(ys, r, L, lane);
    acc = rcb_madd<AZ>(acc, qx, qy, fe_is_zero(qy), cc);
    pt_store(out, R, r, L, lane, acc);
  }
}

// excl[:, r] = sum_{r' > r} in[:, r'], tot = sum over all rows.
// in, excl: (3, R, 16, L); tot: (3, 1, 16, L).
template <bool AZ>
__global__ void __launch_bounds__(THREADS)
    suffix_jac_scan_kernel(const int32_t* __restrict__ in,
                           int32_t* __restrict__ excl,
                           int32_t* __restrict__ tot, int64_t R, int64_t L,
                           CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)L) return;
  Pt acc = pt_identity(cc);
  for (int64_t r = R - 1; r >= 0; --r) {
    pt_store(excl, R, r, L, lane, acc);
    acc = rcb_add<AZ>(acc, pt_load(in, R, r, L, lane), cc);
  }
  pt_store(tot, 1, 0, L, lane, acc);
}

// out = in[:, 0] + in[:, 1] + ... + in[:, K-1], added in that order.
// in: (3, K, 16, L); out: (3, 1, 16, L).
template <bool AZ>
__global__ void __launch_bounds__(THREADS)
    rowsum_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                  int64_t K, int64_t L, CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)L) return;
  Pt acc = pt_identity(cc);
  for (int64_t r = 0; r < K; ++r) {
    acc = rcb_add<AZ>(acc, pt_load(in, K, r, L, lane), cc);
  }
  pt_store(out, 1, 0, L, lane, acc);
}

// out = 2^k * P + Q elementwise; P, Q, out: (3, 1, 16, m).
template <bool AZ>
__global__ void __launch_bounds__(THREADS)
    rcb_double_k_add_kernel(const int32_t* __restrict__ P,
                            const int32_t* __restrict__ Q,
                            int32_t* __restrict__ out, int64_t m, int32_t k,
                            CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)m) return;
  Pt acc = pt_load(P, 1, 0, m, lane);
  for (int32_t i = 0; i < k; ++i) acc = rcb_double<AZ>(acc, cc);
  acc = rcb_add<AZ>(acc, pt_load(Q, 1, 0, m, lane), cc);
  pt_store(out, 1, 0, m, lane, acc);
}

static inline CurveConst load_cc(const void* words) {
  CurveConst cc;
  memcpy(&cc, words, sizeof cc);
  return cc;
}

static inline unsigned blocks_for(int64_t lanes) {
  return (unsigned)((lanes + THREADS - 1) / THREADS);
}

extern "C" int abtpu_suffix_madd_scan(const void* xy, void* out, int64_t R,
                                      int64_t L, const void* words,
                                      void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.a_zero)
    suffix_madd_scan_kernel<true><<<blocks_for(L), THREADS, 0, s>>>(
        (const int32_t*)xy, (int32_t*)out, R, L, cc);
  else
    suffix_madd_scan_kernel<false><<<blocks_for(L), THREADS, 0, s>>>(
        (const int32_t*)xy, (int32_t*)out, R, L, cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_suffix_jac_scan(const void* in, void* excl, void* tot,
                                     int64_t R, int64_t L, const void* words,
                                     void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.a_zero)
    suffix_jac_scan_kernel<true><<<blocks_for(L), THREADS, 0, s>>>(
        (const int32_t*)in, (int32_t*)excl, (int32_t*)tot, R, L, cc);
  else
    suffix_jac_scan_kernel<false><<<blocks_for(L), THREADS, 0, s>>>(
        (const int32_t*)in, (int32_t*)excl, (int32_t*)tot, R, L, cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_rowsum(const void* in, void* out, int64_t K, int64_t L,
                            const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.a_zero)
    rowsum_kernel<true><<<blocks_for(L), THREADS, 0, s>>>(
        (const int32_t*)in, (int32_t*)out, K, L, cc);
  else
    rowsum_kernel<false><<<blocks_for(L), THREADS, 0, s>>>(
        (const int32_t*)in, (int32_t*)out, K, L, cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_rcb_double_k_add(const void* P, const void* Q, void* out,
                                      int64_t m, int32_t k, const void* words,
                                      void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.a_zero)
    rcb_double_k_add_kernel<true><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (const int32_t*)Q, (int32_t*)out, m, k, cc);
  else
    rcb_double_k_add_kernel<false><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (const int32_t*)Q, (int32_t*)out, m, k, cc);
  return (int)cudaGetLastError();
}
