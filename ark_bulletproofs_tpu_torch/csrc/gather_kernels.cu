// A row gather of 64-byte rows, for Hopper (sm_90a): out[k, :] =
// tbl[idx[k], :] for an (n, 16) int32 table and K int64 or int32 indices.
//
// Replaces the TPU kernel:
//   row_gather <- tools/probe_dma_gather.py (the per-row DMA gather probe,
//                 one async copy descriptor a row from the scalar core)
//
// It is a probe beside the v2 MSM's stage B (ops/msm2.py::_stage_gather),
// which gathers the sorted points with a torch index; no path calls it.
//
// What bounds it: bytes. Each row is read once from a random place and
// written once in order, 128 bytes a row plus its index, and no
// arithmetic. Design: four threads a row, each moving one 16-byte vector
// (int4), so a warp reads eight whole 64-byte rows (two 32-byte sectors
// each) and writes 512 contiguous bytes. The output is written with
// streaming stores (__stcs): it is not read again by this kernel and
// should not push the table out of the 50 MB L2. An index outside [0, n)
// fails a device-side assert, as torch's own index kernels do.
//
// The launcher is extern "C", takes device pointers and the stream as
// void*, and returns cudaGetLastError().
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GATHER_THREADS 256

template <class I>
__global__ void __launch_bounds__(GATHER_THREADS)
    row_gather_kernel(const int4* __restrict__ tbl, const I* __restrict__ idx,
                      int4* __restrict__ out, int64_t K, int64_t n) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 4 * K) return;
  int64_t r = (int64_t)idx[t >> 2];
  assert(r >= 0 && r < n);
  __stcs(out + t, tbl[4 * r + (t & 3)]);
}

extern "C" int abtpu_row_gather(const void* tbl, const void* idx, void* out,
                                int64_t K, int64_t n, int32_t idx64,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned blocks = (unsigned)((4 * K + GATHER_THREADS - 1) / GATHER_THREADS);
  if (idx64)
    row_gather_kernel<int64_t><<<blocks, GATHER_THREADS, 0, s>>>(
        (const int4*)tbl, (const int64_t*)idx, (int4*)out, K, n);
  else
    row_gather_kernel<int32_t><<<blocks, GATHER_THREADS, 0, s>>>(
        (const int4*)tbl, (const int32_t*)idx, (int4*)out, K, n);
  return (int)cudaGetLastError();
}
