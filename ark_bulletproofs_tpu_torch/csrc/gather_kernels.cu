// The row gathers, for Hopper (sm_90a).
//
// Replaces the TPU kernel:
//   stage_gather <- tools/probe_dma_gather.py:67 (the per-row DMA gather
//                   probe, one async copy descriptor a row from the scalar
//                   core, written to find out whether the v2 MSM's stage B
//                   should switch to it), made the v2 MSM's stage B
//                   (ops/msm2.py::_stage_gather): it writes stage C's
//                   limb-major affine rows straight from the sort order
//   row_gather   <- the same probe in its flat form, out[k, :] =
//                   tbl[idx[k], :] for an (n, 16) int32 table; on no path
//
// stage_gather: xy[t, r, k, l] = limb k of coordinate t (x, or y with
// identity rows set to y = 0) of table row idx(r, l), for lane l = bw * C +
// col and sorted slot i = col * R + r, where idx = order[bw, i], or
// base_map[bw / W, order[bw, i]] with a base map. The output is (2, R, 16,
// L) int32, L = BW * C.
//
// What bounds it: bytes. At n = 2^20 (R = 256, L = 90,112) it writes
// 2.95 GB once, reads the 185 MB int64 order once and the table's 2^20
// points: 3.27 GB, about 0.98 ms at 3.35 TB/s. The torch stage it replaces
// gathered the 128-byte rows of a (m, 2, 16) table into an (R, L, 2, 16)
// intermediate, then wrote it again through a permute with a stride of 32
// words, and made the order's (R, L) permute-copy first. Design:
//   - the table is packed as the JAX package packs it, x | y << 16, one
//     64-byte row a point (limbs are 16 bits; the table kernel below): the
//     67 MB table is a third larger than the 50 MB L2, where the 128-byte
//     table is 2.7 times larger, and every window reads each row once in
//     a random order, so the packed rows halve the random-read bytes and
//     more of them hit in L2; the store unpacks;
//   - a table kernel packs the rows first (stage_table_kernel: each limb
//     plane read along the points, the rows written contiguously through
//     shared memory), 2.6 to 3.8 times faster than the same packing in
//     torch;
//   - a block of the gather takes a tile of STAGE_POINTS = 256 points: tr
//     rows r (STAGE_ROWS = 8, fewer where R is smaller) of tl =
//     STAGE_POINTS / tr lanes (32 at tr = 8). Its threads read the order
//     of tr consecutive slots of each column (64 contiguous bytes of int64:
//     whole sectors; a tile over lanes alone would read a sector for every
//     8 bytes), compose the base map there, then load each point's row as
//     four 16-byte vectors into shared memory (rows padded to 17 words, so
//     the transpose reads without bank conflicts), and write each
//     (coordinate, row r, limb) run of the tile's lanes contiguously: 128
//     bytes a warp, streaming stores (__stcs); the order is read with
//     streaming loads and the table rows under an L2 evict_last policy,
//     so the streams make room before the table;
//   - every offset is 64-bit: the output passes 2^31 words from B = 3 at
//     n = 2^20.
// On the H100 (PERF.md, bench_kernels.py --parts stage_gather) the gather
// runs at about twice its bound: with every table row an L2 hit (a table of
// 4,096 rows) it writes at about 2.4 TB/s, and the misses of the 67 MB
// table cost the rest. Tiles of 2 to 16 rows and of 512 points, the
// other block order and the (m, 2, 16) table of 128-byte rows each
// lost or tied (bench_kernels.py carries each as a
// text substitution of this source). The evict_last policy on every
// line, on half or a quarter of them, no hint and write-back stores came
// within about 4% of each other, in an order that changed from bench to
// bench (every line ahead of no hint on three of four). An L2
// persisting window over the table needs the context's persisting
// set-aside, under which this kernel ran 2.3 times slower: it was left
// out.
// An index outside the order's or the table's rows fails a device-side
// assert, as torch's own index kernels do.
//
// row_gather: four threads a row, each moving one 16-byte vector (int4), so
// a warp reads eight whole 64-byte rows and writes 512 contiguous bytes,
// with streaming stores.
//
// The launchers are extern "C", take device pointers and the stream as
// void*, and return cudaGetLastError().
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

// stage_gather's tile: STAGE_POINTS points a block (a power of two), over
// at most STAGE_ROWS rows r (a power of two).
#define STAGE_THREADS 256
#define STAGE_POINTS 256
#define STAGE_ROWS 8

__host__ __device__ constexpr int lg2(int x) {
  return x > 1 ? 1 + lg2(x >> 1) : 0;
}

// The table, TABLE_POINTS points a block: limb k of each coordinate read
// along the points from its (16, m) plane (row stride ld), packed x | y <<
// 16, the rows written contiguously through shared memory (padded to RW +
// 1 words).
#define TABLE_POINTS 128

__global__ void __launch_bounds__(STAGE_THREADS)
    stage_table_kernel(const int32_t* __restrict__ X,
                       const int32_t* __restrict__ Y,
                       const uint8_t* __restrict__ inf, int64_t ldx,
                       int64_t ldy, int64_t m, uint32_t* __restrict__ tbl) {
  constexpr int RW = 16;  // words a table row
  __shared__ uint32_t s[TABLE_POINTS * (RW + 1)];
  const int64_t j0 = (int64_t)blockIdx.x * TABLE_POINTS;
  for (int f = threadIdx.x; f < 16 * TABLE_POINTS; f += STAGE_THREADS) {
    const int k = f / TABLE_POINTS, t = f % TABLE_POINTS;
    const int64_t j = j0 + t;
    if (j < m) {
      const uint32_t x = X[k * ldx + j], y = inf[j] ? 0 : Y[k * ldy + j];
      s[t * (RW + 1) + k] = x | (y << 16);
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < RW * TABLE_POINTS; f += STAGE_THREADS) {
    const int t = f / RW, k = f % RW;
    if (j0 + t < m) tbl[(j0 + t) * RW + k] = s[t * (RW + 1) + k];
  }
}

extern "C" int abtpu_stage_table(const void* X, const void* Y,
                                 const void* inf, int64_t ldx, int64_t ldy,
                                 int64_t m, void* tbl, void* stream) {
  const int64_t blocks = (m + TABLE_POINTS - 1) / TABLE_POINTS;
  if (blocks >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  stage_table_kernel<<<(unsigned)blocks, STAGE_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)X, (const int32_t*)Y, (const uint8_t*)inf, ldx, ldy, m,
      (uint32_t*)tbl);
  return (int)cudaGetLastError();
}

// A table row's vector, loaded under the L2 policy `keep` (evict_last):
// the streamed order and output lines make room before the table's.
__device__ __forceinline__ int4 ld_keep(const int4* p, uint64_t keep) {
  int4 q;
  asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
      : "l"(p), "l"(keep));
  return q;
}

__device__ __forceinline__ int64_t ld_stream(const int64_t* p) {
  return (int64_t)__ldcs((const long long*)p);
}
__device__ __forceinline__ int64_t ld_stream(const int32_t* p) {
  return __ldcs(p);
}

template <class I>
__global__ void __launch_bounds__(STAGE_THREADS)
    stage_gather_kernel(const int4* __restrict__ tbl,
                        const I* __restrict__ order,
                        const int32_t* __restrict__ bmap,
                        int32_t* __restrict__ out, int64_t m, int64_t n,
                        int64_t R, uint32_t C, uint32_t W, uint32_t L,
                        int lg_tr) {
  constexpr int RW = 16;  // words a table row
  constexpr int VEC = RW / 4;  // 16-byte vectors a row
  constexpr int SW = RW + 1;   // padded words a row in smem
  __shared__ int32_t sidx[STAGE_POINTS];
  __shared__ uint32_t srow[STAGE_POINTS * SW];

  const int tr = 1 << lg_tr, lg_tl = lg2(STAGE_POINTS) - lg_tr;
  const int tl = 1 << lg_tl;
  // A row tile's lane tiles in consecutive blocks.
  const int64_t nlt = ((int64_t)L + tl - 1) >> lg_tl;
  const int64_t rt = blockIdx.x / nlt, lt = blockIdx.x - rt * nlt;
  const int64_t l0 = lt << lg_tl, r0 = rt << lg_tr;

  // The order: consecutive threads read consecutive slots of a column.
  for (int f = threadIdx.x; f < STAGE_POINTS; f += STAGE_THREADS) {
    const int lane = f >> lg_tr, rr = f & (tr - 1);
    const int64_t l = l0 + lane, r = r0 + rr;
    int64_t v = -1;
    if (l < L && r < R) {
      const uint32_t bw = (uint32_t)l / C, col = (uint32_t)l - bw * C;
      v = ld_stream(order + (int64_t)bw * n + (int64_t)col * R + r);
      if (bmap) {
        assert(v >= 0 && v < n);
        v = bmap[(int64_t)(bw / W) * n + v];
      }
      assert(v >= 0 && v < m);
    }
    sidx[(rr << lg_tl) + lane] = (int32_t)v;
  }
  __syncthreads();

  // The rows: VEC threads a point, all loads in flight before the stores.
  constexpr int LOADS = STAGE_POINTS * VEC / STAGE_THREADS;
  int4 q[LOADS];
  uint64_t keep;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int f = j * STAGE_THREADS + threadIdx.x;
    const int32_t row = sidx[f / VEC];
    q[j] = make_int4(0, 0, 0, 0);
    if (row >= 0) q[j] = ld_keep(tbl + (int64_t)row * VEC + f % VEC, keep);
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int f = j * STAGE_THREADS + threadIdx.x;
    uint32_t* s = srow + (f / VEC) * SW + 4 * (f % VEC);
    s[0] = q[j].x;
    s[1] = q[j].y;
    s[2] = q[j].z;
    s[3] = q[j].w;
  }
  __syncthreads();

  // The transpose: a warp writes 32 consecutive lanes of one (t, r, limb).
  const int64_t plane = R * 16 * (int64_t)L;  // words of one coordinate
#pragma unroll 4
  for (int j = 0; j < 16 * STAGE_POINTS / STAGE_THREADS; ++j) {
    const int f = j * STAGE_THREADS + threadIdx.x;
    const int lane = f & (tl - 1), k = (f >> lg_tl) & 15,
              rr = f >> (lg_tl + 4);
    const int64_t l = l0 + lane, r = r0 + rr;
    if (l < L && r < R) {
      const uint32_t* s = srow + ((rr << lg_tl) + lane) * SW;
      const int64_t o = (r * 16 + k) * L + l;
      const uint32_t w = s[k];
      __stcs(out + o, (int32_t)(w & 0xFFFF));
      __stcs(out + plane + o, (int32_t)(w >> 16));
    }
  }
}

// tr: the largest power of two at most STAGE_ROWS and R.
extern "C" int abtpu_stage_gather(const void* tbl, const void* order,
                                  const void* bmap, void* out, int64_t m,
                                  int64_t n, int64_t R, int64_t C, int64_t W,
                                  int64_t BW, int32_t order64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int lg_tr = 0;
  while ((2 << lg_tr) <= STAGE_ROWS && (2 << lg_tr) <= R) ++lg_tr;
  const int64_t L = BW * C, tl = STAGE_POINTS >> lg_tr;
  const int64_t blocks = ((L + tl - 1) / tl) * ((R + (1 << lg_tr) - 1) >>
                                                lg_tr);
  if (L >= (int64_t)1 << 32 || blocks >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  if (order64)
    stage_gather_kernel<int64_t><<<(unsigned)blocks, STAGE_THREADS, 0, s>>>(
        (const int4*)tbl, (const int64_t*)order, (const int32_t*)bmap,
        (int32_t*)out, m, n, R, (uint32_t)C, (uint32_t)W, (uint32_t)L, lg_tr);
  else
    stage_gather_kernel<int32_t><<<(unsigned)blocks, STAGE_THREADS, 0, s>>>(
        (const int4*)tbl, (const int32_t*)order, (const int32_t*)bmap,
        (int32_t*)out, m, n, R, (uint32_t)C, (uint32_t)W, (uint32_t)L, lg_tr);
  return (int)cudaGetLastError();
}
