// The group-law kernels of the v2 Pippenger MSM (ops/msm2.py) and of the
// device Pedersen batch (ops/prove.py), for Hopper (sm_90a).
//
// Replaces the TPU kernels:
//   suffix_madd_scan  <- ark_bulletproofs_tpu/ops/kernels2.py::suffix_madd_scan
//                        (its TE body: ops/kernels.py::te_madd_tiled's)
//   suffix_jac_scan   <- ark_bulletproofs_tpu/ops/kernels2.py::suffix_jac_scan
//   rowsum            <- ark_bulletproofs_tpu/ops/kernels2.py::rowsum_jac
//   rcb_double_k_add  <- ark_bulletproofs_tpu/ops/kernels.py::rcb_double_k_add_tiled
//                        and, with k = 0, ::rcb_add_tiled
//   te_double_k_add   <- ark_bulletproofs_tpu/ops/kernels.py::te_double_k_add_tiled
//                        and, with k = 0, ::te_add_tiled
//   te_double         <- ark_bulletproofs_tpu/ops/kernels.py::te_double_tiled
//   jac_double_k_add  <- ark_bulletproofs_tpu/ops/kernels.py::sw_add_tiled
//                        (k = 0) and ::sw_double_k_add_tiled (k > 0)
//   jac_double        <- ark_bulletproofs_tpu/ops/kernels.py::sw_double_tiled
//   rcb_double        <- ark_bulletproofs_tpu/ops/kernels.py::rcb_double_tiled
//   jac_madd          <- ark_bulletproofs_tpu/ops/kernels.py::sw_madd_tiled
//   te_madd           <- ark_bulletproofs_tpu/ops/kernels.py::te_madd_tiled
//                        (its elementwise launcher; the body also runs in
//                        the TE suffix_madd_scan)
//   horner            <- ark_bulletproofs_tpu/ops/kernels2.py::horner_windows
//                        (RCB, and here also TE extended points)
//   jac_horner        <- the same Horner on Jacobian points
//
// Each kernel is a template over a point model: RcbModel<true> (RCB, a = 0:
// secq256k1), RcbModel<false> (RCB, general a: zorro) and TeModel (HWCD
// extended: curve25519); JacModel<AZ> (Jacobian, jac.cuh) instantiates
// only the elementwise double-k-add, doubling and mixed add and the
// window Horner, for the Q terms of the on-device Fiat-Shamir IPA and the
// v1 Pippenger (no scan runs on Jacobian points). A model supplies the point type, its identity,
// add, mixed add, doubling, load and store; the launchers pick it from the
// constants (te, a_zero), so each kernel is compiled once per model and
// carries no dead registers of another. A 3-coordinate model reads and
// writes (3, rows, 16, L) arrays, TeModel (4, rows, 16, L).
//
// Design: one thread per lane, the running point in registers. On the TPU
// the row loop was the grid's sequential dimension with a VMEM scratch
// carry; on Hopper blocks run in no order, so the loop over rows moves into
// the thread. Lanes are columns of independent sums, so no block needs
// another's result.
//
// What bounds them: integer multiply throughput. One mixed add is 11
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
// A TE point is 4 x 8 words against 3 x 8: the TE scans write a third
// more bytes (5.9 GB at the n = 2^20 shape) for the same 11 products a
// mixed add.
//
// Each launcher is extern "C", takes device pointers and the stream as
// void*, the curve constants as a pointer to 45 host words, and returns
// cudaGetLastError() (cudaErrorInvalidValue, without a launch, for a
// curve of the wrong model).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "jac.cuh"
#include "rcb.cuh"
#include "te.cuh"

#define THREADS 128

template <bool AZ>
struct RcbModel {
  using P = Pt;
  static __device__ __forceinline__ P identity(const CurveConst& cc) {
    return pt_identity(cc);
  }
  static __device__ __forceinline__ P add(const P& a, const P& b,
                                          const CurveConst& cc) {
    return rcb_add<AZ>(a, b, cc);
  }
  static __device__ __forceinline__ P madd(const P& a, const Fe& qx,
                                           const Fe& qy, bool q_inf,
                                           const CurveConst& cc) {
    return rcb_madd<AZ>(a, qx, qy, q_inf, cc);
  }
  static __device__ __forceinline__ P dbl(const P& a, const CurveConst& cc) {
    return rcb_double<AZ>(a, cc);
  }
  static __device__ __forceinline__ P load(const int32_t* base, size_t rows,
                                           size_t row, size_t L,
                                           size_t lane) {
    return pt_load(base, rows, row, L, lane);
  }
  static __device__ __forceinline__ void store(int32_t* base, size_t rows,
                                               size_t row, size_t L,
                                               size_t lane, const P& a) {
    pt_store(base, rows, row, L, lane, a);
  }
};

struct TeModel {
  using P = Pt4;
  static __device__ __forceinline__ P identity(const CurveConst& cc) {
    return te_identity(cc);
  }
  static __device__ __forceinline__ P add(const P& a, const P& b,
                                          const CurveConst& cc) {
    return te_add(a, b, cc);
  }
  static __device__ __forceinline__ P madd(const P& a, const Fe& qx,
                                           const Fe& qy, bool q_inf,
                                           const CurveConst& cc) {
    return te_madd(a, qx, qy, q_inf, cc);
  }
  static __device__ __forceinline__ P dbl(const P& a, const CurveConst& cc) {
    return te_double(a, cc);
  }
  static __device__ __forceinline__ P load(const int32_t* base, size_t rows,
                                           size_t row, size_t L,
                                           size_t lane) {
    return pt4_load(base, rows, row, L, lane);
  }
  static __device__ __forceinline__ void store(int32_t* base, size_t rows,
                                               size_t row, size_t L,
                                               size_t lane, const P& a) {
    pt4_store(base, rows, row, L, lane, a);
  }
};

// Jacobian short-Weierstrass points (X, Y, Z) = (x Z^2, y Z^3), identity
// (0, 0, 0), not RCB's (0, R, 0).
template <bool AZ>
struct JacModel {
  using P = Pt;
  static __device__ __forceinline__ P identity(const CurveConst&) {
    return jac_identity();
  }
  static __device__ __forceinline__ P add(const P& a, const P& b,
                                          const CurveConst& cc) {
    return jac_add<AZ>(a, b, cc);
  }
  static __device__ __forceinline__ P madd(const P& a, const Fe& qx,
                                           const Fe& qy, bool q_inf,
                                           const CurveConst& cc) {
    return jac_madd<AZ>(a, qx, qy, q_inf, cc);
  }
  static __device__ __forceinline__ P dbl(const P& a, const CurveConst& cc) {
    return jac_double<AZ>(a, cc);
  }
  static __device__ __forceinline__ P load(const int32_t* base, size_t rows,
                                           size_t row, size_t L,
                                           size_t lane) {
    return pt_load(base, rows, row, L, lane);
  }
  static __device__ __forceinline__ void store(int32_t* base, size_t rows,
                                               size_t row, size_t L,
                                               size_t lane, const P& a) {
    pt_store(base, rows, row, L, lane, a);
  }
};

using RcbA0 = RcbModel<true>;
using RcbA = RcbModel<false>;

// out[:, r] = sum_{r' >= r} (x, y)[r'] per lane, scanned from the last row
// up. xy: (2, R, 16, L) affine Montgomery coords; a row with y = 0 is the
// identity (no point of an odd-order short-Weierstrass curve, and no point
// of curve25519's prime-order subgroup, has y = 0). out: (NC, R, 16, L).
template <class M>
__global__ void __launch_bounds__(THREADS)
    suffix_madd_scan_kernel(const int32_t* __restrict__ xy,
                            int32_t* __restrict__ out, int64_t R, int64_t L,
                            CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)L) return;
  const int32_t* ys = xy + (size_t)R * 16 * L;
  typename M::P acc = M::identity(cc);
  for (int64_t r = R - 1; r >= 0; --r) {
    Fe qx = fe_load(xy, r, L, lane);
    Fe qy = fe_load(ys, r, L, lane);
    acc = M::madd(acc, qx, qy, fe_is_zero(qy), cc);
    M::store(out, R, r, L, lane, acc);
  }
}

// excl[:, r] = sum_{r' > r} in[:, r'], tot = sum over all rows.
// in, excl: (NC, R, 16, L); tot: (NC, 1, 16, L).
template <class M>
__global__ void __launch_bounds__(THREADS)
    suffix_jac_scan_kernel(const int32_t* __restrict__ in,
                           int32_t* __restrict__ excl,
                           int32_t* __restrict__ tot, int64_t R, int64_t L,
                           CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)L) return;
  typename M::P acc = M::identity(cc);
  for (int64_t r = R - 1; r >= 0; --r) {
    M::store(excl, R, r, L, lane, acc);
    acc = M::add(acc, M::load(in, R, r, L, lane), cc);
  }
  M::store(tot, 1, 0, L, lane, acc);
}

// out = in[:, 0] + in[:, 1] + ... + in[:, K-1], added in that order.
// in: (NC, K, 16, L); out: (NC, 1, 16, L).
template <class M>
__global__ void __launch_bounds__(THREADS)
    rowsum_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                  int64_t K, int64_t L, CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)L) return;
  typename M::P acc = M::identity(cc);
  for (int64_t r = 0; r < K; ++r) {
    acc = M::add(acc, M::load(in, K, r, L, lane), cc);
  }
  M::store(out, 1, 0, L, lane, acc);
}

// out = 2^k * P + Q elementwise; P, Q, out: (NC, 1, 16, m).
template <class M>
__global__ void __launch_bounds__(THREADS)
    double_k_add_kernel(const int32_t* __restrict__ P,
                        const int32_t* __restrict__ Q,
                        int32_t* __restrict__ out, int64_t m, int32_t k,
                        CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)m) return;
  typename M::P acc = M::load(P, 1, 0, m, lane);
  for (int32_t i = 0; i < k; ++i) acc = M::dbl(acc, cc);
  acc = M::add(acc, M::load(Q, 1, 0, m, lane), cc);
  M::store(out, 1, 0, m, lane, acc);
}

// out = P + affine (qx, qy) elementwise; a lane with q_inf[lane] != 0
// adds the identity. P, out: (NC, 1, 16, m); qx, qy: (16, m); q_inf: (m,)
// bytes (a torch bool tensor).
template <class M>
__global__ void __launch_bounds__(THREADS)
    madd_kernel(const int32_t* __restrict__ P, const int32_t* __restrict__ qx,
                const int32_t* __restrict__ qy,
                const uint8_t* __restrict__ q_inf, int32_t* __restrict__ out,
                int64_t m, CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)m) return;
  typename M::P acc = M::load(P, 1, 0, m, lane);
  acc = M::madd(acc, fe_load(qx, 0, m, lane), fe_load(qy, 0, m, lane),
                q_inf[lane] != 0, cc);
  M::store(out, 1, 0, m, lane, acc);
}

// out = 2P elementwise; P, out: (NC, 1, 16, m).
template <class M>
__global__ void __launch_bounds__(THREADS)
    double_kernel(const int32_t* __restrict__ P, int32_t* __restrict__ out,
                  int64_t m, CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)m) return;
  M::store(out, 1, 0, m, lane, M::dbl(M::load(P, 1, 0, m, lane), cc));
}

// The window Horner of both MSM engines: acc = acc0, then for w = W - 1
// down to 0, c doublings and acc += part[w]; out = acc. parts: (NC, 16,
// B, Ws) with the windows innermost, the layout the engines hold their
// window sums in, of which windows [0, W) are read (Ws >= W: v2 passes
// its top window as acc0 and the other W - 1 as parts, without a copy);
// acc0, out: (NC, 16, B). One thread per scalar set, the accumulator in
// registers throughout: W (c + 1) dependent group operations a lane, so
// at B = 1 (one set, v2's stage G) the chain runs on one thread and its
// latency is the whole cost; what it saves is the W - 1 launches and
// per-window copies of a double-k-add loop. The strided window reads
// (stride Ws between lanes) are a few KB a lane and do not matter.
template <class M>
__global__ void __launch_bounds__(THREADS)
    horner_kernel(const int32_t* __restrict__ parts,
                  const int32_t* __restrict__ acc0,
                  int32_t* __restrict__ out, int64_t B, int64_t W,
                  int64_t Ws, int32_t c, CurveConst cc) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  typename M::P acc = M::load(acc0, 1, 0, B, lane);
  for (int64_t w = W - 1; w >= 0; --w) {
    for (int32_t i = 0; i < c; ++i) acc = M::dbl(acc, cc);
    acc = M::add(acc, M::load(parts, 1, 0, B * Ws, lane * Ws + w), cc);
  }
  M::store(out, 1, 0, B, lane, acc);
}

static inline CurveConst load_cc(const void* words) {
  CurveConst cc;
  memcpy(&cc, words, sizeof cc);
  return cc;
}

static inline unsigned blocks_for(int64_t lanes) {
  return (unsigned)((lanes + THREADS - 1) / THREADS);
}

// Launch KERNEL<model>(args...) over `lanes` threads, the model picked from
// the constants `cc` (in scope with the stream `s`).
#define LAUNCH_BY_MODEL(KERNEL, lanes, ...)                           \
  do {                                                                \
    if (cc.te)                                                        \
      KERNEL<TeModel><<<blocks_for(lanes), THREADS, 0, s>>>(__VA_ARGS__); \
    else if (cc.a_zero)                                               \
      KERNEL<RcbA0><<<blocks_for(lanes), THREADS, 0, s>>>(__VA_ARGS__);   \
    else                                                              \
      KERNEL<RcbA><<<blocks_for(lanes), THREADS, 0, s>>>(__VA_ARGS__);    \
  } while (0)

extern "C" int abtpu_suffix_madd_scan(const void* xy, void* out, int64_t R,
                                      int64_t L, const void* words,
                                      void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  LAUNCH_BY_MODEL(suffix_madd_scan_kernel, L, (const int32_t*)xy,
                  (int32_t*)out, R, L, cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_suffix_jac_scan(const void* in, void* excl, void* tot,
                                     int64_t R, int64_t L, const void* words,
                                     void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  LAUNCH_BY_MODEL(suffix_jac_scan_kernel, L, (const int32_t*)in,
                  (int32_t*)excl, (int32_t*)tot, R, L, cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_rowsum(const void* in, void* out, int64_t K, int64_t L,
                            const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  LAUNCH_BY_MODEL(rowsum_kernel, L, (const int32_t*)in, (int32_t*)out, K, L,
                  cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_rcb_double_k_add(const void* P, const void* Q, void* out,
                                      int64_t m, int32_t k, const void* words,
                                      void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  LAUNCH_BY_MODEL(double_k_add_kernel, m, (const int32_t*)P,
                  (const int32_t*)Q, (int32_t*)out, m, k, cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_te_double_k_add(const void* P, const void* Q, void* out,
                                     int64_t m, int32_t k, const void* words,
                                     void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (!cc.te) return (int)cudaErrorInvalidValue;
  double_k_add_kernel<TeModel><<<blocks_for(m), THREADS, 0, s>>>(
      (const int32_t*)P, (const int32_t*)Q, (int32_t*)out, m, k, cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_te_double(const void* P, void* out, int64_t m,
                               const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (!cc.te) return (int)cudaErrorInvalidValue;
  double_kernel<TeModel><<<blocks_for(m), THREADS, 0, s>>>(
      (const int32_t*)P, (int32_t*)out, m, cc);
  return (int)cudaGetLastError();
}

// 2^k P + Q on Jacobian points (k = 0: sw_add_tiled's complete add).
extern "C" int abtpu_jac_double_k_add(const void* P, const void* Q, void* out,
                                      int64_t m, int32_t k, const void* words,
                                      void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    double_k_add_kernel<JacModel<true>><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (const int32_t*)Q, (int32_t*)out, m, k, cc);
  else
    double_k_add_kernel<JacModel<false>><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (const int32_t*)Q, (int32_t*)out, m, k, cc);
  return (int)cudaGetLastError();
}

extern "C" int abtpu_jac_double(const void* P, void* out, int64_t m,
                                const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    double_kernel<JacModel<true>><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (int32_t*)out, m, cc);
  else
    double_kernel<JacModel<false>><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (int32_t*)out, m, cc);
  return (int)cudaGetLastError();
}

// P + affine Q on Jacobian points (sw_madd_tiled).
extern "C" int abtpu_jac_madd(const void* P, const void* qx, const void* qy,
                              const void* q_inf, void* out, int64_t m,
                              const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    madd_kernel<JacModel<true>><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (const int32_t*)qx, (const int32_t*)qy,
        (const uint8_t*)q_inf, (int32_t*)out, m, cc);
  else
    madd_kernel<JacModel<false>><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (const int32_t*)qx, (const int32_t*)qy,
        (const uint8_t*)q_inf, (int32_t*)out, m, cc);
  return (int)cudaGetLastError();
}

// P + affine Q on twisted-Edwards extended points (te_madd_tiled).
extern "C" int abtpu_te_madd(const void* P, const void* qx, const void* qy,
                             const void* q_inf, void* out, int64_t m,
                             const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (!cc.te) return (int)cudaErrorInvalidValue;
  madd_kernel<TeModel><<<blocks_for(m), THREADS, 0, s>>>(
      (const int32_t*)P, (const int32_t*)qx, (const int32_t*)qy,
      (const uint8_t*)q_inf, (int32_t*)out, m, cc);
  return (int)cudaGetLastError();
}

// Complete RCB doubling on projective points (rcb_double_tiled: Alg 9 for
// a = 0, Alg 3 otherwise); a twisted-Edwards curve is refused, as
// abtpu_te_double refuses the others.
extern "C" int abtpu_rcb_double(const void* P, void* out, int64_t m,
                                const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    double_kernel<RcbA0><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (int32_t*)out, m, cc);
  else
    double_kernel<RcbA><<<blocks_for(m), THREADS, 0, s>>>(
        (const int32_t*)P, (int32_t*)out, m, cc);
  return (int)cudaGetLastError();
}

// The window Horner over B sets of W windows (window stride Ws) on RCB
// projective or twisted-Edwards extended points, the model picked from
// the constants.
extern "C" int abtpu_horner(const void* parts, const void* acc0, void* out,
                            int64_t B, int64_t W, int64_t Ws, int32_t c,
                            const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  LAUNCH_BY_MODEL(horner_kernel, B, (const int32_t*)parts,
                  (const int32_t*)acc0, (int32_t*)out, B, W, Ws, c, cc);
  return (int)cudaGetLastError();
}

// The same Horner on Jacobian points (the v1 Pippenger's window sums on a
// short-Weierstrass curve).
extern "C" int abtpu_jac_horner(const void* parts, const void* acc0,
                                void* out, int64_t B, int64_t W, int64_t Ws,
                                int32_t c, const void* words, void* stream) {
  CurveConst cc = load_cc(words);
  cudaStream_t s = (cudaStream_t)stream;
  if (cc.te) return (int)cudaErrorInvalidValue;
  if (cc.a_zero)
    horner_kernel<JacModel<true>><<<blocks_for(B), THREADS, 0, s>>>(
        (const int32_t*)parts, (const int32_t*)acc0, (int32_t*)out, B, W,
        Ws, c, cc);
  else
    horner_kernel<JacModel<false>><<<blocks_for(B), THREADS, 0, s>>>(
        (const int32_t*)parts, (const int32_t*)acc0, (int32_t*)out, B, W,
        Ws, c, cc);
  return (int)cudaGetLastError();
}
