// Host MSM and fixed-base commitments of the port (a copy of the JAX
// package's csrc/abtpu_msm_cpu.cpp, kept apart so the port stands alone).
//
// A straightforwardly optimized single-core C++ Pippenger — 4x64-bit
// Montgomery CIOS field mul (the same shape as ark-ff's
// Fp256<MontBackend<_,4>>), branchy Jacobian group law, window size
// chosen by arkworks' ln-approximation. Reference anchor: ark-ec
// VariableBaseMSM, call sites src/r1cs/verifier.rs:574,685.
//
// One change from the JAX package's copy: `abtpu_cpu_commit_many` hands
// the caller's curve parameters to its worker threads by value. The
// parameters are thread_local, so a worker thread would otherwise start
// from the secq256k1 defaults and commit on the wrong curve.
//
// Field: secq256k1 base field p = secp256k1 group order
//   0xfffffffffffffffffffffffffffffffebaaedce6af48a03bbfd25e8cd0364141
// Curve: y^2 = x^3 + 7 (a = 0), cofactor 1.

#include <cstdint>
#include <cstring>
#include <exception>
#include <thread>
#include <vector>

namespace {

typedef unsigned __int128 u128;

// Runtime curve parameters (default: secq256k1, y^2 = x^3 + 7 over the
// secp256k1 group order). `abtpu_cpu_set_curve` switches them so zorro
// (a = 6) and any other 4x64-limb short-Weierstrass curve reuse the
// same code. thread_local: concurrent callers can't clobber each other.
struct CurveParams {
  uint64_t p_[4];        // modulus
  uint64_t r2_[4];       // R^2 mod p, R = 2^256
  uint64_t inv_;         // -p^{-1} mod 2^64
  uint64_t one_mont_[4]; // R mod p
  uint64_t a_mont_[4];   // curve a in Montgomery form
  int a_is_zero;
};

static const CurveParams kSecq = {
    {0xbfd25e8cd0364141ULL, 0xbaaedce6af48a03bULL, 0xfffffffffffffffeULL,
     0xffffffffffffffffULL},
    {0x896cf21467d7d140ULL, 0x741496c20e7cf878ULL, 0xe697f5e45bcd07c6ULL,
     0x9d671cd581c69bc5ULL},
    0x4b0dff665588b13fULL,
    {0x402da1732fc9bebfULL, 0x4551231950b75fc4ULL, 0x1ULL, 0x0ULL},
    {0, 0, 0, 0},
    1,
};

static thread_local CurveParams g_cp = kSecq;

#define P g_cp.p_
#define R2 g_cp.r2_
#define INV g_cp.inv_
#define ONE_MONT g_cp.one_mont_

struct Fp {
  uint64_t v[4];
};

static inline bool geq_p(const uint64_t t[4]) {
  for (int i = 3; i >= 0; --i) {
    if (t[i] > P[i]) return true;
    if (t[i] < P[i]) return false;
  }
  return true;  // equal
}

static inline void sub_p(uint64_t t[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 cur = (u128)t[i] - P[i] - borrow;
    t[i] = (uint64_t)cur;
    borrow = (cur >> 64) & 1;  // 1 if borrowed
  }
}

static inline void fp_add(const Fp& a, const Fp& b, Fp& r) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 cur = (u128)a.v[i] + b.v[i] + carry;
    r.v[i] = (uint64_t)cur;
    carry = cur >> 64;
  }
  if (carry || geq_p(r.v)) sub_p(r.v);
}

static inline void fp_sub(const Fp& a, const Fp& b, Fp& r) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 cur = (u128)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint64_t)cur;
    borrow = (cur >> 64) & 1;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 cur = (u128)r.v[i] + P[i] + carry;
      r.v[i] = (uint64_t)cur;
      carry = cur >> 64;
    }
  }
}

// Montgomery CIOS product: r = a * b * R^{-1} mod p.
static inline void fp_mul(const Fp& a, const Fp& b, Fp& r) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)a.v[j] * b.v[i] + t[j] + carry;
      t[j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[4] + carry;
    t[4] = (uint64_t)cur;
    t[5] = (uint64_t)(cur >> 64);

    uint64_t m = t[0] * INV;
    carry = ((u128)m * P[0] + t[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 c2 = (u128)m * P[j] + t[j] + carry;
      t[j - 1] = (uint64_t)c2;
      carry = c2 >> 64;
    }
    u128 c2 = (u128)t[4] + carry;
    t[3] = (uint64_t)c2;
    t[4] = t[5] + (uint64_t)(c2 >> 64);
    t[5] = 0;
  }
  if (t[4] || geq_p(t)) sub_p(t);
  std::memcpy(r.v, t, 32);
}

static inline void fp_sqr(const Fp& a, Fp& r) { fp_mul(a, a, r); }

static inline bool fp_is_zero(const Fp& a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline void fp_dbl(const Fp& a, Fp& r) { fp_add(a, a, r); }

struct Affine {
  Fp x, y;   // Montgomery domain
  bool inf;
};

struct Jac {
  Fp x, y, z;  // Montgomery domain; inf <=> z == 0
};

static const Jac JAC_INF = {{{0, 0, 0, 0}}, {{0, 0, 0, 0}}, {{0, 0, 0, 0}}};

static inline bool jac_is_inf(const Jac& p) { return fp_is_zero(p.z); }

// Doubling (dbl-2009-l style on Jacobian coords; general a adds the
// a*Z^4 term to the tangent slope M = 3X^2 + a*Z^4).
static void jac_double(Jac& p) {
  if (jac_is_inf(p)) return;
  Fp A, B, C, D, E, F, t, t2;
  fp_sqr(p.x, A);            // A = X^2
  fp_sqr(p.y, B);            // B = Y^2
  fp_sqr(B, C);              // C = B^2
  fp_add(p.x, B, t);         // (X+B)
  fp_sqr(t, t);              // (X+B)^2
  fp_sub(t, A, t);
  fp_sub(t, C, t);
  fp_dbl(t, D);              // D = 2((X+B)^2 - A - C)
  fp_dbl(A, E);
  fp_add(E, A, E);           // E = 3A
  if (!g_cp.a_is_zero) {
    Fp zz, z4, am;
    fp_sqr(p.z, zz);
    fp_sqr(zz, z4);
    std::memcpy(am.v, g_cp.a_mont_, 32);
    fp_mul(am, z4, z4);
    fp_add(E, z4, E);        // E = 3A + a*Z^4
  }
  fp_sqr(E, F);              // F = E^2
  fp_dbl(D, t);
  fp_sub(F, t, p.x);         // X3 = F - 2D
  fp_sub(D, p.x, t);
  fp_mul(E, t, t);           // E(D - X3)
  fp_dbl(C, t2);
  fp_dbl(t2, t2);
  fp_dbl(t2, t2);            // 8C
  fp_sub(t, t2, t);
  fp_mul(p.y, p.z, t2);
  fp_dbl(t2, p.z);           // Z3 = 2YZ
  p.y = t;                   // Y3 = E(D-X3) - 8C
}

// Mixed add: p += q (q affine), madd-2007-bl with branches for the
// exceptional cases (CPU baseline — branches are fine here).
static void jac_madd(Jac& p, const Affine& q) {
  if (q.inf) return;
  if (jac_is_inf(p)) {
    p.x = q.x;
    p.y = q.y;
    std::memcpy(p.z.v, ONE_MONT, 32);
    return;
  }
  Fp z1z1, u2, s2, h, hh, i, j, r, v, t, t2;
  fp_sqr(p.z, z1z1);
  fp_mul(q.x, z1z1, u2);
  fp_mul(q.y, p.z, s2);
  fp_mul(s2, z1z1, s2);
  fp_sub(u2, p.x, h);
  fp_sub(s2, p.y, r);
  if (fp_is_zero(h)) {
    if (fp_is_zero(r)) {
      jac_double(p);
      return;
    }
    p = JAC_INF;
    return;
  }
  fp_sqr(h, hh);
  fp_dbl(hh, i);
  fp_dbl(i, i);              // I = 4 HH
  fp_mul(h, i, j);           // J = H * I
  fp_dbl(r, r);              // r = 2 (S2 - Y1)
  fp_mul(p.x, i, v);         // V = X1 * I
  fp_sqr(r, t);
  fp_sub(t, j, t);
  fp_dbl(v, t2);
  fp_sub(t, t2, t);          // X3 = r^2 - J - 2V
  fp_sub(v, t, t2);
  fp_mul(r, t2, t2);         // r (V - X3)
  Fp yj;
  fp_mul(p.y, j, yj);
  fp_dbl(yj, yj);
  fp_sub(t2, yj, t2);        // Y3 = r(V-X3) - 2 Y1 J
  Fp z3;
  fp_add(p.z, h, z3);
  fp_sqr(z3, z3);
  fp_sub(z3, z1z1, z3);
  fp_sub(z3, hh, z3);        // Z3 = (Z1+H)^2 - Z1Z1 - HH
  p.x = t;
  p.y = t2;
  p.z = z3;
}

// Full Jacobian add: p += q (add-2007-bl with branches).
static void jac_add(Jac& p, const Jac& q) {
  if (jac_is_inf(q)) return;
  if (jac_is_inf(p)) {
    p = q;
    return;
  }
  Fp z1z1, z2z2, u1, u2, s1, s2, h, i, j, r, v, t, t2;
  fp_sqr(p.z, z1z1);
  fp_sqr(q.z, z2z2);
  fp_mul(p.x, z2z2, u1);
  fp_mul(q.x, z1z1, u2);
  fp_mul(p.y, q.z, s1);
  fp_mul(s1, z2z2, s1);
  fp_mul(q.y, p.z, s2);
  fp_mul(s2, z1z1, s2);
  fp_sub(u2, u1, h);
  fp_sub(s2, s1, r);
  if (fp_is_zero(h)) {
    if (fp_is_zero(r)) {
      jac_double(p);
      return;
    }
    p = JAC_INF;
    return;
  }
  fp_dbl(h, t);
  fp_sqr(t, i);              // I = (2H)^2
  fp_mul(h, i, j);           // J = H I
  fp_dbl(r, r);              // r = 2 (S2 - S1)
  fp_mul(u1, i, v);          // V = U1 I
  fp_sqr(r, t);
  fp_sub(t, j, t);
  fp_dbl(v, t2);
  fp_sub(t, t2, t);          // X3
  fp_sub(v, t, t2);
  fp_mul(r, t2, t2);
  Fp sj;
  fp_mul(s1, j, sj);
  fp_dbl(sj, sj);
  fp_sub(t2, sj, t2);        // Y3
  Fp z3;
  fp_add(p.z, q.z, z3);
  fp_sqr(z3, z3);
  fp_sub(z3, z1z1, z3);
  fp_sub(z3, z2z2, z3);
  fp_mul(z3, h, z3);         // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
  p.x = t;
  p.y = t2;
  p.z = z3;
}

static inline uint32_t scalar_digit(const uint8_t* s, uint32_t w, uint32_t c) {
  // Bits [w*c, w*c + c) of a 256-bit little-endian scalar.
  uint32_t bit = w * c;
  uint32_t byte = bit >> 3;
  uint64_t acc = 0;
  for (uint32_t k = 0; k < 8 && byte + k < 32; ++k)
    acc |= (uint64_t)s[byte + k] << (8 * k);
  acc >>= (bit & 7);
  uint32_t take = (256 - bit) < c ? (256 - bit) : c;
  return (uint32_t)(acc & ((1ULL << take) - 1));
}

}  // namespace

extern "C" {

// Select the active curve for subsequent calls on this thread.
// p/r2/one/a_mont: 32-byte little-endian; inv = -p^{-1} mod 2^64.
void abtpu_cpu_set_curve(const uint8_t* p, const uint8_t* r2, uint64_t inv,
                         const uint8_t* one, const uint8_t* a_mont,
                         int a_is_zero) {
  std::memcpy(g_cp.p_, p, 32);
  std::memcpy(g_cp.r2_, r2, 32);
  g_cp.inv_ = inv;
  std::memcpy(g_cp.one_mont_, one, 32);
  std::memcpy(g_cp.a_mont_, a_mont, 32);
  g_cp.a_is_zero = a_is_zero;
}

// xs, ys: n * 32-byte little-endian affine coordinates (normal domain);
// inf: n bytes (1 = point at infinity); scalars: n * 32-byte LE;
// c: window bits (0 = auto via arkworks' ln approximation);
// out: 96 bytes — Jacobian X, Y, Z little-endian, normal domain.
void abtpu_cpu_pippenger(const uint8_t* xs, const uint8_t* ys,
                         const uint8_t* inf, const uint8_t* scalars,
                         uint64_t n, uint32_t c, uint8_t* out) {
  if (c == 0) {
    // arkworks 0.4: ln_without_floats(n) + 2 = (ilog2(n)*69/100) + 2.
    uint32_t lg = 0;
    for (uint64_t m = n; m > 1; m >>= 1) ++lg;
    c = lg * 69 / 100 + 2;
    if (c < 3) c = 3;
  }
  const uint32_t W = (256 + c - 1) / c;
  const uint32_t nbuckets = (1u << c) - 1;

  // Convert input to Montgomery-domain affine.
  std::vector<Affine> pts(n);
  Fp r2;
  std::memcpy(r2.v, R2, 32);
  for (uint64_t k = 0; k < n; ++k) {
    Fp x, y;
    std::memcpy(x.v, xs + 32 * k, 32);
    std::memcpy(y.v, ys + 32 * k, 32);
    fp_mul(x, r2, pts[k].x);
    fp_mul(y, r2, pts[k].y);
    pts[k].inf = inf != nullptr && inf[k] != 0;
  }

  std::vector<Jac> buckets(nbuckets);
  Jac acc = JAC_INF;
  for (int w = (int)W - 1; w >= 0; --w) {
    for (uint32_t k = 0; k < c; ++k) jac_double(acc);
    for (uint32_t b = 0; b < nbuckets; ++b) buckets[b] = JAC_INF;
    for (uint64_t k = 0; k < n; ++k) {
      uint32_t d = scalar_digit(scalars + 32 * k, (uint32_t)w, c);
      if (d) jac_madd(buckets[d - 1], pts[k]);
    }
    // running-sum reduction: sum_d d * bucket[d]
    Jac running = JAC_INF, winsum = JAC_INF;
    for (int b = (int)nbuckets - 1; b >= 0; --b) {
      jac_add(running, buckets[b]);
      jac_add(winsum, running);
    }
    jac_add(acc, winsum);
  }

  // Out of Montgomery domain (multiply by 1).
  Fp one = {{1, 0, 0, 0}};
  Fp ox, oy, oz;
  fp_mul(acc.x, one, ox);
  fp_mul(acc.y, one, oy);
  fp_mul(acc.z, one, oz);
  std::memcpy(out, ox.v, 32);
  std::memcpy(out + 32, oy.v, 32);
  std::memcpy(out + 64, oz.v, 32);
}

// Batched fixed-base Pedersen commitments: out[i] = v[i]*B + r[i]*Bt.
//
// The protocol layer commits m witness values up front (reference
// src/r1cs/prover.rs:327-341 in a loop over the gadget's inputs); a
// pure-Python double-and-add costs ~8 ms per commitment, which at
// k=1024 shuffle scale (2048 commitments) dominates proof creation.
// Fixed bases admit one-time window tables: T[w][d] = (d+1)*2^(8w)*P,
// then each scalar is 32 table adds. Tables are rebuilt per call (a few
// ms) — callers batch, so amortization is inside the call.
//
// xs/ys: 2*32 bytes (B then Bt, affine LE, normal domain); vs/rs: n*32
// LE scalars; out: n * 96 bytes Jacobian (X,Y,Z normal domain).
extern "C" void abtpu_cpu_commit_many(const uint8_t* xs, const uint8_t* ys,
                                      const uint8_t* vs, const uint8_t* rs,
                                      uint64_t n, uint8_t* out) {
  const uint32_t c = 8;
  const uint32_t W = 32;          // 256 / 8
  const uint32_t D = (1u << c) - 1;  // 255 table entries per window
  Fp r2;
  std::memcpy(r2.v, R2, 32);

  // window tables for both bases, cached across calls (the (B, B~)
  // pair is fixed per PedersenGens, so 5-commit calls reuse the ~30 ms
  // build; thread_local keeps concurrent callers safe).
  static thread_local std::vector<Jac> table;  // 2 * W * D
  static thread_local uint8_t cached_key[160];  // bases + active modulus
  bool hit = table.size() == 2ull * W * D &&
             std::memcmp(cached_key, xs, 64) == 0 &&
             std::memcmp(cached_key + 64, ys, 64) == 0 &&
             std::memcmp(cached_key + 128, g_cp.p_, 32) == 0;
  if (!hit) {
    std::memcpy(cached_key, xs, 64);
    std::memcpy(cached_key + 64, ys, 64);
    std::memcpy(cached_key + 128, g_cp.p_, 32);
    table.assign(2 * W * D, JAC_INF);
  }
  for (int b = 0; b < 2 && !hit; ++b) {
    Affine base;
    Fp x, y;
    std::memcpy(x.v, xs + 32 * b, 32);
    std::memcpy(y.v, ys + 32 * b, 32);
    fp_mul(x, r2, base.x);
    fp_mul(y, r2, base.y);
    base.inf = false;
    Jac pw = JAC_INF;
    jac_madd(pw, base);  // pw = 2^(8w) * P, starting w = 0
    for (uint32_t w = 0; w < W; ++w) {
      Jac* row = &table[(b * W + w) * D];
      row[0] = pw;
      for (uint32_t d = 1; d < D; ++d) {
        row[d] = row[d - 1];
        jac_add(row[d], pw);
      }
      // pw for the next window = 2^8 * this window's base
      if (w + 1 < W)
        for (int k = 0; k < 8; ++k) jac_double(pw);
    }
  }

  // The per-scalar walks are independent; split across threads (the
  // 2048-commit batch of a k=1024 shuffle ran 62 ms single-threaded).
  const Jac* tbl = table.data();
  const CurveParams cp = g_cp;
  auto worker = [&, cp](uint64_t lo, uint64_t hi) {
    g_cp = cp;  // this thread's copy of the caller's curve
    for (uint64_t i = lo; i < hi; ++i) {
      Jac acc = JAC_INF;
      const uint8_t* two[2] = {vs + 32 * i, rs + 32 * i};
      for (int b = 0; b < 2; ++b) {
        for (uint32_t w = 0; w < W; ++w) {
          uint32_t d = two[b][w];  // c = 8: digit w is byte w
          if (d) jac_add(acc, tbl[(b * W + w) * D + (d - 1)]);
        }
      }
      Fp one = {{1, 0, 0, 0}};
      Fp ox, oy, oz;
      fp_mul(acc.x, one, ox);
      fp_mul(acc.y, one, oy);
      fp_mul(acc.z, one, oz);
      std::memcpy(out + 96 * i, ox.v, 32);
      std::memcpy(out + 96 * i + 32, oy.v, 32);
      std::memcpy(out + 96 * i + 64, oz.v, 32);
    }
  };
  uint64_t nthreads = std::thread::hardware_concurrency();
  if (nthreads > n / 64) nthreads = n / 64;  // >=64 scalars per thread
  if (nthreads <= 1) {
    worker(0, n);
  } else {
    // A thread that cannot be started (std::system_error, or bad_alloc
    // for the vector) leaves its range and the later ones to the calling
    // thread; the threads already started are joined either way.
    std::vector<std::thread> threads;
    uint64_t chunk = (n + nthreads - 1) / nthreads;
    uint64_t started = 0;  // [0, started) is handed to threads
    try {
      threads.reserve(nthreads);
      for (uint64_t t = 0; t < nthreads; ++t) {
        uint64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
        started = hi;
      }
    } catch (const std::exception&) {
    }
    if (started < n) worker(started, n);
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"
