// Native host byte layer: Keccak-f[1600], SHA3, ChaCha20 blocks.
//
// The port's copy of the JAX package's csrc/abtpu_host.cpp. Replaces the
// reference's Rust byte-layer crates
// (merlin v3 STROBE over Keccak-f[1600], the sha3 crate, rand_chacha;
// reference Cargo.toml:16-26). The Fiat-Shamir transcript is a strict
// data-dependence chain that lives on the host between device MSM
// phases, so these primitives gate proof latency; the Python versions
// remain as a fallback and as an executable specification.
//
// Implemented from FIPS-202 and the ChaCha specification directly.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------
// Keccak-f[1600]
// ---------------------------------------------------------------------

static const uint64_t kRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// rho rotation offsets, indexed x + 5*y.
static const int kRot[25] = {
    0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
    25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14,
};

static inline uint64_t rotl64(uint64_t v, int n) {
  n &= 63;
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

// In-place permutation of 25 little-endian lanes (x + 5*y order).
void abtpu_keccak_f1600(uint64_t a[25]) {
  uint64_t b[25], c[5], d[5];
  for (int round = 0; round < 24; ++round) {
    // theta
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
    // rho + pi: b[y + 5*((2x+3y)%5)] = rot(a[x + 5y])
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], kRot[x + 5 * y]);
    // chi
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] =
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
    // iota
    a[0] ^= kRC[round];
  }
}

// ---------------------------------------------------------------------
// ChaCha20 (djb variant: 64-bit block counter, 64-bit stream id = 0)
// ---------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t v, int n) {
  return (v << n) | (v >> (32 - n));
}

#define QR(a, b, c, d)                \
  a += b; d ^= a; d = rotl32(d, 16);  \
  c += d; b ^= c; b = rotl32(b, 12);  \
  a += b; d ^= a; d = rotl32(d, 8);   \
  c += d; b ^= c; b = rotl32(b, 7);

// Write nblocks consecutive 16-word blocks starting at block counter
// `counter0` into out (16 * nblocks u32 words, little-endian order).
void abtpu_chacha20_blocks(const uint32_t key[8], uint64_t counter0,
                           uint64_t nblocks, uint32_t* out) {
  static const uint32_t sigma[4] = {0x61707865u, 0x3320646Eu, 0x79622D32u,
                                    0x6B206574u};
  for (uint64_t blk = 0; blk < nblocks; ++blk) {
    uint64_t ctr = counter0 + blk;
    uint32_t init[16];
    init[0] = sigma[0]; init[1] = sigma[1]; init[2] = sigma[2]; init[3] = sigma[3];
    for (int i = 0; i < 8; ++i) init[4 + i] = key[i];
    init[12] = (uint32_t)(ctr & 0xFFFFFFFFu);
    init[13] = (uint32_t)(ctr >> 32);
    init[14] = 0;
    init[15] = 0;
    uint32_t x[16];
    std::memcpy(x, init, sizeof(x));
    for (int i = 0; i < 10; ++i) {
      QR(x[0], x[4], x[8], x[12])
      QR(x[1], x[5], x[9], x[13])
      QR(x[2], x[6], x[10], x[14])
      QR(x[3], x[7], x[11], x[15])
      QR(x[0], x[5], x[10], x[15])
      QR(x[1], x[6], x[11], x[12])
      QR(x[2], x[7], x[8], x[13])
      QR(x[3], x[4], x[9], x[14])
    }
    uint32_t* o = out + 16 * blk;
    for (int i = 0; i < 16; ++i) o[i] = x[i] + init[i];
  }
}

// ---------------------------------------------------------------------
// SHA3 sponge (used for SHA3-512 / SHA3-256)
// ---------------------------------------------------------------------

void abtpu_sha3(const uint8_t* data, uint64_t len, uint64_t rate,
                uint8_t domain, uint8_t* out, uint64_t out_len) {
  uint64_t lanes[25];
  std::memset(lanes, 0, sizeof(lanes));
  uint8_t* state = reinterpret_cast<uint8_t*>(lanes);  // little-endian hosts
  uint64_t off = 0;
  while (off + rate <= len) {
    for (uint64_t i = 0; i < rate; ++i) state[i] ^= data[off + i];
    abtpu_keccak_f1600(lanes);
    off += rate;
  }
  uint64_t rem = len - off;
  for (uint64_t i = 0; i < rem; ++i) state[i] ^= data[off + i];
  state[rem] ^= domain;
  state[rate - 1] ^= 0x80;
  abtpu_keccak_f1600(lanes);
  uint64_t produced = 0;
  while (produced < out_len) {
    uint64_t take = out_len - produced < rate ? out_len - produced : rate;
    std::memcpy(out + produced, state, take);
    produced += take;
    if (produced < out_len) abtpu_keccak_f1600(lanes);
  }
}


// ---------------------------------------------------------------------
// STROBE-128 bulk Fp::rand
//
// Replicates, byte-for-byte, the Python Strobe128 op sequence that
// merlin's TranscriptRng drives for arkworks Fp::rand (reference:
// merlin TranscriptRng fill_bytes = meta-AD(len-LE32) + PRF(n);
// rand_core next_u64_via_fill at 8 bytes/word; ark-ff Fp::rand masks
// the top limb and rejects >= p). One C call replaces n_limbs*count
// Python STROBE ops (~9 us each) on the prover's blinding draws.
// ---------------------------------------------------------------------

static const int kStrobeR = 166;  // 200 - 2*(128/8) - 2

static void strobe_run_f(uint8_t* st, int* pos, int* pos_begin) {
  st[*pos] ^= (uint8_t)(*pos_begin);
  st[*pos + 1] ^= 0x04;
  st[kStrobeR + 1] ^= 0x80;
  abtpu_keccak_f1600(reinterpret_cast<uint64_t*>(st));
  *pos = 0;
  *pos_begin = 0;
}

static void strobe_absorb(uint8_t* st, int* pos, int* pos_begin,
                          const uint8_t* d, int n) {
  for (int i = 0; i < n; ++i) {
    st[*pos] ^= d[i];
    ++*pos;
    if (*pos == kStrobeR) strobe_run_f(st, pos, pos_begin);
  }
}

// flags: I=1 A=2 C=4 T=8 M=16 K=32 (begin_op with more=false).
static void strobe_begin_op(uint8_t* st, int* pos, int* pos_begin,
                            uint8_t* cur_flags, uint8_t flags) {
  uint8_t framing[2] = {(uint8_t)(*pos_begin), flags};
  *pos_begin = *pos + 1;
  *cur_flags = flags;
  strobe_absorb(st, pos, pos_begin, framing, 2);
  if ((flags & (0x04 | 0x20)) && *pos != 0) strobe_run_f(st, pos, pos_begin);
}

// Draw `count` field elements into out[count*n_limbs] (LE u64 limbs of
// the accepted raw sample == the Montgomery representation). meta is
// {pos, pos_begin, cur_flags} of the Python Strobe128, updated in place.
// p_limbs is the modulus (LE limbs); last_mask shaves the top limb.
// Returns 0, or -1 without touching anything when n_limbs is outside
// [1, 8] (a sample is held in 8 limbs).
int abtpu_strobe_rand_fp(uint8_t* st, int32_t* meta,
                         const uint64_t* p_limbs, uint64_t last_mask,
                         int n_limbs, int count, uint64_t* out) {
  if (n_limbs < 1 || n_limbs > 8) return -1;
  int pos = meta[0], pos_begin = meta[1];
  uint8_t cf = (uint8_t)meta[2];
  const uint8_t len8_le[4] = {8, 0, 0, 0};
  for (int e = 0; e < count; ++e) {
    for (;;) {
      uint64_t limbs[8];
      for (int l = 0; l < n_limbs; ++l) {
        // fill_bytes(8): meta_ad(u32_le(8)) then prf(8).
        strobe_begin_op(st, &pos, &pos_begin, &cf, 0x10 | 0x02);
        strobe_absorb(st, &pos, &pos_begin, len8_le, 4);
        strobe_begin_op(st, &pos, &pos_begin, &cf, 0x01 | 0x02 | 0x04);
        uint64_t v = 0;
        for (int i = 0; i < 8; ++i) {  // squeeze: read + zero
          v |= (uint64_t)st[pos] << (8 * i);
          st[pos] = 0;
          ++pos;
          if (pos == kStrobeR) strobe_run_f(st, &pos, &pos_begin);
        }
        limbs[l] = v;
      }
      limbs[n_limbs - 1] &= last_mask;
      bool lt = false;
      for (int l = n_limbs - 1; l >= 0; --l) {
        if (limbs[l] < p_limbs[l]) { lt = true; break; }
        if (limbs[l] > p_limbs[l]) break;
      }
      if (lt) {
        for (int l = 0; l < n_limbs; ++l) out[e * n_limbs + l] = limbs[l];
        break;
      }
    }
  }
  meta[0] = pos;
  meta[1] = pos_begin;
  meta[2] = cf;
  return 0;
}


// Bulk merlin append_message with a shared label: for each message,
// meta-AD(label) + meta-AD(LE32 len, more=true) + AD(msg) — exactly the
// Python Transcript.append_message op sequence. Replaces the per-point
// Python STROBE ops of the commit-phase transcript appends (~10 us per
// point across ~2k commits of a k=1024 shuffle prove).
void abtpu_strobe_append_msgs(uint8_t* st, int32_t* meta,
                              const uint8_t* label, int label_len,
                              const uint8_t* msgs, int msg_len,
                              int count) {
  int pos = meta[0], pos_begin = meta[1];
  uint8_t cf = (uint8_t)meta[2];
  uint8_t len_le[4] = {
      (uint8_t)(msg_len & 0xff), (uint8_t)((msg_len >> 8) & 0xff),
      (uint8_t)((msg_len >> 16) & 0xff), (uint8_t)((msg_len >> 24) & 0xff)};
  for (int e = 0; e < count; ++e) {
    strobe_begin_op(st, &pos, &pos_begin, &cf, 0x10 | 0x02);  // meta-AD
    strobe_absorb(st, &pos, &pos_begin, label, label_len);
    strobe_absorb(st, &pos, &pos_begin, len_le, 4);           // more=true
    strobe_begin_op(st, &pos, &pos_begin, &cf, 0x02);         // AD
    strobe_absorb(st, &pos, &pos_begin, msgs + (size_t)e * msg_len, msg_len);
  }
  meta[0] = pos;
  meta[1] = pos_begin;
  meta[2] = cf;
}


// Bulk merlin TranscriptRngBuilder::rekey_with_witness_bytes with a
// shared label: meta-AD(label) + meta-AD(LE32 len, more) + KEY(witness)
// per item. KEY = begin_op(A|C) (forced permutation) + overwrite.
void abtpu_strobe_rekey_msgs(uint8_t* st, int32_t* meta,
                             const uint8_t* label, int label_len,
                             const uint8_t* msgs, int msg_len,
                             int count) {
  int pos = meta[0], pos_begin = meta[1];
  uint8_t cf = (uint8_t)meta[2];
  uint8_t len_le[4] = {
      (uint8_t)(msg_len & 0xff), (uint8_t)((msg_len >> 8) & 0xff),
      (uint8_t)((msg_len >> 16) & 0xff), (uint8_t)((msg_len >> 24) & 0xff)};
  for (int e = 0; e < count; ++e) {
    strobe_begin_op(st, &pos, &pos_begin, &cf, 0x10 | 0x02);  // meta-AD
    strobe_absorb(st, &pos, &pos_begin, label, label_len);
    strobe_absorb(st, &pos, &pos_begin, len_le, 4);           // more=true
    strobe_begin_op(st, &pos, &pos_begin, &cf, 0x02 | 0x04);  // KEY
    const uint8_t* m = msgs + (size_t)e * msg_len;
    for (int i = 0; i < msg_len; ++i) {  // overwrite
      st[pos] = m[i];
      ++pos;
      if (pos == kStrobeR) strobe_run_f(st, &pos, &pos_begin);
    }
  }
  meta[0] = pos;
  meta[1] = pos_begin;
  meta[2] = cf;
}

}  // extern "C"
