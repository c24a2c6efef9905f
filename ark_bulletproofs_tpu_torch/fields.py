"""Prime-field arithmetic (host exact layer).

Field elements are canonical Python ints in [0, p). The only place the
Montgomery representation matters for host-side bit-exactness is random
sampling: arkworks 0.4 `UniformRand` for `Fp256<MontBackend<_,4>>` samples
4 random u64 limbs, masks the excess top bits, rejects if >= modulus, and
interprets the result as the **Montgomery** representation (value * R mod p,
R = 2^256). See reference call sites: src/transcript.rs:95-101 (challenge
scalars), src/generators.rs:59-64,87-101 (generator chains).

Device-side vectorized field kernels live in `ark_bulletproofs_tpu_torch.ops`.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Field:
    """A 256-bit-limbed prime field (arkworks Fp256 equivalent)."""

    name: str
    p: int
    n_limbs: int = 4  # 64-bit limbs, Fp256
    _cache: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def num_bits(self) -> int:
        return self.p.bit_length()

    @property
    def byte_size(self) -> int:
        """Serialized size with no flags (arkworks buffer_byte_size)."""
        return (self.num_bits + 7) // 8

    @property
    def flagged_byte_size(self) -> int:
        """Serialized size with a 2-bit flag set (SW/TE point flags)."""
        return (self.num_bits + 2 + 7) // 8

    @property
    def R(self) -> int:  # Montgomery radix 2^(64*n_limbs) mod p
        r = self._cache.get("R")
        if r is None:
            r = (1 << (64 * self.n_limbs)) % self.p
            self._cache["R"] = r
        return r

    @property
    def R_inv(self) -> int:
        r = self._cache.get("R_inv")
        if r is None:
            r = pow(self.R, -1, self.p)
            self._cache["R_inv"] = r
        return r

    # ---- arithmetic (canonical ints) ---------------------------------

    def add(self, a: int, b: int) -> int:
        c = a + b
        return c - self.p if c >= self.p else c

    def sub(self, a: int, b: int) -> int:
        c = a - b
        return c + self.p if c < 0 else c

    def neg(self, a: int) -> int:
        return 0 if a == 0 else self.p - a

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("field inverse of zero")
        return pow(a, -1, self.p)

    def batch_inversion(self, xs: list[int]) -> list[int]:
        """Montgomery's trick; zeros are left untouched (arkworks semantics,
        reference: ark_ff batch_inversion used at src/inner_product_proof.rs:283)."""
        p = self.p
        prod = []
        acc = 1
        for x in xs:
            if x != 0:
                acc = acc * x % p
            prod.append(acc)
        inv_acc = pow(acc, -1, p) if acc != 0 else 0
        out = list(xs)
        for i in range(len(xs) - 1, -1, -1):
            if xs[i] == 0:
                continue
            # skip over zeros when looking up the previous prefix product
            j = i - 1
            while j >= 0 and xs[j] == 0:
                j -= 1
            before = prod[j] if j >= 0 else 1
            out[i] = inv_acc * before % p
            inv_acc = inv_acc * xs[i] % p
        return out

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def legendre_is_qr(self, a: int) -> bool:
        if a == 0:
            return True
        return pow(a, (self.p - 1) // 2, self.p) == 1

    def sqrt(self, a: int) -> int | None:
        """Tonelli-Shanks square root; returns one root or None."""
        p = self.p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # Tonelli-Shanks
        q = p - 1
        s = 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m = s
        c = pow(z, q, p)
        t = pow(a, q, p)
        r = pow(a, (q + 1) // 2, p)
        while t != 1:
            i = 0
            t2 = t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m = i
            c = b * b % p
            t = t * c % p
            r = r * b % p
        return r

    # ---- arkworks-compatible sampling ---------------------------------

    def rand(self, rng) -> int:
        """arkworks 0.4 `Fp::rand`: sample 4 u64 limbs (LE), mask shave bits,
        reject >= p; the accepted limbs are the Montgomery repr."""
        shave = 64 * self.n_limbs - self.num_bits
        assert shave <= 64
        mask = 0 if shave == 64 else ((1 << 64) - 1) >> shave
        while True:
            limbs = [rng.next_u64() for _ in range(self.n_limbs)]
            limbs[-1] &= mask
            mont = 0
            for i, limb in enumerate(limbs):
                mont |= limb << (64 * i)
            if mont < self.p:
                return mont * self.R_inv % self.p

    def rand_many(self, rng, count: int) -> list[int]:
        """`count` sequential `rand` draws, bit-identical to the loop.

        When `rng` is a TranscriptRng backed by a Strobe128, the whole
        draw sequence (meta-AD + PRF framing per u64, mask, rejection)
        runs in one native call — the per-call Python STROBE op cost
        (~36 us per 4-limb draw) made the prover's ~4k blinding draws
        the largest single host item of a k=1024 shuffle prove
        (~180 ms, reference analog prover.rs:516-564).
        """
        if count <= 0:
            return []
        strobe = getattr(rng, "_strobe", None)
        if strobe is not None and count >= 8:
            from .native import strobe_rand_fp_native

            raw = strobe_rand_fp_native(
                strobe, self.p, self.num_bits, self.n_limbs, count
            )
            if raw is not None:
                R_inv, p = self.R_inv, self.p
                return [m * R_inv % p for m in raw]
        if count >= 8 and hasattr(rng, "next_u32_array"):
            # ChaCha path: bulk keystream words, processed through the
            # same sequential cursor the per-call loop would consume
            # (a rejection costs that element 2*n_limbs extra words and
            # shifts everything after it, exactly like the loop).
            shave = 64 * self.n_limbs - self.num_bits
            mask = 0 if shave == 64 else ((1 << 64) - 1) >> shave
            R_inv, p, nl = self.R_inv, self.p, self.n_limbs
            words: list[int] = []
            cur = 0
            out = []
            while len(out) < count:
                if cur + 2 * nl > len(words):
                    need = 2 * nl * (count - len(out)) + 2 * nl
                    words.extend(
                        int(w) for w in rng.next_u32_array(need)
                    )
                mont = 0
                for i in range(nl):
                    lo, hi = words[cur], words[cur + 1]
                    cur += 2
                    limb = lo | (hi << 32)
                    if i == nl - 1:
                        limb &= mask
                    mont |= limb << (64 * i)
                if mont < p:
                    out.append(mont * R_inv % p)
            # Words fetched beyond the cursor were never consumed by
            # the sequential semantics; rewind the stream to the exact
            # position the loop would have left it at.
            if cur < len(words):
                rng.skip_words(cur - len(words))
            return out
        return [self.rand(rng) for _ in range(count)]

    # ---- arkworks-compatible serialization ----------------------------

    def to_bytes(self, a: int, flags: int = 0, flag_bits: int = 0) -> bytes:
        size = (self.num_bits + flag_bits + 7) // 8
        buf = bytearray(a.to_bytes(size, "little"))
        if flags:
            buf[-1] |= flags
        return bytes(buf)

    def from_bytes(self, data: bytes, flag_mask: int = 0) -> tuple[int, int]:
        """Returns (value, flags). Raises ValueError if value >= p."""
        buf = bytearray(data)
        flags = buf[-1] & flag_mask
        buf[-1] &= ~flag_mask & 0xFF
        v = int.from_bytes(bytes(buf), "little")
        if v >= self.p:
            raise ValueError("field element out of range")
        return v, flags

    def is_less_than_neg(self, a: int) -> bool:
        """a <= -a in canonical integer order (arkworks 'positive' test)."""
        return a <= self.neg(a)


# --- named fields ------------------------------------------------------

# secp256k1 base field prime and group order.
SECP256K1_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

# ed25519 base field and group order.
ED25519_P = (1 << 255) - 19
ED25519_L = (1 << 252) + 27742317777372353535851937790883648493

# zorro base field (reference: src/curve/zorro/fq.rs:4); its scalar field is
# the ed25519 base field (src/curve/zorro/fr.rs:1-2).
ZORRO_P = 57896044618658097711785492504343953927116110621106131396339151912985063395361

secp256k1_fq = Field("secp256k1::Fq", SECP256K1_P)
secp256k1_fr = Field("secp256k1::Fr", SECP256K1_N)
# secq256k1: base field = secp's scalar field, scalar field = secp's base field
secq256k1_fq = Field("secq256k1::Fq", SECP256K1_N)
secq256k1_fr = Field("secq256k1::Fr", SECP256K1_P)
ed25519_fq = Field("ed25519::Fq", ED25519_P)
ed25519_fr = Field("ed25519::Fr", ED25519_L)
zorro_fq = Field("zorro::Fq", ZORRO_P)
zorro_fr = Field("zorro::Fr", ED25519_P)
