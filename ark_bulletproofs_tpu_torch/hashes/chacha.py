"""ChaCha20 keystream RNG matching `rand_chacha::ChaCha20Rng` semantics.

The reference derives every generator and every Fiat–Shamir challenge scalar
through `ChaChaRng::from_seed(seed32)` followed by arkworks `UniformRand`
(reference: src/generators.rs:59,87 and src/transcript.rs:99). Bit-exactness
of this word stream is a correctness keystone for the whole framework.

`ChaCha20Rng` is the original (djb) ChaCha variant with a 64-bit block
counter and 64-bit stream id, both starting at 0. With stream id 0 the
keystream for the first 2^32 blocks is identical to the IETF (RFC 8439)
keystream with an all-zero 96-bit nonce. Consumers read the output as a
sequence of little-endian 32-bit words; `next_u64` takes two consecutive
words (low word first), matching rand_core's `BlockRng` behavior for
word-aligned consumption.
"""

from __future__ import annotations

MASK32 = (1 << 32) - 1

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _quarter(state: list[int], a: int, b: int, c: int, d: int) -> None:
    x = state
    x[a] = (x[a] + x[b]) & MASK32
    x[d] ^= x[a]
    x[d] = ((x[d] << 16) | (x[d] >> 16)) & MASK32
    x[c] = (x[c] + x[d]) & MASK32
    x[b] ^= x[c]
    x[b] = ((x[b] << 12) | (x[b] >> 20)) & MASK32
    x[a] = (x[a] + x[b]) & MASK32
    x[d] ^= x[a]
    x[d] = ((x[d] << 8) | (x[d] >> 24)) & MASK32
    x[c] = (x[c] + x[d]) & MASK32
    x[b] ^= x[c]
    x[b] = ((x[b] << 7) | (x[b] >> 25)) & MASK32


def chacha20_block_words(key_words: tuple[int, ...], counter: int) -> list[int]:
    """One 64-byte ChaCha20 block as 16 little-endian u32 words.

    64-bit counter split over state words 12 (low) and 13 (high); stream id 0
    in words 14-15.
    """
    from ..native import chacha20_blocks_native

    fast = chacha20_blocks_native(key_words, counter, 1)
    if fast is not None:
        return fast.tolist()
    init = list(_SIGMA) + list(key_words) + [
        counter & MASK32,
        (counter >> 32) & MASK32,
        0,
        0,
    ]
    x = list(init)
    for _ in range(10):
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return [(x[i] + init[i]) & MASK32 for i in range(16)]


class ChaChaRng:
    """Word-stream view of the ChaCha20 keystream, seeded from 32 bytes."""

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("ChaChaRng seed must be 32 bytes")
        self._key = tuple(
            int.from_bytes(seed[4 * i: 4 * i + 4], "little") for i in range(8)
        )
        self._counter = 0
        self._buf: list[int] = []
        self._idx = 0

    def _refill(self) -> None:
        self._buf = chacha20_block_words(self._key, self._counter)
        self._counter += 1
        self._idx = 0

    def next_u32(self) -> int:
        if self._idx >= len(self._buf):
            self._refill()
        w = self._buf[self._idx]
        self._idx += 1
        return w

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def next_bool(self) -> bool:
        """rand 0.8 `Standard` bool: most-significant bit of next_u32."""
        return (self.next_u32() >> 31) == 1

    # --- bulk access (device generator farm; state-exact) ---------------

    def state_snapshot(self):
        return (self._counter, self._idx, list(self._buf))

    def state_restore(self, snap) -> None:
        self._counter, self._idx, buf = snap
        self._buf = list(buf)

    def _abs_pos(self) -> int:
        """Absolute number of keystream words consumed so far."""
        blocks_done = self._counter - (1 if self._buf else 0)
        return blocks_done * 16 + self._idx

    def skip_words(self, k: int) -> None:
        """Advance the word stream by k words in O(1) (+1 block gen)."""
        pos = self._abs_pos() + k
        self._counter = pos // 16
        idx = pos % 16
        if idx:
            self._refill()  # generates block self._counter, increments it
            self._idx = idx
        else:
            self._buf = []
            self._idx = 0

    def next_u32_array(self, k: int):
        """k keystream words as a numpy uint32 array (state advances by k);
        the blocks come from the native library as one array."""
        import numpy as np

        from ..native import chacha20_blocks_native

        lead = np.array(self._buf[self._idx:self._idx + k] if self._buf
                        else [], dtype=np.uint32)
        need = k - len(lead)
        nblk = (need + 15) // 16
        if not nblk:
            self._idx += len(lead)
            return lead
        words = chacha20_blocks_native(self._key, self._counter, nblk)
        if words is None:
            words = np.array(
                [w for i in range(nblk)
                 for w in chacha20_block_words(self._key, self._counter + i)],
                dtype=np.uint32)
        self._counter += nblk
        used = need % 16
        if used:
            self._buf = words[-16:].tolist()
            self._idx = used
        else:
            self._buf = []
            self._idx = 0
        return np.concatenate([lead, words[:need]])

    def fill_bytes(self, n: int) -> bytes:
        """n keystream bytes, little-endian word order (word-aligned reads only
        are needed by arkworks; byte-level reads are used as external entropy
        where exactness versus rand_core does not matter)."""
        words = (n + 3) // 4
        out = b"".join(self.next_u32().to_bytes(4, "little") for _ in range(words))
        return out[:n]
