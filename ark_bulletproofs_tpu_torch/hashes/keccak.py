"""Keccak-f[1600] permutation and SHA3-512, pure Python.

Host byte layer of the port (its own copy of the JAX package's). The reference
uses the Rust `sha3` crate for generator derivation
(reference: src/generators.rs:16,52,79) and Merlin's STROBE-128 duplex is
built on Keccak-f[1600]. These are *not* hot loops (a handful of calls per
proof / per generator), so a clear host implementation is the right design;
a C++ fast path can be swapped in via `ark_bulletproofs_tpu_torch.native`.

Implemented from the FIPS-202 / Keccak specification (not translated from
any other codebase).
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1

# Round constants for the iota step (24 rounds), from FIPS-202.
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets rho[x][y] laid out as a flat list indexed by x + 5*y.
_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rotl(v: int, n: int) -> int:
    n &= 63
    return ((v << n) | (v >> (64 - n))) & MASK64


def keccak_f1600(lanes: list[int]) -> list[int]:
    """Apply the Keccak-f[1600] permutation to 25 64-bit lanes (x + 5*y order)."""
    from ..native import keccak_f1600_native

    fast = keccak_f1600_native(lanes)
    if fast is not None:
        return fast
    return _keccak_f1600_py(lanes)


def _keccak_f1600_py(lanes: list[int]) -> list[int]:
    a = list(lanes)
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                # pi: b[y, 2x+3y] = rot(a[x, y])
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x + 5 * y])
        # chi
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & MASK64)
                    & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        # iota
        a[0] ^= rc
    return a


def keccak_f1600_bytes(state: bytearray) -> None:
    """Apply Keccak-f[1600] in place to a 200-byte state (little-endian lanes)."""
    from ..native import keccak_f1600_bytes_native

    if keccak_f1600_bytes_native(state):
        return
    lanes = [int.from_bytes(state[8 * i: 8 * i + 8], "little") for i in range(25)]
    lanes = keccak_f1600(lanes)
    for i, lane in enumerate(lanes):
        state[8 * i: 8 * i + 8] = lane.to_bytes(8, "little")


def _sponge(data: bytes, rate: int, out_len: int, domain: int) -> bytes:
    """Keccak sponge with `rate` bytes rate and the given domain-separation byte."""
    state = bytearray(200)
    # absorb
    off = 0
    while off + rate <= len(data):
        for i in range(rate):
            state[i] ^= data[off + i]
        keccak_f1600_bytes(state)
        off += rate
    # final partial block + padding (pad10*1 with domain bits)
    rem = data[off:]
    for i, byte in enumerate(rem):
        state[i] ^= byte
    state[len(rem)] ^= domain
    state[rate - 1] ^= 0x80
    keccak_f1600_bytes(state)
    # squeeze
    out = bytearray()
    while len(out) < out_len:
        out += state[:rate]
        if len(out) < out_len:
            keccak_f1600_bytes(state)
    return bytes(out[:out_len])


def sha3_512(data: bytes) -> bytes:
    """SHA3-512 digest (64 bytes). rate = 200 - 2*64 = 72, domain 0x06."""
    from ..native import sha3_native

    fast = sha3_native(data, 72, 0x06, 64)
    if fast is not None:
        return fast
    return _sponge(data, 72, 64, 0x06)


def sha3_256(data: bytes) -> bytes:
    """SHA3-256 digest (32 bytes). rate = 200 - 2*32 = 136, domain 0x06."""
    fast = None
    try:
        from ..native import sha3_native

        fast = sha3_native(data, 136, 0x06, 32)
    except Exception:
        pass
    if fast is not None:
        return fast
    return _sponge(data, 136, 32, 0x06)
