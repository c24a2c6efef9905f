"""External entropy sources for proving and batch verification.

Any object with next_u32/next_u64/next_bool/fill_bytes works as an RNG for
`Field.rand` / `Curve.rand` / `Prover.prove` / `batch_verify`. `OsRng`
wraps os.urandom; `seeded_rng` gives a deterministic ChaCha20 stream, the
tool for reproducible proofs and golden vectors (SURVEY.md §4).
"""

from __future__ import annotations

import os

from .hashes.chacha import ChaChaRng


class OsRng:
    def fill_bytes(self, n: int) -> bytes:
        return os.urandom(n)

    def next_u32(self) -> int:
        return int.from_bytes(os.urandom(4), "little")

    def next_u64(self) -> int:
        return int.from_bytes(os.urandom(8), "little")

    def next_bool(self) -> bool:
        return (self.next_u32() >> 31) == 1


def seeded_rng(seed: int | bytes) -> ChaChaRng:
    if isinstance(seed, int):
        seed = seed.to_bytes(32, "little")
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    return ChaChaRng(seed)
