"""Merlin transcript: domain-separated Fiat-Shamir over STROBE-128.

Byte-exact equivalent of the `merlin` v3 crate used by the reference
(reference: src/transcript.rs:6, src/r1cs/prover.rs:483-494). Every
challenge in the protocol is squeezed through this object, so its byte
behavior is pinned by golden-vector tests (tests/test_byte_layer.py).
"""

from __future__ import annotations

from .strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _u32_le(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    """A Merlin proof transcript."""

    def __init__(self, label: bytes | None, _strobe: Strobe128 | None = None):
        if _strobe is not None:
            self._strobe = _strobe
            return
        self._strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        assert label is not None
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        return Transcript(None, _strobe=self._strobe.clone())

    def append_message(self, label: bytes, message: bytes) -> None:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(_u32_le(len(message)), True)
        self._strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, (x & ((1 << 64) - 1)).to_bytes(8, "little"))

    def append_messages(self, label: bytes, messages: list[bytes]) -> None:
        """Sequential `append_message` with a shared label, bit-identical
        to the loop; equal-size messages ride one native STROBE call
        (the per-call Python ops cost ~10 us/message across the ~2k
        commit-phase point appends of a k=1024 prove)."""
        if not messages:
            return
        mlen = len(messages[0])
        if len(messages) >= 8 and all(len(m) == mlen for m in messages):
            from ..native import strobe_append_msgs_native

            if strobe_append_msgs_native(
                self._strobe, label, b"".join(messages), mlen,
                len(messages),
            ):
                return
        for m in messages:
            self.append_message(label, m)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(_u32_le(n), True)
        return self._strobe.prf(n, False)

    def build_rng(self) -> "TranscriptRngBuilder":
        return TranscriptRngBuilder(self._strobe.clone())


class TranscriptRngBuilder:
    """Builds a witness-bound RNG from a snapshot of the transcript state."""

    def __init__(self, strobe: Strobe128):
        self._strobe = strobe

    def rekey_with_witness_bytes(self, label: bytes, witness: bytes) -> "TranscriptRngBuilder":
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(_u32_le(len(witness)), True)
        self._strobe.key(witness, False)
        return self

    def rekey_with_witness_many(
        self, label: bytes, witnesses: list[bytes]
    ) -> "TranscriptRngBuilder":
        """Sequential `rekey_with_witness_bytes` with a shared label,
        bit-identical to the loop; equal-size witnesses ride one native
        STROBE call (the prover rekeys once per committed blinding —
        ~2k ops of a k=1024 shuffle prove; reference prover.rs:483-494)."""
        if not witnesses:
            return self
        wlen = len(witnesses[0])
        if len(witnesses) >= 8 and all(len(w) == wlen for w in witnesses):
            from ..native import strobe_rekey_msgs_native

            if strobe_rekey_msgs_native(
                self._strobe, label, b"".join(witnesses), wlen,
                len(witnesses),
            ):
                return self
        for w in witnesses:
            self.rekey_with_witness_bytes(label, w)
        return self

    def finalize(self, rng) -> "TranscriptRng":
        """`rng` must expose fill_bytes(n) -> bytes (external entropy)."""
        random_bytes = rng.fill_bytes(32)
        self._strobe.meta_ad(b"rng", False)
        self._strobe.key(random_bytes, False)
        return TranscriptRng(self._strobe)


class TranscriptRng:
    """RNG squeezed from the transcript; rand_core-compatible word semantics.

    `next_u64` goes through an 8-byte `fill_bytes` (one meta-AD + PRF per
    call), matching rand_core's `next_u64_via_fill` used by merlin's
    TranscriptRng — this granularity affects the byte stream and therefore
    the sampled blinding factors.
    """

    def __init__(self, strobe: Strobe128):
        self._strobe = strobe

    def fill_bytes(self, n: int) -> bytes:
        self._strobe.meta_ad(_u32_le(n), False)
        return self._strobe.prf(n, False)

    def next_u32(self) -> int:
        return int.from_bytes(self.fill_bytes(4), "little")

    def next_u64(self) -> int:
        return int.from_bytes(self.fill_bytes(8), "little")

    def next_bool(self) -> bool:
        return (self.next_u32() >> 31) == 1
