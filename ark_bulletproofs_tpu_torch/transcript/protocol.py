"""Domain-separated transcript protocol for Bulletproofs.

Equivalent of the `TranscriptProtocol` trait impl for merlin::Transcript
(reference src/transcript.rs:45-102). Scalars and points are appended in
their arkworks *uncompressed* canonical encodings; challenge scalars are
derived by squeezing 32 bytes and running arkworks `F::rand` over a ChaCha20
RNG seeded with them (reference src/transcript.rs:95-101).
"""

from __future__ import annotations

from ..errors import VerificationError
from ..hashes.chacha import ChaChaRng
from .merlin import Transcript


def rangeproof_domain_sep(t: Transcript, n: int, m: int) -> None:
    t.append_message(b"dom-sep", b"rangeproof v1")
    t.append_u64(b"n", n)
    t.append_u64(b"m", m)


def innerproduct_domain_sep(t: Transcript, n: int) -> None:
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_u64(b"n", n)


def r1cs_domain_sep(t: Transcript) -> None:
    t.append_message(b"dom-sep", b"r1cs v1")


def r1cs_1phase_domain_sep(t: Transcript) -> None:
    t.append_message(b"dom-sep", b"r1cs-1phase")


def r1cs_2phase_domain_sep(t: Transcript) -> None:
    t.append_message(b"dom-sep", b"r1cs-2phase")


def append_scalar(t: Transcript, curve, label: bytes, scalar: int) -> None:
    t.append_message(label, curve.fr.to_bytes(scalar))


def append_point(t: Transcript, curve, label: bytes, point) -> None:
    t.append_message(label, curve.serialize_uncompressed(point))


def validate_and_append_point(t: Transcript, curve, label: bytes, point) -> None:
    if curve.is_zero(point):
        raise VerificationError("identity point in transcript")
    t.append_message(label, curve.serialize_uncompressed(point))


def challenge_scalar(t: Transcript, curve, label: bytes) -> int:
    buf = t.challenge_bytes(label, 32)
    return curve.fr.rand(ChaChaRng(buf))
