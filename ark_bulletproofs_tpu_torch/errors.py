"""Error taxonomy (behavioral parity with reference src/errors.rs)."""

from __future__ import annotations


class ProofError(Exception):
    """Error in proof creation, verification, or parsing
    (reference src/errors.rs:12-37)."""


class VerificationError(ProofError):
    """Proof failed to verify."""


class FormatError(ProofError):
    """Proof encoding is malformed."""


class InvalidGeneratorsLength(ProofError):
    """Too few generators for the proof."""


class MPCError(ProofError):
    """Vestigial multiparty-computation error type kept for API parity
    (reference src/errors.rs:89-116; the dealer/party modules were removed
    upstream and only the error type remains)."""


class R1CSError(Exception):
    """Error during constraint-system proving or verifying
    (reference src/errors.rs:150-167)."""


class R1CSVerificationError(R1CSError):
    pass


class R1CSFormatError(R1CSError):
    pass


class R1CSInvalidGeneratorsLength(R1CSError):
    pass


class MissingAssignment(R1CSError):
    """A gadget needed a witness value the caller did not provide."""


class GadgetError(R1CSError):
    def __init__(self, description: str):
        super().__init__(description)
        self.description = description
