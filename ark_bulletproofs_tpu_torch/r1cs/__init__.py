"""R1CS verification on the port's MSM."""

from .verifier import Verifier, batch_verify

__all__ = ["Verifier", "batch_verify"]
