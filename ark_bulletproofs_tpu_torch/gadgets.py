"""Shuffle gadget on the port (counterpart of gadgets.py).

`ShuffleProof` proves with the shared host prover (with the shared
engine pinned to its host path) and verifies with the port's `Verifier`,
whose mega-MSM runs on the torch device.
"""

from __future__ import annotations

from ark_bulletproofs_tpu import gadgets as _shared
from ark_bulletproofs_tpu.gadgets import shuffle_gadget

from . import engine
from .r1cs.verifier import Verifier


class ShuffleProof(_shared.ShuffleProof):
    """Proof that `output` is a permutation of `input`."""

    @classmethod
    def prove(cls, prng, pc_gens, bp_gens, transcript, input_vals,
              output_vals):
        with engine.host_backend():
            return super().prove(prng, pc_gens, bp_gens, transcript,
                                 input_vals, output_vals)

    def verify(self, pc_gens, bp_gens, transcript, input_commitments,
               output_commitments) -> None:
        verifier = self.build_verifier(pc_gens, transcript,
                                       input_commitments, output_commitments)
        verifier.verify(self.proof, pc_gens, bp_gens)

    def build_verifier(self, pc_gens, transcript, input_commitments,
                       output_commitments) -> Verifier:
        """Constraint-only port verifier, also for `batch_verify`."""
        curve = pc_gens.curve
        transcript.append_message(b"dom-sep", b"ShuffleProof")
        transcript.append_u64(b"k", len(input_commitments))
        verifier = Verifier(curve, transcript)
        in_vars = verifier.commit_many(input_commitments)
        out_vars = verifier.commit_many(output_commitments)
        shuffle_gadget(verifier, curve, in_vars, out_vars)
        return verifier
