"""Gadget library of the port: shuffle proof, example gadget, range proof
(the JAX package's gadgets.py on the port's prover and verifier).

Behavioral parity with the reference's test-side gadgets
(tests/r1cs_secq256k1.rs:16-129, 218-229, 361-393), packaged as a reusable
module and exercised across all supported curves by the test suite.
"""

from __future__ import annotations

from .errors import MissingAssignment
from .generators import BulletproofGens, PedersenGens
from .r1cs import LinearCombination, Prover, Variable, Verifier
from .transcript.merlin import Transcript


# --- k-shuffle -----------------------------------------------------------


def shuffle_gadget(cs, curve, x: list[Variable], y: list[Variable]) -> None:
    """Permutation proof via grand products at a random challenge z:
    prod(x_i - z) == prod(y_i - z). Uses the randomized second phase
    (reference tests/r1cs_secq256k1.rs:16-56)."""
    assert len(x) == len(y)
    k = len(x)
    if k == 1:
        cs.constrain(y[0] - x[0])
        return

    def randomized(rcs):
        z = rcs.challenge_scalar(b"shuffle challenge")
        _, _, last_mulx_out = rcs.multiply(x[k - 1] - z, x[k - 2] - z)
        first_mulx_out = last_mulx_out
        for i in range(k - 3, -1, -1):
            _, _, first_mulx_out = rcs.multiply(first_mulx_out.lc(), x[i] - z)
        _, _, last_muly_out = rcs.multiply(y[k - 1] - z, y[k - 2] - z)
        first_muly_out = last_muly_out
        for i in range(k - 3, -1, -1):
            _, _, first_muly_out = rcs.multiply(first_muly_out.lc(), y[i] - z)
        rcs.constrain(first_mulx_out - first_muly_out)

    cs.specify_randomized_constraints(randomized)


class ShuffleProof:
    """Proof that `output` is a permutation of `input`."""

    def __init__(self, proof):
        self.proof = proof

    @classmethod
    def prove(
        cls,
        prng,
        pc_gens: PedersenGens,
        bp_gens: BulletproofGens,
        transcript: Transcript,
        input_vals: list[int],
        output_vals: list[int],
    ):
        curve = pc_gens.curve
        k = len(input_vals)
        transcript.append_message(b"dom-sep", b"ShuffleProof")
        transcript.append_u64(b"k", k)

        from .utils.profiling import phase

        prover = Prover(pc_gens, transcript)
        # blinding draws happen in the same order as the sequential
        # commit loop, so transcripts (and proofs) are unchanged
        with phase("shuffle:commits"):
            with phase("shuffle:blind-draws"):
                in_blinds = curve.fr.rand_many(prng, len(input_vals))
                out_blinds = curve.fr.rand_many(prng, len(output_vals))
            in_coms, in_vars = zip(
                *prover.commit_many(list(input_vals), in_blinds)
            )
            out_coms, out_vars = zip(
                *prover.commit_many(list(output_vals), out_blinds)
            )
        with phase("shuffle:gadget"):
            shuffle_gadget(prover, curve, list(in_vars), list(out_vars))
        proof = prover.prove(prng, bp_gens)
        return cls(proof), list(in_coms), list(out_coms)

    def verify(
        self,
        pc_gens: PedersenGens,
        bp_gens: BulletproofGens,
        transcript: Transcript,
        input_commitments: list,
        output_commitments: list,
    ) -> None:
        curve = pc_gens.curve
        k = len(input_commitments)
        transcript.append_message(b"dom-sep", b"ShuffleProof")
        transcript.append_u64(b"k", k)

        verifier = Verifier(curve, transcript)
        in_vars = verifier.commit_many(input_commitments)
        out_vars = verifier.commit_many(output_commitments)
        shuffle_gadget(verifier, curve, in_vars, out_vars)
        verifier.verify(self.proof, pc_gens, bp_gens)

    def build_verifier(
        self,
        pc_gens: PedersenGens,
        transcript: Transcript,
        input_commitments: list,
        output_commitments: list,
    ) -> Verifier:
        """Constraint-only verifier for use with batch_verify."""
        curve = pc_gens.curve
        transcript.append_message(b"dom-sep", b"ShuffleProof")
        transcript.append_u64(b"k", len(input_commitments))
        verifier = Verifier(curve, transcript)
        in_vars = verifier.commit_many(input_commitments)
        out_vars = verifier.commit_many(output_commitments)
        shuffle_gadget(verifier, curve, in_vars, out_vars)
        return verifier


# --- example gadget ------------------------------------------------------


def example_gadget(cs, a1, a2, b1, b2, c1, c2) -> None:
    """(a1 + a2) * (b1 + b2) = (c1 + c2)
    (reference tests/r1cs_secq256k1.rs:218-229)."""
    _, _, c_var = cs.multiply(a1 + a2, b1 + b2)
    cs.constrain(c1 + c2 - c_var)


# --- range proof ----------------------------------------------------------


def range_proof_gadget(cs, curve, v_lc, v_assignment: int | None, n: int) -> None:
    """Bit-decomposition range gadget: v in [0, 2^n)
    (reference tests/r1cs_secq256k1.rs:361-393)."""
    fr = curve.fr
    exp_2 = 1
    v = LinearCombination.from_value(fr, v_lc)
    for i in range(n):
        if v_assignment is not None:
            bit = (v_assignment >> i) & 1
            a, b, o = cs.allocate_multiplier((1 - bit, bit))
        else:
            a, b, o = cs.allocate_multiplier(None)
        # a*b = 0 forces one of (a, b) to be zero; a + b = 1 makes them bits.
        cs.constrain(o.lc())
        cs.constrain(a + b - LinearCombination.from_value(fr, 1))
        v = v - b * exp_2
        exp_2 = (exp_2 + exp_2) % fr.p
    cs.constrain(v)
