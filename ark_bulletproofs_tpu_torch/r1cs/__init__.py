"""R1CS constraint-system proofs on the port (reference src/r1cs/)."""

from .constraint_system import (
    ConstraintSystem,
    RandomizableConstraintSystem,
    RandomizedConstraintSystem,
)
from .linear_combination import LinearCombination, Variable
from .proof import R1CSProof
from .prover import Prover, RandomizingProver, prove_batch
from .verifier import RandomizingVerifier, Verifier, batch_verify

__all__ = [
    "ConstraintSystem",
    "RandomizableConstraintSystem",
    "RandomizedConstraintSystem",
    "LinearCombination",
    "Variable",
    "R1CSProof",
    "Prover",
    "RandomizingProver",
    "prove_batch",
    "Verifier",
    "RandomizingVerifier",
    "batch_verify",
]
