"""ark_bulletproofs_tpu_torch: the PyTorch + CUDA port of ark_bulletproofs_tpu.

The JAX package beside it stays the reference. This package stands
alone: it imports torch, never jax, and nothing of the JAX package. It
keeps its own copy of the host layer (fields, curves, transcript, native
C++, generators, the R1CS constraint system, prover and verifier) and
owns the device layer: the v2 Pippenger MSM on four hand-written CUDA
kernels for Hopper and a Montgomery-product kernel for the prover's
vector phase and inner-product argument (csrc/), with plain PyTorch
versions that run on the CPU.

Entry points run on the card (`engine.config.device = "cuda"`) unless
the caller asks for the CPU (`engine.config.device = "cpu"`).

Public surface:
  engine                   - device and size routing (`engine.config`)
  curves, PedersenGens, BulletproofGens, Transcript, seeded_rng
  msm, msm_many            - host-facing device MSMs
  Prover, prove_batch, Verifier, batch_verify, R1CSProof, ShuffleProof
  InnerProductProof        - create, create_batch (P proofs in lockstep)
"""

from . import curves, engine
from .errors import MPCError, ProofError, R1CSError, VerificationError
from .gadgets import ShuffleProof
from .generators import (BulletproofGens, BulletproofGensShare,
                         GeneratorsChain, PedersenGens)
from .ipp import InnerProductProof
from .ops.msm import msm, msm_many
from .r1cs import Prover, R1CSProof, Verifier, batch_verify, prove_batch
from .rand import OsRng, seeded_rng
from .transcript.merlin import Transcript

__all__ = [
    "curves", "engine", "msm", "msm_many",
    "BulletproofGens", "BulletproofGensShare", "GeneratorsChain",
    "PedersenGens", "InnerProductProof", "Transcript", "OsRng",
    "seeded_rng", "Prover", "R1CSProof", "Verifier", "batch_verify",
    "prove_batch",
    "ShuffleProof", "ProofError", "VerificationError", "MPCError",
    "R1CSError",
]
