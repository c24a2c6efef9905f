"""ark_bulletproofs_tpu_torch: the PyTorch + CUDA port of ark_bulletproofs_tpu.

The JAX package beside it stays the reference. This package shares its
jax-free host layer (fields, curves, transcript, native C++, generators,
the R1CS constraint system and prover) and owns the device layer: the v2
Pippenger MSM on four hand-written CUDA kernels for Hopper (csrc/), with
plain PyTorch versions that run on the CPU. It imports torch, never jax.

Public surface:
  engine           - device and size routing (`engine.config`)
  msm, msm_many    - host-facing device MSMs
  Verifier, batch_verify, ShuffleProof - verification on the port's MSM
"""

from . import engine
from .gadgets import ShuffleProof
from .ops.msm import msm, msm_many
from .r1cs import Verifier, batch_verify

__all__ = ["engine", "msm", "msm_many", "Verifier", "batch_verify",
           "ShuffleProof"]
