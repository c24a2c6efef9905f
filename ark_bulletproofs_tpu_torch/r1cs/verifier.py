"""R1CS verifier and batch verification on the port's MSM.

Counterpart of ark_bulletproofs_tpu/r1cs/verifier.py. The constraint
system, the transcript replay (`_verification_ingredients`) and the
scalar assembly (`_assemble_host_scalars`) are the shared host code;
what changes is the mega-MSM: one MSM over [B, B_blinding, G, H, extras]
that must be the identity, on the port's device path above the engine
threshold. Generator tables come from the device cache. The device
scalar pipeline of the JAX package (ops/verify.py) is not ported yet:
the g/h scalar vectors are assembled on the host.
"""

from __future__ import annotations

import torch

from ark_bulletproofs_tpu.errors import R1CSVerificationError
from ark_bulletproofs_tpu.r1cs.verifier import Verifier as _SharedVerifier
from ark_bulletproofs_tpu.util import next_power_of_two

from .. import engine
from ..ops import cache as dcache
from ..ops.curve import affine_to_device, point_to_host, spec_for
from ..ops.msm import scalars_to_device
from ..parallel.msm import msm_device_ragged


def _mega_msm(curve, pc_gens, bp_gens, n_gens: int, extras: list,
              scalars: list[int]):
    """sum of scalars times [B, B_blinding] + G(n_gens) + H(n_gens) +
    extras, affine out."""
    n = 2 + 2 * n_gens + len(extras)
    if len(scalars) != n:
        raise ValueError(f"mega-MSM: {len(scalars)} scalars for {n} bases")
    if not engine.use_device(n):
        with engine.host_backend():
            gens = bp_gens.share(0)
            bases = ([pc_gens.B, pc_gens.B_blinding] + gens.G(n_gens)
                     + gens.H(n_gens) + extras)
        return curve.msm(bases, scalars)
    dev = engine.torch_device()
    Xp, Yp, Ip = dcache.pc_pair(pc_gens, curve, dev)
    Xt, Yt, It = dcache.bp_table(bp_gens, curve, n_gens, dev)
    Xe, Ye, Ie = affine_to_device(curve, extras, dev)
    X = torch.cat([Xp, Xt, Xe], dim=1)
    Y = torch.cat([Yp, Yt, Ye], dim=1)
    inf = torch.cat([Ip, It, Ie])
    scal = scalars_to_device(curve, [scalars], dev)
    return point_to_host(curve, msm_device_ragged(spec_for(curve), X, Y,
                                                  inf, scal))


class Verifier(_SharedVerifier):
    """The shared R1CS verifier with the mega-MSM on the port."""

    def verify_and_return_transcript(self, proof, pc_gens, bp_gens):
        with engine.host_backend():
            ing = self._verification_ingredients(proof, bp_gens)
            scalars = self._assemble_host_scalars(ing, proof)
        check = _mega_msm(self.curve, pc_gens, bp_gens, ing["padded_n"],
                          self._extra_bases(proof), scalars)
        if not self.curve.is_zero(check):
            raise R1CSVerificationError("mega-MSM check failed")
        return self._transcript


def batch_verify(prng, instances, pc_gens, bp_gens) -> None:
    """One mega-MSM over a random linear combination of the proofs'
    scalar vectors; the B/B_blinding/G/H columns are shared across proofs
    (the layout of the shared `batch_verify`, reference
    verifier.rs:604-691). Raises R1CSVerificationError if the batch
    fails."""
    curve = pc_gens.curve
    fr = curve.fr
    p = fr.p
    with engine.host_backend():
        ings = [v._verification_ingredients(proof, bp_gens)
                for v, proof in instances]
        vecs = [v._assemble_host_scalars(ing, proof)
                for (v, proof), ing in zip(instances, ings)]
    max_n = max(ing["padded_n"] for ing in ings)
    all_scalars = [0] * (2 * max_n + 2)
    extras: list = []
    for (verifier, proof), scalars in zip(instances, vecs):
        alpha = fr.rand(prng)
        scaled = [alpha * s % p for s in scalars]
        padded_n = next_power_of_two(verifier.num_vars)
        all_scalars[0] = (all_scalars[0] + scaled[0]) % p
        all_scalars[1] = (all_scalars[1] + scaled[1]) % p
        for i, s in enumerate(scaled[2: 2 + padded_n]):
            all_scalars[i + 2] = (all_scalars[i + 2] + s) % p
        for i, s in enumerate(scaled[2 + padded_n: 2 + 2 * padded_n]):
            j = 2 + max_n + i
            all_scalars[j] = (all_scalars[j] + s) % p
        all_scalars.extend(scaled[2 + 2 * padded_n:])
        extras.extend(verifier._extra_bases(proof))
    check = _mega_msm(curve, pc_gens, bp_gens, max_n, extras, all_scalars)
    if not curve.is_zero(check):
        raise R1CSVerificationError("batch verification failed")
