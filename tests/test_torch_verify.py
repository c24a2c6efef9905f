"""Port verifier and batch_verify vs the JAX package's verifier.

Tolerance: the same accept/reject decision as the JAX package's verifier
under engine backend "host", for honest proofs, a flipped t_x byte and
swapped commitments. The proofs come from the port's prover and reach the
JAX verifier as bytes. The port's mega-MSM runs on its device path
(threshold 0, CPU tensors: the kernels' plain versions) for the honest
proofs and for one tampered proof; the rest take the port's host route.
"""

import os
import pickle
import random

import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu import engine as shared_engine
from ark_bulletproofs_tpu import gadgets as shared_gadgets
from ark_bulletproofs_tpu.errors import R1CSError as SharedR1CSError
from ark_bulletproofs_tpu.r1cs import R1CSProof as SharedR1CSProof
from ark_bulletproofs_tpu.r1cs import batch_verify as shared_batch_verify
from ark_bulletproofs_tpu.rand import seeded_rng as shared_rng
from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                        R1CSError, R1CSProof, ShuffleProof,
                                        Transcript, batch_verify, curves,
                                        engine, seeded_rng)

torch.set_num_threads(1)

CURVE = curves.secq256k1
JCURVE = jax_pkg.curves.secq256k1
LABEL = b"port verify test"
BATCH_CACHE = os.path.join(os.path.dirname(__file__), "..", "benches",
                           ".cache_batch_secq256k1_k8_n64.pkl")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(shared_engine.config, "backend", "host")


@pytest.fixture
def device_msm(monkeypatch):
    """Route every mega-MSM through the port's device path (plain
    versions on the CPU)."""
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)


def _gens(k):
    return (PedersenGens.default(CURVE),
            BulletproofGens(CURVE, max(2 * k, 16), 1))


def _shared_gens(k):
    return (jax_pkg.PedersenGens.default(JCURVE),
            jax_pkg.BulletproofGens(JCURVE, max(2 * k, 16), 1))


def _prove(k, seed):
    pc, bp = _gens(k)
    pyrng = random.Random(seed)
    vals = [pyrng.getrandbits(64) for _ in range(k)]
    perm = vals[:]
    pyrng.shuffle(perm)
    sp, ic, oc = ShuffleProof.prove(seeded_rng(seed), pc, bp,
                                    Transcript(LABEL), vals, perm)
    return pc, bp, sp.proof, ic, oc


def _tamper_t_x(proof):
    blob = bytearray(proof.to_bytes(CURVE))
    blob[11 * len(CURVE.serialize_compressed(CURVE.gen))] ^= 1
    return R1CSProof.from_bytes(CURVE, bytes(blob))


def _accepts(fn) -> bool:
    try:
        fn()
    except (R1CSError, SharedR1CSError):
        return False
    return True


def _verify(cls, pc, bp, proof, ic, oc):
    return _accepts(lambda: cls(proof).verify(pc, bp, Transcript(LABEL),
                                              ic, oc))


def _shared_verify(pc, bp, proof, ic, oc):
    sp = SharedR1CSProof.from_bytes(JCURVE, proof.to_bytes(CURVE))
    return _accepts(lambda: shared_gadgets.ShuffleProof(sp).verify(
        pc, bp, jax_pkg.Transcript(LABEL), ic, oc))


@pytest.mark.parametrize("k", [8, 64])
def test_shuffle_verify_matches_shared(k, monkeypatch):
    pc, bp, proof, ic, oc = _prove(k, k)
    variants = {
        "honest": (proof, ic, oc),
        "flipped t_x": (_tamper_t_x(proof), ic, oc),
        "swapped": (proof, oc, ic),
    }
    jpc, jbp = _shared_gens(k)
    for name, (p, a, b) in variants.items():
        shared = _shared_verify(jpc, jbp, p, a, b)
        port = _verify(ShuffleProof, pc, bp, p, a, b)
        assert shared == port == (name == "honest"), name
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    assert _verify(ShuffleProof, pc, bp, proof, ic, oc)
    if k == 8:
        assert not _verify(ShuffleProof, pc, bp, _tamper_t_x(proof), ic, oc)


def _batch_instances(cls, items, pc, transcript=Transcript):
    return [
        (cls(p).build_verifier(pc, transcript(b"bench batch"), ic, oc), p)
        for p, ic, oc in items
    ]


def test_batch_verify_matches_shared(device_msm):
    with open(BATCH_CACHE, "rb") as fh:
        blobs = pickle.load(fh)[:4]  # tracked in the repo
    items = [
        (R1CSProof.from_bytes(CURVE, pb),
         [CURVE.deserialize_compressed(b) for b in icb],
         [CURVE.deserialize_compressed(b) for b in ocb])
        for pb, icb, ocb in blobs
    ]
    pc, bp = _gens(8)
    jpc, jbp = _shared_gens(8)
    bad = list(items)
    p, ic, oc = bad[2]
    bad[2] = (_tamper_t_x(p), ic, oc)
    for batch, ok in ((items, True), (bad, False)):
        jbatch = [(SharedR1CSProof.from_bytes(JCURVE, p.to_bytes(CURVE)),
                   ic, oc) for p, ic, oc in batch]
        shared = _accepts(lambda: shared_batch_verify(
            shared_rng(9), _batch_instances(
                shared_gadgets.ShuffleProof, jbatch, jpc,
                jax_pkg.Transcript), jpc, jbp))
        port = _accepts(lambda: batch_verify(
            seeded_rng(9), _batch_instances(ShuffleProof, batch, pc), pc,
            bp))
        assert shared == port == ok
