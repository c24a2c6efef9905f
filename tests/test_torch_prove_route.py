"""The port's device routes of the prover vs the JAX package's host prover.

The device branches (tabled phase MSMs, vector phase, device IPA) are
forced by lowering their thresholds; on CPU tensors every kernel wrapper
runs its plain version. The JAX package runs its host route (engine
backend "host"). Inputs are made with numpy from a seed; Fiat-Shamir fixes
every challenge, so the tolerance is exact: equal proof bytes.
"""

import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu import engine as shared_engine
from ark_bulletproofs_tpu.gadgets import ShuffleProof as SharedShuffleProof
from ark_bulletproofs_tpu.rand import seeded_rng as shared_rng
from ark_bulletproofs_tpu_torch import (BulletproofGens, InnerProductProof,
                                        PedersenGens, ShuffleProof,
                                        Transcript, curves, engine, ipp,
                                        seeded_rng)
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops import ipa, msm
from ark_bulletproofs_tpu_torch.ops import prove as vector_phase
from ark_bulletproofs_tpu_torch.r1cs import prover

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(shared_engine.config, "backend", "host")


def _scalars(p: int, n: int, seed: int) -> list[int]:
    raw = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(n, 16), dtype=np.uint16).tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") % p
            for i in range(n)]


def test_ipa_device_route_matches_jax_host(monkeypatch):
    """n = 64 on the device route (threshold 0), against the JAX host IPA;
    the proof then verifies on the host route. (The table shrink first
    runs at N / cur = 128 segments per slot, far above this size; the
    card's tests and chip_smoke.py hold it to the host route.)"""
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    n, curve = 64, curves.secq256k1
    jcurve = jax_pkg.curves.secq256k1
    p = curve.fr.p
    gens = BulletproofGens(curve, n, 1).share(0)
    G, H = gens.G(n), gens.H(n)
    Q = curve.mul(PedersenGens.default(curve).B, 12345)
    gf, hf, a, b = (_scalars(p, n, 60 + i) for i in range(4))
    before = df.mont_mul.launches
    proof = InnerProductProof.create(Transcript(b"ipa"), curve, Q, gf, hf,
                                     G, H, a, b)
    assert df.mont_mul.launches == before  # CPU tensors: plain versions
    want = jax_pkg.InnerProductProof.create(
        jax_pkg.Transcript(b"ipa"), jcurve, Q, gf, hf, G, H, a, b)
    assert proof.to_bytes(curve) == want.to_bytes(jcurve)
    monkeypatch.setattr(engine.config, "msm_device_threshold", 1 << 62)
    P = curve.msm(G + H + [Q], [x * f % p for x, f in zip(a, gf)]
                  + [y * f % p for y, f in zip(b, hf)]
                  + [sum(x * y for x, y in zip(a, b)) % p])
    proof.verify(n, Transcript(b"ipa"), curve, gf, hf, P, Q, G, H)


def _spy(monkeypatch, owner, name: str, calls: dict) -> None:
    fn = getattr(owner, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(owner, name, counted)


def test_device_branches_shuffle_matches_jax_host(monkeypatch):
    """A k = 4 shuffle (6 multipliers, padded_n = 8) through every device
    branch equals the JAX host prover's proof, and the port verifies it on
    its host route."""
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    monkeypatch.setattr(prover, "VECTOR_MIN_N", 1)
    monkeypatch.setattr(ipp, "DEVICE_MIN_N", 1)
    calls = {}
    _spy(monkeypatch, msm, "msm_many_tabled", calls)
    _spy(monkeypatch, vector_phase.ProverVectorPhase, "eval_lr", calls)
    _spy(monkeypatch, ipa.IpaDeviceProver, "fold", calls)
    curve, jcurve = curves.secq256k1, jax_pkg.curves.secq256k1
    vals, perm = [11, 22, 33, 44], [33, 11, 44, 22]
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 8, 1)
    sp, ic, oc = ShuffleProof.prove(seeded_rng(4), pc, bp,
                                    Transcript(b"device route"), vals, perm)
    jsp, jic, joc = SharedShuffleProof.prove(
        shared_rng(4), jax_pkg.PedersenGens.default(jcurve),
        jax_pkg.BulletproofGens(jcurve, 8, 1),
        jax_pkg.Transcript(b"device route"), vals, perm)
    # the phase-2 table MSM, the vector phase, the IPA's 3 rounds
    assert calls == {"msm_many_tabled": 1, "eval_lr": 1, "fold": 3}
    assert sp.proof.to_bytes(curve) == jsp.proof.to_bytes(jcurve)
    assert (ic, oc) == (jic, joc)
    monkeypatch.setattr(engine.config, "msm_device_threshold", 1 << 62)
    ShuffleProof(sp.proof).verify(pc, bp, Transcript(b"device route"), ic, oc)
