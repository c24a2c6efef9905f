"""The port's on-device Fiat-Shamir IPA (`ops/ipa.py::ipa_prove_fs`) vs
the JAX package's host prover.

`InnerProductProof.create` takes the FS route on the CPU here (`ipp.IPA_FS`
= ("cpu",)), with every kernel wrapper on its plain version: the Q table
by `jac_double` (or `te_double`), the c * Q tree and S = MSM + c * Q by
`jac_double_k_add` (or `te_double_k_add`), one `fs_round` a round, the fold
and the host replay at the end, at n = 16 in one segment (n = 64 with the
on-device shrink: tests/test_torch_ipa_fs_shrink.py). The JAX package
runs its host route (engine backend "host"; its own `ipa_prove_fs` is never
called here: its XLA compile takes minutes). Inputs are made with numpy
from a seed; Fiat-Shamir fixes every challenge, so the tolerance is exact:
equal proof bytes and equal transcripts after the proof. To keep the plain
MSMs small, the v2 MSM pads its scalar axis to 16 here instead of 256
(`msm2.V2_MIN_N`); the group sums are the same.
"""

import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu import engine as shared_engine
from ark_bulletproofs_tpu_torch import (BulletproofGens, InnerProductProof,
                                        PedersenGens, Transcript, curves,
                                        engine, ipp)
from ark_bulletproofs_tpu_torch.ops import fs
from ark_bulletproofs_tpu_torch.ops import ipa
from ark_bulletproofs_tpu_torch.ops import msm2

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    monkeypatch.setattr(shared_engine.config, "backend", "host")
    monkeypatch.setattr(ipp, "DEVICE_MIN_N", 1)
    monkeypatch.setattr(msm2, "V2_MIN_N", 16)


def _scalars(p: int, n: int, seed: int) -> list[int]:
    raw = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(n, 16), dtype=np.uint16).tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") % p
            for i in range(n)]


def _spy(monkeypatch, owner, name: str, calls: dict) -> None:
    fn = getattr(owner, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(owner, name, counted)


def _ipa_inputs(curve, n: int, seed: int):
    p = curve.fr.p
    gens = BulletproofGens(curve, n, 1).share(0)
    B = PedersenGens.default(curve).B
    return (gens.G(n), gens.H(n), B,
            *(_scalars(p, n, seed + i) for i in range(4)))


@pytest.mark.parametrize("n", [16])
@pytest.mark.parametrize("name", ["secq256k1", "zorro", "curve25519"])
def test_ipa_prove_fs_matches_jax_host(monkeypatch, name, n):
    """The whole IPA with the Fiat-Shamir step in `fs_round` (plain
    version), in one segment. Equal bytes to the JAX host IPA, and the
    live transcript ends where the JAX one does."""
    monkeypatch.setattr(ipp, "IPA_FS", ("cpu",))
    monkeypatch.setattr(ipa, "FS_SEG", 2)
    monkeypatch.setattr(ipa, "FS_SEG_MIN", 16)
    calls = {}
    _spy(monkeypatch, fs, "fs_round", calls)
    _spy(monkeypatch, ipa, "_shrink_fs_dev", calls)
    _spy(monkeypatch, ipa.IpaDeviceProver, "fold", calls)
    curve = getattr(curves, name)
    jcurve = getattr(jax_pkg.curves, name)
    G, H, B, gf, hf, a, b = _ipa_inputs(curve, n, 10 * n)
    Q = curve.mul(B, 4321)
    t = Transcript(b"fs ipa")
    proof = InnerProductProof.create(t, curve, Q, gf, hf, G, H, a, b)
    jt = jax_pkg.Transcript(b"fs ipa")
    want = jax_pkg.InnerProductProof.create(jt, jcurve, Q, gf, hf, G, H, a,
                                            b)
    assert proof.to_bytes(curve) == want.to_bytes(jcurve)
    assert t.challenge_bytes(b"end", 32) == jt.challenge_bytes(b"end", 32)
    assert calls == {"fs_round": n.bit_length() - 1}
