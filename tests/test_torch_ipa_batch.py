"""The port's batch IPA and batch prover vs the JAX package's host prover.

`create_batch` on both of its routes (the on-device Fiat-Shamir
`ipa_prove_fs_batch`, forced on the CPU through `ipp.IPA_FS`, and the
per-round `IpaBatchProver`) and `prove_batch` run with every kernel
wrapper on its plain version; the
JAX package runs its host route (engine backend "host"; its own
`ipa_prove_fs` is never called here: its XLA compile takes minutes).
Inputs are made with numpy from a seed; Fiat-Shamir fixes every
challenge, so the tolerance is exact: equal proof bytes. To keep the
plain MSMs small, the v2 MSM pads its scalar axis to 16 here instead of
256 (`msm2.V2_MIN_N`); the group sums are the same.
"""

import random

import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu import engine as shared_engine
from ark_bulletproofs_tpu.gadgets import shuffle_gadget as jax_shuffle
from ark_bulletproofs_tpu.rand import seeded_rng as shared_rng
from ark_bulletproofs_tpu_torch import (BulletproofGens, InnerProductProof,
                                        PedersenGens, Prover, Transcript,
                                        curves, engine, ipp, prove_batch,
                                        seeded_rng)
from ark_bulletproofs_tpu_torch.gadgets import shuffle_gadget
from ark_bulletproofs_tpu_torch.ops import ipa
from ark_bulletproofs_tpu_torch.ops import kernels as kk
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


@pytest.mark.parametrize("fs_route", [True, False], ids=["fs", "per_round"])
def test_create_batch_matches_jax_serial(monkeypatch, fs_route):
    """n = 64, P = 3 proofs in lockstep with Q_b = w_b B: each equal to
    the JAX package's serial `create` on its own transcript."""
    monkeypatch.setattr(ipp, "IPA_FS", ("cpu",) if fs_route else ())
    calls = {}
    _spy(monkeypatch, ipa, "ipa_prove_fs_batch", calls)
    _spy(monkeypatch, ipa.IpaBatchProver, "fold", calls)
    n, P = 64, 3
    curve, jcurve = curves.secq256k1, jax_pkg.curves.secq256k1
    p = curve.fr.p
    G, H, B, *_ = _ipa_inputs(curve, n, 0)
    ws = _scalars(p, P, 7)
    gfs, hfs, As, Bs = ([_scalars(p, n, 100 * i + b) for b in range(P)]
                        for i in range(4))
    ts = [Transcript(b"batch %d" % b) for b in range(P)]
    proofs = InnerProductProof.create_batch(ts, curve, B, ws, gfs, hfs, G,
                                            H, As, Bs)
    assert calls == ({"ipa_prove_fs_batch": 1} if fs_route
                     else {"fold": n.bit_length() - 1})
    for b in range(P):
        jt = jax_pkg.Transcript(b"batch %d" % b)
        want = jax_pkg.InnerProductProof.create(
            jt, jcurve, jcurve.mul(B, ws[b]), gfs[b], hfs[b], G, H, As[b],
            Bs[b])
        assert proofs[b].to_bytes(curve) == want.to_bytes(jcurve)
        assert ts[b].challenge_bytes(b"end", 8) == jt.challenge_bytes(b"end",
                                                                      8)


def test_fs_batch_needs_lockstep():
    """Transcripts at different positions are not proved in lockstep."""
    curve = curves.secq256k1
    G, H, B, gf, hf, a, b = _ipa_inputs(curve, 4, 3)
    ts = [Transcript(b"a"), Transcript(b"bb")]
    ts[1].append_message(b"x", b"y")
    assert ipa.ipa_prove_fs_batch(ts, curve, B, [1, 2], [gf] * 2, [hf] * 2,
                                  G, H, [a] * 2, [b] * 2, "cpu") is None


def _shuffle_provers(pkg, curve, k: int, seeds, gadget):
    pc = pkg.PedersenGens.default(curve)
    out = []
    for seed in seeds:
        pyrng = random.Random(seed)
        vals = [pyrng.getrandbits(64) for _ in range(k)]
        perm = vals[:]
        pyrng.shuffle(perm)
        rng = (seeded_rng if pkg is not jax_pkg else shared_rng)(seed)
        t = pkg.Transcript(b"prove batch")
        t.append_message(b"dom-sep", b"ShuffleProof")
        t.append_u64(b"k", k)
        prover = pkg.r1cs.Prover(pc, t)
        ins = [prover.commit(v, curve.fr.rand(rng))[1] for v in vals]
        outs = [prover.commit(v, curve.fr.rand(rng))[1] for v in perm]
        gadget(prover, curve, ins, outs)
        out.append((prover, rng))
    return out


def test_prove_batch_matches_jax_prove(monkeypatch):
    """P = 2 k = 4 shuffles (6 multipliers, padded n = 8) through
    prove_batch, the phase MSMs on the device (threshold 0) and the IPA on
    create_batch's FS route: each proof equal to the JAX package's
    `Prover.prove` on the same witness and seeded RNG."""
    monkeypatch.setattr(ipp, "IPA_FS", ("cpu",))
    calls = {}
    _spy(monkeypatch, ipa, "ipa_prove_fs_batch", calls)
    curve, jcurve = curves.secq256k1, jax_pkg.curves.secq256k1
    seeds, k = (41, 42), 4
    pairs = _shuffle_provers(
        __import__("ark_bulletproofs_tpu_torch"), curve, k, seeds,
        shuffle_gadget)
    bp = BulletproofGens(curve, 8, 1)
    got = prove_batch([pr for pr, _ in pairs], [r for _, r in pairs], bp)
    assert calls == {"ipa_prove_fs_batch": 1}
    jbp = jax_pkg.BulletproofGens(jcurve, 8, 1)
    for (jprover, jrng), proof in zip(
            _shuffle_provers(jax_pkg, jcurve, k, seeds, jax_shuffle), got):
        want = jprover.prove(jrng, jbp)
        assert proof.to_bytes(curve) == want.to_bytes(jcurve)
    assert kk.jac_double_k_add.launches == 0  # CPU: plain versions only
    assert isinstance(Prover, type)
