"""The prover and the verifiers under a CPU mesh, against the JAX
package.

- A k = 8 shuffle proved through every device branch under a 2-device
  port mesh (the sharded vector phase, the sharded IPA rounds, the phase
  MSMs through the router's mesh branch; no tabled MSM, no on-device
  Fiat-Shamir route) is byte-equal to the JAX package's reference
  Prover's proof under the same seeded_rng. The port then verifies it
  under the mesh with the g/h scalars sharded (their gate lowered), and
  rejects a tampered copy.
- A mesh batch_verify accepts 2 proofs and rejects the batch with one
  tampered.
- `verify.gh_scalars` under an 8-device mesh (padded_n = 4096, sharded
  into Pieces) equals the JAX package's `gh_scalars`: bit-equal g and h,
  equal delta.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu import engine as shared_engine
from ark_bulletproofs_tpu.gadgets import ShuffleProof as SharedShuffleProof
from ark_bulletproofs_tpu.ops import verify as jverify
from ark_bulletproofs_tpu.rand import seeded_rng as shared_rng
from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                        R1CSError, ShuffleProof, Transcript,
                                        batch_verify, curves, engine, ipp,
                                        seeded_rng)
from ark_bulletproofs_tpu_torch.ops import ipa, verify
from ark_bulletproofs_tpu_torch.parallel import mesh as pmesh
from ark_bulletproofs_tpu_torch.parallel import msm as pmsm
from ark_bulletproofs_tpu_torch.r1cs import prover, verifier
from test_torch_mesh import _scalars

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(engine, "_mesh", None)
    monkeypatch.setattr(shared_engine.config, "backend", "host")


def _on_mesh(monkeypatch, D: int):
    """Every device branch on, the mesh branch from 8-term shards, and a
    mesh of D CPU devices."""
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    monkeypatch.setattr(prover, "VECTOR_MIN_N", 1)
    monkeypatch.setattr(ipp, "DEVICE_MIN_N", 1)
    monkeypatch.setattr(pmsm, "SHARD_MIN", 8)
    engine.set_mesh(pmesh.make_mesh(devices=["cpu"] * D))


def _spy(monkeypatch, owner, name: str, calls: dict) -> None:
    fn = getattr(owner, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(owner, name, counted)


def test_mesh_prove_matches_jax_reference_prover(monkeypatch):
    """k = 8 (padded_n = 16, four IPA rounds over 2 devices); then the
    mesh verify with sharded g/h accepts, and rejects swapped
    commitments."""
    _on_mesh(monkeypatch, 2)
    calls = {}
    for owner, name in ((ipa, "_round_scalars_sharded"),
                        (ipa, "_fold_sharded"), (pmsm, "msm_sharded_device"),
                        (prover.Prover, "_tabled_msm"),
                        (ipa, "ipa_prove_fs"), (verify, "gh_scalars")):
        _spy(monkeypatch, owner, name, calls)
    monkeypatch.setattr(ipp, "IPA_FS", ("cpu",))  # the mesh must refuse it
    curve, jcurve = curves.secq256k1, jax_pkg.curves.secq256k1
    vals = [5, 9, 2, 7, 1, 8, 3, 6]
    perm = [9, 1, 8, 2, 7, 3, 6, 5]
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 16, 1)
    sp, ic, oc = ShuffleProof.prove(seeded_rng(8), pc, bp,
                                    Transcript(b"mesh prove"), vals, perm)
    jsp, jic, joc = SharedShuffleProof.prove(
        shared_rng(8), jax_pkg.PedersenGens.default(jcurve),
        jax_pkg.BulletproofGens(jcurve, 16, 1),
        jax_pkg.Transcript(b"mesh prove"), vals, perm)
    assert sp.proof.to_bytes(curve) == jsp.proof.to_bytes(jcurve)
    assert (ic, oc) == (jic, joc)
    assert calls["_round_scalars_sharded"] == calls["_fold_sharded"] == 4
    assert calls["msm_sharded_device"] >= 5  # the phase MSM, the rounds
    assert "_tabled_msm" not in calls and "ipa_prove_fs" not in calls
    monkeypatch.setattr(verifier, "DEVICE_SCALARS_MIN_N", 1)
    monkeypatch.setattr(verify, "GH_SHARD_MIN_N", 8)
    pieces = []
    mega = verifier._device_mega_msm
    monkeypatch.setattr(verifier, "_device_mega_msm", lambda *a: (
        pieces.append(isinstance(a[-1], pmesh.Pieces)), mega(*a))[1])
    ShuffleProof(sp.proof).verify(pc, bp, Transcript(b"mesh prove"), ic, oc)
    assert pieces == [True]  # g and h reached the mega-MSM as shards
    with pytest.raises(R1CSError):
        ShuffleProof(sp.proof).verify(pc, bp, Transcript(b"mesh prove"), oc,
                                      ic)


def test_mesh_batch_verify_accepts_and_rejects(monkeypatch):
    """2 host-proved k = 4 shuffles, batch-verified under a 2-device mesh
    with the g/h scalars on the device: accepted; with one proof's t_x
    changed: rejected."""
    curve = curves.secq256k1
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 8, 1)
    items = []
    for i in range(2):
        vals = [3 + i, 1, 4, 1 + 2 * i]
        sp, ic, oc = ShuffleProof.prove(seeded_rng(20 + i), pc, bp,
                                        Transcript(b"mesh batch"), vals,
                                        vals[::-1])
        items.append((sp.proof, ic, oc))
    _on_mesh(monkeypatch, 2)
    monkeypatch.setattr(verifier, "DEVICE_SCALARS_MIN_N", 1)
    calls = {}
    _spy(monkeypatch, pmsm, "msm_sharded_device", calls)

    def instances(its):
        return [(ShuffleProof(p).build_verifier(pc, Transcript(b"mesh batch"),
                                                ic, oc), p)
                for p, ic, oc in its]

    batch_verify(seeded_rng(5), instances(items), pc, bp)
    assert calls["msm_sharded_device"] >= 1
    bad = dataclasses.replace(items[1][0],
                              t_x=(items[1][0].t_x + 1) % curve.fr.p)
    with pytest.raises(R1CSError):
        batch_verify(seeded_rng(5), instances([items[0],
                                               (bad, *items[1][1:])]), pc, bp)


def _t(a) -> torch.Tensor:
    """JAX (..., L, 16) limbs -> port (..., 16, L) int64."""
    return torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(np.asarray(a), -1, -2).astype(np.int64)))


def test_sharded_gh_scalars_match_jax_gh_scalars(monkeypatch):
    """padded_n = 4096, n = 4000 constraints' w vectors, n1 = 1000 (the
    u factor turns on inside block 1 of 8): the port's g, h as Pieces of 8
    blocks and its device delta (the blocks' partials added in order)
    equal the JAX package's."""
    curve = curves.secq256k1
    p = curve.fr.p
    padded_n, n, D = 4096, 4000, 8
    wL, wR, wO = (_scalars(p, n, 90 + i) for i in range(3))
    sc = _scalars(p, 7, 95)
    u_sq = _scalars(p, 12, 96)
    args = (padded_n, wL, wR, wO, *sc[:5], u_sq, sc[5], 1000)
    engine.set_mesh(pmesh.make_mesh(devices=["cpu"] * D))
    g, h, delta = verify.gh_scalars(curve, *args)
    assert isinstance(g, pmesh.Pieces) and len(g.parts) == D
    jg, jh, jdelta = jverify.gh_scalars(jax_pkg.curves.secq256k1, *args)
    assert torch.equal(pmesh.gather(g, "cpu").long(), _t(jg))
    assert torch.equal(pmesh.gather(h, "cpu").long(), _t(jh))
    assert delta == jdelta == verify.compute_delta_host(p, wL, wR, sc[0])
