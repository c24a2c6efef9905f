"""The mesh branches of the ragged MSM and of the IPA rounds, on CPU
meshes, against the JAX package.

- `msm_device_ragged` under a 2-device mesh (each chunk sharded by
  itself, scalars also as uneven Pieces) equals it without a mesh and the
  JAX host Pippenger: equal affine points.
- The port's sharded round scalars and fold (`ops/ipa.py::
  _round_scalars_sharded`, `_fold_sharded`) on 8 "cpu" devices equal the
  JAX package's `_round_scalars_sharded` / `_fold_sharded` on the
  8-device CPU mesh of tests/conftest.py at n = 64, round by round:
  bit-equal limbs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.ops import field as jf
from ark_bulletproofs_tpu.ops import ipa as jipa
from ark_bulletproofs_tpu.parallel.mesh import data_sharding
from ark_bulletproofs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ark_bulletproofs_tpu_torch import curves, engine
from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops import ipa
from ark_bulletproofs_tpu_torch.ops.curve import (affine_to_device,
                                                  point_to_host, spec_for)
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs
from ark_bulletproofs_tpu_torch.parallel import mesh as pmesh
from ark_bulletproofs_tpu_torch.parallel import msm as pmsm
from test_torch_mesh import _scalars

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(engine, "_mesh", None)


def _j(t: torch.Tensor):
    """Port (..., 16, L) limbs -> the JAX package's (..., L, 16) uint32."""
    return jnp.asarray(np.ascontiguousarray(
        np.swapaxes(t.numpy(), -1, -2).astype(np.uint32)))


def _t(a) -> torch.Tensor:
    """JAX (..., L, 16) limbs -> port (..., 16, L) int64."""
    return torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(np.asarray(a), -1, -2).astype(np.int64)))


def test_ragged_msm_under_a_mesh_equals_it_without(monkeypatch):
    """37 terms with the chunk floor at 16: a chunk of 32 and the 5-term
    remainder padded to 16, each sharded over 2 devices; the scalars also
    as Pieces cut at 10 (across the first shard)."""
    monkeypatch.setattr(pmsm, "_RAGGED_MIN", 16)
    monkeypatch.setattr(pmsm, "SHARD_MIN", 8)
    curve = curves.secq256k1
    spec = spec_for(curve)
    pts = GeneratorsChain(curve, b"mesh ragged").take(37)
    ks = _scalars(curve.fr.p, 37, 72)
    X, Y, inf = affine_to_device(curve, pts, "cpu")
    scal = ints_to_limbs(ks)
    alone = point_to_host(curve, pmsm.msm_device_ragged(spec, X, Y, inf,
                                                        scal))
    assert alone == jax_pkg.curves.secq256k1.msm(pts, ks)
    mesh = pmesh.make_mesh(devices=["cpu:0", "cpu:1"])
    engine.set_mesh(mesh)
    sharded = []
    fn = pmsm.msm_sharded_device
    monkeypatch.setattr(pmsm, "msm_sharded_device", lambda *a, **k: (
        sharded.append(pmesh.width(a[2])), fn(*a, **k))[1])
    pieces = pmesh.Pieces([scal[:, :10], scal[:, 10:]])
    got = pmsm.msm_device_ragged(spec, X, Y, inf, pieces)
    assert point_to_host(curve, got) == alone
    assert sharded == [32, 16]


def test_sharded_rounds_match_jax_sharded_rounds():
    """n = 64 over 8 devices: the rows [gw | hw] and c q of the rounds at
    cur = 64 and 4, and a, b, gm, hm after every fold, against the
    JAX functions run on their 8-device mesh."""
    curve, jcurve = curves.secq256k1, jax_pkg.curves.secq256k1
    fs, js = df.spec_for(curve.fr), jf.spec_for(jcurve.fr)
    p, R = curve.fr.p, curve.fr.R
    n, D = 64, 8
    mesh = pmesh.make_mesh(devices=["cpu"] * D)
    jmesh = jax_make_mesh(D)
    assert jmesh.devices.size == D
    sh = data_sharding(jmesh)
    vecs = [ints_to_limbs([x * R % p for x in _scalars(p, n, 80 + i)])
            for i in range(4)]
    state = [pmesh.shard_rows(mesh, v) for v in vecs]
    jstate = [jax.device_put(_j(v), sh) for v in vecs]
    one = df.mont_one(fs, 1, "cpu")
    M = 4 * n  # the JAX table [G | H | Q | pad]: 2n + 1 padded
    b = n // D
    cur = n
    while cur > 1:
        if cur in (64, 4):
            rows, cq = ipa._round_scalars_sharded(fs, mesh, *state, one, cur)
            jrows = _t(jipa._round_scalars_sharded(
                js, *jstate, jf.mont_one(js, ()), cur, M))  # (2, 16, M)
            full = pmesh.gather(rows, "cpu").reshape(2, 16, D, 2, b)
            full = full.permute(0, 1, 3, 2, 4).reshape(2, 16, 2 * n)
            assert torch.equal(full.long(), jrows[..., :2 * n]), cur
            assert torch.equal(cq[..., 0].long(), jrows[..., 2 * n]), cur
            assert not jrows[..., 2 * n + 1:].any()
        u = (cur * 7919 + 5) % p
        ul, uil = (ints_to_limbs([v * R % p]) for v in (u, pow(u, -1, p)))
        state = list(ipa._fold_sharded(fs, mesh, *state, ul, uil, cur))
        jstate = list(jipa._fold_sharded(js, *jstate, _j(ul)[0],
                                         _j(uil)[0], cur))
        for v, jv in zip(state, jstate):
            assert len(v.parts) == D
            assert torch.equal(pmesh.gather(v, "cpu").long(), _t(jv)), cur
        cur //= 2


def test_mesh_batch_ipa_and_ipa_verify_match_jax_host(monkeypatch):
    check_mesh_batch_ipa(True, monkeypatch)


def check_mesh_batch_ipa(cut, monkeypatch):
    """create_batch of P = 2 proofs at n = 16 under a 2-device mesh (no
    on-device Fiat-Shamir route) equals the JAX package's host `create` of
    each: with full-width rows over the [G | H] table cut into the mesh's
    blocks where its 32 points make shards of SHARD_MIN, with the compact
    rows where they do not; `verify` under the mesh takes the host-scalar
    route (no device IPA verify), and accepts."""
    from ark_bulletproofs_tpu import engine as shared_engine
    from ark_bulletproofs_tpu_torch import (BulletproofGens,
                                            InnerProductProof, PedersenGens,
                                            Transcript, ipp)
    from ark_bulletproofs_tpu_torch.ops import verify as dverify

    monkeypatch.setattr(shared_engine.config, "backend", "host")
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    monkeypatch.setattr(ipp, "DEVICE_MIN_N", 1)
    monkeypatch.setattr(ipp, "IPA_FS", ("cpu",))  # the mesh must refuse it
    monkeypatch.setattr(ipp, "VERIFY_DEVICE_MIN_N", 1)
    monkeypatch.setattr(pmsm, "SHARD_MIN", 8 if cut else 32)
    curve, jcurve = curves.secq256k1, jax_pkg.curves.secq256k1
    p, n, P = curve.fr.p, 16, 2
    gens = BulletproofGens(curve, n, 1).share(0)
    G, H = gens.G(n), gens.H(n)
    B = PedersenGens.default(curve).B
    ws = _scalars(p, P, 100)
    gfs, hfs, As, Bs = ([_scalars(p, n, 110 + 10 * j + b) for b in range(P)]
                        for j in range(4))
    engine.set_mesh(pmesh.make_mesh(devices=["cpu"] * 2))
    calls = []
    for name in ("_round_scalars_full", "_round_scalars_compact_batch"):
        fn = getattr(ipa, name)
        monkeypatch.setattr(ipa, name, lambda *a, fn=fn, name=name: (
            calls.append(name), fn(*a))[1])
    monkeypatch.setattr(ipa, "ipa_prove_fs_batch", None)
    proofs = InnerProductProof.create_batch(
        [Transcript(b"mesh batch ipa") for _ in range(P)], curve, B, ws, gfs,
        hfs, G, H, As, Bs)
    rows = "_round_scalars_full" if cut else "_round_scalars_compact_batch"
    assert calls == [rows] * 4  # lg n rounds
    for b in range(P):
        want = jax_pkg.InnerProductProof.create(
            jax_pkg.Transcript(b"mesh batch ipa"), jcurve,
            jcurve.mul(B, ws[b]), gfs[b], hfs[b], G, H, As[b], Bs[b])
        assert proofs[b].to_bytes(curve) == want.to_bytes(jcurve)
    Q = curve.mul(B, ws[0])
    Pt = jcurve.msm(G + H + [Q], [x * f % p for x, f in zip(As[0], gfs[0])]
                    + [y * f % p for y, f in zip(Bs[0], hfs[0])]
                    + [sum(x * y for x, y in zip(As[0], Bs[0])) % p])
    monkeypatch.setattr(dverify, "ipa_gh_msm", None)  # no device verify
    proofs[0].verify(n, Transcript(b"mesh batch ipa"), curve, gfs[0],
                     hfs[0], Pt, Q, G, H)
