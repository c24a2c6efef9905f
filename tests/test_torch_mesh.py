"""The port's device mesh and sharded MSM on CPU meshes.

A mesh of D "cpu" devices stands in for D cards, as the JAX suite's
virtual CPU devices do (tests/conftest.py); every kernel wrapper runs its
plain version on the CPU tensors. The sharded MSM (parallel/msm.py) on
D = 2 and 4 devices (8 in tests/test_torch_mesh_wide.py), for one scalar
set and for B sets, with v1 and with v2 on the shards, on secq256k1,
zorro and curve25519, must equal the JAX package's host Pippenger
(`curve.msm`) on the same seeded points: equal affine points, tolerance
zero. The mesh's helpers must cut, move and join tensors exactly, and
`shard_numpy` must read the JAX package's table layout. `create_batch`
keeps its compact rows where the mesh cannot cut its table.
"""

import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.ops import curve as jcurve_ops
from ark_bulletproofs_tpu_torch import curves, engine
from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
from ark_bulletproofs_tpu_torch.ops import msm2
from ark_bulletproofs_tpu_torch.ops.curve import (affine_to_device,
                                                  point_batch_to_host,
                                                  spec_for)
from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device
from ark_bulletproofs_tpu_torch.parallel import mesh as pmesh
from ark_bulletproofs_tpu_torch.parallel import msm as pmsm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(engine, "_mesh", None)


def _scalars(p: int, n: int, seed: int) -> list[int]:
    raw = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(n, 16), dtype=np.uint16).tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") % p
            for i in range(n)]


def _case(name: str, n: int, sets: int, seed: int):
    """n chain points (one the identity) and `sets` scalar lists (one
    scalar zero, one p - 1), from a seed."""
    curve = getattr(curves, name)
    pts = GeneratorsChain(curve, b"mesh test").take(n)
    pts[3] = curve.zero()
    ks = [_scalars(curve.fr.p, n, seed + s) for s in range(sets)]
    ks[0][5], ks[-1][6] = 0, curve.fr.p - 1
    return curve, pts, ks


def test_make_mesh_and_the_helpers_cut_and_join_exactly():
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.devices == (torch.device("cpu"),) * 4
    assert pmesh.make_mesh(2, devices=["cpu"] * 8).size == 2
    with pytest.raises(ValueError):
        pmesh.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        pmesh.make_mesh(devices=["meta"])
    t = torch.arange(3 * 16 * 24).reshape(3, 16, 24)
    sh = pmesh.shard_rows(mesh, t)
    assert [p.shape for p in sh.parts] == [(3, 16, 6)] * 4
    assert sh.shape == (3, 16, 24) and sh.device == torch.device("cpu")
    assert torch.equal(pmesh.gather(sh, "cpu"), t)
    assert torch.equal(pmesh.take(sh, "cpu", 5, 9), t[..., 5:14])
    cut = pmesh.narrow(sh, 5, 9)
    assert [p.shape[-1] for p in cut.parts] == [1, 6, 2]
    padded = pmesh.pad(cut, 3, value=7)
    assert torch.equal(pmesh.gather(padded, "cpu"),
                       torch.nn.functional.pad(t[..., 5:14], (0, 3),
                                               value=7))
    assert torch.equal(pmesh.take(t, "cpu", 2, 4), t[..., 2:6])
    assert [r is t for r in pmesh.replicate(mesh, t)] == [True] * 4
    with pytest.raises(ValueError):
        pmesh.shard_rows(mesh, t[..., :23])


@pytest.mark.parametrize("name", ["secq256k1", "curve25519"])
def test_shard_numpy_reads_the_jax_table_layout(name):
    """The JAX package's affine_to_device tables, sharded over 4 devices,
    are the port's affine_to_device tables cut into the mesh's blocks."""
    curve = getattr(curves, name)
    pts = GeneratorsChain(curve, b"mesh numpy").take(16)
    pts[2] = curve.zero()
    jX, jY, jinf = jcurve_ops.affine_to_device(
        getattr(jax_pkg.curves, name), pts)
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    got = pmesh.shard_numpy(mesh, np.asarray(jX), np.asarray(jY),
                            np.asarray(jinf))
    want = affine_to_device(curve, pts, "cpu")
    for g, w in zip(got, want):
        assert len(g.parts) == 4
        assert torch.equal(pmesh.gather(g, "cpu"), w)


# (curve, D, sets, engine on the shards): every curve at D = 2 and 4; one
# set and B sets; v1 and v2 shards on each curve (a shard takes the
# one-device router's engine for its width).
CASES = [("secq256k1", 2, 1, "v2"), ("secq256k1", 4, 3, "v1"),
         ("zorro", 2, 2, "v1"), ("zorro", 4, 1, "v2"),
         ("curve25519", 2, 1, "v1"), ("curve25519", 4, 2, "v2")]


@pytest.mark.parametrize("name,D,sets,eng", CASES,
                         ids=[f"{c}-D{d}-B{b}-{e}" for c, d, b, e in CASES])
def test_sharded_msm_matches_jax_host_msm(name, D, sets, eng, monkeypatch):
    check_sharded_msm(name, D, sets, eng, monkeypatch)


def check_sharded_msm(name, D, sets, eng, monkeypatch):
    """The router's mesh branch (a Pieces of the mesh's blocks in, the
    partials reduced on mesh.devices[0]) equals the JAX package's host
    Pippenger for every set; the one-device router on each shard took
    the engine asked for (its v2 widths lowered to the shard's, or raised
    above it)."""
    n_loc = 16 if eng == "v2" else 8
    monkeypatch.setattr(pmsm, "SHARD_MIN", n_loc)
    monkeypatch.setattr(msm2, "V2_MIN_N", 16)
    for width in ("V2_SINGLE_MIN", "V2_BATCH_MIN"):
        monkeypatch.setattr(pmsm, width, n_loc if eng == "v2" else 1 << 20)
    curve, pts, ks = _case(name, D * n_loc, sets, 40 + D)
    spec = spec_for(curve)
    mesh = pmesh.make_mesh(devices=["cpu"] * D)
    engine.set_mesh(mesh)
    ran = []
    for what in ("msm_v1", "msm_v2"):
        fn = getattr(pmsm, what)
        monkeypatch.setattr(pmsm, what, lambda *a, fn=fn, what=what: (
            ran.append(what), fn(*a))[1])
    X, Y, inf = (pmesh.shard_rows(mesh, t)
                 for t in affine_to_device(curve, pts, "cpu"))
    scal = scalars_to_device(curve, ks, "cpu")
    out = pmsm.msm_device_maybe_sharded(
        spec, X, Y, inf, scal if sets > 1 else scal[0])
    jc = getattr(jax_pkg.curves, name)
    assert point_batch_to_host(curve, out) == [jc.msm(pts, k) for k in ks]
    assert ran == [f"msm_{eng}"] * D


def test_mesh_batch_ipa_keeps_compact_rows_on_an_uncut_table(monkeypatch):
    """create_batch under a 2-device mesh whose SHARD_MIN its 32-point
    table cannot meet runs the compact rows, and its proofs equal the JAX
    package's host `create` (tests/test_torch_mesh_paths.py runs the cut
    table)."""
    from test_torch_mesh_paths import check_mesh_batch_ipa

    check_mesh_batch_ipa(False, monkeypatch)
