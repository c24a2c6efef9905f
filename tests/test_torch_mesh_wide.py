"""The sharded MSM on an 8-device CPU mesh, the bit-serial and the forced
v2 MSM over a mesh, and where the shards' tensors go.

As tests/test_torch_mesh.py: D = 8 "cpu" devices stand in for cards (the
JAX suite's eight virtual CPU devices), the kernel wrappers run their
plain versions, and every sum must equal the JAX package's host
Pippenger (equal affine points, tolerance zero). One card cannot show a
wrong device index, so a mesh of "cpu:0" ... "cpu:3" (torch keeps the
index on the device, not on a CPU tensor) shows where the sharded MSM
sends each block: block d to mesh.devices[d], and nothing of a shard to
mesh.devices[0] before the partials' reduce.
"""

import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu_torch import curves, engine
from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
from ark_bulletproofs_tpu_torch.ops import msm2, proj
from ark_bulletproofs_tpu_torch.ops.curve import (affine_to_device,
                                                  point_batch_to_host,
                                                  point_to_host, spec_for)
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs
from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device
from ark_bulletproofs_tpu_torch.parallel import mesh as pmesh
from ark_bulletproofs_tpu_torch.parallel import msm as pmsm
from test_torch_mesh import _scalars, check_sharded_msm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(engine, "_mesh", None)


CASES = [("secq256k1", 8, 1, "v2"), ("zorro", 8, 1, "v1"),
         ("curve25519", 8, 1, "v1")]


@pytest.mark.parametrize("name,D,sets,eng", CASES,
                         ids=[f"{c}-D{d}-B{b}-{e}" for c, d, b, e in CASES])
def test_sharded_msm_on_8_devices_matches_jax_host_msm(name, D, sets, eng,
                                                       monkeypatch):
    check_sharded_msm(name, D, sets, eng, monkeypatch)


@pytest.mark.parametrize("name", ["secq256k1", "curve25519"])
def test_msm_sharded_serial_matches_jax_host_msm(name):
    """msm_sharded_serial (the bit-serial MSM on each of 2 devices; 13
    points padded to 16) equals the host Pippenger; so does msm_sharded."""
    curve = getattr(curves, name)
    pts = GeneratorsChain(curve, b"mesh serial").take(13)
    ks = _scalars(curve.fr.p, 13, 70)
    ks[4] = 0
    want = getattr(jax_pkg.curves, name).msm(pts, ks)
    mesh = pmesh.make_mesh(devices=["cpu"] * 2)
    assert pmsm.msm_sharded_serial(curve, pts, ks, mesh) == want
    assert pmsm.msm_sharded(curve, pts, ks, mesh) == want
    assert pmsm.msm_sharded(curve, [], [], mesh) == curve.zero()


@pytest.mark.parametrize("name,sets", [("secq256k1", 2), ("curve25519", 1)])
def test_sharded_msm2_device_fn_matches_jax_host_msm(name, sets,
                                                     monkeypatch):
    """sharded_msm2_device_fn (the v2 MSM forced on each of 2 devices,
    shards of 16 terms with msm2.V2_MIN_N lowered to them) equals the
    host Pippenger for every set, the scalars one set or B sets."""
    monkeypatch.setattr(msm2, "V2_MIN_N", 16)
    curve = getattr(curves, name)
    pts = GeneratorsChain(curve, b"mesh v2 fn").take(32)
    pts[9] = curve.zero()
    ks = [_scalars(curve.fr.p, 32, 72 + s) for s in range(sets)]
    ks[0][17] = 0
    mesh = pmesh.make_mesh(devices=["cpu"] * 2)
    X, Y, inf = (pmesh.shard_rows(mesh, t)
                 for t in affine_to_device(curve, pts, "cpu"))
    scal = scalars_to_device(curve, ks, "cpu")
    ran = []
    impl = msm2.msm2_impl
    monkeypatch.setattr(msm2, "msm2_impl", lambda *a: (
        ran.append(a[1]), impl(*a))[1])
    out = pmsm.sharded_msm2_device_fn(spec_for(curve), mesh)(
        X, Y, inf, scal if sets > 1 else scal[0])
    jc = getattr(jax_pkg.curves, name)
    assert point_batch_to_host(curve, out) == [jc.msm(pts, k) for k in ks]
    assert len(ran) == 2


def test_shards_stay_on_their_devices_until_the_reduce(monkeypatch):
    """On a mesh of cpu:0..3 every block the sharded MSM takes goes to its
    own device, each shard's engine gets only that block, and the
    partials meet on mesh.devices[0] only in `_reduce_partials`, after
    every shard ran."""
    curve = curves.secq256k1
    spec = spec_for(curve)
    D, b = 4, 8
    mesh = pmesh.make_mesh(devices=[f"cpu:{d}" for d in range(D)])
    assert [d.index for d in mesh.devices] == [0, 1, 2, 3]
    events, tags = [], {}
    take = pmesh.take

    def recording_take(x, dev, lo, size):
        out = take(x, dev, lo, size)
        events.append(("take", lo // b, dev.index))
        tags[id(out)] = dev.index
        return out

    def local(spec_, X, Y, inf, scal):
        events.append(("shard", {tags[id(t)] for t in (X, Y, inf)}))
        return proj.point_zero(spec_, 1, X.device).to(torch.int32)

    reduce = pmsm._reduce_partials

    def recording_reduce(spec_, mesh_, parts):
        events.append(("reduce", len(parts)))
        return reduce(spec_, mesh_, parts)

    monkeypatch.setattr(pmesh, "take", recording_take)
    monkeypatch.setattr(pmsm, "_reduce_partials", recording_reduce)
    pts = GeneratorsChain(curve, b"mesh placement").take(D * b)
    X, Y, inf = affine_to_device(curve, pts, "cpu")
    scal = ints_to_limbs(_scalars(curve.fr.p, D * b, 71))
    out = pmsm.msm_sharded_device(spec, mesh, X, Y, inf, scal, local)
    assert point_to_host(curve, out) is None  # D identity partials
    takes = [e for e in events if e[0] == "take"]
    assert len(takes) == 4 * D
    assert all(blk == dev for _, blk, dev in takes)
    assert [e for e in events if e[0] != "take"] == (
        [("shard", {d}) for d in range(D)] + [("reduce", D)])
    assert events[-1] == ("reduce", D)
