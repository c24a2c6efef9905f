"""The port's multi-process MSM over gloo on the CPU, and its dry run.

Two processes of `python -m ark_bulletproofs_tpu_torch.parallel.dryrun`
form a real 2-rank torch.distributed group (gloo over TCP on this
machine): each draws only its own half of the generators
(GeneratorsChain.fast_forward), sums it, and the ranks exchange their
partials; both must print the same point, which must equal the JAX
package's host Pippenger over all the points. A rank whose peer never
comes must fail within its timeout, not hang. `dryrun_multichip` runs its
four checks on a 2-device CPU mesh. Every worker is started with a
`communicate(timeout=...)`. In one process `msm_multihost` runs each
kind of shard MSM (the v1 Pippenger, the bit-serial MSM).
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.hashes.chacha import ChaChaRng
from ark_bulletproofs_tpu_torch import curves, engine
from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
from ark_bulletproofs_tpu_torch.parallel import dryrun
from ark_bulletproofs_tpu_torch.parallel import msm as pmsm
from ark_bulletproofs_tpu_torch.parallel import multihost

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _workers(world: int, ranks, n: int, timeout: float):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ark_bulletproofs_tpu_torch.parallel.dryrun",
         "--rank", str(r), "--world", str(world), "--port", str(port),
         "--n", str(n), "--device", "cpu", "--timeout", str(timeout)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in ranks]
    outs = []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=240)
        finally:
            pr.kill()
        outs.append((pr.returncode, out, err))
    return outs


def test_two_ranks_agree_with_each_other_and_the_host():
    n = 256
    outs = _workers(2, (0, 1), n, 120)
    lines = []
    for r, (rc, out, err) in enumerate(outs):
        ok = [ln for ln in out.splitlines()
              if ln.startswith("MULTIHOST_OK")]
        assert rc == 0 and ok, (r, rc, out[-2000:], err[-2000:])
        assert ok[0].startswith(f"MULTIHOST_OK rank={r} world=2 point=")
        lines.append(ok[0].split("point=")[1])
    assert lines[0] == lines[1]
    jc = jax_pkg.curves.secq256k1
    rng = ChaChaRng(bytes([7]) * 32)
    ks = [jc.fr.rand(rng) for _ in range(n)]
    pts = GeneratorsChain(curves.secq256k1, dryrun.LABEL).take(n)
    assert lines[0] == hex(jc.msm(pts, ks)[0])


def test_a_rank_without_its_peer_fails_within_the_timeout():
    (rc, out, err), = _workers(2, (0,), 64, 5)
    assert rc != 0 and "MULTIHOST_OK" not in out
    assert "Timed out" in err or "timed out" in err, err[-2000:]


def test_dryrun_multichip_on_a_cpu_mesh(monkeypatch):
    """The four checks on 2 CPU devices, the batch_verify's mega-MSM on
    the device (threshold 0) and sharded (shards from 8 terms, k = 4)."""
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    monkeypatch.setattr(pmsm, "SHARD_MIN", 8)
    monkeypatch.setattr(dryrun, "BATCH_K", 4)
    calls = []
    fn = pmsm.msm_sharded_device
    monkeypatch.setattr(pmsm, "msm_sharded_device",
                        lambda *a, **k: (calls.append(1), fn(*a, **k))[1])
    dryrun.dryrun_multichip(2, "cpu")
    assert len(calls) >= 3  # the MSM, then the batch's accept and reject
    assert engine.active_mesh() is None


@pytest.mark.parametrize("kind", ["pippenger", "serial"])
def test_msm_multihost_in_one_process(kind):
    """msm_multihost in a process of its own (no process group: the
    global mesh is this rank's 2 CPU devices) with each kind of shard MSM
    equals the host Pippenger; the identity among the points."""
    curve = curves.secq256k1
    n = 16
    pts = GeneratorsChain(curve, b"multihost kinds").take(n)
    pts[5] = curve.zero()
    rng = ChaChaRng(bytes([9]) * 32)
    ks = [curve.fr.rand(rng) for _ in range(n)]
    mesh = multihost.global_mesh(["cpu"] * 2)
    assert mesh.size == 2 and mesh.process_count == 1
    got = multihost.msm_multihost(curve, pts, ks, n, mesh, kind=kind)
    assert got == jax_pkg.curves.secq256k1.msm(pts, ks)
