"""Dry runs of the port's multi-device layer.

`dryrun_multichip(n_devices, device)` checks the mesh paths on a mesh of
n_devices copies of `device` (one card can hold several shards), as the
JAX package's dry run checks its own:

  1. the sharded MSM (v1 on every shard) equals the host Pippenger;
  2. the sharded IPA round scalars and fold equal the one-device ones;
  3. the sharded g/h verification scalars equal the one-device ones;
  4. a batch_verify of 2 shuffle proofs under the mesh accepts them and
     rejects the batch with one proof tampered.

Run as a module it is one rank of a multi-process MSM over gloo:

    python -m ark_bulletproofs_tpu_torch.parallel.dryrun --rank R \\
        --world W --port P [--n N] [--device cuda] [--timeout S]

Every rank draws only its own block of the n generators
(GeneratorsChain.fast_forward), all ranks the same n scalars from one
seed; `multihost.msm_multihost` sums them, and the rank checks the sum
against the host Pippenger over all n points and prints
"MULTIHOST_OK rank=R world=W point=<x>" (x the sum's x coordinate in
hex), so that a caller can hold the ranks against each other. It exits
nonzero on any failure, and when a peer does not come within the
timeout.
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import sys

import torch

from .. import curves, engine
from . import msm as pmsm
from .mesh import make_mesh

LABEL = b"multihost-msm"
# The shuffle size of check 4: its batch's mega-MSM is wide enough for
# shards of pmsm.SHARD_MIN on 4 devices.
BATCH_K = 128


def _check_msm(curve, mesh, n: int) -> None:
    from ..generators import GeneratorsChain

    pts = GeneratorsChain(curve, b"dryrun msm").take(n)
    rng = random.Random(7)
    ks = [rng.randrange(curve.fr.p) for _ in range(n)]
    if pmsm.msm_sharded(curve, pts, ks, mesh) != curve.msm(pts, ks):
        raise AssertionError("sharded MSM != host Pippenger")


def _check_rounds(curve, mesh, n: int) -> None:
    from ..ops import field as df
    from ..ops import ipa
    from ..ops.limbs import limbs_to_ints
    from .mesh import gather, shard_rows

    fr = df.spec_for(curve.fr)
    dev = mesh.devices[0]
    p = curve.fr.p
    vecs = [ipa._mont(curve, [(s * 31 + i * 7 + 1) % p for i in range(n)],
                      dev) for s in range(1, 5)]
    one = df.mont_one(fr, 1, dev)
    sh = [shard_rows(mesh, v) for v in vecs]
    u, ui = (ipa._mont(curve, [x], dev) for x in (5, pow(5, -1, p)))
    cur = n
    while cur > 1:
        m = cur // 2
        rows, bm, cq = ipa._round_scalars_compact(fr, *vecs, one, m, cur)
        srows, scq = ipa._round_scalars_sharded(fr, mesh, *sh, one, cur)
        if limbs_to_ints(scq.reshape(2, 16).T) != limbs_to_ints(
                cq.reshape(2, 16).T):
            raise AssertionError(f"sharded c_L, c_R differ at cur={cur}")
        # the compact row's scalar on G_i or H_i, as the full rows hold it
        b = n // mesh.size
        full = gather(srows, dev).reshape(2, 16, mesh.size, 2, b)
        full = full.permute(0, 1, 3, 2, 4).reshape(2, 16, 2 * n)
        picked = torch.gather(full, 2, bm.unsqueeze(1).expand(2, 16, n))
        if not torch.equal(picked.long(), rows.long()):
            raise AssertionError(f"sharded round rows differ at cur={cur}")
        vecs = list(ipa._fold(fr, *vecs, u, ui, m, cur))
        sh = list(ipa._fold_sharded(fr, mesh, *sh, u, ui, cur))
        for v, s in zip(vecs, sh):
            if not torch.equal(gather(s, dev).long(), v.long()):
                raise AssertionError(f"sharded fold differs at cur={cur}")
        cur = m


def _check_gh(curve, mesh, padded_n: int) -> None:
    from ..ops import verify as dverify
    from .mesh import Pieces, gather

    p = curve.fr.p
    wv = [(i * 13 + 5) % p for i in range(padded_n)]
    lg = padded_n.bit_length() - 1
    args = (curve, padded_n, wv, wv[::-1], wv, 3, 5, 7, 11, 13,
            [17 + i for i in range(lg)], 19, 10)
    saved = engine.active_mesh()
    engine.set_mesh(None)
    try:
        g0, h0, d0 = dverify.gh_scalars(*args, device=mesh.devices[0])
    finally:
        engine.set_mesh(saved)
    g, h, d = dverify.gh_scalars(*args, device=mesh.devices[0])
    if not isinstance(g, Pieces) or len(g.parts) != mesh.size:
        raise AssertionError("g/h scalars were not sharded over the mesh")
    for got, want in ((g, g0), (h, h0)):
        if not torch.equal(gather(got, mesh.devices[0]).long(), want.long()):
            raise AssertionError("sharded g/h scalars differ")
    if d != d0:
        raise AssertionError("sharded delta differs")


def _check_batch_verify(curve, k: int) -> None:
    from ..errors import R1CSError
    from ..gadgets import ShuffleProof
    from ..generators import BulletproofGens, PedersenGens
    from ..r1cs import batch_verify
    from ..rand import seeded_rng
    from ..transcript.merlin import Transcript

    pc = PedersenGens.default(curve)
    bp = BulletproofGens(curve, 2 * k, 1)
    instances = []
    mesh, threshold = engine.active_mesh(), engine.config.msm_device_threshold
    engine.set_mesh(None)
    engine.config.msm_device_threshold = 1 << 62  # proved on the host
    try:
        for i in range(2):
            pyrng = random.Random(80 + i)
            vals = [pyrng.getrandbits(64) for _ in range(k)]
            sp, ic, oc = ShuffleProof.prove(
                seeded_rng(80 + i), pc, bp, Transcript(b"dryrun batch"), vals,
                list(reversed(vals)))
            instances.append((sp.build_verifier(
                pc, Transcript(b"dryrun batch"), ic, oc), sp.proof))
    finally:
        engine.set_mesh(mesh)
        engine.config.msm_device_threshold = threshold
    batch_verify(seeded_rng(99), instances, pc, bp)
    bad = dataclasses.replace(instances[1][1],
                              t_x=(instances[1][1].t_x + 1) % curve.fr.p)
    try:
        batch_verify(seeded_rng(99), [instances[0], (instances[1][0], bad)],
                     pc, bp)
    except R1CSError:
        return
    raise AssertionError("tampered proof passed batch_verify")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The four checks above on a mesh of n_devices copies of `device`.
    Raises on a failure; the engine's mesh and device are restored
    after."""
    curve = curves.secq256k1
    mesh = make_mesh(devices=[device] * n_devices)
    saved = engine.active_mesh(), engine.config.device
    engine.config.device = str(mesh.devices[0])
    try:
        _check_msm(curve, mesh, 8 * n_devices)
        _check_rounds(curve, mesh, 8 * n_devices)
        engine.set_mesh(mesh)
        _check_gh(curve, mesh, max(4096, 8 * n_devices))
        _check_batch_verify(curve, BATCH_K)
    finally:
        engine.set_mesh(saved[0])
        engine.config.device = saved[1]


def worker(rank: int, world: int, port: int, n: int, device: str,
           timeout: float):
    """One rank of the multi-process MSM (module docstring); returns the
    affine sum."""
    from ..generators import GeneratorsChain
    from ..hashes.chacha import ChaChaRng
    from . import multihost

    engine.config.device = device
    multihost.initialize(f"127.0.0.1:{port}", world, rank, timeout_s=timeout)
    try:
        curve = curves.secq256k1
        mesh = multihost.global_mesh([device])
        start, stop = multihost._host_range(n)
        local = GeneratorsChain(curve, LABEL).fast_forward(start).take(
            stop - start)
        rng = ChaChaRng(bytes([7]) * 32)
        ks = [curve.fr.rand(rng) for _ in range(n)]
        got = multihost.msm_multihost(curve, local, ks[start:stop], n, mesh)
        want = curve.msm(GeneratorsChain(curve, LABEL).take(n), ks)
        if got != want:
            raise AssertionError(f"rank {rank}: multi-process MSM != host "
                                 "Pippenger")
        return got
    finally:
        multihost.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=120.0)
    a = ap.parse_args(argv)
    pt = worker(a.rank, a.world, a.port, a.n, a.device, a.timeout)
    x = "identity" if pt is None else hex(pt[0])
    print(f"MULTIHOST_OK rank={a.rank} world={a.world} point={x}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
