"""Port v2 MSM vs the JAX package's glue and the host Pippenger.

Tolerances: digits, sorted keys and bucket positions equal (exact
integers) to the JAX package's pure-jnp stage functions
(msm2._digits_all, _stage_sort, _searchsorted16); whole MSMs equal in
affine to `curve.msm` (the internal add order differs from the host
Pippenger's, so projective coordinates are not compared). On the CPU the
kernels' plain versions run.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.ops import curve as jc
from ark_bulletproofs_tpu.ops import msm2 as jm
from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens, curves,
                                        engine, msm, msm_many, seeded_rng)
from ark_bulletproofs_tpu_torch.ops import cache, msm2
from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _case(curve, n, seed, sets=1):
    """n bases from a pool of 24 random points (repeats give doublings,
    a point and its negation cancel), identity bases and zero scalars."""
    rng = seeded_rng(seed)
    pool = [curve.rand(rng) for _ in range(12)]
    pool += [curve.neg(P) for P in pool]
    prng = random.Random(seed)
    bases = [pool[prng.randrange(24)] for _ in range(n)]
    bases[1] = None
    ks = [[prng.randrange(curve.fr.p) for _ in range(n)] for _ in range(sets)]
    for k in ks:
        k[2] = 0
        k[3] = curve.fr.p - 1
    return bases, ks


@pytest.mark.parametrize("n", [256, 1024])
def test_digits_sort_and_bucket_positions_match_jax(n):
    curve = curves.secq256k1
    _, ks = _case(curve, n, n, sets=2)
    c = msm2.window_bits(n)
    assert c == jm.window_bits(n)
    scal = scalars_to_device(curve, ks, "cpu")  # (2, 16, n)
    jscal = jnp.asarray(np.ascontiguousarray(
        scal.permute(0, 2, 1).numpy().astype(np.uint32)))
    g, jg = msm2._Cfg(n, c, 2), jm._Cfg(n, c, 2)
    assert (g.W, g.BW, g.C, g.R, g.L, g.S) == (jg.W, jg.BW, jg.C, jg.R,
                                               jg.L, jg.S)
    assert np.array_equal(msm2._digits_all(scal, c, g.W).numpy(),
                          np.asarray(jm._digits_all(jscal, c, jg.W)))
    order, sd = msm2._stage_sort(g, scal)
    jorder, jsd = jm._stage_sort(jg, jscal)
    assert np.array_equal(order.numpy(), np.asarray(jorder))
    assert np.array_equal(sd.numpy(), np.asarray(jsd))
    assert np.array_equal(msm2._bucket_pos(sd, g.S).numpy(),
                          np.asarray(jm._searchsorted16(jsd, jg.S)))


# 1061 runs the ragged driver: a 1024 chunk plus a tail padded to 1024.
@pytest.mark.parametrize("n", [256, 1061])
def test_msm_matches_host(n):
    curve = curves.secq256k1
    bases, (ks,) = _case(curve, n, 7 + n)
    assert msm(curve, bases, ks, device="cpu") == curve.msm(bases, ks)


def test_msm_many_two_sets_zorro():
    """B = 2 scalar sets over shared bases on the a != 0 curve."""
    curve = curves.zorro
    bases, ks = _case(curve, 256, 3, sets=2)
    got = msm_many(curve, bases, ks, device="cpu")
    assert got == [curve.msm(bases, k) for k in ks]


def test_engine_routing():
    curve = curves.secq256k1
    bases, (ks,) = _case(curve, 40, 5)
    want = curve.msm(bases, ks)
    assert engine.config.msm_device_threshold == 512
    assert engine.msm(curve, bases, ks) == want  # below: host Pippenger
    assert engine.msm_many(curve, bases, [ks]) == [want]
    with pytest.raises(ValueError):
        msm(curve, bases, ks[:-1], device="cpu")
    assert msm(curve, [], [], device="cpu") is None


def test_tables_from_numpy_and_cache():
    """The port's device tables equal the JAX package's numpy tables."""
    curve, jcurve = curves.secq256k1, jax_pkg.curves.secq256k1
    bp = BulletproofGens(curve, 8, 1)
    pc = PedersenGens.default(curve)
    jgens = jax_pkg.BulletproofGens(jcurve, 8, 1).share(0)
    pts = jgens.G(8) + jgens.H(8)
    X, Y, inf = cache.bp_table(bp, curve, 8, "cpu")
    jX, jY, jinf = jc.affine_to_device(jcurve, pts)
    for a, b in zip((X, Y, inf), cache.from_numpy(jX, jY, jinf, "cpu")):
        assert torch.equal(a, b)
    assert cache.bp_table(bp, curve, 8, "cpu")[0] is X  # cached
    Xp, Yp, _ = cache.pc_pair(pc, curve, "cpu")
    jpc = jax_pkg.PedersenGens.default(jcurve)
    jXp, jYp, jIp = jc.affine_to_device(jcurve, [jpc.B, jpc.B_blinding])
    assert torch.equal(Xp, cache.from_numpy(jXp, jYp, jIp, "cpu")[0])
