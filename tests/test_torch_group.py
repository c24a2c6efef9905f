"""Port RCB group law vs the JAX package's plain group law and the host model.

Tolerances: projective coordinates bit-equal to the JAX package's plain
RCB formulas (ops/proj.py `_add_xla`, `add_mixed`, `_double_xla`), and
results equal in affine to curves/models.py. Lanes include the identity,
doublings (P + P) and P + (-P); curves secq256k1 (a = 0, Alg 7/8/9) and
zorro (a = 6, Alg 1/2/3).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_bulletproofs_tpu import curves as jcurves
from ark_bulletproofs_tpu.ops import curve as jc
from ark_bulletproofs_tpu.ops import proj as jp
from ark_bulletproofs_tpu_torch import curves, engine, seeded_rng
from ark_bulletproofs_tpu_torch.ops import curve as tc
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops import proj as tp
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _jspec(curve):
    """The JAX package's CurveSpec of the port's curve."""
    return jc.spec_for(jcurves.ALL_CURVES[curve.name])

CURVES = [curves.secq256k1, curves.zorro]
M = 12  # lanes: 0-1 P + P, 2-3 P + (-P), 4 P + O, 5 O + Q, 6 O + O, rest random


def _points(curve, seed):
    """(P, Q) host affine lists with the special lanes above."""
    rng = seeded_rng(seed)
    P = [curve.rand(rng) for _ in range(M)]
    Q = [curve.rand(rng) for _ in range(M)]
    Q[0], Q[1] = P[0], P[1]
    Q[2], Q[3] = curve.neg(P[2]), curve.neg(P[3])
    Q[4] = None
    P[5] = None
    P[6], Q[6] = None, None
    return P, Q


def _proj(curve, pts, seed):
    """Host affine points -> (3, 16, m) Montgomery projective limbs with
    random Z (identity = (0 : 1 : 0))."""
    f = curve.fq
    rng = random.Random(seed)
    cols = []
    for P in pts:
        if P is None:
            cols.append((0, 1, 0))
        else:
            z = rng.randrange(1, f.p)
            cols.append((P[0] * z % f.p, P[1] * z % f.p, z))
    R = f.R
    return torch.stack([
        ints_to_limbs([c[i] * R % f.p for c in cols]) for i in range(3)
    ])


def _jax(P: torch.Tensor):
    return tuple(jnp.asarray(np.ascontiguousarray(
        c.numpy().T.astype(np.uint32))) for c in P)


def _from_jax(P) -> torch.Tensor:
    return torch.stack([torch.from_numpy(np.asarray(c).T.astype(np.int64))
                        for c in P])


def _affine(curve, P: torch.Tensor):
    return tc.point_batch_to_host(curve, P)


@pytest.mark.parametrize("k", [0, 1, 4])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_double_k_add(curve, k):
    """rcb_double_k_add (CPU: its plain version) == k JAX doublings then
    the JAX add, bit for bit; == 2^k P + Q on the host model."""
    Pa, Qa = _points(curve, 10 + k)
    P, Q = _proj(curve, Pa, 1), _proj(curve, Qa, 2)
    spec, jspec = tc.spec_for(curve), _jspec(curve)
    got = kk.rcb_double_k_add(spec, P.int(), Q.int(), k)
    assert got.dtype == torch.int32 and got.shape == (3, 16, M)
    jP = _jax(P)
    for _ in range(k):
        jP = jp._double_xla(jspec, jP)
    want = _from_jax(jp._add_xla(jspec, jP, _jax(Q)))
    assert torch.equal(got.long(), want)
    host = [curve.add(curve.mul_bigint(p, 1 << k) if p else None, q)
            for p, q in zip(Pa, Qa)]
    assert _affine(curve, got) == host
    if k == 0:
        assert host[2] is None and host[3] is None  # P + (-P)


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_add_mixed(curve):
    """proj.add_mixed == the JAX add_mixed bit for bit, identity lanes
    of the affine operand passing P through."""
    Pa, Qa = _points(curve, 20)
    Qa[7] = None  # a second affine identity lane
    P = _proj(curve, Pa, 3)
    X, Y, inf = tc.affine_to_device(curve, Qa)
    spec, jspec = tc.spec_for(curve), _jspec(curve)
    got = tp.add_mixed(spec, P, X, Y, inf)
    jX, jY = _jax(torch.stack([X, Y]))
    want = _from_jax(jp.add_mixed(jspec, _jax(P), jX, jY,
                                  jnp.asarray(inf.numpy())))
    assert torch.equal(got, want)
    assert torch.equal(got[:, :, 4], P[:, :, 4].long())  # + O passes P
    assert _affine(curve, got) == [curve.add(p, q) for p, q in zip(Pa, Qa)]


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_double(curve):
    Pa, _ = _points(curve, 30)
    P = _proj(curve, Pa, 4)
    spec, jspec = tc.spec_for(curve), _jspec(curve)
    got = tp.double(spec, P)
    assert torch.equal(got, _from_jax(jp._double_xla(jspec, _jax(P))))
    assert _affine(curve, got) == [curve.double(p) if p else None
                                   for p in Pa]


def test_point_conversions_and_spec():
    curve = curves.zorro
    rng = seeded_rng(5)
    pts = [curve.rand(rng) for _ in range(5)] + [None]
    X, Y, inf = tc.affine_to_device(curve, pts)
    jX, jY, jinf = jc.affine_to_device(jcurves.zorro, pts)
    assert torch.equal(X, torch.from_numpy(jX.T.astype(np.int32)))
    assert torch.equal(Y, torch.from_numpy(jY.T.astype(np.int32)))
    assert inf.tolist() == list(jinf)
    P = _proj(curve, pts, 6)
    assert _affine(curve, P) == pts
    assert tc.point_to_host(curve, P[:, :, 2]) == pts[2]
    spec = tc.spec_for(curve)
    assert not spec.is_a_zero and spec.a_small == 6 and spec.b3_small is None
    assert tc.spec_for(curves.secq256k1).b3_small == 21
    te, jte = tc.spec_for(curves.curve25519), _jspec(curves.curve25519)
    assert isinstance(te, tc.TECurveSpec) and te.fq.p == jte.fq.p
    assert (te.a_mont_limbs, te.d_mont_limbs) == (jte.a_mont_limbs,
                                                  jte.d_mont_limbs)


def test_wrapper_rejects_bad_input():
    spec = tc.spec_for(curves.secq256k1)
    P = torch.zeros(3, 16, 4, dtype=torch.int32)
    with pytest.raises(TypeError):
        kk.rcb_double_k_add(spec, P.long(), P, 0)
    with pytest.raises(ValueError):
        kk.rcb_double_k_add(spec, P, P[:, :, :2], 0)
    with pytest.raises(ValueError):
        kk.rcb_double_k_add(spec, P.transpose(1, 2).contiguous()
                            .transpose(1, 2), P, 0)
