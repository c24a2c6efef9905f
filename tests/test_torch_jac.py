"""The port's Jacobian short-Weierstrass law (ops/curve.py `_sw_double`,
`_sw_add`; the plain versions of the `jac_double_k_add` and `jac_double`
kernels, csrc/jac.cuh) and `proj.to_jacobian` vs the JAX package.

Tolerances: Jacobian coordinates bit-equal to the JAX package's kernel
bodies `_k_sw_double` / `_k_sw_add` (ops/kernels.py, run eagerly on lists
of 16 (L,) limb vectors), k doublings then the add as
`sw_double_k_add_tiled` runs them; results equal in affine to the host
model (curves/models.py); `to_jacobian` bit-equal to JAX
`proj.to_jacobian`. Lanes include doublings (P + P), P + (-P), P + O,
O + Q and O + O, with the identity as (0, 0, 0) and as (R, R, 0), on
secq256k1 (a = 0) and zorro (a = 6). On the CPU every kernel wrapper runs
its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.ops import curve as jc
from ark_bulletproofs_tpu.ops import kernels as jk
from ark_bulletproofs_tpu.ops import proj as jp
from ark_bulletproofs_tpu_torch import curves, engine, seeded_rng
from ark_bulletproofs_tpu_torch.ops import curve as tc
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops import proj as tp
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

torch.set_num_threads(1)

CURVES = ["secq256k1", "zorro"]
M = 12  # lanes: 0-1 P + P, 2-3 P + (-P), 4 P + O, 5 O + Q, 6 O + O


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _curves(name):
    curve = getattr(curves, name)
    return curve, tc.spec_for(curve), jc.spec_for(getattr(jax_pkg.curves,
                                                          name))


def _points(curve, seed):
    rng = seeded_rng(seed)
    P = [curve.rand(rng) for _ in range(M)]
    Q = [curve.rand(rng) for _ in range(M)]
    Q[0], Q[1] = P[0], P[1]
    Q[2], Q[3] = curve.neg(P[2]), curve.neg(P[3])
    Q[4] = P[5] = P[6] = Q[6] = None
    return P, Q


def _jac(curve, pts, seed) -> torch.Tensor:
    """Host affine points -> (3, 16, m) Montgomery Jacobian limbs with a
    random Z from numpy; the identity as (0, 0, 0) on even lanes and as
    (R, R, 0) on odd ones."""
    f = curve.fq
    zs = np.random.default_rng(seed).integers(1, 1 << 62, size=len(pts))
    cols = []
    for i, (pt, z) in enumerate(zip(pts, zs)):
        if pt is None:
            cols.append((1, 1, 0) if i % 2 else (0, 0, 0))
            continue
        z = int(z)
        cols.append((pt[0] * z * z % f.p, pt[1] * z * z * z % f.p, z))
    return torch.stack([ints_to_limbs([c[i] * f.R % f.p for c in cols])
                        for i in range(3)])


def _affine(curve, P: torch.Tensor) -> list:
    f = curve.fq
    X, Y, Z = ([v * f.R_inv % f.p for v in limbs_to_ints(P[i])]
               for i in range(3))
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, f.p)
        out.append((x * zi * zi % f.p, y * zi * zi * zi % f.p))
    return out


def _klimbs(t: torch.Tensor):
    return [jnp.asarray(t[i].numpy().astype(np.uint32)) for i in range(16)]


def _kpoint(P: torch.Tensor):
    return tuple(_klimbs(c) for c in P)


def _from_k(P) -> torch.Tensor:
    return torch.stack([torch.from_numpy(np.stack(
        [np.asarray(v) for v in c]).astype(np.int64)) for c in P])


@pytest.mark.parametrize("k", [0, 1, 4])
@pytest.mark.parametrize("name", CURVES)
def test_jac_double_k_add_matches_kernel_body(name, k):
    curve, spec, jspec = _curves(name)
    Pa, Qa = _points(curve, 10 + k)
    P, Q = _jac(curve, Pa, 1).int(), _jac(curve, Qa, 2).int()
    got = kk.jac_double_k_add(spec, P, Q, k)
    assert got.dtype == torch.int32 and got.shape == (3, 16, M)
    jP = _kpoint(P)
    for _ in range(k):
        jP = jk._k_sw_double(jspec, *jP)
    assert torch.equal(got.long(), _from_k(jk._k_sw_add(jspec, jP,
                                                        _kpoint(Q))))
    host = [curve.add(curve.mul_bigint(p, 1 << k) if p else None, q)
            for p, q in zip(Pa, Qa)]
    assert _affine(curve, got) == host
    if k == 0:
        assert host[2] is None and host[3] is None  # P + (-P)
        assert torch.equal(got[:, :, 4], P[:, :, 4])  # P + O passes P


@pytest.mark.parametrize("name", CURVES)
def test_jac_double_matches_kernel_body(name):
    curve, spec, jspec = _curves(name)
    Pa, _ = _points(curve, 30)
    P = _jac(curve, Pa, 4).int()
    got = kk.jac_double(spec, P)
    assert torch.equal(got.long(), _from_k(jk._k_sw_double(jspec,
                                                           *_kpoint(P))))
    assert torch.equal(got.long(), tc._sw_double(spec, P))
    assert _affine(curve, got) == [curve.double(p) if p else None
                                   for p in Pa]
    assert kk.jac_double.launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("name", CURVES)
def test_sw_law_matches_jax_xla_law(name):
    """The plain law also equals the JAX package's XLA Jacobian law,
    except for X and Y of the P + (-P) lanes, which the XLA law sets to 0
    and the kernel body leaves (both have Z = 0)."""
    curve, spec, jspec = _curves(name)
    Pa, Qa = _points(curve, 40)
    P, Q = _jac(curve, Pa, 5), _jac(curve, Qa, 6)

    def jx(T):
        return tuple(jnp.asarray(np.ascontiguousarray(
            c.numpy().T.astype(np.uint32))) for c in T)

    def back(T):
        return torch.stack([torch.from_numpy(np.asarray(c).T.astype(
            np.int64)) for c in T])

    got = tc._sw_add(spec, P, Q)
    want = back(jc._sw_add(jspec, jx(P), jx(Q)))
    keep = [i for i in range(M) if i not in (2, 3)]
    assert torch.equal(got[..., keep], want[..., keep])
    assert torch.equal(got[2], want[2]) and not got[2, :, 2:4].any()
    assert torch.equal(tc._sw_double(spec, P),
                       back(jc._sw_double(jspec, jx(P))))


def test_model_identity_helpers():
    curve, spec, _ = _curves("secq256k1")
    te = tc.spec_for(curves.curve25519)
    Z = tc.point_zero(spec, 3, "cpu")
    assert Z.shape == (3, 16, 3) and not Z.any()
    assert tc.is_zero(spec, Z).all()
    Zt = tc.point_zero(te, 2, "cpu")
    assert tc.is_zero(te, Zt).all()
    assert torch.equal(Zt, tp.point_zero(te, 2, "cpu"))
    P = _jac(curve, [curve.gen, None], 3)
    assert tc.is_zero(spec, P).tolist() == [False, True]


@pytest.mark.parametrize("name", CURVES + ["curve25519"])
def test_to_jacobian_matches_jax(name):
    """RCB (X : Y : Z) -> (XZ, YZ^2, Z), the identity (0 : R : 0) to
    (0, 0, 0); TE passes through."""
    curve = getattr(curves, name)
    spec = tc.spec_for(curve)
    jspec = jc.spec_for(getattr(jax_pkg.curves, name))
    nc = tc.n_coords(spec)
    rng = np.random.default_rng(7)
    f = curve.fq
    vals = [[int(v) % f.p for v in rng.integers(0, 1 << 62, size=5)]
            for _ in range(nc)]
    P = torch.stack([ints_to_limbs(v) for v in vals])
    ident = tp.point_zero(spec, 1, "cpu").int()
    P = torch.cat([P, ident], dim=-1)
    got = tp.to_jacobian(spec, P)
    want = jp.to_jacobian(jspec, tuple(jnp.asarray(np.ascontiguousarray(
        c.numpy().T.astype(np.uint32))) for c in P))
    want = torch.stack([torch.from_numpy(np.asarray(c).T.astype(np.int64))
                        for c in want])
    assert torch.equal(got.long(), want)
    if nc == 3:
        assert not got[:, :, -1].any()


def test_jac_wrappers_reject_bad_input():
    _, spec, _ = _curves("secq256k1")
    te = tc.spec_for(curves.curve25519)
    P3 = torch.zeros(3, 16, 4, dtype=torch.int32)
    with pytest.raises(TypeError):
        kk.jac_double_k_add(te, P3, P3, 0)
    with pytest.raises(TypeError):
        kk.jac_double(te, P3)
    with pytest.raises(ValueError):
        kk.jac_double(spec, P3[:2].contiguous())
    with pytest.raises(ValueError):
        kk.jac_double_k_add(spec, P3, P3, -1)
