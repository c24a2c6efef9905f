"""The port's v1 Pippenger (ops/msm.py::msm_impl), the plain versions of
its mixed-add kernels and the MSM router (parallel/msm.py) vs the JAX
package and the host Pippenger.

Tolerances: v1 sums equal in affine to `curve.msm` (one scalar set; two
sets; two sets over base_map rows of a wider table), with identity
bases, the scalars 0, 1 and p - 1 and duplicated points; window digits
equal (exact integers) to JAX `_digits_for_windows`; `jac_madd_plain` /
`te_madd_plain` bit-equal to the kernel bodies `_k_sw_madd` /
`_k_te_madd` run eagerly, and to the XLA laws `_sw_add_mixed` /
`_te_add_mixed` except where the two JAX versions differ from each other
(noted at the test); the router's engine choice equal to the JAX
router's on the TPU, shape by shape, and its sums, from either engine,
in the device coordinates (RCB on a short-Weierstrass curve). On the CPU
every kernel wrapper runs its plain version.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.ops import curve as jc
from ark_bulletproofs_tpu.ops import kernels as jk
from ark_bulletproofs_tpu.ops import msm as jm
from ark_bulletproofs_tpu.ops import msm2 as jm2
from ark_bulletproofs_tpu.parallel import msm as jpm
from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens, curves,
                                        engine, msm, msm_many, seeded_rng)
from ark_bulletproofs_tpu_torch.ops import cache, msm2, proj
from ark_bulletproofs_tpu_torch.ops import curve as tc
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops import msm as v1
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs
from ark_bulletproofs_tpu_torch.ops.msm import (msm_many_tabled,
                                                scalars_to_device)
from ark_bulletproofs_tpu_torch.parallel import msm as pm

torch.set_num_threads(1)

CURVES = ["secq256k1", "zorro", "curve25519"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _curves(name):
    curve = getattr(curves, name)
    return curve, tc.spec_for(curve), jc.spec_for(getattr(jax_pkg.curves,
                                                          name))


def _pool(curve, seed, size=12):
    rng = seeded_rng(seed)
    pool = [curve.rand(rng) for _ in range(size)]
    return pool + [curve.neg(P) for P in pool]


def _ident(curve):
    return None if hasattr(curve, "b") else curve.zero()


def _case(curve, n, sets, seed, width=None):
    """`width` bases (n by default) drawn from a pool of points and their
    negatives, two of them the identity and two the same point; `sets`
    scalar sets of n, holding 0, 1 and p - 1."""
    width = width or n
    pool = _pool(curve, seed)
    r = random.Random(seed)
    bases = [pool[r.randrange(len(pool))] for _ in range(width)]
    bases[min(1, width - 1)] = _ident(curve)
    bases[width - 1] = _ident(curve)
    if width > 4:
        bases[4] = bases[3]
    p = curve.fr.p
    ks = [[r.randrange(p) for _ in range(n)] for _ in range(sets)]
    for k in ks:
        k[0] = 1
        k[n // 2] = 0
        k[n - 1] = p - 1
    return bases, ks


def _affine(curve, spec, P) -> list:
    """(NC, 16, B) model-coordinate sums -> host affine points."""
    return tc.point_batch_to_host(curve, proj.from_jacobian(spec, P).int())


@pytest.mark.parametrize("n", [8, 64, 256])
@pytest.mark.parametrize("name", CURVES)
def test_msm_impl_matches_host(name, n, monkeypatch):
    """Equal to the host Pippenger: at n = 8 one scalar set and two sets
    over shared bases (also with the window axis split over several
    passes: the same coordinates), at n = 64 two sets over base_map rows
    of a table twice as wide, at n = 256 one set."""
    curve, spec, _ = _curves(name)
    table, ks = _case(curve, n, 2, seed=n, width=2 * n)
    X, Y, inf = tc.affine_to_device(curve, table)
    bases = table[:n]
    scal = scalars_to_device(curve, ks, "cpu")
    if n == 64:
        r = random.Random(n + 1)
        bm = [[r.randrange(2 * n) for _ in range(n)] for _ in range(2)]
        bm[0][:3] = [n - 1, 1, 1]  # an identity row, twice
        got = v1.msm_impl(spec, 4, X, Y, inf, scal, torch.tensor(bm))
        assert _affine(curve, spec, got) == [
            curve.msm([table[i] for i in bm[b]], ks[b]) for b in range(2)]
        return
    one = v1.msm_impl(spec, 4, X[:, :n], Y[:, :n], inf[:n], scal[0])
    assert one.dtype == torch.int32 and one.shape == (tc.n_coords(spec), 16,
                                                      1)
    assert _affine(curve, spec, one) == [curve.msm(bases, ks[0])]
    if n == 8:
        two = v1.msm_impl(spec, 4, X[:, :n], Y[:, :n], inf[:n], scal)
        assert _affine(curve, spec, two) == [curve.msm(bases, k) for k in ks]
        monkeypatch.setattr(v1, "V1_MAX_WINDOW_TERMS", 8 * 48)
        assert torch.equal(v1.msm_impl(spec, 4, X[:, :n], Y[:, :n],
                                       inf[:n], scal), two)


@pytest.mark.parametrize("c", [4, 8])
def test_digits_for_windows_match_jax(c):
    curve = curves.secq256k1
    _, ks = _case(curve, 16, 2, seed=c)
    scal = scalars_to_device(curve, ks, "cpu")  # (2, 16, n)
    jscal = np.ascontiguousarray(scal.permute(0, 2, 1).numpy()
                                 .astype(np.uint32))
    W = 256 // c
    ws = np.array([0, 1, W - 1, W, W + 3, 2 * W - 1], dtype=np.uint32)
    got = v1._digits_for_windows(scal, torch.from_numpy(ws.astype(np.int64)),
                                 c)
    want = jm._digits_for_windows(jnp.asarray(jscal), jnp.asarray(ws), c)
    assert np.array_equal(got.numpy(), np.asarray(want))
    ws1 = ws[ws < W]
    got1 = v1._digits_for_windows(scal[0], torch.from_numpy(
        ws1.astype(np.int64)), c)
    want1 = jm._digits_for_windows(jnp.asarray(jscal[0]), jnp.asarray(ws1),
                                   c)
    assert np.array_equal(got1.numpy(), np.asarray(want1))
    assert v1._window_bits(64) == jm._window_bits(64) == 4
    assert v1._window_bits(4096) == jm._window_bits(4096) == 8


M = 10  # lanes: 0-1 P + P, 2-3 P + (-P), 4 P + O, 5 O + Q, 6 O + O


def _mixed_case(curve, seed):
    """Host (P, Q) lists with the special lanes above."""
    pool = _pool(curve, seed, size=M)
    P, Q = pool[:M], pool[M:2 * M][::-1]
    Q[0], Q[1] = P[0], P[1]
    Q[2], Q[3] = curve.neg(P[2]), curve.neg(P[3])
    Q[4] = P[5] = P[6] = Q[6] = _ident(curve)
    return P, Q


def _model(curve, pts, seed) -> torch.Tensor:
    """Host affine points -> model coordinates with a random Z from numpy:
    Jacobian (x Z^2, y Z^3, Z), identity (0, 0, 0); or TE extended."""
    f = curve.fq
    zs = np.random.default_rng(seed).integers(1, 1 << 62, size=len(pts))
    te = not hasattr(curve, "b")
    cols = []
    for pt, z in zip(pts, zs):
        z = int(z)
        if te:
            x, y = pt
            cols.append((x * z, y * z, x * y % f.p * z, z))
        elif pt is None:
            cols.append((0, 0, 0))
        else:
            cols.append((pt[0] * z * z, pt[1] * z ** 3, z))
    return torch.stack([ints_to_limbs([c[i] % f.p * f.R % f.p for c in cols])
                        for i in range(len(cols[0]))]).int()


def _klimbs(t: torch.Tensor):
    return [jnp.asarray(t[i].numpy().astype(np.uint32)) for i in range(16)]


def _from_k(P) -> torch.Tensor:
    return torch.stack([torch.from_numpy(np.stack(
        [np.asarray(v) for v in c]).astype(np.int64)) for c in P])


def _jx(T: torch.Tensor):
    return tuple(jnp.asarray(np.ascontiguousarray(
        c.numpy().T.astype(np.uint32))) for c in T)


def _back(T) -> torch.Tensor:
    return torch.stack([torch.from_numpy(np.asarray(c).T.astype(np.int64))
                        for c in T])


@pytest.mark.parametrize("name", CURVES)
def test_madd_plain_matches_jax(name):
    """jac_madd / te_madd (the plain versions on the CPU) vs the kernel
    bodies, eagerly, bit for bit; vs the XLA laws bit for bit except: on
    the P + (-P) lanes the XLA Jacobian law sets X and Y to 0 where the
    body leaves them (both Z = 0), and on the TE q_inf lanes the XLA law
    adds (0, 1) where the body passes P (the same affine point)."""
    curve, spec, jspec = _curves(name)
    te = tc.is_te(spec)
    Pa, Qa = _mixed_case(curve, 50)
    P = _model(curve, Pa, 1)
    X, Y, inf = tc.affine_to_device(curve, Qa)
    wrapper = kk.te_madd if te else kk.jac_madd
    got = wrapper(spec, P, X, Y, inf)
    assert got.dtype == torch.int32 and wrapper.launches == 0
    plain = (kk.te_madd_plain if te else kk.jac_madd_plain)(spec, P, X, Y,
                                                            inf)
    assert torch.equal(got, plain)
    body = jk._k_te_madd if te else jk._k_sw_madd
    want = body(jspec, tuple(_klimbs(c) for c in P), _klimbs(X), _klimbs(Y),
                jnp.asarray(inf.numpy()))
    assert torch.equal(got.long(), _from_k(want))
    xla = (jc._te_add_mixed if te else jc._sw_add_mixed)(
        jspec, _jx(P), *_jx(torch.stack([X, Y])), jnp.asarray(inf.numpy()))
    xla = _back(xla)
    skip = {4, 6} if te else {2, 3}
    keep = [i for i in range(M) if i not in skip]
    assert torch.equal(got.long()[..., keep], xla[..., keep])
    want_aff = [curve.add(p, q) for p, q in zip(Pa, Qa)]
    assert _affine(curve, spec, got) == want_aff
    assert _affine(curve, spec, xla.int()) == want_aff


def test_madd_wrappers_reject_bad_input():
    curve, spec, _ = _curves("secq256k1")
    P = tc.point_zero(spec, 4, "cpu").int()
    X = torch.zeros(16, 4, dtype=torch.int32)
    inf = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        kk.te_madd(spec, P, X, X, inf)
    with pytest.raises(ValueError):
        kk.jac_madd(spec, P, X, X, inf[:3])
    with pytest.raises(ValueError):
        kk.jac_madd(spec, P, X, X, inf.int())
    with pytest.raises(TypeError):
        kk.jac_madd(spec, P, X.long(), X, inf)


class _FakeTpu:
    platform = "tpu"


SHAPES = [1, 2, 8, 16, 64, 128, 256, 512, 1024, 2048, 4096]


def test_router_matches_jax_thresholds(monkeypatch):
    """For every width, scalar layout and base_map, the port's router
    picks the engine the JAX router picks on a TPU (its jax.devices
    answers "tpu" here, and both packages' engines are replaced by
    recorders)."""
    jax_picked, picked = [], []
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_FakeTpu()])
    monkeypatch.setattr(jm2, "msm2_device_jac",
                        lambda *a, **k: jax_picked.append("v2"))
    monkeypatch.setattr(jm, "msm_device",
                        lambda *a, **k: jax_picked.append("v1"))
    spec = tc.spec_for(curves.secq256k1)
    zero = tc.point_zero(spec, 1, "cpu").int()

    def recorder(name):
        return lambda *a, **k: picked.append(name) or zero

    monkeypatch.setattr(pm, "msm_v2", recorder("v2"))
    monkeypatch.setattr(pm, "msm_v1", recorder("v1"))
    jspec = jc.spec_for(jax_pkg.curves.secq256k1)
    for n in SHAPES:
        for batched, mapped in ((False, False), (True, False), (True, True),
                                (False, True)):
            rows = 2 * n if mapped else n
            X = np.zeros((rows, 16), np.uint32)
            inf = np.zeros(rows, bool)
            jscal = np.zeros((2, n, 16) if batched else (n, 16), np.uint32)
            bm = np.zeros((2 if batched else 1, n), np.int32)
            jpm.msm_device_maybe_sharded(jspec, 4, X, X, inf, jscal,
                                         bm if mapped else None)
            scal = torch.zeros((2, 16, n) if batched else (16, n),
                               dtype=torch.int32)
            out = pm.msm_device_maybe_sharded(
                spec, None, None, None, scal,
                torch.from_numpy(bm) if mapped else None)
            assert picked[-1] == jax_picked[-1], (n, batched, mapped)
            assert pm.uses_v2(n, batched, mapped) == (picked[-1] == "v2")
            assert out.shape == (3, 16, 1)
    assert len(picked) == 4 * len(SHAPES) and picked.count("v2") == 17


def test_from_jacobian_identity_and_points():
    curve, spec, _ = _curves("secq256k1")
    pts = _pool(curve, 3, size=3)[:3] + [None]
    J = _model(curve, pts, 2)
    R = proj.from_jacobian(spec, J)
    assert tc.point_batch_to_host(curve, R.int()) == pts
    assert R[1, :, 3].tolist() == list(spec.fq.r_limbs)  # (0 : R : 0)


@pytest.fixture(params=["v1", "v2"])
def forced_engine(request, monkeypatch):
    """Every router call on one engine: v2 (with msm2.V2_MIN_N lowered to
    16 so that it takes the small widths) or v1."""
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    monkeypatch.setattr(msm2, "V2_MIN_N", 16)
    want_v2 = request.param == "v2"
    monkeypatch.setattr(pm, "uses_v2", lambda n, b, m: want_v2)
    return request.param


def test_router_callers_on_both_engines(forced_engine):
    """msm (one set, ragged), msm_many (two sets) and msm_many_tabled (a
    base_map batch over the cached table) equal the host Pippenger with
    the router's sums from either engine, read as RCB points."""
    curve = curves.secq256k1
    bases, ks = _case(curve, 12, 2, seed=20)
    assert msm(curve, bases, ks[0]) == curve.msm(bases, ks[0])
    assert msm_many(curve, bases, ks) == [curve.msm(bases, k) for k in ks]
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 16, 1)
    table = cache.full_table(bp, pc, curve, torch.device("cpu"))
    rows = [3, 16 + 5, 32, 33, 7, 7]
    sets = [k[:len(rows)] for k in ks]
    gens = bp.share(0)
    pts = gens.G(16) + gens.H(16) + [pc.B, pc.B_blinding]
    assert msm_many_tabled(curve, table, sets, rows) == [
        curve.msm([pts[i] for i in rows], k) for k in sets]
