"""The port's twisted-Edwards path (curve25519) vs the JAX package.

Tolerances: extended coordinates bit-equal to the JAX package's plain TE
law (ops/curve.py `_te_add`, `_te_double`, jnp) and to its kernel bodies
`_k_te_madd` / `_k_te_add` (ops/kernels.py, run eagerly on lists of 16
(L,) limb vectors) in the order the TPU kernels add; results equal in
affine to the host model (curves/models.py::TECurve); whole MSMs and
commitments equal in affine to the host; the device-route proof equal in
bytes to the JAX package's host prover. Lanes include the identity
(0, 1), doublings (P + P) and P + (-P). On the CPU every kernel wrapper
runs its plain version.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu import engine as shared_engine
from ark_bulletproofs_tpu.gadgets import ShuffleProof as SharedShuffleProof
from ark_bulletproofs_tpu.ops import curve as jc
from ark_bulletproofs_tpu.ops import kernels as jk
from ark_bulletproofs_tpu.rand import seeded_rng as shared_rng
from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                        ShuffleProof, Transcript, curves,
                                        engine, ipp, seeded_rng)
from ark_bulletproofs_tpu_torch.ops import _build
from ark_bulletproofs_tpu_torch.ops import curve as tc
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
from ark_bulletproofs_tpu_torch.ops import proj as tp
from ark_bulletproofs_tpu_torch.ops import prove as tprove
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs
from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device
from ark_bulletproofs_tpu_torch.parallel.msm import msm_device_mapped
from ark_bulletproofs_tpu_torch.r1cs import prover

torch.set_num_threads(1)

CURVE = curves.curve25519
JCURVE = jax_pkg.curves.curve25519
M = 12  # lanes: 0-1 P + P, 2-3 P + (-P), 4 P + O, 5 O + Q, 6 O + O
L = 8  # scan lanes


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _specs():
    return tc.spec_for(CURVE), jc.spec_for(JCURVE)


def _points(seed):
    """(P, Q) host affine lists with the special lanes above."""
    rng = seeded_rng(seed)
    P = [CURVE.rand(rng) for _ in range(M)]
    Q = [CURVE.rand(rng) for _ in range(M)]
    Q[0], Q[1] = P[0], P[1]
    Q[2], Q[3] = CURVE.neg(P[2]), CURVE.neg(P[3])
    Q[4] = P[5] = P[6] = Q[6] = CURVE.zero()
    return P, Q


def _ext(pts, seed) -> torch.Tensor:
    """Host affine points -> (4, 16, m) Montgomery extended limbs with a
    random Z from numpy (the identity too: (0 : Z : 0 : Z))."""
    f = CURVE.fq
    zs = np.random.default_rng(seed).integers(1, 1 << 62, size=len(pts))
    cols = []
    for (x, y), z in zip(pts, zs):
        z = int(z)
        cols.append((x * z % f.p, y * z % f.p, x * y % f.p * z % f.p, z))
    return torch.stack([ints_to_limbs([c[i] * f.R % f.p for c in cols])
                        for i in range(4)])


def _jax(P: torch.Tensor):
    """(4, 16, m) -> the JAX law's tuple of (m, 16) uint32 arrays."""
    return tuple(jnp.asarray(np.ascontiguousarray(
        c.numpy().T.astype(np.uint32))) for c in P)


def _from_jax(P) -> torch.Tensor:
    return torch.stack([torch.from_numpy(np.asarray(c).T.astype(np.int64))
                        for c in P])


def _klimbs(t: torch.Tensor):
    """(16, L) -> a kernel body's list of 16 (L,) uint32 vectors."""
    return [jnp.asarray(t[i].numpy().astype(np.uint32)) for i in range(16)]


def _kpoint(P: torch.Tensor):
    return tuple(_klimbs(c) for c in P)


def _from_k(P) -> torch.Tensor:
    return torch.stack([torch.from_numpy(np.stack(
        [np.asarray(v) for v in c]).astype(np.int32)) for c in P])


def _affine(P: torch.Tensor):
    return tc.point_batch_to_host(CURVE, P)


def test_te_spec_matches_jax():
    spec, jspec = _specs()
    assert isinstance(spec, tc.TECurveSpec) and tc.n_coords(spec) == 4
    assert spec.fq.p == jspec.fq.p == (1 << 255) - 19
    assert spec.a_mont_limbs == jspec.a_mont_limbs
    assert spec.d_mont_limbs == jspec.d_mont_limbs
    # csrc/field.cuh::CurveConst: a at words 17-24, d at 36-43, te at 44
    w = [int(v) for v in _build.curve_words(spec)]
    assert len(w) == 45 and w[44] == 1 and w[25:36] == [0] * 11
    f = spec.fq
    assert sum(v << (32 * i) for i, v in enumerate(w[36:44])) == (
        CURVE.d * f.R % f.p)
    assert sum(v << (32 * i) for i, v in enumerate(w[17:25])) == (
        CURVE.a * f.R % f.p)


def test_te_point_conversions():
    rng = seeded_rng(5)
    pts = [CURVE.rand(rng) for _ in range(5)] + [CURVE.zero()]
    X, Y, inf = tc.affine_to_device(CURVE, pts)
    jX, jY, jinf = jc.affine_to_device(JCURVE, pts)
    assert torch.equal(X, torch.from_numpy(jX.T.astype(np.int32)))
    assert torch.equal(Y, torch.from_numpy(jY.T.astype(np.int32)))
    assert inf.tolist() == list(jinf) == [False] * 5 + [True]
    P = _ext(pts, 6)
    assert _affine(P) == pts  # the identity comes back as (0, 1)
    assert tc.point_to_host(CURVE, P[:, :, 5]) == CURVE.zero()
    spec, _ = _specs()
    assert _affine(tp.point_zero(spec, 2, "cpu")) == [(0, 1)] * 2


@pytest.mark.parametrize("k", [0, 1, 4])
def test_te_double_k_add(k):
    """te_double_k_add (CPU: its plain version) == k JAX doublings then
    the JAX add, bit for bit; == 2^k P + Q on the host model."""
    Pa, Qa = _points(10 + k)
    P, Q = _ext(Pa, 1), _ext(Qa, 2)
    spec, jspec = _specs()
    got = kk.te_double_k_add(spec, P.int(), Q.int(), k)
    assert got.dtype == torch.int32 and got.shape == (4, 16, M)
    assert torch.equal(got, kk.double_k_add(spec, P.int(), Q.int(), k))
    jP = _jax(P)
    for _ in range(k):
        jP = jc._te_double(jspec, jP)
    assert torch.equal(got.long(), _from_jax(jc._te_add(jspec, jP,
                                                        _jax(Q))))
    host = [CURVE.add(CURVE.mul_bigint(p, 1 << k), q)
            for p, q in zip(Pa, Qa)]
    assert _affine(got) == host
    if k == 0:
        assert host[2] == host[3] == CURVE.zero()  # P + (-P)


def test_te_double():
    Pa, _ = _points(30)
    P = _ext(Pa, 4)
    spec, jspec = _specs()
    got = kk.te_double(spec, P.int())
    assert torch.equal(got.long(), tp.double(spec, P))
    assert torch.equal(got.long(), _from_jax(jc._te_double(jspec,
                                                           _jax(P))))
    assert _affine(got) == [CURVE.double(p) for p in Pa]


def test_te_add_mixed():
    """proj.add_mixed == the kernel body _k_te_madd bit for bit (T2 = x y
    in the body; identity lanes of the affine operand pass P through)."""
    Pa, Qa = _points(20)
    Qa[7] = CURVE.zero()  # a second affine identity lane
    P = _ext(Pa, 3)
    X, Y, inf = tc.affine_to_device(CURVE, Qa)
    spec, jspec = _specs()
    got = tp.add_mixed(spec, P, X, Y, inf)
    want = jk._k_te_madd(jspec, _kpoint(P), _klimbs(X), _klimbs(Y),
                         jnp.asarray(inf.numpy()))
    assert torch.equal(got, _from_k(want).long())
    assert torch.equal(got[:, :, 4], P[:, :, 4].long())
    assert _affine(got) == [CURVE.add(p, q) for p, q in zip(Pa, Qa)]


def _rows(R, seed):
    """(2, R, 16, L) affine rows + the host points; column 0 repeats its
    point (doublings), column 1 alternates P, -P, column 2 holds identity
    rows (y = 0)."""
    rng = seeded_rng(seed)
    pts = [[CURVE.rand(rng) for _ in range(L)] for _ in range(R)]
    for r in range(R):
        pts[r][0] = pts[0][0]
        pts[r][1] = pts[0][1] if r % 2 else CURVE.neg(pts[0][1])
        if r % 3 == 0:
            pts[r][2] = CURVE.zero()
    X, Y = zip(*(tc.affine_to_device(CURVE, row)[:2] for row in pts))
    return torch.stack([torch.stack(X), torch.stack(Y)]), pts


@pytest.mark.parametrize("R", [1, 8])
def test_te_suffix_madd_scan(R):
    spec, jspec = _specs()
    xy, pts = _rows(R, R)
    got = k2.suffix_madd_scan(spec, xy)
    assert got.shape == (4, R, 16, L) and got.dtype == torch.int32
    acc = _kpoint(tp.point_zero(spec, L, "cpu"))
    for r in range(R - 1, -1, -1):
        qy = _klimbs(xy[1, r])
        acc = jk._k_te_madd(jspec, acc, _klimbs(xy[0, r]), qy,
                            jk._k_is_zero(qy))
        assert torch.equal(got[:, r], _from_k(acc)), f"row {r}"
    totals = [CURVE.msm([pts[r][i] for r in range(R)], [1] * R)
              for i in range(L)]
    assert _affine(got[:, 0]) == totals


def test_te_suffix_jac_scan_and_rowsum():
    """Both against loops of the kernel body _k_te_add, 8 rows, a column
    of equal rows (doublings)."""
    spec, jspec = _specs()
    R = 8
    T = k2.suffix_madd_scan(spec, _rows(R, 11)[0])
    T[:, :, :, 3] = T[:, :1, :, 3]
    excl, tot = k2.suffix_jac_scan(spec, T)
    acc = _kpoint(tp.point_zero(spec, L, "cpu"))
    for r in range(R - 1, -1, -1):
        assert torch.equal(excl[:, r], _from_k(acc)), f"row {r}"
        acc = jk._k_te_add(jspec, acc, _kpoint(T[:, r]))
    assert torch.equal(tot, _from_k(acc))
    got = k2.rowsum(spec, T)
    acc = _kpoint(tp.point_zero(spec, L, "cpu"))
    for r in range(R):
        acc = jk._k_te_add(jspec, acc, _kpoint(T[:, r]))
    assert torch.equal(got, _from_k(acc))
    rows = [_affine(T[:, r]) for r in range(R)]
    assert _affine(got) == [CURVE.msm([rows[r][i] for r in range(R)],
                                      [1] * R) for i in range(L)]


def test_te_msm_two_sets_base_map():
    """n = 256, two scalar sets over their own selections of a 300-row
    table (identity rows, repeats and negations among them) == the host
    Pippenger."""
    rng = seeded_rng(7)
    pool = [CURVE.rand(rng) for _ in range(12)]
    pool += [CURVE.neg(P) for P in pool]
    prng = random.Random(7)
    table = [pool[prng.randrange(24)] for _ in range(300)]
    table[5] = CURVE.zero()
    n, p = 256, CURVE.fr.p
    bm = [[prng.randrange(300) for _ in range(n)] for _ in range(2)]
    bm[0][0] = 5
    ks = [[prng.randrange(p) for _ in range(n)] for _ in range(2)]
    ks[1][3] = 0
    X, Y, inf = tc.affine_to_device(CURVE, table)
    got = msm_device_mapped(tc.spec_for(CURVE), X, Y, inf,
                            scalars_to_device(CURVE, ks, "cpu"),
                            torch.tensor(bm))
    assert got.shape == (4, 16, 2)
    assert _affine(got) == [CURVE.msm([table[i] for i in bm[b]], ks[b])
                            for b in range(2)]


def test_te_pedersen_commit_many_dev(monkeypatch):
    """64 commitments on the device route (through PedersenGens with the
    threshold at 0) == the host `commit`, zero value and blinding
    included."""
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    pc = PedersenGens.default(CURVE)
    prng = random.Random(64)
    vals = [prng.getrandbits(64) for _ in range(64)]
    blinds = [prng.randrange(CURVE.fr.p) for _ in range(64)]
    vals[0] = blinds[0] = blinds[1] = 0
    calls = []
    dev = tprove.pedersen_commit_many_dev
    monkeypatch.setattr(tprove, "pedersen_commit_many_dev",
                        lambda *a: calls.append(1) or dev(*a))
    got = pc.commit_many(vals, blinds)
    assert calls == [1]
    assert got == [pc.commit(v, r) for v, r in zip(vals, blinds)]
    assert got[0] == CURVE.zero()


def test_te_shuffle_device_branches_match_jax_host(monkeypatch):
    """A k = 4 curve25519 shuffle through every device branch (tabled
    phase MSMs, vector phase, device IPA; all MSMs on the TE kernels'
    plain versions) equals the JAX package's host prover's proof; the port
    verifies it on its device route."""
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    monkeypatch.setattr(prover, "VECTOR_MIN_N", 1)
    monkeypatch.setattr(ipp, "DEVICE_MIN_N", 1)
    monkeypatch.setattr(shared_engine.config, "backend", "host")
    calls = []
    te_dka = kk.te_double_k_add
    monkeypatch.setattr(kk, "te_double_k_add",
                        lambda *a: calls.append(1) or te_dka(*a))
    vals, perm = [11, 22, 33, 44], [33, 11, 44, 22]
    pc, bp = PedersenGens.default(CURVE), BulletproofGens(CURVE, 8, 1)
    sp, ic, oc = ShuffleProof.prove(seeded_rng(4), pc, bp,
                                    Transcript(b"te route"), vals, perm)
    assert calls  # the MSMs ran on the TE path
    jsp, jic, joc = SharedShuffleProof.prove(
        shared_rng(4), jax_pkg.PedersenGens.default(JCURVE),
        jax_pkg.BulletproofGens(JCURVE, 8, 1),
        jax_pkg.Transcript(b"te route"), vals, perm)
    assert sp.proof.to_bytes(CURVE) == jsp.proof.to_bytes(JCURVE)
    assert (ic, oc) == (jic, joc)
    ShuffleProof(sp.proof).verify(pc, bp, Transcript(b"te route"), ic, oc)


def test_te_wrappers_reject_bad_input():
    spec, _ = _specs()
    sw = tc.spec_for(curves.secq256k1)
    P4 = torch.zeros(4, 16, 4, dtype=torch.int32)
    P3 = torch.zeros(3, 16, 4, dtype=torch.int32)
    with pytest.raises(TypeError):
        kk.rcb_double_k_add(spec, P4, P4, 0)
    with pytest.raises(TypeError):
        kk.te_double(sw, P3)
    with pytest.raises(ValueError):
        kk.te_double_k_add(spec, P3, P3, 0)
    with pytest.raises(ValueError):
        k2.rowsum(spec, P3[:, None].contiguous())
    with pytest.raises(ValueError, match="Z = 0"):
        tc.point_batch_to_host(CURVE, P4)
