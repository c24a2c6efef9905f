"""The port's device verify scalars (ops/verify.py) and the device verify
routes (r1cs/verifier.py, ipp.py) vs the JAX package and the host route.

Tolerances: the g/h scalar vectors, delta and the batch-accumulated g/h
equal (exact integers) to the JAX package's `gh_scalars` /
`_gh_scalars_batch_accum` and to the port's host assembly
(`_assemble_host_scalars`); the s-vector equal to JAX `_s_vector`;
`ipa_gh_msm` equal in affine to the host Pippenger over the host's
scalars (the JAX package's `ipa_gh_msm` compiles its v1 MSM for minutes
on the CPU, so its point is not compared here); the device routes, with
their gates lowered, accept and reject exactly what the host route does,
tampered proofs included; a 16-bit range proof made on the port's device
route, whose per-round IPA runs on the v1 Pippenger, byte-equal to the
JAX package's host prover under the same seeded RNG. On the CPU every
kernel wrapper runs its plain version.
"""

import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu import engine as shared_engine
from ark_bulletproofs_tpu import gadgets as shared_gadgets
from ark_bulletproofs_tpu import r1cs as shared_r1cs
from ark_bulletproofs_tpu.ops import field as jdf
from ark_bulletproofs_tpu.ops import verify as jv
from ark_bulletproofs_tpu.ops.limbs import ints_to_limbs as jlimbs
from ark_bulletproofs_tpu.rand import seeded_rng as shared_rng
import ark_bulletproofs_tpu_torch as port
from ark_bulletproofs_tpu_torch import (BulletproofGens, InnerProductProof,
                                        PedersenGens, R1CSError, R1CSProof,
                                        ShuffleProof, Transcript,
                                        batch_verify, curves, engine,
                                        gadgets, ipp, r1cs, seeded_rng)
from ark_bulletproofs_tpu_torch.errors import VerificationError
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops import verify as tv
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from ark_bulletproofs_tpu_torch.parallel import msm as pm
from ark_bulletproofs_tpu_torch.r1cs import prover, verifier

torch.set_num_threads(1)

CURVE = curves.secq256k1
JCURVE = jax_pkg.curves.secq256k1
P_ = CURVE.fr.p


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(shared_engine.config, "backend", "host")


def _ints(count: int, seed: int) -> list[int]:
    raw = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(count, 16), dtype=np.uint16).tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") % P_
            for i in range(count)]


def _ingredients(n: int, n1: int, seed: int) -> dict:
    """A verifier's ingredients dict for n multipliers (padded to a power
    of two), random from numpy."""
    padded = 1 << max(n - 1, 0).bit_length()
    lg = padded.bit_length() - 1
    v = _ints(3 * n + lg + 12, seed)
    ing = dict(wL=v[:n], wR=v[n:2 * n], wO=v[2 * n:3 * n],
               u_sq=v[3 * n:3 * n + lg], n=n, n1=n1, n2=n - n1,
               padded_n=padded, pad=padded - n, wV=[v[-12]], wc=v[-11])
    for i, k in enumerate(("y", "z", "u", "x", "w", "r", "allinv", "a",
                           "b")):
        ing[k] = v[-10 + i]
    ing["u_inv_sq"] = [pow(x, -1, P_) for x in ing["u_sq"]]
    return ing


_PROOF = SimpleNamespace(t_x=5, t_x_blinding=6, e_blinding=7)


def _host_gh(ing):
    """The port's host assembly: (g, h) int lists."""
    vec = verifier.Verifier(CURVE, Transcript(b"t"))._assemble_host_scalars(
        ing, _PROOF)
    pn = ing["padded_n"]
    return vec[2:2 + pn], vec[2 + pn:2 + 2 * pn]


def _ints_of(t: torch.Tensor) -> list[int]:
    return limbs_to_ints(t.reshape(16, -1))


def test_gh_scalars_match_jax_and_host():
    ing = _ingredients(13, 5, seed=1)
    y_inv = pow(ing["y"], -1, P_)
    args = (ing["wL"], ing["wR"], ing["wO"], y_inv, ing["u"], ing["x"],
            ing["a"], ing["b"], ing["u_sq"], ing["allinv"], ing["n1"])
    g, h, delta = tv.gh_scalars(CURVE, 16, *args, device="cpu")
    assert g.shape == h.shape == (16, 16)
    jg, jh, jdelta = jv.gh_scalars(JCURVE, 16, *args)
    assert np.array_equal(g.numpy().T, np.asarray(jg))
    assert np.array_equal(h.numpy().T, np.asarray(jh))
    assert (_ints_of(g), _ints_of(h)) == _host_gh(ing)
    host_delta = tv.compute_delta_host(P_, ing["wL"], ing["wR"], y_inv)
    assert delta == jdelta == host_delta == jv.compute_delta_host(
        P_, ing["wL"], ing["wR"], y_inv)
    g2, h2, d2 = tv.gh_scalars(CURVE, 16, *args, delta_host=True,
                               mont_out=True, device="cpu")
    assert d2 == delta
    assert _ints_of(df.from_mont(df.spec_for(CURVE.fr), g2)) == _ints_of(g)


def test_gh_scalars_batch_accum_matches_jax_and_host():
    """Three proofs of padded_n = 8 (different n1), alpha-scaled and
    summed on the device, against JAX and the alpha-sum of the host's
    vectors."""
    ings = [_ingredients(7 + (i == 1), 2 + i, seed=10 + i) for i in range(3)]
    alphas = _ints(3, 20)
    fr = df.spec_for(CURVE.fr)
    keys = ("u", "x", "a", "b")
    y_inv = [pow(g["y"], -1, P_) for g in ings]
    g_acc, h_acc = tv._gh_scalars_batch_accum(
        fr, 8, 3, *(tv._rows([g[k] for g in ings], 8, "cpu")
                    for k in ("wL", "wR", "wO")),
        tv._col(y_inv, "cpu"), *(tv._col([g[k] for g in ings], "cpu")
                                 for k in keys),
        tv._rows([g["u_sq"] for g in ings], 3, "cpu"),
        tv._col([g["allinv"] for g in ings], "cpu"), [g["n1"] for g in ings],
        tv._col([a * CURVE.fr.R % P_ for a in alphas], "cpu"))
    got = [[x * CURVE.fr.R_inv % P_ for x in _ints_of(t)]
           for t in (g_acc, h_acc)]
    host = [_host_gh(g) for g in ings]
    want = [[sum(a * v[s][i] for a, v in zip(alphas, host)) % P_
             for i in range(8)] for s in range(2)]
    assert got == want
    # the same sums one proof at a time (`_scale_accumulate`)
    acc_g = acc_h = torch.zeros(16, 8, dtype=torch.int64)
    for g, a in zip(ings, alphas):
        pg, ph, _ = tv.gh_scalars(
            CURVE, 8, g["wL"], g["wR"], g["wO"], pow(g["y"], -1, P_),
            g["u"], g["x"], g["a"], g["b"], g["u_sq"], g["allinv"], g["n1"],
            mont_out=True, delta_host=True, device="cpu")
        acc_g, acc_h = tv._scale_accumulate(
            fr, acc_g, acc_h, pg, ph,
            ints_to_limbs([a * CURVE.fr.R % P_]))
    assert torch.equal(acc_g, g_acc.long()) and torch.equal(acc_h,
                                                            h_acc.long())

    def L(vals):
        return jnp.asarray(jlimbs(vals))

    def Lrows(rows, n):
        return jnp.asarray(np.stack([jlimbs(list(r) + [0] * (n - len(r)))
                                     for r in rows]))

    jg, jh = jv._gh_scalars_batch_accum(
        jdf.spec_for(JCURVE.fr), 8, 3,
        *(Lrows([g[k] for g in ings], 8) for k in ("wL", "wR", "wO")),
        L(y_inv), *(L([g[k] for g in ings]) for k in keys),
        Lrows([g["u_sq"] for g in ings], 3), L([g["allinv"] for g in ings]),
        jnp.asarray(np.array([g["n1"] for g in ings], np.uint32)),
        L([a * CURVE.fr.R % P_ for a in alphas]))
    assert np.array_equal(g_acc.numpy().T, np.asarray(jg))
    assert np.array_equal(h_acc.numpy().T, np.asarray(jh))


def test_s_vector_and_ipa_gh_msm():
    """The s-vector equals JAX `_s_vector`; `ipa_gh_msm` at n = 64 equals
    the host Pippenger over the host's g/h scalars (v1 at 2n = 128
    terms)."""
    n, lg = 64, 6
    fr = df.spec_for(CURVE.fr)
    R = CURVE.fr.R
    u_sq = _ints(lg, 30)
    allinv = _ints(1, 31)[0]
    s = tv._s_vector(fr, ints_to_limbs([x * R % P_ for x in u_sq]),
                     ints_to_limbs([allinv * R % P_]), n, lg)
    js = jv._s_vector(jdf.spec_for(JCURVE.fr),
                      jnp.asarray(jlimbs([x * R % P_ for x in u_sq])),
                      jnp.asarray(jlimbs([allinv * R % P_])[0]), n, lg)
    assert np.array_equal(s.numpy().T, np.asarray(js))
    gens = BulletproofGens(CURVE, n, 1).share(0)
    G, H = gens.G(n), gens.H(n)
    a, b = _ints(2, 32)
    gf, hf = _ints(n, 33), _ints(n, 34)
    calls = []
    real = tv.msm_v1
    tv.msm_v1 = lambda *a_, **k: calls.append(1) or real(*a_, **k)
    try:
        got = tv.ipa_gh_msm(CURVE, n, a, b, u_sq, allinv, gf, hf, G, H,
                            device="cpu")
    finally:
        tv.msm_v1 = real
    assert calls == [1]
    sv = [x * CURVE.fr.R_inv % P_ for x in _ints_of(s)]
    want = CURVE.msm(G + H, [a * si * gi % P_ for si, gi in zip(sv, gf)]
                     + [b * si * hi % P_ for si, hi in zip(sv[::-1], hf)])
    assert got == want


def test_ipa_gh_msm_cache_keys_by_content():
    """Two `ipa_gh_msm` calls at n = 16 whose factor vectors (and, in the
    second pair, G vectors) share their first and last elements but differ
    inside: each equals the host Pippenger over its own inputs, never a
    cached vector or table of the other call."""
    n, lg = 16, 4
    gens = BulletproofGens(CURVE, 2 * n, 1).share(0)
    G, H = gens.G(n), gens.H(n)
    u_sq = _ints(lg, 40)
    allinv = _ints(1, 41)[0]
    a, b = _ints(2, 42)
    R = CURVE.fr.R
    s = tv._s_vector(df.spec_for(CURVE.fr),
                     ints_to_limbs([x * R % P_ for x in u_sq]),
                     ints_to_limbs([allinv * R % P_]), n, lg)
    sv = [x * CURVE.fr.R_inv % P_ for x in _ints_of(s)]
    hf1 = [1] + _ints(n - 2, 43) + [1]
    hf2 = [1] + _ints(n - 2, 44) + [1]
    G2 = [G[0]] + gens.G(2 * n)[n + 1:2 * n - 1] + [G[-1]]
    gf = _ints(n, 45)
    for Gv, hf in ((G, hf1), (G, hf2), (G2, hf2)):
        got = tv.ipa_gh_msm(CURVE, n, a, b, u_sq, allinv, list(gf),
                            list(hf), list(Gv), list(H), device="cpu")
        want = CURVE.msm(Gv + H,
                         [a * si * gi % P_ for si, gi in zip(sv, gf)]
                         + [b * si * hi % P_ for si, hi in zip(sv[::-1], hf)])
        assert got == want


def _shuffle(k: int, seed: int, curve=CURVE):
    pc = PedersenGens.default(curve)
    bp = BulletproofGens(curve, 16, 1)
    r = random.Random(seed)
    vals = [r.getrandbits(64) for _ in range(k)]
    perm = vals[:]
    r.shuffle(perm)
    sp, ic, oc = ShuffleProof.prove(seeded_rng(seed), pc, bp,
                                    Transcript(b"dev verify"), vals, perm)
    return pc, bp, sp.proof, ic, oc


def _tamper_t_x(proof, curve=CURVE):
    blob = bytearray(proof.to_bytes(curve))
    blob[11 * len(curve.serialize_compressed(curve.gen))] ^= 1
    return R1CSProof.from_bytes(curve, bytes(blob))


def _accepts(fn) -> bool:
    try:
        fn()
    except (R1CSError, VerificationError):
        return False
    return True


@pytest.fixture
def device_routes(monkeypatch):
    """The device verify routes with their gates lowered; returns a
    function that runs fn on the device route and on the host route and
    returns both decisions, after checking that the device route made its
    scalars on the device."""
    made = []
    real = tv.gh_scalars

    def spy(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tv, "gh_scalars", spy)
    monkeypatch.setattr(verifier, "DEVICE_SCALARS_MIN_N", 1)
    monkeypatch.setattr(ipp, "VERIFY_DEVICE_MIN_N", 1)

    def both(fn):
        made.clear()
        monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
        dev = _accepts(fn)
        monkeypatch.setattr(engine.config, "msm_device_threshold", 1 << 62)
        return dev, _accepts(fn)

    both.made = made
    return both


@pytest.mark.parametrize("curve_name", ["secq256k1", "curve25519"])
def test_device_verifier_matches_host_route(device_routes, curve_name):
    curve = getattr(curves, curve_name)
    pc, bp, proof, ic, oc = _shuffle(4, 3, curve)

    def verify(p, a, b):
        return lambda: ShuffleProof(p).verify(pc, bp, Transcript(
            b"dev verify"), a, b)

    assert device_routes(verify(proof, ic, oc)) == (True, True)
    assert device_routes.made == [1]
    assert device_routes(verify(_tamper_t_x(proof, curve), ic, oc)) == (
        False, False)


def test_device_batch_verify_mixed_sizes(device_routes, monkeypatch):
    """Proofs of k = 2, 4 and 2 (two padded sizes: two groups) accepted
    together; one tampered proof rejects the batch on both routes."""
    items = [_shuffle(k, 40 + i) for i, k in enumerate((2, 4, 2))]
    pc, bp = items[0][:2]

    def run(bad: int | None):
        def go():
            inst = []
            for i, (_, _, p, ic, oc) in enumerate(items):
                p = _tamper_t_x(p) if i == bad else p
                inst.append((ShuffleProof(p).build_verifier(
                    pc, Transcript(b"dev verify"), ic, oc), p))
            batch_verify(seeded_rng(7), inst, pc, bp)
        return go

    made = []
    real = tv._gh_scalars_batch_accum
    monkeypatch.setattr(tv, "_gh_scalars_batch_accum",
                        lambda *a, **k: made.append(a[1]) or real(*a, **k))
    assert device_routes(run(None)) == (True, True)
    assert sorted(made) == [2, 8]  # one batched pass per size group
    assert device_routes(run(1)) == (False, False)


@pytest.mark.parametrize("curve_name", ["secq256k1", "curve25519"])
def test_device_ipa_verify_matches_host_route(device_routes, curve_name,
                                             monkeypatch):
    """InnerProductProof.verify at n = 16: the device route (on a
    short-Weierstrass curve; a twisted-Edwards curve stays on the host
    route) accepts the honest proof and rejects a changed a, as the host
    route does."""
    curve = getattr(curves, curve_name)
    n = 16
    gens = BulletproofGens(curve, n, 1).share(0)
    G, H = gens.G(n), gens.H(n)
    Q = curve.mul(PedersenGens.default(curve).B, 99)
    gf, hf, a, b = (_ints(n, 50 + i) for i in range(4))
    gf = [x % curve.fr.p for x in gf]
    hf = [x % curve.fr.p for x in hf]
    a = [x % curve.fr.p for x in a]
    b = [x % curve.fr.p for x in b]
    proof = InnerProductProof.create(Transcript(b"ipa"), curve, Q, gf, hf,
                                     G, H, a, b)
    p = curve.fr.p
    c = sum(x * y for x, y in zip(a, b)) % p
    Pt = curve.msm(G + H + [Q], [x * f % p for x, f in zip(a, gf)]
                   + [x * f % p for x, f in zip(b, hf)] + [c])
    big = []
    real = tv.ipa_gh_msm
    monkeypatch.setattr(tv, "ipa_gh_msm",
                        lambda *x, **k: big.append(1) or real(*x, **k))

    def verify(pr, point):
        return lambda: pr.verify(n, Transcript(b"ipa"), curve, gf, hf, point,
                                 Q, G, H)

    assert device_routes(verify(proof, Pt)) == (True, True)
    assert len(big) == (1 if curve_name == "secq256k1" else 0)
    bad = InnerProductProof(proof.L_vec, proof.R_vec, (proof.a + 1) % p,
                            proof.b)
    assert device_routes(verify(bad, Pt)) == (False, False)


PORT = SimpleNamespace(pkg=port, r1cs=r1cs, gadgets=gadgets, rng=seeded_rng)
JAX = SimpleNamespace(pkg=jax_pkg, r1cs=shared_r1cs, gadgets=shared_gadgets,
                      rng=shared_rng)


def _range_proof(ns, bits: int = 16):
    """(proof bytes, commitment) of a `bits`-bit range proof (phase 1
    only, padded_n = bits)."""
    curve = ns.pkg.curves.secq256k1
    pc, bp = ns.pkg.PedersenGens.default(curve), ns.pkg.BulletproofGens(
        curve, bits, 1)
    rng = ns.rng(16)
    pr = ns.r1cs.Prover(pc, ns.pkg.Transcript(b"range16"))
    value = random.Random(16).randrange(1 << bits)
    V, var = pr.commit(value, curve.fr.rand(rng))
    ns.gadgets.range_proof_gadget(pr, curve, var.lc(), value, bits)
    return pr.prove(rng, bp).to_bytes(curve), V


def test_range16_device_route_matches_jax_host(monkeypatch):
    """Every device branch of the prover on (thresholds lowered, the IPA
    on the per-round route): its compact round MSMs, 2 sets of 16 terms,
    run on the v1 Pippenger. Byte-equal to the JAX host prover."""
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    monkeypatch.setattr(prover, "VECTOR_MIN_N", 1)
    monkeypatch.setattr(ipp, "DEVICE_MIN_N", 1)
    monkeypatch.setattr(ipp, "IPA_FS", ())
    calls = []
    real = pm.msm_v1
    monkeypatch.setattr(pm, "msm_v1",
                        lambda *a, **k: calls.append(a[4].shape) or
                        real(*a, **k))
    got = _range_proof(PORT)
    assert got == _range_proof(JAX)
    assert (2, 16, 16) in calls  # the IPA's round MSMs
