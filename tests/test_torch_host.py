"""The port's own host layer vs the JAX package's.

The port keeps its own copy of the jax-free host layer (fields, curves,
transcript, native C++, generators, R1CS prover and verifier). Tolerance:
exact. The same seeds give equal field constants, generator points,
transcript challenges and proof bytes; the port's threaded fixed-base
commitments equal its own sequential commitments on every curve (in the
JAX package's copy of the C++ the worker threads start from the secq256k1
constants, so that copy is not the reference here).
"""

import os
import random
import subprocess
import sys
from types import SimpleNamespace

import pytest

import ark_bulletproofs_tpu as jax_pkg
import ark_bulletproofs_tpu_torch as port
from ark_bulletproofs_tpu import engine as shared_engine
from ark_bulletproofs_tpu import gadgets as shared_gadgets
from ark_bulletproofs_tpu import r1cs as shared_r1cs
from ark_bulletproofs_tpu.gadgets import ShuffleProof as SharedShuffleProof
from ark_bulletproofs_tpu.rand import seeded_rng as shared_rng
from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                        ShuffleProof, Transcript, curves,
                                        engine, gadgets, native, r1cs,
                                        seeded_rng)
from ark_bulletproofs_tpu_torch.transcript import protocol


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")
    monkeypatch.setattr(shared_engine.config, "backend", "host")


@pytest.mark.parametrize("name", ["secq256k1", "zorro", "curve25519"])
def test_curves_generators_and_transcript_match_jax(name):
    curve, jcurve = getattr(curves, name), getattr(jax_pkg.curves, name)
    assert (curve.fq.p, curve.fr.p, curve.gen) == (jcurve.fq.p, jcurve.fr.p,
                                                   jcurve.gen)
    gens, jgens = BulletproofGens(curve, 4, 1), jax_pkg.BulletproofGens(
        jcurve, 4, 1)
    assert gens.G(4, 1) + gens.H(4, 1) == jgens.G(4, 1) + jgens.H(4, 1)
    pc, jpc = PedersenGens.default(curve), jax_pkg.PedersenGens.default(
        jcurve)
    assert (pc.B, pc.B_blinding) == (jpc.B, jpc.B_blinding)
    t, jt = Transcript(b"host"), jax_pkg.Transcript(b"host")
    for tr in (t, jt):
        tr.append_message(b"m", curve.serialize_compressed(pc.B_blinding))
    from ark_bulletproofs_tpu.transcript import protocol as jprotocol

    assert (protocol.challenge_scalar(t, curve, b"c")
            == jprotocol.challenge_scalar(jt, jcurve, b"c"))
    rng, jrng = seeded_rng(3), shared_rng(3)
    assert curve.fr.rand_many(rng, 5) == jcurve.fr.rand_many(jrng, 5)


def test_commit_many_threaded_matches_sequential():
    """512 commitments run on several worker threads of the native
    library. On zorro, then secq256k1, then zorro again, each equals the
    sequential `commit` of the port's own curve model."""
    r = random.Random(512)
    for name in ("zorro", "secq256k1", "zorro"):
        curve = getattr(curves, name)
        if not native.set_curve_native(curve):
            pytest.fail("the port's native host library did not build")
        pc = PedersenGens.default(curve)
        p = curve.fr.p
        vals = [r.randrange(p) for _ in range(512)]
        blinds = [r.randrange(p) for _ in range(512)]
        got = pc.commit_many(vals, blinds)
        assert got == [pc.commit(v, b) for v, b in zip(vals, blinds)], name


_RAND_FP_9 = r"""
from ark_bulletproofs_tpu_torch import curves, native
from ark_bulletproofs_tpu_torch.transcript.strobe import Strobe128
st = Strobe128(b"rand_fp")
before = (bytes(st.state), st.pos, st.pos_begin, st.cur_flags)
fr = curves.secq256k1.fr
assert native.strobe_rand_fp_native(st, fr.p, fr.num_bits, 4, 8)
before = (bytes(st.state), st.pos, st.pos_begin, st.cur_flags)
try:
    native.strobe_rand_fp_native(st, fr.p, fr.num_bits, 9, 8)
except ValueError:
    assert (bytes(st.state), st.pos, st.pos_begin, st.cur_flags) == before
    print("OK")
"""


def test_strobe_rand_fp_refuses_more_than_8_limbs():
    """The native field sampler holds a sample in 8 limbs: n_limbs = 9 is
    refused with a ValueError and the strobe untouched, in a process that
    lives on (run apart, so that a write past the limbs could not take
    this one down)."""
    if native.lib() is None:
        pytest.fail("the port's native host library did not build")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _RAND_FP_9], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "OK"


def _shuffle_case(k):
    prng = random.Random(k)
    vals = [prng.getrandbits(64) for _ in range(k)]
    perm = vals[:]
    prng.shuffle(perm)
    return vals, perm


@pytest.mark.parametrize("name", ["secq256k1", "zorro"])
@pytest.mark.parametrize("k", [2, 7])
def test_host_route_shuffle_matches_jax(name, k):
    """The port's host-route proof equals the JAX host prover's, byte for
    byte, and the port verifies it."""
    curve, jcurve = getattr(curves, name), getattr(jax_pkg.curves, name)
    vals, perm = _shuffle_case(k)
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 16, 1)
    sp, ic, oc = ShuffleProof.prove(seeded_rng(k), pc, bp,
                                    Transcript(b"host route"), vals, perm)
    jsp, jic, joc = SharedShuffleProof.prove(
        shared_rng(k), jax_pkg.PedersenGens.default(jcurve),
        jax_pkg.BulletproofGens(jcurve, 16, 1),
        jax_pkg.Transcript(b"host route"), vals, perm)
    assert sp.proof.to_bytes(curve) == jsp.proof.to_bytes(jcurve)
    assert (ic, oc) == (jic, joc)
    ShuffleProof(sp.proof).verify(pc, bp, Transcript(b"host route"), ic, oc)


PORT = SimpleNamespace(pkg=port, r1cs=r1cs, gadgets=gadgets, rng=seeded_rng)
JAX = SimpleNamespace(pkg=jax_pkg, r1cs=shared_r1cs, gadgets=shared_gadgets,
                      rng=shared_rng)


def _gadget_proof(ns, name: str, kind: str):
    """(proof bytes, commitments) of the example gadget ((3 + 4) * (6 + 1)
    = 40 + 9) or a 32-bit range proof (phase 1 only, padded_n = n = 32)."""
    curve = getattr(ns.pkg.curves, name)
    pc, bp = ns.pkg.PedersenGens.default(curve), ns.pkg.BulletproofGens(
        curve, 64, 1)
    rng = ns.rng(9)
    prover = ns.r1cs.Prover(pc, ns.pkg.Transcript(kind.encode()))
    if kind == "example":
        pairs = [prover.commit(x, curve.fr.rand(rng)) for x in (3, 4, 6, 1,
                                                                  40)]
        v = [var.lc() for _, var in pairs]
        ns.gadgets.example_gadget(prover, *v, ns.r1cs.LinearCombination
                                  .from_value(curve.fr, 9))
    else:
        value = random.Random(32).randrange(1 << 32)
        pairs = [prover.commit(value, curve.fr.rand(rng))]
        ns.gadgets.range_proof_gadget(prover, curve, pairs[0][1].lc(), value,
                                      32)
    proof = prover.prove(rng, bp)
    return proof.to_bytes(curve), [V for V, _ in pairs]


@pytest.mark.parametrize("name", ["secq256k1", "zorro"])
@pytest.mark.parametrize("kind", ["example", "range32"])
def test_host_route_gadgets_match_jax(kind, name):
    """The example gadget and a 32-bit range proof: the port's proof bytes
    and commitments equal the JAX host prover's."""
    assert _gadget_proof(PORT, name, kind) == _gadget_proof(JAX, name, kind)
