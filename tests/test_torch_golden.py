"""The port alone against the frozen golden vectors (tests/golden/golden.json).

The vectors were generated once from the JAX package's host stack
(tests/golden_compute.py says why they are load-bearing). Here the port
recomputes them with nothing of the JAX package: the generators layer
(Pedersen bases, the first chain points of G and H) on the three curves
through the host chain, and on secq256k1 and zorro also through the
generator farm's route (the gate lowered to one generator, the engine on
the CPU: ops/gens.py's plain version; zorro's farm replays on the host);
the transcript layer (a fixed history's challenges) on the three curves;
and the proof layers (a k = 3 shuffle on each curve, the example gadget,
an n = 10 range proof and an n = 32 IPA on secq256k1) on the port's host
route, under the same seeded RNGs.

Tolerance: exact (compressed point and proof bytes, challenge values).
"""

import json
import os
import random

import pytest

from ark_bulletproofs_tpu_torch import (BulletproofGens, InnerProductProof,
                                        PedersenGens, Prover, ShuffleProof,
                                        Transcript, curves, engine,
                                        seeded_rng)
from ark_bulletproofs_tpu_torch.gadgets import (example_gadget,
                                                range_proof_gadget)
from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
from ark_bulletproofs_tpu_torch.transcript import protocol

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.json")
CURVES = ["secq256k1", "zorro", "curve25519"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


@pytest.fixture(scope="module")
def frozen():
    with open(GOLDEN) as fh:
        return json.load(fh)


def _pt(curve, P) -> str:
    return curve.serialize_compressed(P).hex()


@pytest.mark.parametrize("name,route", [(c, "host") for c in CURVES] + [
    ("secq256k1", "farm"), ("zorro", "farm")])  # the farm's curves
def test_generators_layer(frozen, monkeypatch, name, route):
    curve = getattr(curves, name)
    if route == "farm":
        monkeypatch.setattr(GeneratorsChain, "_DEVICE_MIN", 1)
        assert GeneratorsChain(curve, b"")._device_ok(1)
    pc = PedersenGens.default(curve)
    chain_g = GeneratorsChain(curve, b"G" + (0).to_bytes(4, "little"))
    chain_h = GeneratorsChain(curve, b"H" + (0).to_bytes(4, "little"))
    assert frozen[name]["generators"] == {
        "pedersen_B": _pt(curve, pc.B),
        "pedersen_B_blinding": _pt(curve, pc.B_blinding),
        "chain_G0_first4": [_pt(curve, p) for p in chain_g.take(4)],
        "chain_H0_first2": [_pt(curve, p) for p in chain_h.take(2)],
    }


@pytest.mark.parametrize("name", CURVES)
def test_transcript_layer(frozen, name):
    curve = getattr(curves, name)
    t = Transcript(b"golden")
    protocol.r1cs_domain_sep(t)
    t.append_message(b"msg", b"arkworks-parity")
    t.append_u64(b"n", 42)
    c1 = protocol.challenge_scalar(t, curve, b"c1")
    protocol.append_scalar(t, curve, b"s", c1)
    c2 = protocol.challenge_scalar(t, curve, b"c2")
    protocol.append_point(t, curve, b"P", curve.gen)
    c3 = protocol.challenge_scalar(t, curve, b"c3")
    assert frozen[name]["transcript"] == {
        "challenges": [hex(c1), hex(c2), hex(c3)]}


@pytest.mark.parametrize("name", CURVES)
def test_shuffle_layer(frozen, name):
    curve = getattr(curves, name)
    seed = 100 + CURVES.index(name)
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 8, 1)
    pyrng = random.Random(seed)
    inputs = [pyrng.getrandbits(64) for _ in range(3)]
    outputs = list(inputs)
    pyrng.shuffle(outputs)
    sp, in_coms, out_coms = ShuffleProof.prove(
        seeded_rng(seed), pc, bp, Transcript(b"ShuffleProofGolden"), inputs,
        outputs)
    sp.verify(pc, bp, Transcript(b"ShuffleProofGolden"), in_coms, out_coms)
    assert frozen[name]["shuffle_k3"] == {
        "inputs": inputs,
        "proof": sp.proof.to_bytes(curve).hex(),
        "in_coms": [_pt(curve, P) for P in in_coms],
        "out_coms": [_pt(curve, P) for P in out_coms],
    }


def _example(curve) -> dict:
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 8, 1)
    rng = seeded_rng(7)
    prover = Prover(pc, Transcript(b"ExampleGolden"))
    coms, vars_ = zip(*[prover.commit(v, curve.fr.rand(rng))
                        for v in [3, 4, 6, 1, 40, 9]])
    example_gadget(prover, *vars_)
    proof = prover.prove(rng, bp)
    return {"proof": proof.to_bytes(curve).hex(),
            "coms": [_pt(curve, P) for P in coms]}


def _range(curve) -> dict:
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 16, 1)
    rng = seeded_rng(8)
    prover = Prover(pc, Transcript(b"RangeGolden"))
    com, var = prover.commit(777, curve.fr.rand(rng))
    range_proof_gadget(prover, curve, var, 777, 10)
    proof = prover.prove(rng, bp)
    return {"proof": proof.to_bytes(curve).hex(), "com": _pt(curve, com)}


def _ipa(curve) -> dict:
    n, f, rng = 32, curve.fr, seeded_rng(9)
    bp = BulletproofGens(curve, n, 1)
    a = [f.rand(rng) for _ in range(n)]
    b = [f.rand(rng) for _ in range(n)]
    proof = InnerProductProof.create(
        Transcript(b"IPAGolden"), curve, curve.mul(curve.gen, 7), [1] * n,
        [1] * n, bp.G(n, 1), bp.H(n, 1), a, b)
    return {"proof": proof.to_bytes(curve).hex()}


@pytest.mark.parametrize("layer,make", [("example_gadget", _example),
                                        ("range_n10", _range),
                                        ("ipa_n32", _ipa)])
def test_secq256k1_proof_layers(frozen, layer, make):
    assert frozen["secq256k1"][layer] == make(curves.secq256k1)
