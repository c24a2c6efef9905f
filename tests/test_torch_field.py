"""Port field layer vs the exact host field and the JAX package's ops/field.py.

Tolerance: bit-equal limbs. The port's plain PyTorch field ops (the CPU
versions of the CUDA field core) must give exactly the canonical limbs
of `fields.py` and of the JAX plain field ops, on the fq and fr of
secq256k1, zorro and curve25519, for random values and the edges 0, 1,
p - 1 and R mod p.
"""

import random

import numpy as np
import pytest
import torch

from ark_bulletproofs_tpu import fields as jfields
from ark_bulletproofs_tpu.ops import field as jf
from ark_bulletproofs_tpu_torch import engine, fields
from ark_bulletproofs_tpu_torch.ops import field as tf
from ark_bulletproofs_tpu_torch.ops import limbs as tl

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")

FIELDS = [
    fields.secq256k1_fq,
    fields.secq256k1_fr,
    fields.zorro_fq,
    fields.zorro_fr,
    fields.ed25519_fq,
    fields.ed25519_fr,
]


def _jax_field(f):
    """The JAX package's field object of the port's field f."""
    jfs = [v for v in vars(jfields).values()
           if isinstance(v, jfields.Field) and v.name == f.name]
    assert len(jfs) == 1, f.name
    return jfs[0]


def _values(f, n, seed):
    rng = random.Random(seed)
    R = (1 << 256) % f.p
    edges = [0, 1, f.p - 1, R]
    return edges + [rng.randrange(f.p) for _ in range(n - len(edges))]


def _jax(t: torch.Tensor) -> np.ndarray:
    """Port (16, m) limbs -> the JAX package's (m, 16) uint32 layout."""
    return np.ascontiguousarray(t.numpy().T.astype(np.uint32))


def test_limbs_roundtrip():
    xs = _values(fields.secq256k1_fq, 40, 0)
    t = tl.ints_to_limbs(xs)
    assert t.dtype == torch.int32 and t.shape == (16, 40)
    assert tl.limbs_to_ints(t) == xs
    assert tl.limbs_to_ints(tl.int_to_limbs(xs[7])) == [xs[7]]
    # the JAX package's (m, 16) numpy layout converts to the same tensor
    from ark_bulletproofs_tpu.ops import limbs as jl

    assert torch.equal(tl.limbs_from_numpy(jl.ints_to_limbs(xs)), t)


@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_field_ops_match_host_and_jax(f):
    """add, sub, neg, mont_mul, to_mont, from_mont: bit-equal to the host
    ints and to the JAX plain field ops."""
    xs, ys = _values(f, 24, 1), _values(f, 24, 2)[::-1]
    a, b = tl.ints_to_limbs(xs), tl.ints_to_limbs(ys)
    p = f.p
    Rinv = pow((1 << 256) % p, -1, p)
    ts, js = tf.spec_for(f), jf.spec_for(_jax_field(f))
    ja, jb = _jax(a), _jax(b)
    cases = [
        (tf.add(ts, a, b), jf.add(js, ja, jb), [(x + y) % p for x, y in
                                                 zip(xs, ys)]),
        (tf.sub(ts, a, b), jf.sub(js, ja, jb), [(x - y) % p for x, y in
                                                 zip(xs, ys)]),
        (tf.neg(ts, a), jf.neg(js, ja), [(-x) % p for x in xs]),
        (tf.mont_mul(ts, a, b), jf.mont_mul(js, ja, jb),
         [x * y * Rinv % p for x, y in zip(xs, ys)]),
        (tf.to_mont(ts, a), jf.to_mont(js, ja),
         [x * (1 << 256) % p for x in xs]),
        (tf.from_mont(ts, a), jf.from_mont(js, ja), [x * Rinv % p
                                                     for x in xs]),
    ]
    for got, ref_jax, want in cases:
        assert got.dtype == torch.int64
        assert tl.limbs_to_ints(got) == want
        assert np.array_equal(_jax(got), np.asarray(ref_jax))


@pytest.mark.parametrize("f", [fields.secq256k1_fq, fields.zorro_fq],
                         ids=lambda f: f.name)
def test_wide_tensors_take_the_same_values(f):
    """Wide tensors take the shifted-row product and digit-serial REDC
    path of mont_mul: bit-equal to the host ints, in a stacked
    (2, 16, m) layout too."""
    xs, ys = _values(f, 600, 3), _values(f, 600, 4)
    a, b = tl.ints_to_limbs(xs), tl.ints_to_limbs(ys)
    ts = tf.spec_for(f)
    p = f.p
    Rinv = pow((1 << 256) % p, -1, p)
    got = tf.mont_mul(ts, torch.stack([a, b]), torch.stack([b, b]))
    assert tl.limbs_to_ints(got[0]) == [x * y * Rinv % p for x, y in
                                        zip(xs, ys)]
    assert tl.limbs_to_ints(got[1]) == [y * y * Rinv % p for y in ys]
    assert tl.limbs_to_ints(tf.mul_small(ts, a, 21)) == [21 * x % p
                                                         for x in xs]


def test_norm_resolves_long_carry_chains():
    """A column sum that ripples through fifteen 0xFFFF limbs."""
    x = torch.full((16, 1), 0xFFFF, dtype=torch.int64)
    x[0, 0] += 1
    limbs, top = tf._norm(x, 1)
    assert int(top) == 1 and not bool(limbs.any())
