"""The prover's device functions vs the JAX package's, at small sizes.

Inputs are made with numpy from a seed and go through both. The JAX side
runs as its own CPU tests run it: plain jnp field ops (`ops/field.py::
mont_mul` is the plain reference of the `mont_mul_tiled` TPU kernel), here
with jit disabled so that nothing is compiled. On the port's side the CPU
tensors take the plain version of the Montgomery-product kernel.
Tolerance: bit-equal limbs (every result is canonical in [0, p)); MSMs
equal in affine to the host Pippenger.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.ops import field as jf
from ark_bulletproofs_tpu.ops import ipa as jipa
from ark_bulletproofs_tpu.ops import prove as jprove
from ark_bulletproofs_tpu.ops import verify as jverify
from ark_bulletproofs_tpu_torch import curves, engine
from ark_bulletproofs_tpu_torch.ops import cache, ipa, prove, verify
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops.curve import affine_to_device, spec_for
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs
from ark_bulletproofs_tpu_torch.ops.msm import (msm_many_tabled,
                                                scalars_to_device)
from ark_bulletproofs_tpu_torch.parallel.msm import msm_device_mapped

torch.set_num_threads(1)

CURVES = ["secq256k1", "zorro", "curve25519"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _ints(p: int, n: int, seed: int, edges: bool = True) -> list[int]:
    """n field elements from numpy's generator; 0, 1 and p - 1 first."""
    raw = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(n, 16), dtype=np.uint16).tobytes()
    xs = [int.from_bytes(raw[32 * i:32 * i + 32], "little") % p
          for i in range(n)]
    if edges:
        xs[:3] = [0, 1, p - 1]
    return xs


def _mont(p: int, xs: list[int]) -> list[int]:
    R = (1 << 256) % p
    return [x * R % p for x in xs]


def _j(t: torch.Tensor):
    """Port (..., 16, L) limbs -> the JAX package's (..., L, 16) uint32."""
    return jnp.asarray(np.ascontiguousarray(
        np.swapaxes(t.numpy(), -1, -2).astype(np.uint32)))


def _t(a) -> torch.Tensor:
    """JAX (..., L, 16) limbs -> port (..., 16, L) int64."""
    return torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(np.asarray(a), -1, -2).astype(np.int64)))


def _eq(port, jax_out) -> bool:
    """Vectors: port (..., 16, L) against JAX (..., L, 16)."""
    return torch.equal(port.long(), _t(jax_out))


def _eq1(port, jax_out) -> bool:
    """Single elements: port (..., 16, 1) against JAX (..., 16)."""
    return torch.equal(port[..., 0].long(), torch.from_numpy(
        np.asarray(jax_out).astype(np.int64)))


@pytest.mark.parametrize("name", CURVES)
def test_field_reductions_match_jax(name):
    """mont_mul (elementwise, (16, 1) broadcast), sum_mod and dot_mod on
    the curve's scalar field."""
    field = getattr(curves, name).fr
    fs, js = df.spec_for(field), jf.spec_for(getattr(jax_pkg.curves,
                                                     name).fr)
    p = field.p
    a = ints_to_limbs(_ints(p, 40, 1))
    b = ints_to_limbs(_ints(p, 40, 2))
    col = b[:, 7:8]
    with jax.disable_jit():
        assert _eq(df.mont_mul(fs, a, b), jf.mont_mul(js, _j(a), _j(b)))
        assert _eq(df.mont_mul(fs, a, col), jf.mont_mul(js, _j(a),
                                                         _j(col)[0]))
        assert _eq1(df.sum_mod(fs, a), jf.sum_mod(js, _j(a)))
        assert _eq1(df.dot_mod(fs, a, b), jf.dot_mod(js, _j(a), _j(b)))
        stacked = torch.stack([a, b])  # sums per row of a stack
        assert _eq1(df.sum_mod(fs, stacked),
                    jf.sum_mod(js, _j(stacked), axis=1))


def test_vector_phase_matches_jax():
    """_pow_vector, _poly_phase and _eval_phase at padded_n = 16."""
    n, lg_n = 16, 4
    field = curves.secq256k1.fr
    fs, js = df.spec_for(field), jf.spec_for(jax_pkg.curves.secq256k1.fr)
    p = field.p
    vecs = [ints_to_limbs(_ints(p, n, 10 + i)) for i in range(8)]
    y, y_inv, x = _ints(p, 3, 20, edges=False)
    y_l, yi_l, x_l = (ints_to_limbs([v]) for v in (y, y_inv, x))
    with jax.disable_jit():
        base = ints_to_limbs(_mont(p, [y]))
        assert _eq(verify._pow_vector(fs, base, n, lg_n),
                   jverify._pow_vector(js, _j(base)[0], n, lg_n))
        t, coeffs = prove._poly_phase(fs, n, lg_n, *vecs, y_l, yi_l)
        jt, jcoeffs = jprove._poly_phase(
            js, n, lg_n, *(_j(v) for v in vecs), _j(y_l)[0], _j(yi_l)[0])
        assert _eq1(t, jt)
        for c, jc in zip(coeffs, jcoeffs):
            assert _eq(c, jc)
        lr = prove._eval_phase(fs, coeffs, x_l)
        jlr = jprove._eval_phase(js, jcoeffs, _j(x_l)[0])
        assert all(_eq(v, jv) for v, jv in zip(lr, jlr))


def test_fold_and_round_scalars_match_jax():
    """_round_scalars_compact and _fold at N = 16, rounds cur = 16, 8."""
    N = 16
    field = curves.secq256k1.fr
    fs, js = df.spec_for(field), jf.spec_for(jax_pkg.curves.secq256k1.fr)
    p = field.p
    a, b, gm, hm = (ints_to_limbs(_mont(p, _ints(p, N, 30 + i)))
                    for i in range(4))
    u, u_inv = _ints(p, 2, 40, edges=False)
    u_l, ui_l = (ints_to_limbs(_mont(p, [v])) for v in (u, u_inv))
    one = df.mont_one(fs, 1, "cpu")
    U32 = jnp.uint32
    jstate = tuple(_j(v) for v in (a, b, gm, hm))
    with jax.disable_jit():
        for cur in (16, 8):
            m = cur // 2
            rows, bm, cq = ipa._round_scalars_compact(fs, a, b, gm, hm, one,
                                                      m, cur)
            jrows, jbm, jcq = jipa._round_scalars_compact(
                js, *jstate, _j(one)[0], U32(m), U32(cur - 1))
            assert _eq(rows, jrows) and _eq1(cq, jcq)
            assert np.array_equal(bm.numpy(), np.asarray(jbm))
            a, b, gm, hm = ipa._fold(fs, a, b, gm, hm, u_l, ui_l, m, cur)
            jstate = jipa._fold(js, *jstate, _j(u_l)[0], _j(ui_l)[0],
                                U32(m), U32(cur - 1))
            for v, jv in zip((a, b, gm, hm), jstate):
                assert _eq(v, jv), cur


def test_base_map_msm_matches_host():
    """Two scalar sets over their own selections of table rows (padded to
    the v2 MSM's 256 terms) and the prover's tabled MSM, against the host
    Pippenger over the selected bases."""
    curve = curves.secq256k1
    rng = np.random.default_rng(7)
    from ark_bulletproofs_tpu_torch import BulletproofGens, PedersenGens

    bp, pc = BulletproofGens(curve, 12, 1), PedersenGens.default(curve)
    tab = cache.full_table(bp, pc, curve, "cpu")
    rows = bp.share(0).G(12) + bp.share(0).H(12) + [pc.B, pc.B_blinding]
    assert tab[3] == 12 and tab[0].shape == (16, 26)
    idx = rng.integers(0, 26, size=(2, 20))
    ks = [_ints(curve.fr.p, 20, 50 + s) for s in range(2)]
    got = msm_device_mapped(spec_for(curve), *tab[:3],
                            scalars_to_device(curve, ks, "cpu"),
                            torch.from_numpy(idx))
    from ark_bulletproofs_tpu_torch.ops.curve import point_batch_to_host

    want = [curve.msm([rows[i] for i in idx[s]], ks[s]) for s in range(2)]
    assert point_batch_to_host(curve, got) == want
    shared = list(range(3, 9)) + list(range(15, 21))
    assert msm_many_tabled(curve, tab, [k[:12] for k in ks], shared) == [
        curve.msm([rows[i] for i in shared], k[:12]) for k in ks]
