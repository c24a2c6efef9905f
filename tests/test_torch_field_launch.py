"""The port's field launches and the twisted-Edwards doubling chain vs the
JAX package, on the CPU.

The wrappers of csrc/field_kernels.cu (`field.mont_mul` with a third
operand, `field.add` / `sub` / `neg` through `add_sub`, `field.sum_mod`,
`fs.mont_inv_batch` with rows) and of the TE chain (`kernels.te_double`
with `steps`) run their plain versions on CPU tensors; the callers the
slice rewrote (`prove._poly_phase`, `prove._eval_phase`, `ipa._fold`,
`ipa._q_doubles`, `cache.commit_table`) run through them. Each is held
against the JAX package's plain functions (ops/field.py, ops/prove.py,
ops/ipa.py; jit disabled where that compiles less) and its
kernel body `_k_te_double` (ops/kernels.py, run eagerly on lists of 16
(L,) limb vectors), on the scalar and base fields of secq256k1, zorro and
curve25519. Inputs come from numpy generators with fixed seeds, with the
edges 0, 1 and p - 1, sums at and above 2^256 (on the fields whose 2p
exceeds 2^256: secq256k1's, zorro's base field), runs of 0xFFFF limbs and broadcast (16, 1) and
per-row (rows, 16, 1) operands. Tolerance: bit-equal limbs (every result
is canonical in [0, p)); points also equal in affine to the host model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.ops import curve as jc
from ark_bulletproofs_tpu.ops import field as jf
from ark_bulletproofs_tpu.ops import ipa as jipa
from ark_bulletproofs_tpu.ops import kernels as jk
from ark_bulletproofs_tpu.ops import prove as jprove
from ark_bulletproofs_tpu_torch import PedersenGens, curves, engine
from ark_bulletproofs_tpu_torch.ops import cache, fs, ipa, prove
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops import curve as tc
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

torch.set_num_threads(1)

CURVES = ["secq256k1", "zorro", "curve25519"]
# Lanes of a vector case: one width throughout, so that the JAX side's
# eager operations compile once for it.
LANES = 16


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _fields(name: str, which: str):
    """(port field, port FieldSpec, JAX FieldSpec) of curve `name`'s fq or
    fr."""
    f = getattr(getattr(curves, name), which)
    return f, df.spec_for(f), jf.spec_for(getattr(getattr(jax_pkg.curves,
                                                          name), which))


def _ints(p: int, n: int, seed: int) -> list[int]:
    """n elements below p from numpy; 0, 1 and p - 1 first (as many as
    fit)."""
    raw = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(n, 16), dtype=np.uint16).tobytes()
    xs = [int.from_bytes(raw[32 * i:32 * i + 32], "little") % p
          for i in range(n)]
    k = min(n, 3)
    xs[:k] = [0, 1, p - 1][:k]
    return xs


def _j(t: torch.Tensor):
    """Port (..., 16, L) limbs -> the JAX package's (..., L, 16) uint32."""
    return jnp.asarray(np.ascontiguousarray(
        np.swapaxes(t.numpy(), -1, -2).astype(np.uint32)))


def _t(a) -> torch.Tensor:
    """JAX (..., L, 16) limbs -> port (..., 16, L) int64."""
    return torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(np.asarray(a), -1, -2).astype(np.int64)))


def _same(port: torch.Tensor, jax_out) -> bool:
    return port.dtype == torch.int64 and torch.equal(port, _t(jax_out))


def _rows(xs: list[int], rows: int) -> torch.Tensor:
    """rows * L ints, row-major -> (rows, 16, L) limbs."""
    L = len(xs) // rows
    t = ints_to_limbs(xs).reshape(16, rows, L)
    return t.permute(1, 0, 2).contiguous()


@pytest.mark.parametrize("which", ["fq", "fr"])
@pytest.mark.parametrize("name", CURVES)
def test_fused_mont_mul_matches_jax_add_sub_of_mont_mul(name, which):
    """mont_mul(a, b, c, +-1) == JAX add / sub of mont_mul: flat, with a
    (16, 1) b or c, and per-row (3, 16, 1) operands of a (3, 16, L)
    stack."""
    f, fs_, js = _fields(name, which)
    p, L = f.p, LANES
    a, b, c = (ints_to_limbs(_ints(p, L, 10 * i + len(name)))
               for i in range(3))
    col = b[:, 5:6]
    A3 = _rows(_ints(p, 3 * L, 7), 3)
    B3, C3 = (_rows(_ints(p, 3, 8 + i), 3) for i in range(2))
    before = df.mont_mul.launches
    with jax.disable_jit():
        for sign, jop in ((1, jf.add), (-1, jf.sub)):
            cases = [
                (df.mont_mul(fs_, a, b, c, sign),
                 jop(js, jf.mont_mul(js, _j(a), _j(b)), _j(c))),
                (df.mont_mul(fs_, a, col, c, sign),
                 jop(js, jf.mont_mul(js, _j(a), _j(col)), _j(c))),
                (df.mont_mul(fs_, a, b, col, sign),
                 jop(js, jf.mont_mul(js, _j(a), _j(b)), _j(col))),
                (df.mont_mul(fs_, A3, B3, C3, sign),
                 jop(js, jf.mont_mul(js, _j(A3), _j(B3)), _j(C3))),
            ]
            for got, want in cases:
                assert _same(got, want)
    # the fused form equals the separate product and add, and no launch ran
    assert torch.equal(df.mont_mul(fs_, a, b, c),
                       df.add(fs_, df.mont_mul(fs_, a, b), c))
    assert df.mont_mul.launches == before
    with pytest.raises(ValueError, match="sign"):
        df.mont_mul(fs_, a, b, c, 0)


def _edge_pairs(p: int) -> tuple[list[int], list[int]]:
    """Operand pairs at the edges of the carry chains: sums of p - 1 and
    p - 2 (at and above 2^256 where 2p > 2^256), sums and differences
    that ripple through runs of 0xFFFF limbs, equal operands, zeros."""
    big = (1 << 240) - 1  # fifteen 0xFFFF limbs
    xs = [p - 1, p - 1, p - 2, big, 1 << 240, 0, 1, p - 1, big, 0, 5]
    ys = [p - 1, 1, p - 1, 1, 1, p - 1, p - 1, 0, big, 0, 7]
    return xs, ys


@pytest.mark.parametrize("which", ["fq", "fr"])
@pytest.mark.parametrize("name", CURVES)
def test_add_sub_neg_at_the_edges_match_jax(name, which):
    """add, sub and neg (on the CPU their plain versions) == JAX add, sub,
    neg and the host ints, at the edge pairs and on numpy draws; add and
    sub with a (16, 1) operand on either side."""
    f, fs_, js = _fields(name, which)
    p = f.p
    ex, ey = _edge_pairs(p)
    xs = ex + _ints(p, LANES - len(ex), 40)
    ys = ey + _ints(p, LANES - len(ey), 41)[::-1]
    a, b = ints_to_limbs(xs), ints_to_limbs(ys)
    col = b[:, 1:2]
    with jax.disable_jit():
        for got, want, ints in (
                (df.add(fs_, a, b), jf.add(js, _j(a), _j(b)),
                 [(x + y) % p for x, y in zip(xs, ys)]),
                (df.sub(fs_, a, b), jf.sub(js, _j(a), _j(b)),
                 [(x - y) % p for x, y in zip(xs, ys)]),
                (df.neg(fs_, a), jf.neg(js, _j(a)), [(-x) % p for x in xs]),
                (df.add(fs_, col, a), jf.add(js, _j(col), _j(a)),
                 [(ys[1] + x) % p for x in xs]),
                (df.sub(fs_, col, a), jf.sub(js, _j(col), _j(a)),
                 [(ys[1] - x) % p for x in xs]),
                (df.sub(fs_, a, col), jf.sub(js, _j(a), _j(col)),
                 [(x - ys[1]) % p for x in xs])):
            assert _same(got, want)
            assert limbs_to_ints(got) == ints
    assert df.add_sub.launches == 0


@pytest.mark.parametrize("name", CURVES)
def test_sum_mod_matches_jax(name):
    """sum_mod over 1, 2 and 16 lanes, on rows of numpy draws and on rows
    of p - 1 (the widest carries), == JAX sum_mod and the host ints."""
    f, fs_, js = _fields(name, "fr")
    p = f.p
    for L in (1, 2, LANES):
        rows = torch.stack([ints_to_limbs(_ints(p, L, 50 + L)),
                            ints_to_limbs([p - 1] * L),
                            ints_to_limbs(_ints(p, L, 60 + L)[::-1])])
        got = df.sum_mod(fs_, rows)
        assert got.shape == (3, 16, 1) and got.dtype == torch.int64
        with jax.disable_jit():
            want = jf.sum_mod(js, _j(rows), axis=1)
        assert torch.equal(got[..., 0], torch.from_numpy(
            np.asarray(want).astype(np.int64)))
        assert [limbs_to_ints(got[r])[0] for r in range(3)] == [
            sum(limbs_to_ints(rows[r])) % p for r in range(3)]
        assert torch.equal(df.dot_mod(fs_, rows, rows), df.sum_mod(
            fs_, df.mont_mul(fs_, rows, rows)))
    assert df.sum_mod.launches == 0


def test_vector_phase_matches_jax():
    """prove._poly_phase (l1, r1, r3 fused with their adds, the t sums in
    one add launch) at padded_n = 16 on zorro's scalar field (secq256k1's:
    tests/test_torch_prove.py)."""
    n, lg_n = LANES, 4
    f, fs_, js = _fields("zorro", "fr")
    p = f.p
    vecs = [ints_to_limbs(_ints(p, n, 70 + i)) for i in range(8)]
    y, y_inv = (ints_to_limbs([v]) for v in _ints(p, 5, 80)[3:])
    t, coeffs = prove._poly_phase(fs_, n, lg_n, *vecs, y, y_inv)
    # one compiled program: fewer seconds than its eager operations
    jt, jcoeffs = jax.jit(jprove._poly_phase, static_argnums=(0, 1, 2))(
        js, n, lg_n, *(_j(v) for v in vecs), _j(y)[0], _j(y_inv)[0])
    assert torch.equal(t[..., 0], torch.from_numpy(
        np.asarray(jt).astype(np.int64)))
    for cp, cj in zip(coeffs, jcoeffs):
        assert torch.equal(cp.long(), _t(cj))


@pytest.mark.parametrize("name", CURVES)
def test_evaluation_matches_jax(name):
    """prove._eval_phase (Horner, l and r side by side, three fused
    launches) == JAX _eval_phase on the same six Montgomery coefficient
    vectors, at x = 0, 1 and a numpy draw."""
    f, fs_, js = _fields(name, "fr")
    p, R = f.p, f.R
    coeffs = [ints_to_limbs([v * R % p for v in _ints(p, LANES, 85 + i)])
              for i in range(6)]
    for x in _ints(p, 4, 89)[:2] + _ints(p, 4, 89)[3:]:
        xl = ints_to_limbs([x])
        lr = prove._eval_phase(fs_, coeffs, xl)
        with jax.disable_jit():
            jlr = jprove._eval_phase(js, [_j(c) for c in coeffs], _j(xl)[0])
        for v, jv in zip(lr, jlr):
            assert _same(v, jv)


@pytest.mark.parametrize("name", CURVES)
def test_fold_matches_jax(name):
    """ipa._fold (the products of a u and b u^-1 added inside the second
    product launch) == JAX _fold at N = 16, rounds cur = 16 and 8, for
    one proof and for a lockstep batch of two."""
    N = 16
    f, fs_, js = _fields(name, "fr")
    p, R = f.p, f.R

    def mont(xs):
        return ints_to_limbs([v * R % p for v in xs])

    state = [mont(_ints(p, N, 90 + i)) for i in range(4)]
    other = [mont(_ints(p, N, 95 + i)) for i in range(4)]
    us = _ints(p, 7, 99)[3:]
    u, ui, u2, ui2 = (mont([v]) for v in us)
    jstate = [_j(v) for v in state]
    batch = [torch.stack([s, o]) for s, o in zip(state, other)]
    U, Ui = torch.stack([u, u2]), torch.stack([ui, ui2])
    for cur in (16, 8):
        m = cur // 2
        with jax.disable_jit():
            want = jipa._fold(js, *jstate, _j(u)[0], _j(ui)[0],
                              jnp.uint32(m), jnp.uint32(cur - 1))
        got = ipa._fold(fs_, *state, u, ui, m, cur)
        for g, w in zip(got, want):
            assert _same(g.long(), w)
        got_b = ipa._fold(fs_, *batch, U, Ui, m, cur)
        for g, w in zip(got_b, got):
            assert torch.equal(g[0].long(), w.long())
        state, jstate = list(got), list(want)
        batch = [torch.stack([g, b[1]]) for g, b in zip(got, got_b)]


@pytest.mark.parametrize("name", CURVES)
def test_mont_inv_batch_with_rows_matches_jax(name):
    """fs.mont_inv_batch over 16 lanes with zero lanes, with rows
    multiplied in (the shrink's affine X / Z, Y / Z): the rows by the
    inverses == JAX mont_mul, and a row of Montgomery ones gives the
    inverses themselves == the host's (tests/test_torch_fs.py holds the
    plain version against the JAX mont_inv_batch)."""
    f, fs_, js = _fields(name, "fq")
    p, R = f.p, f.R
    zs = _ints(p, LANES, 110)
    zs[4] = zs[7] = 0
    z = ints_to_limbs([v * R % p for v in zs])
    rows = torch.cat([_rows(_ints(p, 2 * LANES, 111), 2),
                      df.mont_one(fs_, LANES, "cpu")[None].long()])
    got = fs.mont_inv_batch(fs_, z, rows)
    assert got.shape == (3, 16, LANES)
    inv = got[2]
    assert [v * f.R_inv % p for v in limbs_to_ints(inv)] == [
        pow(v, -1, p) if v else 0 for v in zs]
    with jax.disable_jit():
        want = jf.mont_mul(js, _j(rows), _j(inv))
    assert _same(got.long(), want)
    assert fs.mont_inv_batch.launches == 0


# --- the twisted-Edwards doubling chain --------------------------------


def _te_points(n: int, seed: int) -> list:
    """n host affine curve25519 points: multiples of B by numpy scalars,
    the identity at lane 1 when n > 1."""
    curve = curves.curve25519
    B = PedersenGens.default(curve).B
    ks = np.random.default_rng(seed).integers(1, 1 << 62, size=n)
    pts = [curve.mul(B, int(k)) for k in ks]
    if n > 1:
        pts[1] = curve.zero()
    return pts


def _ext(pts, seed) -> torch.Tensor:
    """Host affine points -> (4, 16, m) int32 Montgomery extended limbs
    with a random Z from numpy."""
    f = curves.curve25519.fq
    zs = np.random.default_rng(seed).integers(1, 1 << 62, size=len(pts))
    cols = [(x * int(z), y * int(z), x * y * int(z), int(z))
            for (x, y), z in zip(pts, zs)]
    return torch.stack([ints_to_limbs([c[i] % f.p * f.R % f.p for c in cols])
                        for i in range(4)])


def _k(t: torch.Tensor):
    """(16, L) limbs -> the JAX kernel bodies' list of 16 (L,) vectors."""
    return [jnp.asarray(t[i].numpy().astype(np.uint32)) for i in range(16)]


def _kpoint(P: torch.Tensor):
    return tuple(_k(c) for c in P)


def _from_k(P) -> torch.Tensor:
    return torch.stack([torch.from_numpy(np.stack(
        [np.asarray(v) for v in c]).astype(np.int64)) for c in P])


def _flat(T: torch.Tensor) -> torch.Tensor:
    """(..., 16, S, L) -> (..., 16, S L): rows side by side as lanes."""
    return T.reshape(*T.shape[:-2], -1)


@pytest.mark.parametrize("steps", [1, 2, 255])
def test_te_double_chain_matches_kernel_body(steps):
    """kk.te_double(spec, P, steps) == JAX _k_te_double looped: one step
    gives 2P (4, 16, m); more give the rows P, ..., 2^steps P as (4, 16,
    steps + 1, m), row i from row i - 1 (at 255 steps every row from the
    row before it in one eager call, which by induction is the loop).
    Lanes: the identity, and points with random Z."""
    curve = curves.curve25519
    spec = tc.spec_for(curve)
    jspec = jc.spec_for(jax_pkg.curves.curve25519)
    pts = _te_points(3, steps)
    P = _ext(pts, steps).int()
    got = kk.te_double(spec, P, steps)
    assert kk.te_double.launches == 0 and got.dtype == torch.int32
    if steps == 1:
        assert got.shape == (4, 16, 3)
        assert torch.equal(got.long(),
                           _from_k(jk._k_te_double(jspec, _kpoint(P))))
        assert tc.point_batch_to_host(curve, got) == [curve.double(q)
                                                      for q in pts]
        return
    assert got.shape == (4, 16, steps + 1, 3)
    assert torch.equal(got[:, :, 0], P)
    if steps == 2:
        acc = _kpoint(P)
        for i in (1, 2):
            acc = jk._k_te_double(jspec, acc)
            assert torch.equal(got[:, :, i].long(), _from_k(acc)), i
    else:
        want = jk._k_te_double(jspec, _kpoint(_flat(got[:, :, :-1])))
        assert torch.equal(_flat(got[:, :, 1:]).long(), _from_k(want))
    assert tc.point_batch_to_host(curve, got[:, :, steps].contiguous()) == [
        curve.mul_bigint(q, 1 << steps) for q in pts]


def test_te_q_doubles_and_commit_table_equal_single_doublings():
    """The TE 2^i Q table of the on-device Fiat-Shamir IPA and the commit
    table's 2^i B | 2^i B_blinding, one chain call each, equal 255 single
    doublings, and their rows are 2^i Q, 2^i B and 2^i B_blinding."""
    curve = curves.curve25519
    spec = tc.spec_for(curve)
    Q = _te_points(1, 120)[0]
    table = ipa._q_doubles(curve, Q, "cpu")
    assert table.dtype == torch.int32 and table.shape == (4, 16, 256)
    rows = [table[..., :1].contiguous()]
    for _ in range(255):
        rows.append(kk.te_double(spec, rows[-1]))
    assert torch.equal(table, torch.cat(rows, dim=-1))
    assert tc.point_batch_to_host(curve, table[..., [0, 1, 200]]) == [
        curve.mul_bigint(Q, 1 << i) for i in (0, 1, 200)]
    pc = PedersenGens.default(curve)
    tab = cache.commit_table(pc, "cpu")
    assert tab.dtype == torch.int32 and tab.shape == (4, 16, 512)
    pair = torch.stack([tab[..., 0], tab[..., 256]], dim=-1).contiguous()
    rows = [pair]
    for _ in range(255):
        rows.append(kk.te_double(spec, rows[-1]))
    want = torch.stack(rows, dim=-1)  # (4, 16, 2, 256)
    assert torch.equal(tab, want.reshape(4, 16, 512))
    assert tc.point_batch_to_host(curve, tab[..., [0, 255, 256, 511]]) == [
        pc.B, curve.mul_bigint(pc.B, 1 << 255), pc.B_blinding,
        curve.mul_bigint(pc.B_blinding, 1 << 255)]
    assert kk.te_double.launches == 0
