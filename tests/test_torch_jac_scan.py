"""The v1 row scan and the Q-table chain of the port (ops/kernels.py
`jac_madd` over rows, `jac_double` with `steps`, `madd_scan`, and
ops/ipa.py::_q_doubles) vs the JAX package's kernel bodies.

Tolerances: Jacobian coordinates bit-equal to `_k_sw_madd` and
`_k_sw_double` (ark_bulletproofs_tpu/ops/kernels.py, run eagerly on lists
of 16 (L,) limb vectors) looped as the JAX package's scans loop them: the
mixed add from row R - 1 down to row 0 (ops/msm.py's lax.scan over
sw_madd_tiled), the doubling 2^i times (ops/ipa.py's Q table). Short
scans run that loop literally; the 32-row scan and the 255-step chain
apply the body once to every row before each output row, all rows in
one eager call (lanes side by side), which by induction over the rows is
the same as the loop. Lanes hold an identity start, doublings (P = Q at
the first add, and Q_{R-2} = Q_{R-1} from the identity), cancellations
(P = -Q, and Q_{R-2} = -Q_{R-1}), q_inf rows and all-q_inf lanes, on
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
from ark_bulletproofs_tpu_torch import curves, engine, seeded_rng
from ark_bulletproofs_tpu_torch.ops import curve as tc
from ark_bulletproofs_tpu_torch.ops import ipa
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

torch.set_num_threads(1)

CURVES = ["secq256k1", "zorro"]
M = 10  # lanes of a scan case, see _scan_case


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _curves(name):
    curve = getattr(curves, name)
    return curve, tc.spec_for(curve), jc.spec_for(getattr(jax_pkg.curves,
                                                          name))


def _jac(curve, pts, seed) -> torch.Tensor:
    """Host affine points -> (3, 16, m) Montgomery Jacobian limbs with a
    random Z from numpy; the identity (None) as (0, 0, 0)."""
    f = curve.fq
    zs = np.random.default_rng(seed).integers(1, 1 << 62, size=len(pts))
    cols = [(0, 0, 0) if pt is None else
            (pt[0] * int(z) ** 2, pt[1] * int(z) ** 3, int(z))
            for pt, z in zip(pts, zs)]
    return torch.stack([ints_to_limbs([c[i] % f.p * f.R % f.p for c in cols])
                        for i in range(3)]).int()


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
        out.append((x * zi * zi % f.p, y * zi ** 3 % f.p))
    return out


def _scan_case(curve, R, seed):
    """P (3, 16, M) Jacobian and R rows of affine Q (host lists) by lane:
    0 P = O; 1 P = O, Q_{R-2} = Q_{R-1} (a doubling at the second add);
    2 P = O, Q_{R-2} = -Q_{R-1} (a cancellation, then adds from O);
    3 Q_{R-1} = P (a doubling at the first add); 4 Q_{R-1} = -P; 5 every
    other row q_inf; 6 P = O and every row q_inf; 7-9 random."""
    rng = seeded_rng(seed)
    P = [curve.rand(rng) for _ in range(M)]
    Q = [[curve.rand(rng) for _ in range(M)] for _ in range(R)]
    for lane in (0, 1, 2, 6):
        P[lane] = None
    if R >= 2:
        Q[R - 2][1] = Q[R - 1][1]
        Q[R - 2][2] = curve.neg(Q[R - 1][2])
    Q[R - 1][3] = P[3]
    Q[R - 1][4] = curve.neg(P[4])
    for r in range(R):
        Q[r][6] = None
        if r % 2 == 0:
            Q[r][5] = None
    return P, Q


def _rows(curve, Q):
    """Host rows of affine points -> (R, 16, M) Qx, Qy and (R, M) q_inf."""
    X, Y, inf = zip(*(tc.affine_to_device(curve, row) for row in Q))
    return (torch.stack(X).contiguous(), torch.stack(Y).contiguous(),
            torch.stack(inf).contiguous())


def _k(t: torch.Tensor):
    """(16, L) limbs -> the JAX kernel bodies' list of 16 (L,) vectors."""
    return [jnp.asarray(t[i].numpy().astype(np.uint32)) for i in range(16)]


def _kpoint(P: torch.Tensor):
    return tuple(_k(c) for c in P)


def _from_k(P) -> torch.Tensor:
    return torch.stack([torch.from_numpy(np.stack(
        [np.asarray(v) for v in c]).astype(np.int64)) for c in P])


def _flat(T: torch.Tensor) -> torch.Tensor:
    """(..., 16, R, L) -> (..., 16, R L): rows side by side as lanes."""
    return T.reshape(*T.shape[:-2], -1)


@pytest.mark.parametrize("R", [1, 2, 5, 32])
@pytest.mark.parametrize("name", CURVES)
def test_madd_rows_match_kernel_body(name, R):
    curve, spec, jspec = _curves(name)
    Pa, Qa = _scan_case(curve, R, seed=100 + R)
    P = _jac(curve, Pa, R)
    qx, qy, qi = _rows(curve, Qa)
    got = kk.jac_madd(spec, P, qx, qy, qi)
    assert got.dtype == torch.int32 and got.shape == (3, R, 16, M)
    assert kk.jac_madd.launches == 0  # CPU tensors: the plain version
    if R <= 5:  # the JAX scan's loop, literally
        acc = _kpoint(P)
        for r in range(R - 1, -1, -1):
            acc = jk._k_sw_madd(jspec, acc, _k(qx[r]), _k(qy[r]),
                                jnp.asarray(qi[r].numpy()))
            assert torch.equal(got[:, r].long(), _from_k(acc)), r
    else:  # every row from the row after it (P for the last), one call
        prev = torch.cat([got[:, 1:], P.unsqueeze(1)], dim=1)
        want = jk._k_sw_madd(
            jspec, _kpoint(_flat(prev.permute(0, 2, 1, 3))),
            _k(_flat(qx.permute(1, 0, 2))), _k(_flat(qy.permute(1, 0, 2))),
            jnp.asarray(qi.reshape(-1).numpy()))
        assert torch.equal(_flat(got.permute(0, 2, 1, 3)).long(),
                           _from_k(want))
    # the affine suffix sums, and the one-row form at R = 1
    for r in (0, R - 1):
        want_aff = []
        for lane in range(M):
            acc = Pa[lane]
            for j in range(R - 1, r - 1, -1):
                acc = curve.add(acc, Qa[j][lane])
            want_aff.append(acc)
        assert _affine(curve, got[:, r]) == want_aff
    if R == 1:
        one = kk.jac_madd(spec, P, qx[0], qy[0], qi[0])
        assert one.shape == (3, 16, M) and torch.equal(one, got[:, 0])


@pytest.mark.parametrize("steps", [1, 2, 255])
@pytest.mark.parametrize("name", CURVES)
def test_double_chain_matches_kernel_body(name, steps):
    curve, spec, jspec = _curves(name)
    rng = seeded_rng(200 + steps)
    pts = [curve.rand(rng) for _ in range(5)]
    pts[1] = None
    P = _jac(curve, pts, steps)
    one = ints_to_limbs([curve.fq.R % curve.fq.p])[:, 0]
    P[:, :, 3] = torch.stack([one, one, torch.zeros_like(one)])
    pts[3] = None  # the identity as (R, R, 0) as well
    got = kk.jac_double(spec, P, steps)
    assert kk.jac_double.launches == 0
    if steps == 1:
        assert got.shape == (3, 16, 5)
        want = _from_k(jk._k_sw_double(jspec, *_kpoint(P)))
        assert torch.equal(got.long(), want)
        assert _affine(curve, got) == [curve.double(p) if p else None
                                       for p in pts]
        return
    assert got.dtype == torch.int32 and got.shape == (3, 16, steps + 1, 5)
    assert torch.equal(got[:, :, 0], P)
    if steps == 2:
        acc = _kpoint(P)
        for i in (1, 2):
            acc = jk._k_sw_double(jspec, *acc)
            assert torch.equal(got[:, :, i].long(), _from_k(acc)), i
    else:  # every row from the row before it, one call
        want = jk._k_sw_double(jspec, *_kpoint(_flat(got[:, :, :-1])))
        assert torch.equal(_flat(got[:, :, 1:]).long(), _from_k(want))
    for i in (1, steps):
        assert _affine(curve, got[:, :, i]) == [
            curve.mul_bigint(p, 1 << i) if p else None for p in pts]


@pytest.mark.parametrize("name", CURVES)
def test_q_doubles_equal_single_doublings(name):
    """The 2^i Q table of the on-device Fiat-Shamir IPA, one chain call,
    equals 255 single doublings, and row i is 2^i Q."""
    curve, spec, _ = _curves(name)
    Q = curve.rand(seeded_rng(300))
    table = ipa._q_doubles(curve, Q, "cpu")
    assert table.dtype == torch.int32 and table.shape == (3, 16, 256)
    rows = [table[..., :1].contiguous()]
    for _ in range(255):
        rows.append(kk.jac_double(spec, rows[-1]))
    assert torch.equal(table, torch.cat(rows, dim=-1))
    assert _affine(curve, table[..., [0, 1, 100, 255]]) == [
        curve.mul_bigint(Q, 1 << i) for i in (0, 1, 100, 255)]


def test_madd_scan_on_te_loops_te_madd():
    """kernels.madd_scan on curve25519: the same suffix sums from one
    te_madd a row."""
    curve = curves.curve25519
    spec = tc.spec_for(curve)
    rng = seeded_rng(400)
    Q = [[curve.rand(rng) for _ in range(4)] for _ in range(3)]
    Q[1][2] = curve.zero()
    qx, qy, qi = _rows(curve, Q)
    P = tc.point_zero(spec, 4, "cpu").int()
    got = kk.madd_scan(spec, P, qx, qy, qi)
    acc = P
    for r in (2, 1, 0):
        acc = kk.te_madd(spec, acc, qx[r], qy[r], qi[r])
        assert torch.equal(got[:, r], acc), r


def test_scan_and_chain_wrappers_reject_bad_input():
    curve, spec, _ = _curves("secq256k1")
    P = tc.point_zero(spec, 4, "cpu").int()
    X = torch.zeros(2, 16, 4, dtype=torch.int32)
    inf = torch.zeros(2, 4, dtype=torch.bool)
    with pytest.raises(ValueError):
        kk.jac_madd(spec, P, X, X, inf[0])  # q_inf of one row
    with pytest.raises(ValueError):
        kk.jac_madd(spec, P, X, X[0], inf)  # Qy of one row
    with pytest.raises(ValueError):
        kk.jac_madd(spec, P, X[..., :3].contiguous(),
                    X[..., :3].contiguous(), inf[:, :3].contiguous())
    for steps in (0, -1, 1 << 31):
        with pytest.raises(ValueError):
            kk.jac_double(spec, P, steps)
    te = tc.spec_for(curves.curve25519)
    with pytest.raises(TypeError):
        kk.jac_double(te, tc.point_zero(te, 4, "cpu").int(), 3)
