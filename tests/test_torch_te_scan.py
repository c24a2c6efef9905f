"""The twisted-Edwards v1 row scan of the port (ops/kernels.py `te_madd`
over rows, `madd_scan` on curve25519) vs the JAX package's kernel body.

Tolerances: extended coordinates bit-equal to `_k_te_madd`
(ark_bulletproofs_tpu/ops/kernels.py, run eagerly on lists of 16 (L,)
limb vectors) looped as the JAX package's v1 scan loops it
(ops/msm.py's lax.scan over the flipped rows): the mixed add from row
R - 1 down to row 0. Short scans run that loop literally; the 32-row scan
applies the body once to every row before each output row, all rows in
one eager call (lanes side by side), which by induction over the rows is
the same as the loop. The suffix sums equal the host's in affine. A torch
transcription of csrc/te.cuh::te_madd_grp's level order (t2 of the next
row computed one add ahead, in the second level) is bit-equal to the
plain scan. Lanes hold an identity start, doublings (P = Q at the first
add, and Q_{R-2} = Q_{R-1} from the identity), cancellations (P = -Q, and
Q_{R-2} = -Q_{R-1}), q_inf rows, an all-q_inf lane and (0, 1) as an
ordinary affine point. On the CPU every kernel wrapper runs its plain
version.
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
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops import proj
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs

torch.set_num_threads(1)

CURVE = curves.curve25519
M = 10  # lanes of a scan case, see _scan_case


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _specs():
    return tc.spec_for(CURVE), jc.spec_for(jax_pkg.curves.curve25519)


def _ext(pts, seed) -> torch.Tensor:
    """Host affine points -> (4, 16, m) Montgomery extended limbs with a
    random Z from numpy (the identity (0, 1) too: (0 : Z : 0 : Z))."""
    f = CURVE.fq
    zs = np.random.default_rng(seed).integers(1, 1 << 62, size=len(pts))
    cols = [(x * int(z), y * int(z), x * y * int(z), int(z))
            for (x, y), z in zip(pts, zs)]
    return torch.stack([ints_to_limbs([c[i] % f.p * f.R % f.p
                                       for c in cols])
                        for i in range(4)]).int()


def _scan_case(R, seed):
    """P (host list of M points) and R rows of affine Q by lane: 0 P = O;
    1 P = O, Q_{R-2} = Q_{R-1} (a doubling at the second add); 2 P = O,
    Q_{R-2} = -Q_{R-1} (a cancellation, then adds from O); 3 Q_{R-1} = P
    (a doubling at the first add); 4 Q_{R-1} = -P; 5 every other row
    q_inf; 6 P = O and every row q_inf; 7 Q_{R-1} = (0, 1), the identity
    as an ordinary affine point (see _rows); 8-9 random."""
    rng = seeded_rng(seed)
    P = [CURVE.rand(rng) for _ in range(M)]
    Q = [[CURVE.rand(rng) for _ in range(M)] for _ in range(R)]
    for lane in (0, 1, 2, 6):
        P[lane] = CURVE.zero()
    if R >= 2:
        Q[R - 2][1] = Q[R - 1][1]
        Q[R - 2][2] = CURVE.neg(Q[R - 1][2])
    Q[R - 1][3] = P[3]
    Q[R - 1][4] = CURVE.neg(P[4])
    Q[R - 1][7] = CURVE.zero()
    for r in range(R):
        Q[r][6] = CURVE.zero()
        if r % 2 == 0:
            Q[r][5] = CURVE.zero()
    return P, Q


def _rows(Q):
    """Host rows -> (R, 16, M) Qx, Qy and (R, M) q_inf; lane 7's identity
    in row R - 1 stays an ordinary point (0, 1): x = 0, y = R, q_inf
    clear."""
    X, Y, inf = (torch.stack(t).contiguous() for t in zip(
        *(tc.affine_to_device(CURVE, row) for row in Q)))
    f = CURVE.fq
    X[-1, :, 7] = 0
    Y[-1, :, 7] = ints_to_limbs([f.R % f.p])[:, 0].int()
    inf[-1, 7] = False
    return X, Y, inf


def _case(R, seed):
    spec, jspec = _specs()
    Pa, Qa = _scan_case(R, seed)
    return spec, jspec, Pa, Qa, _ext(Pa, seed), *_rows(Qa)


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
def test_te_madd_rows_match_kernel_body(R):
    spec, jspec, Pa, Qa, P, qx, qy, qi = _case(R, 500 + R)
    got = kk.te_madd(spec, P, qx, qy, qi)
    assert got.dtype == torch.int32 and got.shape == (4, R, 16, M)
    assert kk.te_madd.launches == 0  # CPU tensors: the plain version
    assert torch.equal(got, kk.te_madd_plain(spec, P, qx, qy, qi))
    if R <= 5:  # the JAX scan's loop, literally
        acc = _kpoint(P)
        for r in range(R - 1, -1, -1):
            acc = jk._k_te_madd(jspec, acc, _k(qx[r]), _k(qy[r]),
                                jnp.asarray(qi[r].numpy()))
            assert torch.equal(got[:, r].long(), _from_k(acc)), r
    else:  # every row from the row after it (P for the last), one call
        prev = torch.cat([got[:, 1:], P.unsqueeze(1)], dim=1)
        want = jk._k_te_madd(
            jspec, _kpoint(_flat(prev.permute(0, 2, 1, 3))),
            _k(_flat(qx.permute(1, 0, 2))), _k(_flat(qy.permute(1, 0, 2))),
            jnp.asarray(qi.reshape(-1).numpy()))
        assert torch.equal(_flat(got.permute(0, 2, 1, 3)).long(),
                           _from_k(want))
    for r in (0, R - 1):  # the affine suffix sums
        want_aff = []
        for lane in range(M):
            acc = Pa[lane]
            for j in range(R - 1, r - 1, -1):
                acc = CURVE.add(acc, Qa[j][lane])
            want_aff.append(acc)
        assert tc.point_batch_to_host(CURVE, got[:, r]) == want_aff
    if R == 1:  # the one-row form
        one = kk.te_madd(spec, P, qx[0], qy[0], qi[0])
        assert one.shape == (4, 16, M) and torch.equal(one, got[:, 0])


def _grp_scan(spec, P, qx, qy, qi) -> torch.Tensor:
    """csrc/te.cuh::te_madd_grp driven by point_kernels.cuh's
    madd_scan_kernel, in torch: each row's add in three product levels,
    {X1 qx, Y1 qy, T1 t2, (X1 + Y1)(qx + qy)}, {C = (T1 t2) d, a A, the
    next row's t2}, {E F, G H, E H, F G}, with D = Z1; t2 of the first row
    before the loop; every lane through every level, then the q_inf
    select."""
    fs = spec.fq
    R, _, m = qx.shape
    d = df.const(spec.d_mont_limbs, "cpu").expand(16, m)
    a = df.const(spec.a_mont_limbs, "cpu").expand(16, m)

    def mul(xs, ys):
        return df.mont_mul_plain(fs, torch.stack([v.long() for v in xs]),
                                 torch.stack([v.long() for v in ys]))

    def add(x, y):
        return df.add_plain(fs, x, y)

    def sub(x, y):
        return df.sub_plain(fs, x, y)

    out = torch.empty((4, R, 16, m), dtype=torch.int32)
    acc = P.long()
    t2 = mul([qx[R - 1]], [qy[R - 1]])[0]
    for r in range(R - 1, -1, -1):
        x, y = qx[r].long(), qy[r].long()
        r1 = max(r - 1, 0)
        X1, Y1, T1, Z1 = acc
        A, B, TT, E0 = mul([X1, Y1, T1, add(X1, Y1)], [x, y, t2, add(x, y)])
        C, aA, nt2 = mul([TT, A, qx[r1]], [d, a, qy[r1]])
        E, F, G, H = sub(E0, add(A, B)), sub(Z1, C), add(Z1, C), sub(B, aA)
        new = mul([E, G, E, F], [F, H, H, G])
        acc = proj.select(qi[r], acc, new)
        out[:, r] = acc
        t2 = nt2
    return out


@pytest.mark.parametrize("R", [1, 2, 5, 32])
def test_group_level_order_matches_plain_scan(R):
    spec, _, _, _, P, qx, qy, qi = _case(R, 600 + R)
    assert torch.equal(_grp_scan(spec, P, qx, qy, qi),
                       kk.te_madd_plain(spec, P, qx, qy, qi))


def test_madd_scan_on_te_is_one_te_madd_call(monkeypatch):
    """kernels.madd_scan on curve25519 calls te_madd once over all rows
    (the row scan's one launch on the card), never jac_madd."""
    spec, _, _, _, P, qx, qy, qi = _case(5, 700)
    calls = []
    te_madd = kk.te_madd

    def counted(*args):
        calls.append(args[2].shape)
        return te_madd(*args)

    monkeypatch.setattr(kk, "te_madd", counted)
    monkeypatch.setattr(kk, "jac_madd", None)
    got = kk.madd_scan(spec, P, qx, qy, qi)
    assert calls == [(5, 16, M)]
    assert torch.equal(got, kk.te_madd_plain(spec, P, qx, qy, qi))


def test_te_madd_rejects_bad_input():
    spec = tc.spec_for(CURVE)
    P = tc.point_zero(spec, 4, "cpu").int()
    X = torch.zeros(2, 16, 4, dtype=torch.int32)
    inf = torch.zeros(2, 4, dtype=torch.bool)
    with pytest.raises(ValueError):
        kk.te_madd(spec, P, X, X, inf[0])  # q_inf of one row
    with pytest.raises(ValueError):
        kk.te_madd(spec, P, X, X[0], inf)  # Qy of one row
    with pytest.raises(ValueError):
        kk.te_madd(spec, P[:3].contiguous(), X, X, inf)  # 3 coordinates
    with pytest.raises(ValueError):
        kk.te_madd(spec, P, X[..., :3].contiguous(),
                   X[..., :3].contiguous(), inf[:, :3].contiguous())
    with pytest.raises(ValueError):
        kk.te_madd(spec, P, X, X, inf.int())  # q_inf not bool
    with pytest.raises(TypeError):
        kk.te_madd(tc.spec_for(curves.secq256k1),
                   tc.point_zero(tc.spec_for(curves.secq256k1), 4,
                                 "cpu").int(), X, X, inf)
