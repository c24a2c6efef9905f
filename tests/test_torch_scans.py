"""Plain versions of the three scan kernels vs loops of the JAX plain group law.

Tolerance: bit-equal projective coordinates. suffix_madd_scan,
suffix_jac_scan and rowsum (on CPU tensors the wrappers run their plain
versions) are held against row loops of the JAX package's `add_mixed` /
`_add_xla` in the order the TPU kernels add, at R in {1, 8} rows and 8
lanes, with identity rows, doublings and P + (-P) in the columns; totals
also against the host model.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_bulletproofs_tpu import curves as jcurves
from ark_bulletproofs_tpu.ops import curve as jc
from ark_bulletproofs_tpu.ops import proj as jp
from ark_bulletproofs_tpu_torch import curves, engine, seeded_rng
from ark_bulletproofs_tpu_torch.ops import curve as tc
from ark_bulletproofs_tpu_torch.ops import kernels2 as k2

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _jspec(curve):
    """The JAX package's CurveSpec of the port's curve."""
    return jc.spec_for(jcurves.ALL_CURVES[curve.name])

L = 8


def _rows(curve, R, seed):
    """(2, R, 16, L) affine rows + the host points; column 0 repeats its
    point (doublings), column 1 alternates P, -P, column 2 holds
    identity rows (y = 0)."""
    rng = seeded_rng(seed)
    pts = [[curve.rand(rng) for _ in range(L)] for _ in range(R)]
    for r in range(R):
        pts[r][0] = pts[0][0]
        pts[r][1] = pts[0][1] if r % 2 else curve.neg(pts[0][1])
        if r % 3 == 0:
            pts[r][2] = None
    X, Y = [], []
    for row in pts:
        x, y, inf = tc.affine_to_device(curve, row)
        X.append(x)
        Y.append(torch.where(inf, 0, y))
    return torch.stack([torch.stack(X), torch.stack(Y)]), pts


def _j(t: torch.Tensor):
    return jnp.asarray(np.ascontiguousarray(t.numpy().T.astype(np.uint32)))


def _jpoint(P: torch.Tensor):
    return tuple(_j(c) for c in P)


def _t(P) -> torch.Tensor:
    return torch.stack([torch.from_numpy(np.asarray(c).T.astype(np.int32))
                        for c in P])


def _ident(jspec):
    return jp.point_zero(jspec, (L,))


# The JAX loops run eagerly at about a second per row: each scan takes
# both row counts and both curves, but not every combination.
MADD_CASES = [(curves.secq256k1, 1), (curves.secq256k1, 8), (curves.zorro, 8)]
CASES = [(curves.secq256k1, 8), (curves.zorro, 1)]


@pytest.mark.parametrize("curve,R", MADD_CASES,
                         ids=[f"{c.name}-{r}" for c, r in MADD_CASES])
def test_suffix_madd_scan(curve, R):
    spec, jspec = tc.spec_for(curve), _jspec(curve)
    xy, pts = _rows(curve, R, R)
    got = k2.suffix_madd_scan(spec, xy)
    assert got.shape == (3, R, 16, L) and got.dtype == torch.int32
    acc = _ident(jspec)
    for r in range(R - 1, -1, -1):
        qx, qy = _j(xy[0, r]), _j(xy[1, r])
        acc = jp.add_mixed(jspec, acc, qx, qy, jnp.all(qy == 0, axis=-1))
        assert torch.equal(got[:, r], _t(acc)), f"row {r}"
    totals = [curve.msm([pts[r][i] for r in range(R)], [1] * R)
              for i in range(L)]
    assert tc.point_batch_to_host(curve, got[:, 0]) == totals


@pytest.mark.parametrize("curve,R", CASES,
                         ids=[f"{c.name}-{r}" for c, r in CASES])
def test_suffix_jac_scan(curve, R):
    spec, jspec = tc.spec_for(curve), _jspec(curve)
    xy, _ = _rows(curve, R, 10 + R)
    T = k2.suffix_madd_scan(spec, xy)
    T[:, :, :, 3] = T[:, :1, :, 3]  # a column of equal rows: doublings
    excl, tot = k2.suffix_jac_scan(spec, T)
    acc = _ident(jspec)
    for r in range(R - 1, -1, -1):
        assert torch.equal(excl[:, r], _t(acc)), f"row {r}"
        acc = jp._add_xla(jspec, acc, _jpoint(T[:, r]))
    assert torch.equal(tot, _t(acc))


@pytest.mark.parametrize("curve,K", CASES,
                         ids=[f"{c.name}-{r}" for c, r in CASES])
def test_rowsum(curve, K):
    spec, jspec = tc.spec_for(curve), _jspec(curve)
    xy, _ = _rows(curve, K, 20 + K)
    T = k2.suffix_madd_scan(spec, xy)
    got = k2.rowsum(spec, T)
    acc = _ident(jspec)
    for r in range(K):
        acc = jp._add_xla(jspec, acc, _jpoint(T[:, r]))
    assert torch.equal(got, _t(acc))
    rows = [tc.point_batch_to_host(curve, T[:, r]) for r in range(K)]
    want = [curve.msm([rows[r][i] for r in range(K)], [1] * K)
            for i in range(L)]
    assert tc.point_batch_to_host(curve, got) == want


def test_scans_reject_bad_input():
    spec = tc.spec_for(curves.secq256k1)
    with pytest.raises(ValueError):
        k2.suffix_madd_scan(spec, torch.zeros(3, 2, 16, 8,
                                              dtype=torch.int32))
    with pytest.raises(TypeError):
        k2.rowsum(spec, torch.zeros(3, 2, 16, 8, dtype=torch.int64))
