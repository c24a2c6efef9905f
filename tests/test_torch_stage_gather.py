"""The v2 MSM's stage-B gather (`ops/gather.py::stage_gather`) vs the JAX
package's `ops/msm2.py::_stage_gather`, and a transcription of its CUDA
kernel's index arithmetic.

Tolerances, all exact (bit-equal int32 limbs):
- `stage_gather_plain` equals the JAX `_stage_gather` (an XLA gather of the
  packed x | y << 16 rows and a transpose to (R, 16, L)) unpacked into
  (2, R, 16, L): x = XY & 0xFFFF, y = XY >> 16; at n = 256 (R = 1),
  n = 1024, n = 4096 (R = 4) and B = 2, with and without a base_map over a
  table wider than n, with identity rows. The JAX plan's R and C are
  passed to the port's function.
- `_transcribed`, the kernel `csrc/gather_kernels.cu::stage_gather_kernel`
  written out in torch block by block (its block order, tile, the order
  element each thread reads, the shared-memory slot each point lands in,
  and the (t, r, limb, lane) each thread writes), equals
  `stage_gather_plain`, and writes every output word exactly once: at
  R = 1, a row tile that does not divide R, lanes that do not fill the
  last tile, B > 1 with a base map, int32 and int64 orders.
- `stage_table_plain`, the table kernel's plain form, gathered by the
  sort order equals the JAX `_stage_gather`'s packed rows as they are.
- The wrappers reject bad dtypes, shapes and a non-contiguous order, and
  on CPU tensors run their plain versions with `launches` unchanged.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_bulletproofs_tpu.ops import msm2 as jmsm2
from ark_bulletproofs_tpu_torch.ops import gather
from ark_bulletproofs_tpu_torch.ops import msm2

torch.set_num_threads(1)

# csrc/gather_kernels.cu's stage_gather tile, read from the source the
# card builds
with open(os.path.join(os.path.dirname(gather.__file__), "..", "csrc",
                       "gather_kernels.cu")) as _fh:
    _CU = _fh.read()


def _define(name):
    return int(re.search(rf"^#define {name} (\d+)$", _CU, re.M).group(1))


POINTS, ROWS = _define("STAGE_POINTS"), _define("STAGE_ROWS")
ROW_WORDS = 16  # a table row: x | y << 16 of each limb


def _inputs(seed, m, n, BW, B=None):
    """(16, m) limbs, identity rows, a (BW, n) order of random
    permutations and, with B, a (B, n) base map into the m table rows."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 1 << 16, size=(16, m), dtype=np.int64)
    Y = rng.integers(0, 1 << 16, size=(16, m), dtype=np.int64)
    inf = rng.random(m) < 0.2
    base = None
    if B is None:
        order = np.stack([rng.permutation(m)[:n] for _ in range(BW)])
    else:
        order = np.stack([rng.permutation(n) for _ in range(BW)])
        base = rng.integers(0, m, size=(B, n))
    return X, Y, inf, order, base


def _t(a, dtype=torch.int32):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dtype)


@pytest.mark.parametrize("n,B,c,mapped", [
    (256, 1, 8, False), (1024, 1, 8, False), (1024, 2, 8, False),
    (256, 2, 8, True), (4096, 1, 16, False), (4096, 2, 16, True)],
    ids=lambda v: str(v))
def test_plain_matches_jax_stage_gather(n, B, c, mapped):
    g = jmsm2._Cfg(n, c, B)
    m = n + 100 if mapped else n
    X, Y, inf, order, base = _inputs(n + B + c, m, n, g.BW,
                                     B if mapped else None)
    want = jmsm2._stage_gather(
        g, jnp.asarray(X.T.astype(np.uint32)),
        jnp.asarray(Y.T.astype(np.uint32)), jnp.asarray(inf),
        jnp.asarray(order.astype(np.int32)),
        None if base is None else jnp.asarray(base.astype(np.int32)))
    want = np.asarray(want).astype(np.int64)  # (R, 16, L) packed
    want = np.stack([want & 0xFFFF, want >> 16])
    got = gather.stage_gather_plain(_t(X), _t(Y), _t(inf, torch.bool),
                                    _t(order, torch.int64), g.R, g.C, g.W,
                                    _t(base, torch.int64))
    assert got.dtype == torch.int32 and got.shape == (2, g.R, 16, g.L)
    assert np.array_equal(got.numpy(), want)
    assert inf.any() and (got[1] == 0).any()


@pytest.mark.parametrize("n,B,c,mapped", [
    (256, 2, 8, True), (1024, 1, 8, False), (4096, 2, 16, True)],
    ids=lambda v: str(v))
def test_stage_table_matches_jax_packing(n, B, c, mapped):
    """The table kernel's rows, gathered as the JAX plan gathers them,
    equal its packed (R, 16, L) output word for word."""
    g = jmsm2._Cfg(n, c, B)
    m = n + 50 if mapped else n
    X, Y, inf, order, base = _inputs(3 * n + B, m, n, g.BW,
                                     B if mapped else None)
    want = jmsm2._stage_gather(
        g, jnp.asarray(X.T.astype(np.uint32)),
        jnp.asarray(Y.T.astype(np.uint32)), jnp.asarray(inf),
        jnp.asarray(order.astype(np.int32)),
        None if base is None else jnp.asarray(base.astype(np.int32)))
    tbl = gather.stage_table(_t(X), _t(Y), _t(inf, torch.bool))
    assert torch.equal(tbl, gather.stage_table_plain(
        _t(X), _t(Y), _t(inf, torch.bool)))
    rows = torch.from_numpy(order)
    if base is not None:
        rows = torch.gather(torch.from_numpy(base).repeat_interleave(
            g.W, dim=0), 1, rows)
    rows = rows.reshape(g.BW, g.C, g.R).permute(2, 0, 1).reshape(g.R, g.L)
    got = tbl[rows].permute(0, 2, 1).numpy().view(np.uint32)
    assert got.shape == (g.R, 16, g.L)
    assert np.array_equal(got, np.asarray(want))


def _transcribed(X, Y, inf, order, R, C, W, base_map=None):
    """stage_gather_kernel and its launcher in torch: every block of the
    grid, every thread of each phase, the kernel's integer formulas."""
    assert POINTS & (POINTS - 1) == 0
    tbl = gather.stage_table_plain(X, Y, inf).reshape(-1)  # (m * 16,)
    m = X.shape[1]
    BW, n = order.shape
    L = BW * C
    lg_tr = 0
    while (2 << lg_tr) <= ROWS and (2 << lg_tr) <= R:
        lg_tr += 1
    tr = 1 << lg_tr
    lg_tl = POINTS.bit_length() - 1 - lg_tr
    tl = 1 << lg_tl
    ntr, nlt = -(-R // tr), -(-L // tl)
    b = torch.arange(nlt * ntr)[:, None]  # blockIdx.x
    rt, lt = b // nlt, b % nlt  # a row tile's lane tiles in a run
    l0, r0 = lt << lg_tl, rt << lg_tr
    ordf = order.reshape(-1).long()
    # the order: thread f reads slot (lane, rr) of the tile
    f = torch.arange(0, POINTS, 1)[None, :].expand(b.shape[0], POINTS)
    lane, rr = f >> lg_tr, f & (tr - 1)
    lg, rg = l0 + lane, r0 + rr
    ok = (lg < L) & (rg < R)
    bw, col = lg // C, lg - (lg // C) * C
    at = (bw * n + col * R + rg).clamp(0, ordf.numel() - 1)
    v = ordf[at]
    if base_map is not None:
        assert bool(((v >= 0) & (v < n))[ok].all())
        v = base_map.reshape(-1).long()[((bw // W) * n + v).clamp(
            0, base_map.numel() - 1)]
    v = torch.where(ok, v, -1)
    assert bool(((v >= 0) & (v < m))[ok].all())
    sidx = torch.full((b.shape[0], POINTS), -7, dtype=torch.long)
    sidx.scatter_(1, (rr << lg_tl) + lane, v)
    assert bool((sidx != -7).all())
    # the rows: thread f loads vector f % VEC of point f / VEC
    vec = ROW_WORDS // 4
    f = torch.arange(POINTS * vec)[None, :]
    row = sidx[:, f[0] // vec]
    words = (row.clamp(min=0) * vec + f % vec)[..., None] * 4 + torch.arange(4)
    q = torch.where((row >= 0)[..., None], tbl[words], 0)
    srow = q.reshape(b.shape[0], POINTS, ROW_WORDS)
    # the transpose: thread f writes lane f % tl of limb k of row rr
    out = torch.zeros(2 * R * 16 * L, dtype=torch.int32)
    hits = torch.zeros(2 * R * 16 * L, dtype=torch.int32)
    f = torch.arange(16 * POINTS)[None, :]
    lane, k, rr = f & (tl - 1), (f >> lg_tl) & 15, f >> (lg_tl + 4)
    lg, rg = l0 + lane, r0 + rr
    ok = (lg < L) & (rg < R)
    w = srow[b, (rr << lg_tl) + lane, k.expand_as(lg)]
    o = ((rg * 16 + k) * L + lg)[ok]
    plane = R * 16 * L
    for t, word in ((0, w & 0xFFFF), (1, (w >> 16) & 0xFFFF)):
        out[t * plane + o] = word[ok].to(torch.int32)
        hits.index_add_(0, t * plane + o,
                        torch.ones_like(o, dtype=torch.int32))
    assert bool((hits == 1).all())  # every word written exactly once
    return out.reshape(2, R, 16, L)


@pytest.mark.parametrize("n,R,B,W,mapped,idx", [
    (256, 1, 1, 2, False, torch.int64),     # R = 1: 256 lanes a tile
    (24, 6, 1, 3, False, torch.int64),      # tr = 4 does not divide R = 6
    (120, 12, 1, 2, False, torch.int64),    # tr = 8 does not divide R = 12
    (12, 3, 2, 2, True, torch.int32),       # tr = 2, B = 2, a base map
    (320, 8, 1, 5, False, torch.int32),     # L = 200: a ragged lane tile
    (64, 16, 3, 2, True, torch.int64),      # B = 3, several row tiles
    (2048, 16, 1, 2, False, torch.int64),   # two row tiles of 8
    (8, 2, 4, 2, True, torch.int64),        # tr = 2, B = 4, a base map
    (512, 1, 2, 3, True, torch.int32),      # R = 1 with a base map
    (96, 32, 1, 3, False, torch.int32),     # four row tiles, C = 3
    (40, 5, 2, 2, False, torch.int64),      # tr = 4 of R = 5, B = 2
    (256, 4, 1, 1, False, torch.int32),     # W = 1
], ids=lambda v: str(v))
def test_kernel_transcription_matches_plain(n, R, B, W, mapped, idx):
    C = n // R
    m = n + 37 if mapped else n
    X, Y, inf, order, base = _inputs(n * R + W, m, n, B * W,
                                     B if mapped else None)
    args = (_t(X), _t(Y), _t(inf, torch.bool), _t(order, idx), R, C, W,
            _t(base))
    want = gather.stage_gather_plain(*args)
    assert torch.equal(_transcribed(*args), want)
    assert torch.equal(gather.stage_gather(*args), want)


def test_msm2_stage_gather_runs_the_wrapper():
    """msm2._stage_gather on CPU tensors is the plain version through the
    wrapper, with the plan's R, C and W, and no launch counted."""
    g = msm2._Cfg(256, 4, 2)
    X, Y, inf, order, base = _inputs(5, 300, 256, g.BW, 2)
    args = (_t(X), _t(Y), _t(inf, torch.bool), _t(order, torch.int64))
    before = gather.stage_gather.launches
    got = msm2._stage_gather(g, *args, _t(base))
    assert torch.equal(got, gather.stage_gather_plain(*args, g.R, g.C, g.W,
                                                      _t(base)))
    assert got.shape == (2, g.R, 16, g.L)
    assert gather.stage_gather.launches == before


def test_stage_table_rejects_bad_inputs_and_runs_plain_on_cpu():
    X, Y, inf, _, _ = _inputs(4, 40, 16, 4)
    X, Y, inf = _t(X), _t(Y), _t(inf, torch.bool)
    before = gather.stage_table.launches
    got = gather.stage_table(X, Y, inf)
    assert got.shape == (40, 16) and got.dtype == torch.int32
    assert torch.equal(got, gather.stage_table_plain(X, Y, inf))
    assert torch.equal(got & 0xFFFF, X.t())
    assert torch.equal(got >> 16 & 0xFFFF,
                       torch.where(inf, 0, Y).t())
    for args, match in [((X.long(), Y, inf), "X"), ((X, Y.long(), inf), "Y"),
                        ((X, Y[:, :39], inf), "must match"),
                        ((X, Y, inf[:39]), "must match"),
                        ((X, Y, inf.int()), "must match"),
                        ((X[:15], Y[:15], inf), "X"),
                        ((X.to("meta"), Y.to("meta"), inf.to("meta")),
                         "device")]:
        with pytest.raises(ValueError, match=match):
            gather.stage_table(*args)
    assert gather.stage_table.launches == before


def test_wrapper_rejects_bad_inputs_and_runs_plain_on_cpu():
    X, Y, inf, order, base = _inputs(9, 40, 16, 4, 2)
    X, Y, inf = _t(X), _t(Y), _t(inf, torch.bool)
    order, base = _t(order, torch.int64), _t(base)
    good = (X, Y, inf, order, 4, 4, 2, base)
    before = gather.stage_gather.launches, gather.stage_table.launches
    assert torch.equal(gather.stage_gather(*good),
                       gather.stage_gather_plain(*good))
    assert (gather.stage_gather.launches,
            gather.stage_table.launches) == before
    bad = [
        ((X.long(), Y, inf, order, 4, 4, 2, base), "X"),
        ((X, Y[:, :39], inf, order, 4, 4, 2, base), "must match"),
        ((X, Y, inf.int(), order, 4, 4, 2, base), "must match"),
        ((X, Y, inf, order.float(), 4, 4, 2, base), "order"),
        ((X, Y, inf, order, 4, 2, 2, base), "is not"),
        ((X, Y, inf, order, 4, 4, 3, None), "is not"),
        ((X, Y, inf, order, 4, 4, 2, base[:1]), "base_map"),
        ((X, Y, inf, order, 4, 4, 2, base.float()), "base_map"),
        ((X, Y, inf, order.t().contiguous().t(), 4, 4, 2, base),
         "contiguous"),
        ((X.to("meta"), Y.to("meta"), inf.to("meta"), order.to("meta"), 4,
          4, 2, base.to("meta")), "device"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            gather.stage_gather(*args)
    assert (gather.stage_gather.launches,
            gather.stage_table.launches) == before
