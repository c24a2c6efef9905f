"""The port's window Horner (`horner_windows`, `jac_horner_windows`),
`rcb_double` and the row-gather probe, vs the JAX package.

Tolerances, all exact (bit-equal limbs):
- `horner_windows` on RCB projective points (secq256k1, a = 0; zorro,
  a = 6) equals the JAX kernel `horner_windows`'s body run eagerly: the
  identity start, then per window c `_k_rcb_double` and one `_k_rcb_add`;
  on extended points (curve25519) the same with `_k_te_double` /
  `_k_te_add`; `jac_horner_windows` with `_k_sw_double` / `_k_sw_add`.
  W = 3 windows, c = 4, 4 lanes, some parts the identity; the affine
  result equals the host sum.
- Both starts (the identity over all W windows, v1's; the top window over
  the other W - 1, read in place, v2's stage G) equal the W-step loop of
  the double-k-add plain versions.
- `rcb_double` (CPU: its plain version) equals `_k_rcb_double` and the
  JAX XLA law `proj._double_xla`.
- `row_gather_plain` equals `jnp.take` along the rows.
- v1 and v2 MSMs with the Horner kernel's plain version equal the host
  Pippenger, and v2's projective output equals that of the W-step
  double-k-add loop it replaced.
On the CPU every kernel wrapper runs its plain version.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.ops import curve as jc
from ark_bulletproofs_tpu.ops import kernels as jk
from ark_bulletproofs_tpu.ops import proj as jp
from ark_bulletproofs_tpu_torch import curves, engine, seeded_rng
from ark_bulletproofs_tpu_torch.ops import curve as tc
from ark_bulletproofs_tpu_torch.ops import gather
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
from ark_bulletproofs_tpu_torch.ops import msm as v1
from ark_bulletproofs_tpu_torch.ops import msm2
from ark_bulletproofs_tpu_torch.ops import proj as tp
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs
from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device

torch.set_num_threads(1)

B, W, C = 4, 3, 4  # lanes (scalar sets), windows, window bits
# (lane, window) parts that are the identity
IDENT = [(0, 1), (1, 0), (1, 1), (1, 2), (3, 2)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _specs(name):
    curve = getattr(curves, name)
    return curve, tc.spec_for(curve), jc.spec_for(getattr(jax_pkg.curves,
                                                          name))


def _coords(curve, model: str, pt, z: int):
    """Montgomery coordinates of affine pt (the identity: None, or (0, 1)
    on the TE curve) under z: RCB (xz, yz, z), Jacobian (xz^2, yz^3, z),
    TE (xz, yz, xyz, z)."""
    f = curve.fq
    if model == "te":
        x, y = pt
        c = (x * z, y * z, x * y % f.p * z, z)
    elif pt is None:
        c = (0, 1, 0) if model == "rcb" else (0, 0, 0)
    elif model == "rcb":
        c = (pt[0] * z, pt[1] * z, z)
    else:
        c = (pt[0] * z * z, pt[1] * z * z * z, z)
    return [v % f.p * f.R % f.p for v in c]


def _parts(curve, model: str, seed: int):
    """(NC, 16, B, W) int32 parts of random points under random Z, the
    IDENT entries the identity, and their host affine values [b][w]."""
    rng = seeded_rng(seed)
    zs = np.random.default_rng(seed).integers(1, 1 << 62, size=(B, W))
    pts = [[curve.zero() if (b, w) in IDENT else curve.rand(rng)
            for w in range(W)] for b in range(B)]
    cols = [[_coords(curve, model, pts[b][w], int(zs[b, w]))
             for w in range(W)] for b in range(B)]
    nc = len(cols[0][0])
    t = torch.stack([torch.stack([ints_to_limbs([cols[b][w][i]
                                                 for w in range(W)])
                                  for b in range(B)], dim=1)
                     for i in range(nc)])  # (NC, 16, B, W)
    return t.to(torch.int32).contiguous(), pts


def _host_horner(curve, pts, c: int):
    """sum_w 2^(c w) pts[w] on the host model."""
    acc = curve.zero()
    for w in range(len(pts) - 1, -1, -1):
        acc = curve.add(curve.mul_bigint(acc, 1 << c), pts[w])
    return acc


def _klimbs(t: torch.Tensor):
    return [jnp.asarray(t[i].numpy().astype(np.uint32)) for i in range(16)]


def _kpoint(P: torch.Tensor):
    return tuple(_klimbs(c) for c in P)


def _from_k(P) -> torch.Tensor:
    return torch.stack([torch.from_numpy(np.stack(
        [np.asarray(v) for v in c]).astype(np.int32)) for c in P])


def _body_horner(dbl, add, ident, parts: torch.Tensor, c: int):
    """The JAX kernel's loop, eagerly: from `ident`, per window (top
    first) c doublings and one add."""
    acc = _kpoint(ident)
    for w in range(parts.shape[-1] - 1, -1, -1):
        for _ in range(c):
            acc = tuple(list(v) for v in dbl(acc))
        acc = tuple(list(v) for v in add(acc, _kpoint(parts[..., w])))
    return _from_k(acc)


@pytest.mark.parametrize("name", ["secq256k1", "zorro"])
def test_horner_windows_matches_kernel_body_rcb(name):
    curve, spec, jspec = _specs(name)
    parts, pts = _parts(curve, "rcb", seed=1)
    got = k2.horner_windows(spec, parts, C)
    assert got.dtype == torch.int32 and got.shape == (3, 16, B)
    want = _body_horner(lambda P: jk._k_rcb_double(jspec, *P),
                        lambda P, Q: jk._k_rcb_add(jspec, P, Q),
                        tp.point_zero(spec, B, "cpu"), parts, C)
    assert torch.equal(got, want)
    assert tc.point_batch_to_host(curve, got) == [
        _host_horner(curve, pts[b], C) for b in range(B)]
    assert k2.horner_windows.launches == 0  # CPU tensors: the plain version


def test_horner_windows_matches_kernel_body_te():
    curve, spec, jspec = _specs("curve25519")
    parts, pts = _parts(curve, "te", seed=2)
    got = k2.horner_windows(spec, parts, C)
    assert got.shape == (4, 16, B)
    want = _body_horner(lambda P: jk._k_te_double(jspec, P),
                        lambda P, Q: jk._k_te_add(jspec, P, Q),
                        tp.point_zero(spec, B, "cpu"), parts, C)
    assert torch.equal(got, want)
    assert tc.point_batch_to_host(curve, got) == [
        _host_horner(curve, pts[b], C) for b in range(B)]


@pytest.mark.parametrize("name", ["secq256k1", "zorro"])
def test_jac_horner_windows_matches_kernel_body(name):
    curve, spec, jspec = _specs(name)
    parts, pts = _parts(curve, "jac", seed=3)
    got = k2.jac_horner_windows(spec, parts, C)
    want = _body_horner(lambda P: jk._k_sw_double(jspec, *P),
                        lambda P, Q: jk._k_sw_add(jspec, P, Q),
                        tc.point_zero(spec, B, "cpu"), parts, C)
    assert torch.equal(got, want)
    aff = tc.point_batch_to_host(curve, tp.from_jacobian(spec, got).int())
    assert aff == [_host_horner(curve, pts[b], C) for b in range(B)]


@pytest.mark.parametrize("name,model", [("secq256k1", "rcb"),
                                        ("zorro", "rcb"),
                                        ("curve25519", "te"),
                                        ("secq256k1", "jac"),
                                        ("zorro", "jac")])
def test_horner_starts_match_double_k_add_loop(name, model):
    """acc0 = the identity over all W windows (v1) and acc0 = the top
    window over the other W - 1, a slice read in place (v2's stage G),
    each bit-equal to the W-step loop of the double-k-add plain version
    that the engines ran before."""
    curve, spec, _ = _specs(name)
    parts, _ = _parts(curve, model, seed=4)
    horner = k2.jac_horner_windows if model == "jac" else k2.horner_windows
    dka = (kk.jac_double_k_add_plain if model == "jac"
           else kk.double_k_add_plain)
    ident = (tc.point_zero if model == "jac" else tp.point_zero)(spec, B,
                                                                 "cpu")
    acc = ident.to(torch.int32)
    for w in range(W - 1, -1, -1):
        acc = dka(spec, acc, parts[..., w].contiguous(), C)
    assert torch.equal(horner(spec, parts, C), acc)
    acc = parts[..., W - 1].contiguous()
    for w in range(W - 2, -1, -1):
        acc = dka(spec, acc, parts[..., w].contiguous(), C)
    view = parts[..., :W - 1]
    assert not view.is_contiguous()
    assert torch.equal(horner(spec, view, C, parts[..., W - 1].contiguous()),
                       acc)
    with pytest.raises(ValueError, match="innermost"):
        horner(spec, parts.transpose(2, 3).contiguous().transpose(2, 3), C)


def test_horner_wrappers_check_their_inputs():
    curve, spec, _ = _specs("secq256k1")
    parts, _ = _parts(curve, "rcb", seed=5)
    with pytest.raises(TypeError):
        k2.jac_horner_windows(tc.spec_for(curves.curve25519), parts, C)
    with pytest.raises(ValueError, match="shape"):
        k2.horner_windows(spec, parts, C, parts[..., 0, :].contiguous())
    with pytest.raises(TypeError):
        k2.horner_windows(spec, parts.long(), C)
    meta = torch.zeros(3, 16, B, W, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        k2.horner_windows(spec, meta, C)


@pytest.mark.parametrize("name", ["secq256k1", "zorro"])
def test_rcb_double_matches_kernel_body_and_xla(name):
    curve, spec, jspec = _specs(name)
    P, pts = _parts(curve, "rcb", seed=6)
    P = P.reshape(3, 16, B * W).contiguous()  # identity lanes among them
    got = kk.rcb_double(spec, P)
    assert got.dtype == torch.int32 and got.shape == P.shape
    assert torch.equal(got, _from_k(jk._k_rcb_double(jspec, *_kpoint(P))))
    jP = tuple(jnp.asarray(np.ascontiguousarray(c.numpy().T.astype(
        np.uint32))) for c in P)
    xla = torch.stack([torch.from_numpy(np.asarray(c).T.astype(np.int32))
                       for c in jp._double_xla(jspec, jP)])
    assert torch.equal(got, xla)
    assert torch.equal(kk.double(spec, P), got)
    flat = [pts[b][w] for b in range(B) for w in range(W)]
    assert tc.point_batch_to_host(curve, got) == [
        curve.double(p) if p else None for p in flat]
    assert kk.rcb_double.launches == 0
    with pytest.raises(TypeError):
        kk.rcb_double(tc.spec_for(curves.curve25519),
                      torch.zeros(4, 16, 2, dtype=torch.int32))


def test_double_dispatches_te():
    curve, spec, _ = _specs("curve25519")
    P, _ = _parts(curve, "te", seed=7)
    P = P.reshape(4, 16, B * W).contiguous()
    assert torch.equal(kk.double(spec, P), kk.te_double_plain(spec, P))


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_row_gather_plain_matches_take(dtype):
    rng = np.random.default_rng(11)
    tbl = rng.integers(-(1 << 31), 1 << 31, size=(1 << 10, 16),
                       dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, 1 << 10, size=(1 << 12,), dtype=np.int64)
    got = gather.row_gather(torch.from_numpy(tbl),
                            torch.from_numpy(idx).to(dtype))
    want = np.asarray(jnp.take(jnp.asarray(tbl), jnp.asarray(idx), axis=0))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert gather.row_gather.launches == 0
    with pytest.raises(ValueError):
        gather.row_gather(torch.from_numpy(tbl).long(),
                          torch.from_numpy(idx))
    with pytest.raises(ValueError):
        gather.row_gather(torch.from_numpy(tbl),
                          torch.from_numpy(idx).reshape(2, -1))


def _msm_case(curve, n, seed, sets):
    rng = seeded_rng(seed)
    pool = [curve.rand(rng) for _ in range(12)]
    pool += [curve.neg(P) for P in pool]
    prng = random.Random(seed)
    bases = [pool[prng.randrange(24)] for _ in range(n)]
    bases[1] = curve.zero()
    ks = [[prng.randrange(curve.fr.p) for _ in range(n)] for _ in range(sets)]
    return bases, ks


@pytest.mark.parametrize("name", ["secq256k1", "curve25519"])
def test_v1_msm_with_horner_matches_host(name):
    curve, spec, _ = _specs(name)
    bases, ks = _msm_case(curve, 16, 20, sets=2)
    X, Y, inf = tc.affine_to_device(curve, bases, "cpu")
    got = v1.msm_impl(spec, 4, X, Y, inf, scalars_to_device(curve, ks, "cpu"))
    aff = tc.point_batch_to_host(curve, tp.from_jacobian(spec, got).int())
    assert aff == [curve.msm(bases, k) for k in ks]


def _old_stage_horner(g, spec, wsum):
    """v2's stage G as it was: one double-k-add a window from the top
    window."""
    h = wsum.reshape(tc.n_coords(spec), 16, g.B, g.W)
    acc = h[..., g.W - 1].contiguous()
    for w in range(g.W - 2, -1, -1):
        acc = kk.double_k_add(spec, acc, h[..., w].contiguous(), g.c)
    return acc


@pytest.mark.parametrize("name", ["secq256k1", "curve25519"])
def test_v2_msm_with_horner_matches_host_and_old_loop(name, monkeypatch):
    curve, spec, _ = _specs(name)
    n = msm2.V2_MIN_N
    bases, ks = _msm_case(curve, n, 21, sets=1)
    X, Y, inf = tc.affine_to_device(curve, bases, "cpu")
    scal = scalars_to_device(curve, ks, "cpu")
    c = msm2.window_bits(n)
    got = msm2.msm2_impl(spec, c, X, Y, inf, scal)
    assert tc.point_batch_to_host(curve, got) == [curve.msm(bases, ks[0])]
    monkeypatch.setattr(msm2, "_stage_horner", _old_stage_horner)
    assert torch.equal(msm2.msm2_impl(spec, c, X, Y, inf, scal), got)
