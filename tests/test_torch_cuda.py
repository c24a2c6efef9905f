"""The port's CUDA kernels on a card (marker `cuda`; skipped without one).

Tolerances: each kernel bit-equal to its plain PyTorch version on the
same CUDA tensors (projective or extended coordinates, field limbs), at
small widths with a partial last block of threads and with identity,
doubling and P + (-P) lanes, on secq256k1 (a = 0), zorro (a = 6) and
curve25519 (twisted-Edwards); mont_mul also with broadcast operands and
0, 1, p - 1 lanes; whole MSMs equal in affine to the host Pippenger;
proofs made on the card byte-equal to the host route's; verify and
batch_verify give the host's accept/reject.

These tests import only the port (no jax, nothing of the JAX package), so
they run where the JAX package's test configuration cannot load:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import random

import pytest
import torch

from ark_bulletproofs_tpu_torch import (BulletproofGens, InnerProductProof,
                                        PedersenGens, R1CSError, R1CSProof,
                                        ShuffleProof, Transcript,
                                        batch_verify, curves, engine, ipp,
                                        msm, msm_many, seeded_rng)
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops import fs
from ark_bulletproofs_tpu_torch.ops import gather
from ark_bulletproofs_tpu_torch.ops import ipa
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
from ark_bulletproofs_tpu_torch.ops import msm as v1
from ark_bulletproofs_tpu_torch.ops import msm2
from ark_bulletproofs_tpu_torch.ops import proj
from ark_bulletproofs_tpu_torch.ops.curve import (affine_to_device, is_te,
                                                  point_batch_to_host,
                                                  spec_for)
from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from ark_bulletproofs_tpu_torch.r1cs import prover

pytestmark = pytest.mark.cuda

CURVES = [curves.secq256k1, curves.zorro, curves.curve25519]
L = 1000  # lanes: 8 blocks of 128 threads, the last one partial


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _neg(spec, P):
    """-P for a (NC, ..., 16, L) point or (2, ...) affine tensor: the y
    coordinate negated on a short-Weierstrass curve, x (and T) on a
    twisted-Edwards one."""
    out = P.clone()
    for c in ((0, 2) if is_te(spec) else (1,)):
        if c < P.shape[0]:
            out[c] = df.neg(spec.fq, P[c]).to(torch.int32)
    return out


def _affine_rows(curve, spec, R, dev, seed):
    """(2, R, 16, L) affine rows from 32 random points and their
    negatives: lanes [0, L/8) double (row r = row r + 1), lanes [L/8, L/4)
    cancel (row r = -(row r + 1)), about a third of lanes [L/4, 3L/8) are
    identity rows (y = 0); on curve25519 every other row of lanes
    [3L/8, L/2) is the point (0, 1)."""
    rng = seeded_rng(seed)
    X, Y, _ = affine_to_device(curve, [curve.rand(rng) for _ in range(32)],
                               dev)
    pool = torch.stack([X, Y])
    pool = torch.cat([pool, _neg(spec, pool)], dim=2)  # (2, 16, 64)
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, 64, (R, L), generator=g, device=dev)
    if R > 1:
        idx[0::2, :L // 8] = idx[1::2, :L // 8]
        idx[0::2, L // 8:L // 4] = (idx[1::2, L // 8:L // 4] + 32) % 64
    xy = pool[:, :, idx].permute(0, 2, 1, 3).contiguous()
    ident = torch.rand((R, L), generator=g, device=dev) < 0.3
    ident[:, :L // 4] = False
    ident[:, 3 * L // 8:] = False
    xy[1].masked_fill_(ident.unsqueeze(1), 0)
    if is_te(spec):  # (0, 1) as an ordinary point in lanes [3L/8, L/2)
        zy = torch.zeros((R, L), dtype=torch.bool, device=dev)
        zy[::2, 3 * L // 8:L // 2] = True
        zy = zy.unsqueeze(1)
        xy[0].masked_fill_(zy, 0)
        xy[1] = torch.where(zy, df.const(spec.fq.r_limbs, dev)
                            .to(torch.int32), xy[1])
    return xy


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_kernels_match_plain_versions(curve, R, cuda_dev):
    spec = spec_for(curve)
    dka = kk.te_double_k_add if is_te(spec) else kk.rcb_double_k_add
    counts = (k2.suffix_madd_scan.launches, k2.suffix_jac_scan.launches,
              k2.rowsum.launches, dka.launches)
    xy = _affine_rows(curve, spec, R, cuda_dev, seed=R)
    T = k2.suffix_madd_scan(spec, xy)
    assert T.shape == (4 if is_te(spec) else 3, R, 16, L) and T.is_cuda
    assert torch.equal(T, k2.suffix_madd_scan_plain(spec, xy))
    if R > 1:
        T[:, 0::2, :, :L // 8] = T[:, 1::2, :, :L // 8]
        T[:, 0::2, :, L // 8:L // 4] = _neg(spec, T[:, 1::2, :,
                                                   L // 8:L // 4])
    excl, tot = k2.suffix_jac_scan(spec, T)
    pexcl, ptot = k2.suffix_jac_scan_plain(spec, T)
    assert torch.equal(excl, pexcl) and torch.equal(tot, ptot)
    assert torch.equal(k2.rowsum(spec, T), k2.rowsum_plain(spec, T))
    P = T[:, 0].contiguous()
    Q = T[:, R - 1].contiguous()
    Q[..., :L // 8] = P[..., :L // 8]
    Q[..., L // 8:L // 4] = _neg(spec, P[..., L // 8:L // 4])
    for k in (0, 1, 12):
        assert torch.equal(dka(spec, P, Q, k),
                           kk.double_k_add_plain(spec, P, Q, k)), k
    after = (k2.suffix_madd_scan.launches, k2.suffix_jac_scan.launches,
             k2.rowsum.launches, dka.launches)
    assert [b - a for a, b in zip(counts, after)] == [1, 1, 1, 3]
    if is_te(spec):
        before = kk.te_double.launches
        assert torch.equal(kk.te_double(spec, P),
                           kk.te_double_plain(spec, P))
        assert kk.te_double.launches == before + 1


def _msm_case(curve, n, seed, sets):
    rng = seeded_rng(seed)
    pool = [curve.rand(rng) for _ in range(12)]
    pool += [curve.neg(P) for P in pool]
    prng = random.Random(seed)
    bases = [pool[prng.randrange(24)] for _ in range(n)]
    bases[1] = curve.zero()
    ks = [[prng.randrange(curve.fr.p) for _ in range(n)] for _ in range(sets)]
    return bases, ks


@pytest.mark.parametrize("curve,n,sets", [(curves.secq256k1, 1061, 1),
                                          (curves.zorro, 4096, 2),
                                          (curves.curve25519, 1061, 2)],
                         ids=["secq256k1-1061", "zorro-4096x2",
                              "curve25519-1061x2"])
def test_msm_matches_host(curve, n, sets, cuda_dev):
    bases, ks = _msm_case(curve, n, n, sets)
    got = msm_many(curve, bases, ks, device=cuda_dev)
    assert got == [curve.msm(bases, k) for k in ks]
    assert msm(curve, bases, ks[0], device=cuda_dev) == got[0]


def test_shuffle_verify_on_card(cuda_dev, monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cuda")
    curve, k, label = curves.secq256k1, 256, b"card shuffle"
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 2 * k, 1)
    prng = random.Random(k)
    vals = [prng.getrandbits(64) for _ in range(k)]
    perm = vals[:]
    prng.shuffle(perm)
    sp, ic, oc = ShuffleProof.prove(seeded_rng(k), pc, bp, Transcript(label),
                                    vals, perm)
    before = k2.suffix_madd_scan.launches
    ShuffleProof(sp.proof).verify(pc, bp, Transcript(label), ic, oc)
    assert k2.suffix_madd_scan.launches > before  # the mega-MSM ran here
    with pytest.raises(R1CSError):
        ShuffleProof(sp.proof).verify(pc, bp, Transcript(label), oc, ic)


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_mont_mul_matches_plain(curve, cuda_dev):
    fs = df.spec_for(curve.fr)
    p = fs.p
    rng = random.Random(5)
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(L - 3)]
    ys = [p - 1, 0, p - 1] + [rng.randrange(p) for _ in range(L - 3)]
    a, b = ints_to_limbs(xs, cuda_dev), ints_to_limbs(ys, cuda_dev)
    col = ints_to_limbs([ys[4]], cuda_dev)  # (16, 1): read with stride 0
    rows = a.reshape(16, 4, L // 4).permute(1, 0, 2).contiguous()
    per_row = ints_to_limbs(ys[:4], cuda_dev).T.reshape(4, 16, 1)
    pairs = ((a, b), (a, col), (col, a), (rows, per_row),
             (rows, b[:, :L // 4]))
    before = df.mont_mul.launches
    for x, y in pairs:
        got = df.mont_mul(fs, x, y)
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got.long(), df.mont_mul_plain(fs, x, y))
    assert df.mont_mul.launches - before == len(pairs)
    Rinv = pow((1 << 256) % p, -1, p)
    assert limbs_to_ints(df.mont_mul(fs, a, b)) == [
        x * y * Rinv % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("shrink", [128, 4], ids=["plain", "shrink"])
def test_prove_on_card_matches_host_route(shrink, cuda_dev, monkeypatch):
    """k = 64 shuffle with every device branch on the card (thresholds
    lowered) equals the host route's proof byte for byte: "plain" with the
    IPA on the route `ipp.IPA_FS` picks on the card, "shrink" on the
    per-round route with a shrink threshold of 4, so that the IPA table
    (N = 128) shrinks at cur = 32."""
    monkeypatch.setattr(ipa, "SHRINK_T", shrink)
    if shrink == 4:
        monkeypatch.setattr(ipp, "IPA_FS", ())
    monkeypatch.setattr(engine.config, "device", "cuda")
    curve, k, label = curves.secq256k1, 64, b"card prove"
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 2 * k, 1)
    prng = random.Random(k)
    vals = [prng.getrandbits(64) for _ in range(k)]
    perm = vals[:]
    prng.shuffle(perm)

    def prove():
        return ShuffleProof.prove(seeded_rng(k), pc, bp, Transcript(label),
                                  vals, perm)

    monkeypatch.setattr(engine.config, "msm_device_threshold", 1 << 62)
    host, _, _ = prove()
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    monkeypatch.setattr(prover, "VECTOR_MIN_N", 1)
    monkeypatch.setattr(ipp, "DEVICE_MIN_N", 1)
    before = (df.mont_mul.launches, k2.suffix_madd_scan.launches)
    card, ic, oc = prove()
    assert df.mont_mul.launches > before[0]
    assert k2.suffix_madd_scan.launches > before[1]
    assert card.proof.to_bytes(curve) == host.proof.to_bytes(curve)
    ShuffleProof(card.proof).verify(pc, bp, Transcript(label), ic, oc)


def _shuffle(curve, k: int, seed: int):
    prng = random.Random(seed)
    vals = [prng.getrandbits(64) for _ in range(k)]
    perm = vals[:]
    prng.shuffle(perm)
    return vals, perm


def _all_on_card(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cuda")
    monkeypatch.setattr(engine.config, "msm_device_threshold", 0)
    monkeypatch.setattr(prover, "VECTOR_MIN_N", 1)
    monkeypatch.setattr(ipp, "DEVICE_MIN_N", 1)


def test_te_prove_on_card_matches_host_route(cuda_dev, monkeypatch):
    """k = 64 curve25519 shuffle with every device branch on the card (the
    128 witness commitments through the device Pedersen batch) equals the
    host route's proof byte for byte, and verifies on the card."""
    curve, k, label = curves.curve25519, 64, b"card te prove"
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 2 * k, 1)
    vals, perm = _shuffle(curve, k, k)

    def prove():
        return ShuffleProof.prove(seeded_rng(k), pc, bp, Transcript(label),
                                  vals, perm)

    monkeypatch.setattr(engine.config, "msm_device_threshold", 1 << 62)
    host, _, _ = prove()
    _all_on_card(monkeypatch)
    before = (kk.te_double_k_add.launches, kk.te_double.launches,
              k2.suffix_madd_scan.launches)
    card, ic, oc = prove()
    after = (kk.te_double_k_add.launches, kk.te_double.launches,
             k2.suffix_madd_scan.launches)
    assert all(b > a for a, b in zip(before, after)), (before, after)
    assert card.proof.to_bytes(curve) == host.proof.to_bytes(curve)
    ShuffleProof(card.proof).verify(pc, bp, Transcript(label), ic, oc)


def test_te_batch_verify_on_card(cuda_dev, monkeypatch):
    """16 curve25519 k = 8 proofs made on the card pass one batch_verify on
    the card; the batch with one proof's t_x flipped is rejected."""
    _all_on_card(monkeypatch)
    curve, k = curves.curve25519, 8
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 2 * k, 1)
    items = []
    for i in range(16):
        vals, perm = _shuffle(curve, k, 100 + i)
        sp, ic, oc = ShuffleProof.prove(seeded_rng(i), pc, bp,
                                        Transcript(b"te batch"), vals, perm)
        items.append((sp.proof, ic, oc))

    def instances(its):
        return [(ShuffleProof(p).build_verifier(pc, Transcript(b"te batch"),
                                                ic, oc), p)
                for p, ic, oc in its]

    before = kk.te_double_k_add.launches
    batch_verify(seeded_rng(7), instances(items), pc, bp)
    assert kk.te_double_k_add.launches > before
    blob = bytearray(items[5][0].to_bytes(curve))
    blob[11 * len(curve.serialize_compressed(curve.gen))] ^= 1  # t_x
    bad = list(items)
    bad[5] = (R1CSProof.from_bytes(curve, bytes(blob)), *items[5][1:])
    with pytest.raises(R1CSError):
        batch_verify(seeded_rng(8), instances(bad), pc, bp)


def _model_points(curve, spec, R, dev, seed):
    """(NC, R, 16, L) points from _affine_rows in the model coordinates
    of the on-device Fiat-Shamir IPA, each with a random Z: Jacobian (x
    Z^2, y Z^3, Z) with the identity rows as (0, 0, 0), or TE extended
    (x Z, y Z, x y Z, Z) with the y = 0 rows made (0, 1)."""
    fq = spec.fq
    xy = _affine_rows(curve, spec, R, dev, seed)
    ident = df.is_zero(xy[1]).unsqueeze(-2)
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randint(0, 1 << 16, (R, 16, L), generator=g, device=dev,
                      dtype=torch.int32)
    z[:, 15] = 0
    z[:, 0] |= 1

    def mm(a, b):
        return df.mont_mul(fq, a, b).to(torch.int32)

    if is_te(spec):
        one = df.const(fq.r_limbs, dev).to(torch.int32)
        x = torch.where(ident, 0, xy[0])
        y = torch.where(ident, one, xy[1])
        return torch.stack([mm(x, z), mm(y, z), mm(mm(x, y), z), z])
    z2 = mm(z, z)
    P = torch.stack([mm(xy[0], z2), mm(xy[1], mm(z2, z)), z])
    return torch.where(ident, 0, P)


@pytest.mark.parametrize("curve", CURVES[:2], ids=lambda c: c.name)
def test_jac_kernels_match_plain_versions(curve, cuda_dev):
    """jac_double_k_add (k = 0, 1, 4) and jac_double: doubling lanes (one
    point under two Z), P + (-P), O + Q, P + O and O + O."""
    spec = spec_for(curve)
    T = _model_points(curve, spec, 2, cuda_dev, seed=11)
    P, Q = T[:, 0].contiguous(), T[:, 1].contiguous()
    before = (kk.jac_double_k_add.launches, kk.jac_double.launches)
    for k in (0, 1, 4):
        assert torch.equal(kk.jac_double_k_add(spec, P, Q, k),
                           kk.jac_double_k_add_plain(spec, P, Q, k)), k
    assert torch.equal(kk.jac_double(spec, P), kk.jac_double_plain(spec, P))
    P1 = P[..., :1].contiguous()
    assert torch.equal(kk.jac_double(spec, P1),
                       kk.jac_double_plain(spec, P1))
    after = (kk.jac_double_k_add.launches, kk.jac_double.launches)
    assert [b - a for a, b in zip(before, after)] == [3, 2]


@pytest.mark.parametrize("P", [1, 5])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_fs_round_matches_plain_version(curve, P, cuda_dev):
    """fs_round over P transcripts at two positions, one crossing the
    STROBE rate: affine L and R, u and u^-1, the state, the flags and
    the positions equal fs_round_plain's."""
    spec = spec_for(curve)
    fr = df.spec_for(curve.fr)
    S = _model_points(curve, spec, 1, cuda_dev, seed=P)[:, 0, :, :2 * P]
    S = S.contiguous()
    g = torch.Generator(device=cuda_dev).manual_seed(P)
    st = torch.randint(0, 256, (P, 200), generator=g, device=cuda_dev,
                       dtype=torch.int32)
    before = fs.fs_round.launches
    for pos, pb in ((3, 1), (160, 150)):
        got = fs.fs_round(spec, fr, S, st, pos, pb)
        want = fs.fs_round_plain(spec, fr, S, st, pos, pb)
        assert all(torch.equal(a, b) for a, b in zip(got[:4], want[:4]))
        assert got[4:] == want[4:]
    assert fs.fs_round.launches == before + 2


@pytest.mark.parametrize("P", [1, 2, 33, 128])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_fs_round_with_identity_lanes_and_unit_z(curve, P, cuda_dev):
    """fs_round (one safegcd inversion in fq for L's and R's Z, one in fr
    for u) equal to fs_round_plain (Fermat inversions) at P transcripts,
    at three positions, the last crossing the STROBE rate; on a
    short-Weierstrass curve with L = O (lane 0), R = O (lane 3) and both
    (lanes 4, 5) where P reaches them; and a point with Z = 1 (lane
    2P - 1) and one with Z = p - 1 (lane 2P - 2), each rebuilt from its
    lane's affine coordinates."""
    spec = spec_for(curve)
    fq, fr = spec.fq, df.spec_for(curve.fr)
    te = is_te(spec)
    S = _model_points(curve, spec, 1, cuda_dev, seed=P + 40)[:, 0, :, :2 * P]
    S = S.contiguous()
    ident = [lane for lane in (0, 3, 4, 5) if lane < 2 * P and not te]
    for lane in ident:
        S[:, :, lane] = 0
    # the affine coordinates in Montgomery form, then X, Y (and T) for Z
    xy = fs.fs_round_plain(spec, fr, S, torch.zeros(P, 200, dtype=torch.int32,
                                                    device=cuda_dev), 0, 0)[0]
    r2 = df.const(fq.r2_limbs, cuda_dev)

    def mm(a, b):
        return df.mont_mul(fq, a, b).to(torch.int32)

    x, y = mm(xy[0], r2), mm(xy[1], r2)
    for lane, z in ((2 * P - 1, fq.R % fq.p), (2 * P - 2, fq.p - 1)):
        if lane < 0 or lane in ident:
            continue
        zc = ints_to_limbs([z], cuda_dev).to(torch.int32)[:, 0]
        xl, yl = x[:, lane:lane + 1], y[:, lane:lane + 1]
        zl = zc[:, None]
        if te:
            col = [mm(xl, zl), mm(yl, zl), mm(mm(xl, yl), zl), zl]
        else:
            z2 = mm(zl, zl)
            col = [mm(xl, z2), mm(yl, mm(z2, zl)), zl]
        S[:, :, lane:lane + 1] = torch.stack(col)
    g = torch.Generator(device=cuda_dev).manual_seed(P)
    st = torch.randint(0, 256, (P, 200), generator=g, device=cuda_dev,
                       dtype=torch.int32)
    before = fs.fs_round.launches
    for pos, pb in ((3, 1), (90, 85), (160, 150)):
        got = fs.fs_round(spec, fr, S, st, pos, pb)
        want = fs.fs_round_plain(spec, fr, S, st, pos, pb)
        assert all(torch.equal(a, b) for a, b in zip(got[:4], want[:4]))
        assert got[4:] == want[4:]
        assert [int(got[3][0, b]) for b in range(min(P, 3))] == [
            int(2 * b in ident) for b in range(min(P, 3))]
    assert fs.fs_round.launches == before + 3


def _jac_operands(curve, spec, lanes, dev, seed):
    """P, Q (3, 16, lanes) Jacobian points, each with its own random Z,
    by lane % 6: a random pair, Q = P (a doubling), Q = -P, P = O, Q = O,
    both O."""
    fq = spec.fq
    rng = seeded_rng(seed)
    X, Y, _ = affine_to_device(curve, [curve.rand(rng) for _ in range(32)],
                               dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    kind = torch.arange(lanes, device=dev) % 6
    ip = torch.randint(0, 32, (lanes,), generator=g, device=dev)
    iq = torch.randint(0, 32, (lanes,), generator=g, device=dev)
    iq = torch.where((kind == 1) | (kind == 2), ip, iq)
    yq = torch.where(kind == 2, df.neg(fq, Y[:, iq]).to(torch.int32),
                     Y[:, iq])

    def mm(a, b):
        return df.mont_mul(fq, a, b).to(torch.int32)

    def jac(x, y, ident):
        z = torch.randint(0, 1 << 16, (16, lanes), generator=g, device=dev,
                          dtype=torch.int32)
        z[15] = 0
        z[0] |= 1
        z2 = mm(z, z)
        P = torch.stack([mm(x, z2), mm(y, mm(z2, z)), z])
        return torch.where(ident, 0, P).contiguous()

    return (jac(X[:, ip], Y[:, ip], (kind == 3) | (kind == 5)),
            jac(X[:, iq], yq, (kind == 4) | (kind == 5)))


DKA_LANES = [1, 2, 3, 33, 256, kk.DKA_BANDS["jac"][0] - 1,
             kk.DKA_BANDS["jac"][0], kk.DKA_BANDS["jac"][1] - 1,
             kk.DKA_BANDS["jac"][1], 32768]


@pytest.mark.parametrize("lanes", DKA_LANES)
@pytest.mark.parametrize("curve", CURVES[:2], ids=lambda c: c.name)
def test_jac_double_k_add_on_both_sides_of_the_crossover(curve, lanes,
                                                        cuda_dev):
    """jac_double_k_add at k = 0, 1 and 4 (a group of 8 threads a lane,
    of 4 from kk.DKA_BANDS["jac"][0], one thread from its [1]) at lane
    counts of the paths (1-256: the
    c * Q tree and S of one proof; 32,768: the tree's first step at
    P = 128) and both crossovers' neighbours, with doubling, cancelling
    and identity lanes: bit-equal to the plain version, each launch
    counted once."""
    spec = spec_for(curve)
    P, Q = _jac_operands(curve, spec, lanes, cuda_dev, seed=lanes % 991)
    before = kk.jac_double_k_add.launches
    for k in (0, 1, 4):
        assert torch.equal(kk.jac_double_k_add(spec, P, Q, k),
                           kk.jac_double_k_add_plain(spec, P, Q, k)), k
    assert kk.jac_double_k_add.launches == before + 3


def _proj_operands(curve, spec, lanes, dev, seed):
    """P, Q (NC, 16, lanes) RCB projective (x Z, y Z, Z) or TE extended
    (x Z, y Z, x y Z, Z) points, each with its own random Z, by lane % 6:
    a random pair, Q = P (a doubling), Q = -P, P = O, Q = O, both O (RCB
    (0 : R : 0); TE (0 : Z : 0 : Z))."""
    fq = spec.fq
    te = is_te(spec)
    rng = seeded_rng(seed)
    X, Y, _ = affine_to_device(curve, [curve.rand(rng) for _ in range(32)],
                               dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    kind = torch.arange(lanes, device=dev) % 6
    ip = torch.randint(0, 32, (lanes,), generator=g, device=dev)
    iq = torch.randint(0, 32, (lanes,), generator=g, device=dev)
    iq = torch.where((kind == 1) | (kind == 2), ip, iq)
    xq, yq = X[:, iq], Y[:, iq]
    if te:
        xq = torch.where(kind == 2, df.neg(fq, xq).to(torch.int32), xq)
    else:
        yq = torch.where(kind == 2, df.neg(fq, yq).to(torch.int32), yq)
    one = df.const(fq.r_limbs, dev).to(torch.int32)
    zero = proj.point_zero(spec, lanes, dev).to(torch.int32)

    def mm(a, b):
        return df.mont_mul(fq, a, b).to(torch.int32)

    def point(x, y, ident):
        z = torch.randint(0, 1 << 16, (16, lanes), generator=g, device=dev,
                          dtype=torch.int32)
        z[15] = 0
        z[0] |= 1
        if te:  # the identity as (0, 1) under a random Z
            x = torch.where(ident, 0, x)
            y = torch.where(ident, one, y)
            return torch.stack([mm(x, z), mm(y, z), mm(mm(x, y), z),
                                z]).contiguous()
        P = torch.stack([mm(x, z), mm(y, z), z])
        return torch.where(ident, zero, P).contiguous()

    return (point(X[:, ip], Y[:, ip], (kind == 3) | (kind == 5)),
            point(xq, yq, (kind == 4) | (kind == 5)))


def _band_lanes(spec, which):
    g4, one = kk.DKA_BANDS[kk.dka_model(spec)]
    return {"g4-1": g4 - 1, "g4": g4, "one-1": one - 1, "one": one,
            "largest": 1 << 24}.get(which, which)


# the lane counts of test_rcb_te_double_k_add_on_both_sides_of_the_bands:
# few lanes (1-33: the ragged MSM's chunk sum, the TE trees of one proof),
# each band edge and the count below it, the n = 2^20 MSM's stage D and E
# add (90,112), and on secq256k1 the most lanes a path sends (16,777,216:
# stage D of the on-device Fiat-Shamir IPA's 1024-set table shrink)
RT_CASES = [(curve, lanes) for curve in CURVES
            for lanes in (1, 2, 3, 33, "g4-1", "g4", "one-1", "one", 90112)]
RT_CASES.append((curves.secq256k1, "largest"))


@pytest.mark.parametrize("curve,lanes", RT_CASES,
                         ids=[f"{c.name}-{n}" for c, n in RT_CASES])
def test_rcb_te_double_k_add_on_both_sides_of_the_bands(curve, lanes,
                                                        cuda_dev):
    """rcb_double_k_add (secq256k1, zorro) and te_double_k_add
    (curve25519) at k = 0, 1 and 4 (a group of 8 threads a lane, of 4
    from the model's first band edge, one thread from its second:
    kk.DKA_BANDS) with doubling, cancelling and identity lanes: bit-equal
    to double_k_add_plain (compared by slices of 2^20 lanes), each launch
    counted once."""
    spec = spec_for(curve)
    L = _band_lanes(spec, lanes)
    dka = kk.te_double_k_add if is_te(spec) else kk.rcb_double_k_add
    P, Q = _proj_operands(curve, spec, L, cuda_dev, seed=L % 989)
    before = dka.launches
    for k in (0, 1, 4):
        got = dka(spec, P, Q, k)
        for o in range(0, L, 1 << 20):
            sl = slice(o, min(o + (1 << 20), L))
            assert torch.equal(got[..., sl], kk.double_k_add_plain(
                spec, P[..., sl].contiguous(), Q[..., sl].contiguous(),
                k)), (k, o)
        del got
    assert dka.launches == before + 3


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_fs_ipa_on_card_matches_per_round_route(curve, cuda_dev,
                                                monkeypatch):
    """An n = 256 IPA on the on-device Fiat-Shamir route equals the
    per-round route's proof, and leaves the transcript where it does."""
    _all_on_card(monkeypatch)
    n = 256
    gens = BulletproofGens(curve, n, 1).share(0)
    rng = random.Random(n)
    gf, hf, a, b = ([rng.randrange(curve.fr.p) for _ in range(n)]
                    for _ in range(4))
    Q = curve.mul(PedersenGens.default(curve).B, 99)
    out = []
    for route in (("cuda",), ()):
        monkeypatch.setattr(ipp, "IPA_FS", route)
        before = fs.fs_round.launches
        t = Transcript(b"card fs ipa")
        proof = InnerProductProof.create(t, curve, Q, gf, hf, gens.G(n),
                                         gens.H(n), a, b)
        assert (fs.fs_round.launches - before) == (8 if route else 0)
        out.append((proof.to_bytes(curve), t.challenge_bytes(b"end", 8)))
    assert out[0] == out[1]


def test_create_batch_on_card_matches_serial(cuda_dev, monkeypatch):
    """create_batch of 3 proofs at n = 64 on both card routes equals
    serial host-route `create` proof for proof."""
    curve, n, P = curves.secq256k1, 64, 3
    gens = BulletproofGens(curve, n, 1).share(0)
    B = PedersenGens.default(curve).B
    rng = random.Random(3)
    ws = [rng.randrange(curve.fr.p) for _ in range(P)]
    vecs = [[[rng.randrange(curve.fr.p) for _ in range(n)]
             for _ in range(P)] for _ in range(4)]
    want = [InnerProductProof.create(
        Transcript(b"cb %d" % j), curve, curve.mul(B, ws[j]),
        *(v[j] for v in vecs[:2]), gens.G(n), gens.H(n),
        *(v[j] for v in vecs[2:])).to_bytes(curve) for j in range(P)]
    _all_on_card(monkeypatch)
    for route in (("cuda",), ()):
        monkeypatch.setattr(ipp, "IPA_FS", route)
        ts = [Transcript(b"cb %d" % j) for j in range(P)]
        got = InnerProductProof.create_batch(ts, curve, B, ws, *vecs[:2],
                                             gens.G(n), gens.H(n),
                                             *vecs[2:])
        assert [p.to_bytes(curve) for p in got] == want


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_madd_kernels_match_plain_versions(curve, cuda_dev):
    """jac_madd (Jacobian) or te_madd (extended) bit-equal to its plain
    version: P from row 0 of the model points, Q the affine row 1, so the
    lanes hold P = Q (doubling), P = -Q, P = O and Q = O (y = 0 rows)."""
    spec = spec_for(curve)
    T = _model_points(curve, spec, 2, cuda_dev, seed=13)
    xy = _affine_rows(curve, spec, 2, cuda_dev, seed=13)
    P = T[:, 0].contiguous()
    qx, qy = xy[0, 1].contiguous(), xy[1, 1].contiguous()
    q_inf = df.is_zero(qy)
    wrapper = kk.te_madd if is_te(spec) else kk.jac_madd
    plain = kk.te_madd_plain if is_te(spec) else kk.jac_madd_plain
    before = wrapper.launches
    got = wrapper(spec, P, qx, qy, q_inf)
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got, plain(spec, P, qx, qy, q_inf))
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("curve,n,sets", [(curves.secq256k1, 64, 2),
                                          (curves.zorro, 512, 1),
                                          (curves.curve25519, 64, 2),
                                          (curves.secq256k1, 512, 1)],
                         ids=["secq256k1-64x2", "zorro-512",
                              "curve25519-64x2", "secq256k1-512"])
def test_v1_msm_on_card(curve, n, sets, cuda_dev):
    """The v1 Pippenger on the card: equal in affine to the host
    Pippenger, and its coordinates bit-equal to the same run on the CPU
    (the plain versions)."""
    spec = spec_for(curve)
    bases, ks = _msm_case(curve, n, n + 1, sets)
    X, Y, inf = affine_to_device(curve, bases, cuda_dev)
    scal = scalars_to_device(curve, ks, cuda_dev)
    before = (kk.te_madd if is_te(spec) else kk.jac_madd).launches
    got = v1.msm_impl(spec, 4, X, Y, inf, scal)
    assert (kk.te_madd if is_te(spec) else kk.jac_madd).launches > before
    aff = point_batch_to_host(curve, proj.from_jacobian(spec, got).int())
    assert aff == [curve.msm(bases, k) for k in ks]
    cpu = v1.msm_impl(spec, 4, X.cpu(), Y.cpu(), inf.cpu(), scal.cpu())
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("curve,jac", [(curves.secq256k1, False),
                                       (curves.zorro, False),
                                       (curves.curve25519, False),
                                       (curves.secq256k1, True),
                                       (curves.zorro, True)],
                         ids=["secq256k1", "zorro", "curve25519",
                              "secq256k1-jac", "zorro-jac"])
def test_horner_kernels_match_plain_versions(curve, jac, cuda_dev):
    """horner_windows (RCB or extended points) and jac_horner_windows over
    8 windows of L sets, some parts the identity: both starts (the
    identity; the top window over the other seven, read in place) bit-equal
    to the plain version and to the double-k-add kernel's W-step loop."""
    spec = spec_for(curve)
    if jac:
        T = _model_points(curve, spec, 8, cuda_dev, seed=21)
        horner, dka = k2.jac_horner_windows, kk.jac_double_k_add
        plain = k2.jac_horner_windows_plain
    else:
        T = k2.suffix_madd_scan(spec, _affine_rows(curve, spec, 8, cuda_dev,
                                                   seed=21))
        horner, dka = k2.horner_windows, kk.double_k_add
        plain = k2.horner_windows_plain
    nc, W = T.shape[0], T.shape[1]
    parts = T.permute(0, 2, 3, 1).contiguous()  # (NC, 16, L, W)
    zero = (torch.zeros(nc, 16, L, dtype=torch.int32, device=cuda_dev) if jac
            else proj.point_zero(spec, L, cuda_dev).to(torch.int32))
    parts[..., :16, 2] = zero[..., :16]
    parts[..., 8:24, W - 1] = zero[..., 8:24]
    for c in (4, 12):
        before = horner.launches
        got = horner(spec, parts, c)
        assert got.is_cuda and got.shape == (nc, 16, L)
        assert torch.equal(got, plain(spec, parts, c, zero))
        acc = zero
        for w in range(W - 1, -1, -1):
            acc = dka(spec, acc, parts[..., w].contiguous(), c)
        assert torch.equal(got, acc), c
        top = parts[..., W - 1].contiguous()
        got = horner(spec, parts[..., :W - 1], c, top)
        assert torch.equal(got, plain(spec, parts[..., :W - 1], c, top))
        acc = top
        for w in range(W - 2, -1, -1):
            acc = dka(spec, acc, parts[..., w].contiguous(), c)
        assert torch.equal(got, acc), c
        assert horner.launches == before + 2


@pytest.mark.parametrize("curve", CURVES[:2], ids=lambda c: c.name)
def test_rcb_double_matches_plain_version(curve, cuda_dev):
    spec = spec_for(curve)
    T = k2.suffix_madd_scan(spec, _affine_rows(curve, spec, 2, cuda_dev,
                                               seed=22))
    P = T[:, 0].contiguous()
    P[..., :16] = proj.point_zero(spec, 16, cuda_dev).to(torch.int32)
    before = kk.rcb_double.launches
    got = kk.double(spec, P)
    assert got.is_cuda and torch.equal(got, kk.rcb_double_plain(spec, P))
    P1 = P[..., 20:21].contiguous()
    assert torch.equal(kk.rcb_double(spec, P1),
                       kk.rcb_double_plain(spec, P1))
    assert kk.rcb_double.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_row_gather_matches_index_select(dtype, cuda_dev):
    g = torch.Generator(device=cuda_dev).manual_seed(23)
    tbl = torch.randint(-(1 << 31), (1 << 31) - 1, (1000, 16),
                        generator=g, device=cuda_dev, dtype=torch.int32)
    idx = torch.randint(0, 1000, (4099,), generator=g, device=cuda_dev,
                        dtype=dtype)
    before = gather.row_gather.launches
    got = gather.row_gather(tbl, idx)
    assert got.is_cuda and torch.equal(got, tbl.index_select(0, idx))
    assert gather.row_gather.launches == before + 1


@pytest.mark.parametrize("n,R,B,W,mapped,dtype", [
    (256, 1, 1, 3, False, torch.int64),    # R = 1
    (1024, 4, 1, 3, False, torch.int64),   # R = 4
    (4096, 256, 1, 2, False, torch.int64),  # R = 256
    (1024, 4, 2, 3, False, torch.int32),   # B = 2
    (64, 2, 256, 2, True, torch.int64),    # B = 256, a base map
    (512, 8, 3, 4, True, torch.int64),     # a base map over m > n
    (512, 8, 3, 4, True, torch.int32),
    (24, 6, 2, 3, False, torch.int64),     # a row tile that does not divide R
], ids=lambda v: str(v))
def test_stage_gather_matches_plain(n, R, B, W, mapped, dtype, cuda_dev):
    """The stage-B gather bit-equal to its plain version (random 16-bit
    limbs, identity rows, a random permutation a row as the order), one
    launch of the table kernel and one of the gather kernel a call."""
    g = torch.Generator(device=cuda_dev).manual_seed(n + B)
    m = n + 77 if mapped else n
    X, Y = (torch.randint(0, 1 << 16, (16, m), generator=g, device=cuda_dev,
                          dtype=torch.int32) for _ in range(2))
    inf = torch.rand(m, generator=g, device=cuda_dev) < 0.2
    order = torch.argsort(torch.rand(B * W, n, generator=g, device=cuda_dev),
                          dim=1).to(dtype)
    bm = (torch.randint(0, m, (B, n), generator=g, device=cuda_dev)
          if mapped else None)
    args = (X, Y, inf, order, R, n // R, W, bm)
    before = gather.stage_gather.launches, gather.stage_table.launches
    got = gather.stage_gather(*args)
    assert got.is_cuda and got.shape == (2, R, 16, B * W * n // R)
    assert torch.equal(got, gather.stage_gather_plain(*args))
    assert (gather.stage_gather.launches,
            gather.stage_table.launches) == (before[0] + 1, before[1] + 1)


def test_stage_gather_reads_sliced_planes(cuda_dev):
    """X and Y as column slices of wider planes (msm_device_ragged's
    chunks): the table kernel reads them at their row stride."""
    g = torch.Generator(device=cuda_dev).manual_seed(3)
    wide = torch.randint(0, 1 << 16, (2, 16, 1500), generator=g,
                         device=cuda_dev, dtype=torch.int32)
    X, Y = wide[0, :, 300:1324], wide[1, :, 300:1324]
    inf = torch.rand(1500, generator=g, device=cuda_dev)[300:1324] < 0.2
    order = torch.argsort(torch.rand(6, 1024, generator=g, device=cuda_dev),
                          dim=1)
    args = (X, Y, inf, order, 4, 256, 3)
    assert torch.equal(gather.stage_gather(*args),
                       gather.stage_gather_plain(*args))
    assert torch.equal(gather.stage_table(X, Y, inf),
                       gather.stage_table_plain(X, Y, inf))


@pytest.mark.parametrize("m", [1, 127, 129, 1 << 20])
def test_stage_table_matches_plain(m, cuda_dev):
    """The table kernel bit-equal to its plain version, at a partial last
    block of 128 points and at stage B's table, one launch a call."""
    g = torch.Generator(device=cuda_dev).manual_seed(m)
    X, Y = (torch.randint(0, 1 << 16, (16, m), generator=g, device=cuda_dev,
                          dtype=torch.int32) for _ in range(2))
    inf = torch.rand(m, generator=g, device=cuda_dev) < 0.2
    before = gather.stage_table.launches
    got = gather.stage_table(X, Y, inf)
    assert gather.stage_table.launches == before + 1
    assert got.shape == (m, 16)
    assert torch.equal(got, gather.stage_table_plain(X, Y, inf))


@pytest.mark.parametrize("n,B", [(256, 1), (1 << 20, 1), (1024, 2)])
def test_msm2_stage_gather_from_a_real_sort(n, B, cuda_dev):
    """msm2's stage B under its plan, from `_stage_sort` of random scalars,
    bit-equal to the plain version."""
    g = torch.Generator(device=cuda_dev).manual_seed(7)
    cfg = msm2._Cfg(n, msm2.window_bits(n), B, cuda_dev)
    scal = torch.randint(0, 1 << 16, (B, 16, n), generator=g,
                         device=cuda_dev, dtype=torch.int32)
    order, _ = msm2._stage_sort(cfg, scal)
    X, Y = (torch.randint(0, 1 << 16, (16, n), generator=g, device=cuda_dev,
                          dtype=torch.int32) for _ in range(2))
    inf = torch.rand(n, generator=g, device=cuda_dev) < 0.1
    before = gather.stage_gather.launches
    got = msm2._stage_gather(cfg, X, Y, inf, order)
    assert gather.stage_gather.launches == before + 1
    assert torch.equal(got, gather.stage_gather_plain(
        X, Y, inf, order, cfg.R, cfg.C, cfg.W))


FIELDS = [(c, f) for c in CURVES for f in ("fq", "fr")]


@pytest.mark.parametrize("curve,which", FIELDS,
                         ids=[f"{c.name}-{f}" for c, f in FIELDS])
def test_mont_mul_both_fields_top_carry(curve, which, cuda_dev):
    """mont_mul (csrc/field.cuh's carry-chain product) on the base and the
    scalar field of each curve, 2^16 pairs: 0, 1, p - 1, p - 2, R mod p,
    operands in [2^255, p) where p > 2^255 (secq256k1 and zorro, whose
    CIOS top carry must survive), random ones; and left operands up to
    2^256 - 1, as the kernel's contract allows. Bit-equal to the plain
    version and to Python's integers."""
    fs = df.spec_for(getattr(curve, which))
    p = fs.p
    rng = random.Random(len(curve.name) + len(which))
    top = [0, 1, p - 1, p - 2, (1 << 256) % p]
    if p > 1 << 255:
        top += [1 << 255] + [rng.randrange(1 << 255, p) for _ in range(4096)]
    n = 1 << 16
    xs = top + [rng.randrange(p) for _ in range(n - len(top))]
    ys = top[::-1] + [rng.randrange(p) for _ in range(n - len(top))]
    ys[1::7] = xs[1::7]  # squares
    a, b = ints_to_limbs(xs, cuda_dev), ints_to_limbs(ys, cuda_dev)
    got = df.mont_mul(fs, a, b)
    assert torch.equal(got.long(), df.mont_mul_plain(fs, a, b))
    Rinv = pow(1 << 256, -1, p)
    assert limbs_to_ints(got) == [x * y * Rinv % p for x, y in zip(xs, ys)]
    wide = [(1 << 256) - 1 - k for k in range(64)]
    wide += [rng.randrange(1 << 256) for _ in range(960)]
    w = ints_to_limbs(wide, cuda_dev)
    got = df.mont_mul(fs, w, b[:, :1024].contiguous())
    assert limbs_to_ints(got) == [x * y * Rinv % p
                                  for x, y in zip(wide, ys[:1024])]


MODELS = [(curves.secq256k1, False), (curves.zorro, False),
          (curves.curve25519, False), (curves.secq256k1, True),
          (curves.zorro, True)]


@pytest.mark.parametrize("B", [1, 2, 31, 33, 256])
@pytest.mark.parametrize("curve,jac", MODELS,
                         ids=["secq256k1", "zorro", "curve25519",
                              "secq256k1-jac", "zorro-jac"])
def test_horner_group_at_odd_set_counts(curve, jac, B, cuda_dev):
    """The window Horner (a group of 4 or 8 threads a scalar set) at set
    counts that leave a block part-filled or span blocks, over 8 windows
    with identity parts, from the identity and from the top window:
    bit-equal to the plain version and to the double-k-add loop."""
    spec = spec_for(curve)
    if jac:
        T = _model_points(curve, spec, 8, cuda_dev, seed=30 + B)
        horner, dka = k2.jac_horner_windows, kk.jac_double_k_add
        plain = k2.jac_horner_windows_plain
    else:
        T = k2.suffix_madd_scan(spec, _affine_rows(curve, spec, 8, cuda_dev,
                                                   seed=30 + B))
        horner, dka = k2.horner_windows, kk.double_k_add
        plain = k2.horner_windows_plain
    nc, W = T.shape[0], T.shape[1]
    parts = T[..., :B].permute(0, 2, 3, 1).contiguous()  # (NC, 16, B, W)
    zero = (torch.zeros(nc, 16, B, dtype=torch.int32, device=cuda_dev)
            if jac else proj.point_zero(spec, B, cuda_dev).to(torch.int32))
    half = max(B // 2, 1)
    parts[..., :half, 2] = zero[..., :half]
    parts[..., B // 4:half, W - 1] = zero[..., B // 4:half]
    for c in (4, 12):
        for pw, acc0 in ((parts, zero),
                         (parts[..., :W - 1], parts[..., W - 1].contiguous())):
            got = horner(spec, pw, c, acc0)
            assert torch.equal(got, plain(spec, pw, c, acc0)), c
            acc = acc0
            for w in range(pw.shape[-1] - 1, -1, -1):
                acc = dka(spec, acc, pw[..., w].contiguous(), c)
            assert torch.equal(got, acc), c


def _scan_rows(curve, spec, R, lanes, dev, seed):
    """(2, R, 16, lanes) affine rows from 32 random points and their
    negatives: the first eighth of the lanes double (row r = row r + 1),
    the next eighth cancel, a tenth of the rest are identity rows."""
    rng = seeded_rng(seed)
    X, Y, _ = affine_to_device(curve, [curve.rand(rng) for _ in range(32)],
                               dev)
    pool = torch.stack([X, Y])
    pool = torch.cat([pool, _neg(spec, pool)], dim=2)
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, 64, (R, lanes), generator=g, device=dev)
    e = lanes // 8
    if R > 1:
        idx[0::2, :e] = idx[1::2, :e]
        idx[0::2, e:2 * e] = (idx[1::2, e:2 * e] + 32) % 64
    xy = pool[:, :, idx].permute(0, 2, 1, 3).contiguous()
    ident = torch.rand((R, lanes), generator=g, device=dev) < 0.1
    ident[:, :2 * e] = False
    xy[1].masked_fill_(ident.unsqueeze(1), 0)
    return xy


@pytest.mark.parametrize("R,lanes", [(256, 22 * 4096), (512, 22 * 2048),
                                     (3, 1077)],
                         ids=["n2^20-plan", "n2^20-C2048", "ragged-block"])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_suffix_madd_scan_at_the_plan_shapes(curve, R, lanes, cuda_dev):
    """suffix_madd_scan at the n = 2^20 MSM's plan (256 rows x 90,112
    lanes: C = 4096, B = 1), at the 2048-column plan it was measured
    against (512 x 45,056; two sets' plan), and at a lane count that is
    no multiple of the kernel's 128-thread block: bit-equal to its plain
    version."""
    spec = spec_for(curve)
    xy = _scan_rows(curve, spec, R, lanes, cuda_dev, seed=R)
    before = k2.suffix_madd_scan.launches
    got = k2.suffix_madd_scan(spec, xy)
    assert k2.suffix_madd_scan.launches == before + 1
    assert torch.equal(got, k2.suffix_madd_scan_plain(spec, xy))


@pytest.mark.parametrize("curve", [curves.secq256k1, curves.curve25519],
                         ids=lambda c: c.name)
def test_msm_2_20_matches_host(curve, cuda_dev):
    """The n = 2^20 MSM under the card's plan (C = 4096, R = 256) equals
    the host Pippenger in affine: 2^13 random points tiled 128 times, so
    the host sums 2^13 terms with each point's scalars added."""
    from ark_bulletproofs_tpu_torch.ops import msm2

    n, distinct = 1 << 20, 1 << 13
    assert msm2._Cfg(n, msm2.window_bits(n), 1, cuda_dev).C == 4096
    rng = seeded_rng(20)
    pts = [curve.rand(rng) for _ in range(distinct)]
    prng = random.Random(20)
    r = curve.fr.p
    ks = [prng.randrange(r) for _ in range(n)]
    ks[5], ks[6] = 0, r - 1
    ksum = [sum(ks[j::distinct]) % r for j in range(distinct)]
    assert msm(curve, pts * (n // distinct), ks,
               device=cuda_dev) == curve.msm(pts, ksum)


def _chain_points(curve, spec, R, lanes, dev, seed, prefix):
    """(NC, R, 16, lanes) points for the add-only chains (suffix_jac_scan
    from the last row up, rowsum from row 0 down): the rows of a
    suffix_madd_scan over _scan_rows, then lanes by (lane + R) % 6: 1, a
    third of the rows the identity (on curve25519 the point (0, 1)); 2,
    the whole column the identity; 3, the row in the middle of the chain
    equal to the sum before it (P + P); 4, its negative (P + (-P)); 5,
    rows r and r + 1 equal in turn. `prefix(T, r)` is the chain's sum
    before row r (the plain version's)."""
    T = k2.suffix_madd_scan(spec, _scan_rows(curve, spec, R, lanes, dev,
                                             seed))
    kind = (torch.arange(lanes, device=dev) + R) % 6
    zero = proj.point_zero(spec, lanes, dev).to(torch.int32)
    g = torch.Generator(device=dev).manual_seed(seed)
    ident = ((torch.rand((R, lanes), generator=g, device=dev) < 0.3)
             & (kind == 1)) | (kind == 2)
    T = torch.where(ident[None, :, None], zero[:, None], T)
    even = slice(0, R - R % 2, 2)
    T[:, even] = torch.where((kind == 5)[None, None, None],
                             T[:, 1:R:2], T[:, even])
    r = R // 2
    acc = prefix(T, r)
    T[:, r] = torch.where(kind == 3, acc, T[:, r])
    T[:, r] = torch.where(kind == 4, _neg(spec, acc), T[:, r])
    return T.contiguous()


def _suffix_prefix(spec, T, r):
    return k2.suffix_jac_scan_plain(spec, T)[0][:, r]


def _rowsum_prefix(spec, T, r):
    if r == 0:
        return proj.point_zero(spec, T.shape[-1], T.device).to(torch.int32)
    return k2.rowsum_plain(spec, T[:, :r].contiguous())


def _check_chains(curve, R, lanes, dev, seed):
    """suffix_jac_scan and rowsum on _chain_points bit-equal to their plain
    versions, each launch counted once."""
    spec = spec_for(curve)
    T = _chain_points(curve, spec, R, lanes, dev, seed,
                      lambda T, r: _suffix_prefix(spec, T, r))
    before = k2.suffix_jac_scan.launches
    excl, tot = k2.suffix_jac_scan(spec, T)
    assert k2.suffix_jac_scan.launches == before + 1
    pexcl, ptot = k2.suffix_jac_scan_plain(spec, T)
    assert torch.equal(excl, pexcl) and torch.equal(tot, ptot)
    T = _chain_points(curve, spec, R, lanes, dev, seed + 1,
                      lambda T, r: _rowsum_prefix(spec, T, r))
    before = k2.rowsum.launches
    got = k2.rowsum(spec, T)
    assert k2.rowsum.launches == before + 1
    assert torch.equal(got, k2.rowsum_plain(spec, T))


@pytest.mark.parametrize("lanes", [1, 3, 22, 33, 1408])
@pytest.mark.parametrize("R", [1, 2, 16, 64])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_chain_kernels_match_plain_versions(curve, R, lanes, cuda_dev):
    """Stages D and F's kernels (a thread group a lane) at the row counts
    of the paths (1-row rowsum, 16 and 64 rows) and lane counts that leave
    a block part-filled, with identity rows and columns, P + P and
    P + (-P) in the middle of the chain and equal neighbouring rows."""
    _check_chains(curve, R, lanes, cuda_dev, seed=R * 7 + lanes)


@pytest.mark.parametrize("lanes", [k2.CHAIN_ONE_THREAD_MIN_LANES - 1,
                                   k2.CHAIN_ONE_THREAD_MIN_LANES,
                                   16 * 64 * 1024],
                         ids=["group-below", "one-thread-from", "largest"])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_chain_kernels_on_both_sides_of_the_crossover(curve, lanes,
                                                      cuda_dev):
    """Stages D and F's kernels at 16 rows just below the lane count from
    which the launchers run one thread a lane (the group kernel, with a
    ragged last block), at it (one thread a lane), and at the most lanes a
    path sends (stage D level A of 1024 sets at n = 256: the on-device
    Fiat-Shamir IPA's table shrink at n = 2^16): bit-equal to the plain
    versions."""
    _check_chains(curve, 16, lanes, cuda_dev, seed=lanes % 997)


def _scan_operands(curve, spec, R, lanes, dev, seed):
    """The row scan's operands (jac_madd, or te_madd on curve25519): P
    (NC, 16, lanes) Jacobian or extended with a random Z, rows qx, qy (R,
    16, lanes) affine, q_inf (R, lanes); by lane % 6: random (on
    curve25519 every other such lane with (0, 1) as an ordinary point in
    row R - 1); P = O and Q_{R-2} = Q_{R-1} (a doubling at the second
    add); P = O and Q_{R-2} = -Q_{R-1} (a cancellation); Q_{R-1} = P (a
    doubling at the first add); Q_{R-1} = -P; about 40% of the rows the
    identity, P = O on every other such lane."""
    fq = spec.fq
    rng = seeded_rng(seed)
    X, Y, _ = affine_to_device(curve, [curve.rand(rng) for _ in range(32)],
                               dev)
    pool = torch.cat([torch.stack([X, Y]), _neg(spec, torch.stack([X, Y]))],
                     dim=2)  # (2, 16, 64)
    g = torch.Generator(device=dev).manual_seed(seed)
    lane = torch.arange(lanes, device=dev)
    kind = lane % 6
    idx = torch.randint(0, 64, (R, lanes), generator=g, device=dev)
    ip = torch.randint(0, 64, (lanes,), generator=g, device=dev)
    if R >= 2:
        idx[R - 2] = torch.where(kind == 1, idx[R - 1], idx[R - 2])
        idx[R - 2] = torch.where(kind == 2, (idx[R - 1] + 32) % 64,
                                 idx[R - 2])
    idx[R - 1] = torch.where(kind == 3, ip, idx[R - 1])
    idx[R - 1] = torch.where(kind == 4, (ip + 32) % 64, idx[R - 1])
    xy = pool[:, :, idx].permute(0, 2, 1, 3).contiguous()
    q_inf = (kind == 5) & (torch.rand((R, lanes), generator=g, device=dev)
                           < 0.4)
    xy.masked_fill_(q_inf.unsqueeze(1), 0)
    z = torch.randint(0, 1 << 16, (16, lanes), generator=g, device=dev,
                      dtype=torch.int32)
    z[15] = 0
    z[0] |= 1

    def mm(a, b):
        return df.mont_mul(fq, a, b).to(torch.int32)

    x, y = pool[0][:, ip], pool[1][:, ip]
    p_inf = (kind == 1) | (kind == 2) | ((kind == 5) & (lane // 6 % 2 == 1))
    if is_te(spec):
        zy = (kind == 0) & (lane // 6 % 2 == 1)
        xy[0, R - 1].masked_fill_(zy, 0)
        xy[1, R - 1] = torch.where(zy, df.const(fq.r_limbs, dev)
                                   .to(torch.int32), xy[1, R - 1])
        P = torch.stack([mm(x, z), mm(y, z), mm(mm(x, y), z), z])
        zero = proj.point_zero(spec, lanes, dev).to(torch.int32)
        return (torch.where(p_inf, zero, P).contiguous(), xy[0].contiguous(),
                xy[1].contiguous(), q_inf.contiguous())
    z2 = mm(z, z)
    P = torch.stack([mm(x, z2), mm(y, mm(z2, z)), z])
    P = torch.where(p_inf, 0, P).contiguous()
    return P, xy[0].contiguous(), xy[1].contiguous(), q_inf.contiguous()


_WIDEST = {}


def _widest(key, make):
    """The operands and plain result of the widest case of a (curve,
    rows or steps), made once: lanes are independent, so each narrower
    case runs the kernel on a prefix of its lanes."""
    if key not in _WIDEST:
        _WIDEST.clear()
        _WIDEST[key] = make()
    return _WIDEST[key]


SCAN_TEST_LANES = [1, 3, 128, 512, kk.MADD_BANDS["jac"][0] - 1,
                   kk.MADD_BANDS["jac"][0], 32768,
                   kk.MADD_BANDS["jac"][1] - 1, kk.MADD_BANDS["jac"][1],
                   131072]


@pytest.mark.parametrize("lanes", SCAN_TEST_LANES)
@pytest.mark.parametrize("rows", [1, 2, 16, 32])
@pytest.mark.parametrize("curve", CURVES[:2], ids=lambda c: c.name)
def test_jac_madd_scan_on_both_sides_of_the_bands(curve, rows, lanes,
                                                cuda_dev):
    """jac_madd's row scan (a group of 4 threads a lane, of 2 from
    kk.MADD_BANDS["jac"][0] lanes, one thread from its [1]) with doubling,
    cancelling and identity lanes: bit-equal to its plain version (the
    rows of one plain scan over the widest lanes), one launch counted."""
    spec = spec_for(curve)

    def make():
        ops = _scan_operands(curve, spec, rows, max(SCAN_TEST_LANES),
                             cuda_dev, seed=rows)
        return ops, kk.jac_madd_plain(spec, *ops)

    ops, want = _widest((curve.name, "scan", rows), make)
    ops = [t[..., :lanes].contiguous() for t in ops]
    before = kk.jac_madd.launches
    got = kk.jac_madd(spec, *ops)
    assert kk.jac_madd.launches == before + 1
    assert got.shape == (3, rows, 16, lanes)
    assert torch.equal(got, want[..., :lanes])


TE_SCAN_TEST_LANES = [1, 3, 128, 512, kk.MADD_BANDS["te"][0] - 1,
                      kk.MADD_BANDS["te"][0], 32768,
                      kk.MADD_BANDS["te"][1] - 1, kk.MADD_BANDS["te"][1],
                      131072]


@pytest.mark.parametrize("lanes", TE_SCAN_TEST_LANES)
@pytest.mark.parametrize("rows", [1, 2, 16, 32])
def test_te_madd_scan_on_both_sides_of_the_bands(rows, lanes, cuda_dev):
    """te_madd's row scan on curve25519 (a group of 4 threads a lane, of 2
    from kk.MADD_BANDS["te"][0] lanes, one thread from its [1]) with
    doubling, cancelling, identity and (0, 1) lanes: bit-equal to its
    plain version (the rows of one plain scan over the widest lanes), one
    launch counted; madd_scan launches it once too."""
    curve = curves.curve25519
    spec = spec_for(curve)

    def make():
        ops = _scan_operands(curve, spec, rows, max(TE_SCAN_TEST_LANES),
                             cuda_dev, seed=rows)
        return ops, kk.te_madd_plain(spec, *ops)

    ops, want = _widest((curve.name, "te scan", rows), make)
    ops = [t[..., :lanes].contiguous() for t in ops]
    before = kk.te_madd.launches
    got = kk.te_madd(spec, *ops)
    assert kk.te_madd.launches == before + 1
    assert got.shape == (4, rows, 16, lanes)
    assert torch.equal(got, want[..., :lanes])
    assert torch.equal(kk.madd_scan(spec, *ops), got)
    assert kk.te_madd.launches == before + 2


@pytest.mark.parametrize("curve", CURVES[:2], ids=lambda c: c.name)
def test_rcb_double_on_both_sides_of_the_band(curve, cuda_dev):
    """rcb_double (a group of 4 threads a lane on a = 0, of 8 on zorro;
    one thread from kk.DBL_BANDS) bit-equal to its plain version at 1, 2,
    3, the band edge and the lane on each side, 65,536 and 2^20 lanes,
    about a third of the lanes the identity: the kernel on a prefix of
    one operand set, the plain version once on all of it; one launch a
    lane count."""
    spec = spec_for(curve)
    edge = kk.DBL_BANDS[kk.dka_model(spec)]
    lanes = sorted({1, 2, 3, edge - 1, edge, edge + 1, 1 << 16, 1 << 20})
    xy = _affine_rows(curve, spec, 1, cuda_dev, seed=23)[:, 0]
    reps = -(-max(lanes) // L)
    X, Y = (c.repeat(1, reps)[:, :max(lanes)] for c in xy)
    P = k2.suffix_madd_scan(spec, torch.stack([X, Y]).unsqueeze(1)
                            .contiguous())[:, 0].contiguous()
    P[..., 1::3] = proj.point_zero(spec, 1, cuda_dev).to(torch.int32)
    want = kk.rcb_double_plain(spec, P)
    for n in lanes:
        before = kk.rcb_double.launches
        got = kk.rcb_double(spec, P[..., :n].contiguous())
        assert kk.rcb_double.launches == before + 1
        assert torch.equal(got, want[..., :n]), n


@pytest.mark.parametrize("lanes", [1, 2, 65536])
@pytest.mark.parametrize("steps", [1, 2, 255])
@pytest.mark.parametrize("curve", CURVES[:2], ids=lambda c: c.name)
def test_jac_double_chain_matches_plain_version(curve, steps, lanes,
                                                cuda_dev):
    """jac_double's chain (a group of 4 threads a lane at every lane
    count) with identity lanes: bit-equal to the rows of one plain
    255-step chain over the widest lanes, one launch counted; steps = 1
    gives 2P as (3, 16, lanes)."""
    spec = spec_for(curve)

    def make():
        P = _model_points(curve, spec, 1, cuda_dev, seed=31)[:, 0]
        P = P.repeat(1, 1, 66)[..., :65536].contiguous()
        P[..., ::7] = 0
        return P, kk.jac_double_plain(spec, P, 255)

    P, want = _widest((curve.name, "chain"), make)
    P = P[..., :lanes].contiguous()
    before = kk.jac_double.launches
    got = kk.jac_double(spec, P, steps)
    assert kk.jac_double.launches == before + 1
    if steps == 1:
        assert torch.equal(got, want[:, :, 1, :lanes])
    else:
        assert torch.equal(got, want[:, :, :steps + 1, :lanes])


def _field_vals(p: int, n: int, seed: int) -> list[int]:
    """n field elements: 0, 1, p - 1, p - 2 and runs of p - 1 (the
    widest carries and borrows), then random ones."""
    rng = random.Random(seed)
    edge = [0, 1, p - 1, p - 2, p - 1, p - 1, (1 << 240) - 1, 1 << 240]
    xs = edge + [rng.randrange(p) for _ in range(max(n - len(edge), 0))]
    return xs[:n]


FUSED_LANES = [1, 2, 33, 12288, 1 << 16]


@pytest.mark.parametrize("lanes", FUSED_LANES)
@pytest.mark.parametrize("curve,which", FIELDS,
                         ids=[f"{c.name}-{f}" for c, f in FIELDS])
def test_fused_mont_mul_matches_plain(curve, which, lanes, cuda_dev):
    """mont_mul(a, b, c, +-1) (the product with c added or subtracted in
    its registers) bit-equal to add_plain / sub_plain of mont_mul_plain,
    with c full, c broadcast (16, 1), b broadcast, and per-row (rows, 16,
    1) b and c; each call one launch."""
    fs_ = df.spec_for(getattr(curve, which))
    p = fs_.p
    a, b, c = (ints_to_limbs(_field_vals(p, lanes, 3 * lanes + i), cuda_dev)
               for i in range(3))
    col = c[:, :1].contiguous()
    A2 = torch.stack([a, b])
    B2, C2 = (torch.stack([t[:, :1], t[:, -1:]]) for t in (b, c))
    cases = [(a, b, c), (a, b, col), (a, col, c), (A2, B2, C2)]
    for sign in (1, -1):
        plain = df.add_plain if sign > 0 else df.sub_plain
        for x, y, z in cases:
            before = df.mont_mul.launches
            got = df.mont_mul(fs_, x, y, z, sign)
            assert df.mont_mul.launches == before + 1
            assert got.dtype == torch.int32 and got.is_cuda
            assert torch.equal(got.long(), plain(
                fs_, df.mont_mul_plain(fs_, x, y), z))


@pytest.mark.parametrize("lanes", [1, 33, 1000])
@pytest.mark.parametrize("curve,which", FIELDS,
                         ids=[f"{c.name}-{f}" for c, f in FIELDS])
def test_add_sub_neg_match_plain(curve, which, lanes, cuda_dev):
    """add, sub and neg on the card (the add_sub kernel) bit-equal to
    their plain versions, with carry lanes (p - 1 + p - 1, and sums past
    2^256 where 2p > 2^256), borrow lanes (0 - (p - 1)), runs of 0xFFFF
    limbs, and a (16, 1) operand on either side; each call one launch and
    equal to Python's integers."""
    fs_ = df.spec_for(getattr(curve, which))
    p = fs_.p
    xs = _field_vals(p, lanes, lanes)
    ys = _field_vals(p, lanes, lanes + 1)[::-1]
    a, b = ints_to_limbs(xs, cuda_dev), ints_to_limbs(ys, cuda_dev)
    col = b[:, :1].contiguous()
    cases = [(df.add, df.add_plain, a, b), (df.sub, df.sub_plain, a, b),
             (df.add, df.add_plain, col, a), (df.sub, df.sub_plain, col, a),
             (df.sub, df.sub_plain, a, col)]
    for op, plain, x, y in cases:
        before = df.add_sub.launches
        got = op(fs_, x, y)
        assert df.add_sub.launches == before + 1
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got.long(), plain(fs_, x, y))
    got = df.neg(fs_, a)
    assert torch.equal(got.long(), df.neg_plain(fs_, a))
    assert limbs_to_ints(df.add(fs_, a, b)) == [(x + y) % p
                                                for x, y in zip(xs, ys)]
    assert limbs_to_ints(df.sub(fs_, a, b)) == [(x - y) % p
                                                for x, y in zip(xs, ys)]


@pytest.mark.parametrize("lanes", [1, 2048, 1 << 16])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_sum_mod_tail_matches_plain(curve, lanes, cuda_dev):
    """sum_mod on the card (a torch column sum and the sum_mod kernel's
    carries and reduction) bit-equal to sum_mod_plain and Python's sum,
    on random rows and on all-(p - 1) rows (the largest carries), one
    launch a call; dot_mod is a product, a sum and that launch."""
    fs_ = df.spec_for(curve.fr)
    p = fs_.p
    rows = torch.stack([
        ints_to_limbs(_field_vals(p, lanes, lanes), cuda_dev),
        ints_to_limbs([p - 1] * lanes, cuda_dev),
        ints_to_limbs(_field_vals(p, lanes, lanes + 5)[::-1], cuda_dev)])
    before = df.sum_mod.launches
    got = df.sum_mod(fs_, rows)
    assert df.sum_mod.launches == before + 1
    assert got.shape == (3, 16, 1) and got.dtype == torch.int32
    assert torch.equal(got.long(), df.sum_mod_plain(fs_, rows))
    assert [limbs_to_ints(got[r])[0] for r in range(3)] == [
        sum(limbs_to_ints(rows[r])) % p for r in range(3)]
    dot = df.dot_mod(fs_, rows, rows)
    assert torch.equal(dot.long(), df.sum_mod_plain(
        fs_, df.mont_mul_plain(fs_, rows, rows)))


@pytest.mark.parametrize("rows", [128, 129, 256, 512])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_sum_mod_tail_over_many_rows(curve, rows, cuda_dev):
    """sum_mod over more rows than one 128-thread block (a batch IPA's 2P
    at P = 128, the batch verify's 2n g/h sums at n = 256), 64 lanes
    each, every third row all p - 1: one launch, bit-equal to
    sum_mod_plain and Python's sum."""
    fs_ = df.spec_for(curve.fr)
    p = fs_.p
    vals = [[p - 1] * 64 if r % 3 == 0 else _field_vals(p, 64, r)
            for r in range(rows)]
    x = torch.stack([ints_to_limbs(v, cuda_dev) for v in vals])
    before = df.sum_mod.launches
    got = df.sum_mod(fs_, x)
    assert df.sum_mod.launches == before + 1
    assert torch.equal(got.long(), df.sum_mod_plain(fs_, x))
    assert limbs_to_ints(got[..., 0].T.contiguous()) == [sum(v) % p
                                                         for v in vals]


@pytest.mark.parametrize("B", [1, 2, 33, 8192])
@pytest.mark.parametrize("curve,which", FIELDS,
                         ids=[f"{c.name}-{f}" for c, f in FIELDS])
def test_mont_inv_batch_matches_plain(curve, which, B, cuda_dev):
    """mont_inv_batch on the card (one safegcd inverse a lane) with zero
    lanes, alone and with two rows multiplied in: bit-equal to its plain
    version (Montgomery's trick and the Fermat power), one launch a
    call."""
    f = getattr(curve, which)
    fs_ = df.spec_for(f)
    zs = _field_vals(fs_.p, B, B)
    zs[::5] = [0] * len(zs[::5])
    z = ints_to_limbs([v * fs_.R % fs_.p for v in zs], cuda_dev)
    rows = torch.stack([ints_to_limbs(_field_vals(fs_.p, B, B + i),
                                      cuda_dev) for i in (1, 2)])
    before = fs.mont_inv_batch.launches
    inv = fs.mont_inv_batch(fs_, z)
    got = fs.mont_inv_batch(fs_, z, rows)
    assert fs.mont_inv_batch.launches == before + 2
    want = fs.mont_inv_batch_plain(fs_, z)
    assert inv.dtype == torch.int32 and torch.equal(inv.long(), want)
    assert torch.equal(got.long(), df.mont_mul_plain(fs_, rows, want))
    assert [v * f.R_inv % f.p for v in limbs_to_ints(inv[:, :40])] == [
        pow(v, -1, f.p) if v else 0 for v in zs[:40]]


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("steps", [1, 2, 255])
def test_te_double_chain_matches_plain_version(steps, lanes, cuda_dev):
    """te_double's chain (a group of 8 threads a lane) with identity
    lanes: bit-equal to the rows of one plain 255-step chain, one launch
    counted; steps = 1 gives 2P as (4, 16, lanes)."""
    curve = curves.curve25519
    spec = spec_for(curve)

    def make():
        P = _model_points(curve, spec, 1, cuda_dev, seed=41)[:, 0]
        P = P[..., L // 2:L // 2 + 3].contiguous()  # random points
        P[..., 1] = proj.point_zero(spec, 1, cuda_dev)[..., 0]
        return P, kk.te_double_plain(spec, P, 255)

    P, want = _widest((curve.name, "te chain"), make)
    P = P[..., :lanes].contiguous()
    before = kk.te_double.launches
    got = kk.te_double(spec, P, steps)
    assert kk.te_double.launches == before + 1
    if steps == 1:
        assert got.shape == (4, 16, lanes)
        assert torch.equal(got, want[:, :, 1, :lanes])
    else:
        assert torch.equal(got, want[:, :, :steps + 1, :lanes])


def test_field_adds_and_sums_make_no_sync(cuda_dev):
    """add, sub, neg, a fused product and sum_mod on CUDA tensors queue
    their launches without a device-to-host sync (the plain adds' carry
    loop synchronised at every call)."""
    fs_ = df.spec_for(curves.secq256k1.fr)
    p = fs_.p
    a = ints_to_limbs(_field_vals(p, 4096, 1), cuda_dev)
    b = ints_to_limbs(_field_vals(p, 4096, 2), cuda_dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = df.add(fs_, a, b)
        d = df.sub(fs_, s, b)
        n = df.neg(fs_, d)
        m = df.mont_mul(fs_, n, b, a, -1)
        t = df.sum_mod(fs_, m)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(d, a.to(torch.int32))
    assert torch.equal(t.long(), df.sum_mod_plain(fs_, df.sub_plain(
        fs_, df.mont_mul_plain(fs_, df.neg_plain(fs_, a), b), a)))


def _attempt_words(curve, m: int, seed: int) -> torch.Tensor:
    """(m, 9) int32 sampling attempts: x below p (its top word below p's),
    the first lanes x = 0, 1 and the raw limbs of p - 1, random sign
    words; about half the x are not on the curve."""
    import numpy as np

    p = curve.fq.p
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(m, 9),
                                             dtype=np.uint64).astype(np.uint32)
    w[:, 7] %= np.uint32(p >> 224)
    for i, x in enumerate([0, 1, p - 1][:m]):
        w[i, :8] = [(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("curve", CURVES[:2], ids=lambda c: c.name)
@pytest.mark.parametrize("m", [1, 33, 256, 65536, 1 << 21])
def test_gen_candidates_matches_plain(curve, m, cuda_dev):
    """The farm's kernel bit-equal to its plain version (x, y, ok), the
    root picked by the sign word."""
    from ark_bulletproofs_tpu_torch.ops import gens

    spec, sq = spec_for(curve), gens.sqrt_spec_for(curve.fq)
    w = _attempt_words(curve, m, seed=m).to(cuda_dev)
    before = gens.gen_candidates.launches
    xy, ok = gens.gen_candidates(spec, sq, w)
    assert gens.gen_candidates.launches == before + 1
    want_xy, want_ok = gens.gen_candidates_plain(spec, sq, w)
    assert torch.equal(ok, want_ok)
    assert torch.equal(xy, want_xy)
    if m >= 256:
        assert 0 < int(ok.sum()) < m


def test_farm_take_matches_host_chain(cuda_dev, monkeypatch):
    """GeneratorsChain.fast_forward(4096) then take(4096) on secq256k1
    through the farm on the card (one launch each), equal to the host
    chain, which then goes on in step."""
    from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch.ops import gens

    monkeypatch.setattr(engine.config, "device", "cuda")
    curve = curves.secq256k1
    before = gens.gen_candidates.launches
    dev = GeneratorsChain(curve, b"G\0\0\0\0").fast_forward(4096)
    got = dev.take(4096)
    assert gens.gen_candidates.launches == before + 2
    monkeypatch.setattr(GeneratorsChain, "_DEVICE_MIN", 1 << 62)
    host = GeneratorsChain(curve, b"G\0\0\0\0").fast_forward(4096)
    assert got == host.take(4096)
    assert dev.take(5) == host.take(5)


@pytest.fixture
def no_mesh(monkeypatch):
    monkeypatch.setattr(engine, "_mesh", None)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_sharded_msm_on_one_card_matches_unsharded(curve, D, cuda_dev,
                                                   no_mesh):
    """n = 2^16, one scalar set and two, over a mesh of D shards of
    cuda:0 (v2 shards on every curve), equal to the same MSM without a
    mesh; every shard ran on the card."""
    from ark_bulletproofs_tpu_torch.parallel import mesh as pmesh
    from ark_bulletproofs_tpu_torch.parallel import msm as pmsm

    n = 1 << 16
    bases, ks = _msm_case(curve, n, D, 2)
    spec = spec_for(curve)
    X, Y, inf = affine_to_device(curve, bases, cuda_dev)
    scal = scalars_to_device(curve, ks, cuda_dev)
    want = point_batch_to_host(curve, pmsm.msm_device_maybe_sharded(
        spec, X, Y, inf, scal))
    engine.set_mesh(pmesh.make_mesh(devices=["cuda:0"] * D))
    before = k2.horner_windows.launches + k2.jac_horner_windows.launches
    got = pmsm.msm_device_maybe_sharded(spec, X, Y, inf, scal)
    after = k2.horner_windows.launches + k2.jac_horner_windows.launches
    assert got.device.type == "cuda" and after - before == D
    assert point_batch_to_host(curve, got) == want
    one = pmsm.msm_device_maybe_sharded(spec, X, Y, inf, scal[0])
    assert point_batch_to_host(curve, one) == want[:1]


def test_zorro_prove_on_card_matches_host_route(cuda_dev, monkeypatch):
    """A k = 64 zorro shuffle (a != 0: the RCB a branch in the phase MSMs
    and the mega-MSM, jac_double_k_add's a branch in the c * Q tree) with
    every device branch on the card equals the host route's proof byte
    for byte; verify on the card accepts it and rejects a tampered copy."""
    curve, k, label = curves.zorro, 64, b"card zorro prove"
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 2 * k, 1)
    vals, perm = _shuffle(curve, k, 7)

    def prove():
        return ShuffleProof.prove(seeded_rng(k), pc, bp, Transcript(label),
                                  vals, perm)

    monkeypatch.setattr(engine.config, "msm_device_threshold", 1 << 62)
    host, _, _ = prove()
    _all_on_card(monkeypatch)
    before = (kk.rcb_double_k_add.launches, kk.jac_double_k_add.launches,
              fs.fs_round.launches)
    card, ic, oc = prove()
    after = (kk.rcb_double_k_add.launches, kk.jac_double_k_add.launches,
             fs.fs_round.launches)
    assert all(b > a for a, b in zip(before, after)), (before, after)
    assert card.proof.to_bytes(curve) == host.proof.to_bytes(curve)
    before = kk.jac_madd.launches  # the 411-term mega-MSM: v1 at 512
    ShuffleProof(card.proof).verify(pc, bp, Transcript(label), ic, oc)
    assert kk.jac_madd.launches > before
    blob = bytearray(card.proof.to_bytes(curve))
    blob[11 * len(curve.serialize_compressed(curve.gen))] ^= 1  # t_x
    with pytest.raises(R1CSError):
        ShuffleProof(R1CSProof.from_bytes(curve, bytes(blob))).verify(
            pc, bp, Transcript(label), ic, oc)


def test_mesh_prove_on_card_matches_host_route(cuda_dev, monkeypatch,
                                               no_mesh):
    """A k = 64 secq256k1 shuffle under a mesh of 4 shards of cuda:0 (the
    sharded vector phase and IPA rounds, the phase MSMs through the mesh
    branch; shards from 32 terms) equals the host route's proof; the mesh
    verify accepts it."""
    from ark_bulletproofs_tpu_torch.parallel import mesh as pmesh
    from ark_bulletproofs_tpu_torch.parallel import msm as pmsm

    curve, k, label = curves.secq256k1, 64, b"card mesh prove"
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 2 * k, 1)
    vals, perm = _shuffle(curve, k, 9)

    def prove():
        return ShuffleProof.prove(seeded_rng(k), pc, bp, Transcript(label),
                                  vals, perm)

    monkeypatch.setattr(engine.config, "msm_device_threshold", 1 << 62)
    host, _, _ = prove()
    _all_on_card(monkeypatch)
    monkeypatch.setattr(pmsm, "SHARD_MIN", 32)
    engine.set_mesh(pmesh.make_mesh(devices=["cuda:0"] * 4))
    before = fs.fs_round.launches
    card, ic, oc = prove()
    assert fs.fs_round.launches == before  # no FS route under a mesh
    assert card.proof.to_bytes(curve) == host.proof.to_bytes(curve)
    ShuffleProof(card.proof).verify(pc, bp, Transcript(label), ic, oc)


def test_dryrun_multichip_on_one_card(cuda_dev, no_mesh):
    """The dry run's four checks on 4 shards of cuda:0 (k = BATCH_K =
    128: the batch's mega-MSM shards at the default 256-term floor)."""
    from ark_bulletproofs_tpu_torch.parallel import dryrun

    dryrun.dryrun_multichip(4, "cuda")
