"""The port's on-device Fiat-Shamir byte layer (ops/fs.py) vs the JAX
package's ops/fs.py and the host transcript model.

Tolerance: exact everywhere (equal bytes, equal limbs, equal positions):
Keccak-f, the Merlin append and challenge sequences (state bytes, pos,
pos_begin, squeezed bytes) at positions that cross the STROBE rate, the
ChaCha20 block, `fr_rand_from_seed` on the three scalar fields (against
the JAX function where its single draw is accepted, and against the host
`Field.rand` on every seed, rejections included), `mont_pow_pm2`,
`mont_inv_batch`, the point encoders, and the plain `fs_round` against
the same steps composed from the JAX functions. Inputs come from numpy
with fixed seeds; on the CPU `fs_round` runs its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.ops import field as jf
from ark_bulletproofs_tpu.ops import fs as jfs
from ark_bulletproofs_tpu_torch import curves, seeded_rng
from ark_bulletproofs_tpu_torch.hashes.chacha import (ChaChaRng,
                                                      chacha20_block_words)
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops import fs
from ark_bulletproofs_tpu_torch.ops.curve import spec_for
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from ark_bulletproofs_tpu_torch.transcript.merlin import Transcript
from ark_bulletproofs_tpu_torch.transcript.strobe import Strobe128

torch.set_num_threads(1)

CURVES = ["secq256k1", "zorro", "curve25519"]


def _u32(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _rand_ints(p: int, n: int, seed: int) -> list[int]:
    raw = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(n, 16), dtype=np.uint16).tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") % p
            for i in range(n)]


def test_keccak_f1600_matches_jax():
    rng = np.random.default_rng(1)
    lo = torch.from_numpy(rng.integers(0, 1 << 32, size=(3, 25)))
    hi = torch.from_numpy(rng.integers(0, 1 << 32, size=(3, 25)))
    got = fs.keccak_f1600(lo, hi)
    want = jfs.keccak_f1600_dev(_u32(lo), _u32(hi))
    assert all(torch.equal(g, _t(w)) for g, w in zip(got, want))


def _host_state(label: bytes, pre: int):
    """A live transcript after `pre` bytes of messages: the batch of two
    states made from it (the second with flipped bytes), pos, pos_begin,
    and the transcript."""
    t = Transcript(label)
    if pre:
        t.append_message(b"pre", bytes(range(pre)))
    s = t._strobe
    st = torch.tensor(list(s.state), dtype=torch.int64)
    return torch.stack([st, st ^ 0x5A]), s.pos, s.pos_begin, t


def _host_transcript(st: torch.Tensor, pos: int, pb: int) -> Transcript:
    """The host model at state bytes st and position (pos, pb)."""
    s = Strobe128(_clone=True)
    s.state = bytearray(st.tolist())
    s.pos, s.pos_begin, s.cur_flags = pos, pb, 0
    return Transcript(None, _strobe=s)


def _round_host(t: Transcript, Lb: bytes, Rb: bytes) -> bytes:
    t.append_message(b"L", Lb)
    t.append_message(b"R", Rb)
    return t.challenge_bytes(b"u", 32)


@pytest.mark.parametrize("pre", [0, 60, 130])
def test_merlin_sequence_matches_host(pre):
    """append_message "L" and "R" of 65 bytes, then challenge_bytes "u"
    (32): one IPA round's transcript operations on two transcripts in
    lockstep, against the host model (state bytes, pos, pos_begin and the
    squeezed bytes); from pre = 130 the appends cross the STROBE rate."""
    st, pos, pb, _ = _host_state(b"fs test", pre)
    msgs = torch.from_numpy(np.random.default_rng(pre).integers(
        0, 256, size=(2, 2, 65)))
    got = fs.append_message(st, pos, pb, b"L", msgs[0])
    got = fs.append_message(*got, b"R", msgs[1])
    st2, pos2, pb2, out = fs.challenge_bytes(*got, b"u", 32)
    for b in range(2):
        t = _host_transcript(st[b], pos, pb)
        assert bytes(out[b].tolist()) == _round_host(
            t, bytes(msgs[0][b].tolist()), bytes(msgs[1][b].tolist()))
        assert bytes(st2[b].tolist()) == bytes(t._strobe.state)
        assert (pos2, pb2) == (t._strobe.pos, t._strobe.pos_begin)


def test_merlin_sequence_matches_jax():
    """The same round against the JAX package's Merlin functions, on one
    transcript whose appends cross the STROBE rate."""
    st, pos, pb, _ = _host_state(b"fs test", 130)
    msgs = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, size=(2, 65)))
    got = fs.append_message(st[:1], pos, pb, b"L", msgs[:1])
    got = fs.append_message(*got, b"R", msgs[1:])
    st2, pos2, pb2, out = fs.challenge_bytes(*got, b"u", 32)
    j = (_u32(st[0]), jnp.uint32(pos), jnp.uint32(pb))
    j = jfs.append_message(*j, b"L", _u32(msgs[0]))
    j = jfs.append_message(*j, b"R", _u32(msgs[1]))
    jst, jpos, jpb, jout = jfs.challenge_bytes(*j, b"u", 32)
    assert torch.equal(st2[0], _t(jst))
    assert (pos2, pb2) == (int(jpos), int(jpb))
    assert torch.equal(out[0], _t(jout))


@pytest.mark.parametrize("name", CURVES)
def test_round_positions_follow_the_host(name):
    spec = spec_for(getattr(curves, name))
    for pre in (0, 60, 130):
        _, pos, pb, t = _host_state(b"pos", pre)
        msg = bytes(fs.message_len(spec))
        t.append_message(b"L", msg)
        t.append_message(b"R", msg)
        t.challenge_bytes(b"u", 32)
        assert fs.round_positions(spec, pos, pb) == (t._strobe.pos,
                                                     t._strobe.pos_begin)


def test_chacha20_block_matches_jax_and_host():
    rng = np.random.default_rng(2)
    key = torch.from_numpy(rng.integers(0, 1 << 32, size=(4, 8)))
    assert torch.equal(fs.chacha20_block(key, 0),
                       _t(jfs.chacha20_block0(_u32(key))))
    for ctr in (1, 7, (1 << 32) + 3):
        got = fs.chacha20_block(key, ctr)
        for b in range(4):
            want = chacha20_block_words(tuple(key[b].tolist()), ctr)
            assert got[b].tolist() == want


@pytest.mark.parametrize("name", CURVES)
def test_fr_rand_from_seed_matches_jax_and_host(name):
    curve = getattr(curves, name)
    fr = df.spec_for(curve.fr)
    jfr = jf.spec_for(getattr(jax_pkg.curves, name).fr)
    seeds = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, size=(16, 32)))
    u, ok = fs.fr_rand_from_seed(fr, seeds)
    assert ok.all()
    jl, jok = jfs.fr_rand_from_seed(jfr, curve.fr.num_bits, _u32(seeds))
    jl, jok = _t(jl), np.asarray(jok)
    if name == "curve25519":
        assert not jok.all()  # a rejected first draw is covered
    for b in range(16):
        if jok[b]:
            assert torch.equal(u[:, b], jl[b])
        want = curve.fr.rand(ChaChaRng(bytes(seeds[b].tolist())))
        assert limbs_to_ints(u[:, b:b + 1])[0] == want * curve.fr.R % \
            curve.fr.p


@pytest.mark.parametrize("name", CURVES)
def test_inversions_match_python(name):
    """mont_pow_pm2 and mont_inv_batch on fq and fr: Montgomery inverses,
    0 for 0."""
    curve = getattr(curves, name)
    for f in (curve.fq, curve.fr):
        vals = [0, 1, f.p - 1] + _rand_ints(f.p, 5, 4)
        x = ints_to_limbs([v * f.R % f.p for v in vals])
        got = fs.mont_pow_pm2(df.spec_for(f), x)
        assert [v * f.R_inv % f.p for v in limbs_to_ints(got)] == \
            [pow(v, f.p - 2, f.p) for v in vals]
        assert torch.equal(fs.mont_inv_batch(df.spec_for(f), x), got)


@pytest.mark.parametrize("which", ["pow", "batch"])
def test_inversions_match_jax(which):
    """Against the JAX package's mont_pow_pm2 (secq256k1 fq) and
    mont_inv_batch (zorro fr)."""
    name, field = ("secq256k1", "fq") if which == "pow" else ("zorro", "fr")
    f = getattr(getattr(curves, name), field)
    jsp = jf.spec_for(getattr(getattr(jax_pkg.curves, name), field))
    vals = [0, 1, f.p - 1] + _rand_ints(f.p, 5, 4)
    x = ints_to_limbs([v * f.R % f.p for v in vals])
    if which == "pow":
        got = fs.mont_pow_pm2(df.spec_for(f), x)
        want = jfs.mont_pow_pm2(jsp, _u32(x.T.contiguous()))
    else:
        got = fs.mont_inv_batch(df.spec_for(f), x)
        want = jfs.mont_inv_batch(jsp, _u32(x.T.contiguous()))
    assert torch.equal(got, _t(want).T)


@pytest.mark.parametrize("name", CURVES)
def test_point_encodings_match_jax_and_host(name):
    curve = getattr(curves, name)
    jcurve = getattr(jax_pkg.curves, name)
    fq = df.spec_for(curve.fq)
    jfq = jf.spec_for(jcurve.fq)
    bits = curve.fq.num_bits
    rng = seeded_rng(5)
    pts = [curve.rand(rng) for _ in range(4)]
    pts[1] = curve.neg(pts[0])  # both y signs
    te = spec_for(curve).__class__.__name__.startswith("TE")
    if te:
        pts.append((0, 1))
    xc = ints_to_limbs([p[0] for p in pts])
    yc = ints_to_limbs([p[1] for p in pts])
    if te:
        got = fs.te_point_uncompressed_bytes(fq, xc, yc)
        want = jfs.te_point_uncompressed_bytes(jfq, bits, _u32(xc.T), _u32(
            yc.T))
    else:
        pts.append(None)
        xc = torch.cat([xc, torch.zeros(16, 1, dtype=torch.int64)], dim=1)
        yc = torch.cat([yc, torch.zeros(16, 1, dtype=torch.int64)], dim=1)
        inf = torch.tensor([False] * 4 + [True])
        got = fs.point_uncompressed_bytes(fq, xc, yc, inf)
        want = jfs.point_uncompressed_bytes(jfq, bits, _u32(xc.T), _u32(
            yc.T), jnp.asarray(inf.numpy()))
    assert torch.equal(got, _t(want))
    assert got.shape[-1] == fs.message_len(spec_for(curve))
    for b, pt in enumerate(pts):
        assert bytes(got[b].tolist()) == curve.serialize_uncompressed(pt)


def _model_points(curve, pts, seed):
    """(NC, 16, L) Montgomery model coordinates with random Z: Jacobian
    (identity (0, 0, 0)) or TE extended."""
    f = curve.fq
    zs = np.random.default_rng(seed).integers(1, 1 << 62, size=len(pts))
    te = spec_for(curve).__class__.__name__.startswith("TE")
    cols = []
    for pt, z in zip(pts, zs):
        z = int(z)
        if te:
            x, y = pt
            cols.append((x * z, y * z, x * y * z, z))
        elif pt is None:
            cols.append((0, 0, 0))
        else:
            cols.append((pt[0] * z * z, pt[1] * z ** 3, z))
    return torch.stack([ints_to_limbs([c[i] % f.p * f.R % f.p for c in cols])
                        for i in range(len(cols[0]))]).int()


def _fs_round_case(name: str):
    """Two transcripts in lockstep at a position where the round crosses
    the STROBE rate; on a short-Weierstrass curve proof 0's R is the
    identity. Returns the inputs and the plain fs_round's outputs."""
    curve = getattr(curves, name)
    spec = spec_for(curve)
    rng = seeded_rng(6)
    pts = [curve.rand(rng) for _ in range(4)]
    if not spec.__class__.__name__.startswith("TE"):
        pts[1] = None
    S = _model_points(curve, pts, 7)
    st, pos, pb, _ = _host_state(b"fs round", 100)
    out = fs.fs_round(spec, df.spec_for(curve.fr), S, st.int(), pos, pb)
    return curve, spec, pts, S, st, pos, pb, out


@pytest.mark.parametrize("name", CURVES)
def test_fs_round_plain_matches_host(name):
    """Affine L and R, the host encoding appended to the host transcript,
    the host challenge (Field.rand over ChaCha20) and its inverse."""
    curve, spec, pts, S, st, pos, pb, out = _fs_round_case(name)
    xy, u, st2, flags, pos2, pb2 = out
    assert fs.fs_round.launches == 0
    assert (pos2, pb2) == fs.round_positions(spec, pos, pb)
    assert flags[:2].T.reshape(-1).tolist() == [int(p is None) for p in pts]
    assert flags[2].tolist() == [1, 1]
    fr = curve.fr
    for lane, pt in enumerate(pts):
        want = (0, 0) if pt is None else pt
        assert tuple(limbs_to_ints(xy[:, :, lane].T.long())) == want
    for b in range(2):
        t = _host_transcript(st[b], pos, pb)
        enc = [curve.serialize_uncompressed(p) for p in pts[2 * b:2 * b + 2]]
        seed = _round_host(t, *enc)
        assert bytes(st2[b].tolist()) == bytes(t._strobe.state)
        assert (pos2, pb2) == (t._strobe.pos, t._strobe.pos_begin)
        u0, ui = (limbs_to_ints(u[i, :, b:b + 1].long())[0] for i in (0, 1))
        assert u0 == fr.rand(ChaChaRng(seed)) * fr.R % fr.p
        assert ui * u0 % fr.p == fr.R ** 2 % fr.p


@pytest.mark.parametrize("name", ["secq256k1", "curve25519"])
def test_fs_round_plain_matches_jax_composition(name):
    """Transcript 0's round as the JAX package's FS round body composes
    it from its ops/fs.py functions: Z inverse, affine, out of Montgomery
    form, encoding (with the infinity flag on R), the Merlin appends and
    challenge, Fp::rand, the inverse of u."""
    curve, spec, pts, S, st, pos, pb, out = _fs_round_case(name)
    xy, u, st2, _, pos2, pb2 = out
    jcurve = getattr(jax_pkg.curves, name)
    jfq, jfr = jf.spec_for(jcurve.fq), jf.spec_for(jcurve.fr)
    te = name == "curve25519"
    one = np.zeros((1, 16), np.uint32)
    one[0, 0] = 1
    j = (_u32(st[0]), jnp.uint32(pos), jnp.uint32(pb))
    for side, label in ((0, b"L"), (1, b"R")):
        c = [_u32(S[i, :, side:side + 1].T.long()) for i in range(S.shape[0])]
        zi = jfs.mont_pow_pm2(jfq, c[-1])
        if te:
            xa, ya = (jf.mont_mul(jfq, c[i], zi) for i in (0, 1))
        else:
            zi2 = jf.mont_mul(jfq, zi, zi)
            xa = jf.mont_mul(jfq, c[0], zi2)
            ya = jf.mont_mul(jfq, c[1], jf.mont_mul(jfq, zi2, zi))
        xc, yc = (jf.mont_mul(jfq, v, jnp.asarray(one)) for v in (xa, ya))
        assert torch.equal(xy[:, :, side].long(), _t(jnp.concatenate(
            [xc, yc])))
        if te:
            enc = jfs.te_point_uncompressed_bytes(jfq, curve.fq.num_bits, xc,
                                                  yc)
        else:
            enc = jfs.point_uncompressed_bytes(
                jfq, curve.fq.num_bits, xc, yc,
                jnp.asarray([pts[side] is None]))
        j = jfs.append_message(*j, label, enc[0])
    jst, jpos, jpb, seed = jfs.challenge_bytes(*j, b"u", 32)
    assert torch.equal(st2[0].long(), _t(jst))
    assert (pos2, pb2) == (int(jpos), int(jpb))
    ju, jok = jfs.fr_rand_from_seed(jfr, curve.fr.num_bits, seed[None])
    fr = curve.fr
    if bool(jok[0]):  # the JAX function draws once: compare the first draw
        assert torch.equal(u[0, :, 0].long(), _t(ju[0]))
    else:  # a rejected first draw: the port draws on, as the host does
        assert limbs_to_ints(u[0, :, :1].long())[0] == fr.rand(ChaChaRng(
            bytes(np.asarray(seed).tolist()))) * fr.R % fr.p
    assert torch.equal(u[1, :, 0].long(), _t(jfs.mont_pow_pm2(
        jfr, _u32(u[0, :, :1].T.long())))[0])


def test_fs_round_rejects_bad_input():
    spec = spec_for(curves.secq256k1)
    fr = df.spec_for(curves.secq256k1.fr)
    S = torch.zeros(3, 16, 4, dtype=torch.int32)
    st = torch.zeros(2, 200, dtype=torch.int32)
    with pytest.raises(ValueError):
        fs.fs_round(spec, fr, S[..., :3].contiguous(), st, 0, 0)
    with pytest.raises(TypeError):
        fs.fs_round(spec, fr, S, st.long(), 0, 0)
    with pytest.raises(ValueError):
        fs.fs_round(spec_for(curves.curve25519), fr, S, st, 0, 0)
