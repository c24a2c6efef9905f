"""The port's generator farm (ops/gens.py, GeneratorsChain's farm route)
against the JAX package and the host chain, on the CPU.

- The port's plain `candidate_roots` (the JAX algorithm step for step)
  bit-equal to JAX `_candidate_roots` (root y, ok, x canonical) on 256
  numpy-seeded attempts with edge lanes (x = 0, 1, p - 1, non-squares
  among the random lanes), and `gen_candidates` (on CPU tensors: its plain
  version) on those attempts with sign words equal to JAX
  `candidate_points`, which picks the root on the host.
- The kernel's own algorithm (csrc/gens_kernels.cu: the power in fixed
  windows of POW_WIN bits, the tail, the pick by the sign word),
  transcribed into Python ints, against pow() and the host model's
  get_point_from_x, and `gen_candidates_plain` against the transcription;
  at every window width 1 to 5 (bench_kernels.py builds the others); the
  sliding windows the kernel's bound counts (`least_muls`) against pow.
- The chain with the farm's gate and chunk lowered (`_DEVICE_MIN`,
  `_DEVICE_CHUNK`) on the CPU equal to the port's host chain and the JAX
  package's: fast_forward then take across chunk boundaries,
  BulletproofGens, zorro (p just above 2^255: the first chunk holds an
  x >= p and replays on the host), and a secq256k1 rejection planted in
  the stream (the same planted stream on every side).

Tolerance: exact (field values and points).
"""

import os
import re

import numpy as np
import pytest
import torch

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.generators import GeneratorsChain as JaxChain
from ark_bulletproofs_tpu.ops import curve as jcurve
from ark_bulletproofs_tpu.ops import gens as jgens
from ark_bulletproofs_tpu_torch import BulletproofGens, curves, engine
from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
from ark_bulletproofs_tpu_torch.hashes.chacha import ChaChaRng
from ark_bulletproofs_tpu_torch.ops import _build
from ark_bulletproofs_tpu_torch.ops import gens
from ark_bulletproofs_tpu_torch.ops.curve import spec_for
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

SW = ["secq256k1", "zorro"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


@pytest.fixture
def farm(monkeypatch):
    """The farm's gate and chunk lowered, so small requests take it."""
    monkeypatch.setattr(GeneratorsChain, "_DEVICE_MIN", 64)
    monkeypatch.setattr(GeneratorsChain, "_DEVICE_CHUNK", 256)


def _raw_xs(curve, m: int, seed: int) -> list[int]:
    """m raw x values below p: 0, 1, p - 1, then numpy-seeded ones."""
    p = curve.fq.p
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(m, 8),
                                                 dtype=np.uint64)
    xs = [int.from_bytes(w.astype("<u4").tobytes(), "little") % p
          for w in words]
    xs[:3] = [0, 1, p - 1]
    return xs


@pytest.mark.parametrize("name", SW)
def test_candidate_roots_match_jax(name):
    curve = getattr(curves, name)
    jc = getattr(jax_pkg.curves, name)
    spec, sq = spec_for(curve), gens.sqrt_spec_for(curve.fq)
    xs = _raw_xs(curve, 256, seed=15 + len(name))
    x_raw = ints_to_limbs(xs)  # (16, m)
    y, ok, xc = gens.candidate_roots_plain(spec, sq, x_raw)
    jy, jok, jxc = jgens._candidate_roots(
        jcurve.spec_for(jc), jgens.sqrt_spec_for(jc.fq),
        np.ascontiguousarray(x_raw.numpy().T).astype(np.uint32))
    assert torch.equal(y, torch.from_numpy(np.asarray(jy).T.astype(np.int64)))
    assert torch.equal(xc,
                       torch.from_numpy(np.asarray(jxc).T.astype(np.int64)))
    assert ok.tolist() == np.asarray(jok).tolist()
    ok_l = ok.tolist()
    assert 0 < sum(ok_l) < len(ok_l)  # squares and non-squares
    p, R_inv = curve.fq.p, curve.fq.R_inv
    for x, yv, good, xcv in zip(xs, limbs_to_ints(y), ok_l,
                                limbs_to_ints(xc)):
        x = x * R_inv % p
        assert xcv == x
        assert good == (curve.get_ys_from_x(x) is not None)
        if good:
            assert yv * yv % p == (x ** 3 + curve.a * x + curve.b) % p
    # the picked root, as the chain takes it, against the JAX host's pick
    signs = np.random.default_rng(16).integers(0, 1 << 32, size=256,
                                               dtype=np.uint64)
    words = np.zeros((256, 9), dtype=np.uint32)
    words[:, :8] = np.frombuffer(b"".join(x.to_bytes(32, "little")
                                          for x in xs), "<u4").reshape(-1, 8)
    words[:, 8] = signs
    xy, pok = gens.gen_candidates(spec, sq,
                                  torch.from_numpy(words.view(np.int32)))
    xy = xy.numpy().view(np.uint32)
    want = jgens.candidate_points(jc, xs, [bool(int(g) >> 31) for g in signs])
    assert pok.tolist() == ok_l
    assert {bool(int(g) >> 31) for g, P in zip(signs, want) if P} == {
        False, True}
    for i, P in enumerate(want):
        got_x = int.from_bytes(xy[i, :8].astype("<u4").tobytes(), "little")
        assert got_x == limbs_to_ints(xc)[i]
        if P is not None:
            got_y = int.from_bytes(xy[i, 8:].astype("<u4").tobytes(),
                                   "little")
            assert (got_x, got_y) == P


# --- the kernel's algorithm, transcribed (csrc/gens_kernels.cu) ----------


def _pow_win() -> int:
    """POW_WIN as the kernel source sets it and as bench_kernels.py's
    window variants substitute it."""
    src = open(_build._CSRC + "/gens_kernels.cu").read()
    win = int(re.search(r"#define POW_WIN (\d+)", src).group(1))
    bench = open(os.path.join(os.path.dirname(_build._PKG),
                              "bench_kernels.py")).read()
    assert f'GENS_WINDOW = "#define POW_WIN {win}"' in bench
    return win


def _exp_window(e_words: list[int], d: int, W: int) -> int:
    """exp_window: window d of the exponent, from its eight 32-bit words."""
    pos = d * W
    word, off = pos >> 5, pos & 31
    v = e_words[word] >> off
    if off + W > 32 and word < 7:
        v |= (e_words[word + 1] << (32 - off)) & 0xFFFFFFFF
    return v & ((1 << W) - 1)


def _pow_e(a: int, e: int, p: int, W: int) -> tuple:
    """fe_pow_e on plain values: (a^e mod p, products made)."""
    e_words = [(e >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    tbl = [1, a]
    for j in range(2, 1 << W):
        tbl.append(tbl[j - 1] * a % p)
    products = (1 << W) - 2
    nd = (max(e.bit_length(), 1) + W - 1) // W
    acc = tbl[_exp_window(e_words, nd - 1, W)]
    for d in range(nd - 2, -1, -1):
        for _ in range(W):
            acc = acc * acc % p
        win = _exp_window(e_words, d, W)
        products += W
        if win:
            acc = acc * tbl[win] % p
            products += 1
    return acc, products


def _val(limbs) -> int:
    return sum(v << (16 * i) for i, v in enumerate(limbs))


def _kernel_attempt(curve, sq, x: int, greatest: bool, W: int) -> tuple:
    """One thread of gen_candidates_kernel with pick, on plain values
    (Montgomery form only renames them): (x, y, ok)."""
    p = curve.fq.p
    rhs = (x ** 3 + curve.a * x + curve.b) % p
    w, _ = _pow_e(rhs, sq.qm1h, p, W)
    r, t = w * rhs % p, w * w * rhs % p
    c = _val(sq.c0_mont) * curve.fq.R_inv % p
    for k in range(sq.s - 1, 0, -1):
        d = t
        for _ in range(k - 1):
            d = d * d % p
        cond = d == p - 1
        r = r * c % p if cond else r
        c = c * c % p
        t = t * c % p if cond else t
    ny = (p - r) % p
    y = r if (ny < r) == greatest else ny
    return x, y, r * r % p == rhs


@pytest.mark.parametrize("name", SW)
@pytest.mark.parametrize("W", [1, 2, 3, 4, 5])
def test_kernel_power_schedule_matches_pow(name, W):
    curve = getattr(curves, name)
    sq = gens.sqrt_spec_for(curve.fq)
    p = curve.fq.p
    rng = np.random.default_rng(W)
    for a in [0, 1, p - 1, *(int(v) for v in rng.integers(2, 1 << 62,
                                                            size=8))]:
        a = a * 0x9E3779B97F4A7C15 % p
        got, products = _pow_e(a, sq.qm1h, p, W)
        assert got == pow(a, sq.qm1h, p)
    # the count the kernel's bound in chip_smoke.py uses
    assert products == gens.pow_products(sq.qm1h, W)
    assert _pow_win() == gens.POW_WIN


def _pow_sliding(a: int, e: int, p: int, W: int) -> tuple:
    """a^e mod p by sliding windows of up to W bits, MSB first: (value,
    squarings, other products)."""
    sq = a * a % p
    odd = {1: a}
    for j in range(3, 1 << W, 2):
        odd[j] = odd[j - 2] * sq % p
    squarings, products = (1 if W > 1 else 0), (1 << (W - 1)) - 1
    bits = bin(e)[2:]
    acc, i = None, 0
    while i < len(bits):
        if bits[i] == "0":
            acc, i = acc * acc % p, i + 1
            squarings += 1
            continue
        j = min(i + W, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        win = int(bits[i:j], 2)
        if acc is None:
            acc = odd[win]
        else:
            for _ in range(j - i):
                acc = acc * acc % p
            squarings += j - i
            acc = acc * odd[win] % p
            products += 1
        i = j
    return acc, squarings, products


@pytest.mark.parametrize("name", SW)
@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 6])
def test_bound_sliding_windows_match_pow(name, W):
    """The schedules least_muls picks from are real ones: their squarings
    and products compute the power, and count at least the bit length less
    one steps, as any addition chain must."""
    curve = getattr(curves, name)
    sq = gens.sqrt_spec_for(curve.fq)
    p, e = curve.fq.p, sq.qm1h
    for a in [1, 2, p - 1, 0x9E3779B97F4A7C15 * W % p]:
        got, squarings, products = _pow_sliding(a, e, p, W)
        assert got == pow(a, e, p)
    assert (squarings, products) == gens.sliding_schedule(e, W)
    assert squarings + products >= e.bit_length() - 1
    assert gens.SQR_MULS < gens.MUL_MULS == 264  # chip_smoke's product
    spec = spec_for(curve)
    assert gens.least_muls(spec, sq) < (gens.kernel_products(spec, sq)
                                        * gens.MUL_MULS)


@pytest.mark.parametrize("name", SW)
def test_kernel_attempts_match_host_model_and_plain(name):
    curve = getattr(curves, name)
    sq = gens.sqrt_spec_for(curve.fq)
    xs = _raw_xs(curve, 48, seed=7)
    signs = np.random.default_rng(8).integers(0, 1 << 32, size=48,
                                              dtype=np.uint64)
    signs[:6] = [0, 1 << 31, 0, 1 << 31, 0, 1 << 31]
    words = np.zeros((48, 9), dtype=np.uint32)
    words[:, :8] = np.frombuffer(b"".join(x.to_bytes(32, "little")
                                          for x in xs), "<u4").reshape(48, 8)
    words[:, 8] = signs
    xy, ok = gens.gen_candidates(spec_for(curve), sq,
                                 torch.from_numpy(words.view(np.int32)))
    xy = xy.numpy().view(np.uint32)
    R_inv, p = curve.fq.R_inv, curve.fq.p
    for i, (x_raw, sgn) in enumerate(zip(xs, signs)):
        x = x_raw * R_inv % p
        greatest = bool(int(sgn) >> 31)
        want = curve.get_point_from_x(x, greatest)
        for W in (1, 2, 3, 4, 5):
            kx, ky, kok = _kernel_attempt(curve, sq, x, greatest, W)
            assert kok == (want is not None)
            assert (kx, ky) == want if kok else True
        got_x = int.from_bytes(xy[i, :8].astype("<u4").tobytes(), "little")
        got_y = int.from_bytes(xy[i, 8:].astype("<u4").tobytes(), "little")
        assert bool(ok[i]) == (want is not None)
        assert got_x == x
        if want is not None:
            assert (got_x, got_y) == want
        else:  # the tail's garbage, as the transcription computes it
            assert got_y == _kernel_attempt(curve, sq, x, greatest,
                                            gens.POW_WIN)[1]


# --- the chain ------------------------------------------------------------


class _Planted(ChaChaRng):
    """A ChaCha stream with the eight x words of attempt `at` (9 words an
    attempt from the stream's start) set to 0xFFFFFFFF: an x >= p, which
    `Fp::rand` rejects and redraws."""

    def __init__(self, seed: bytes, at: int):
        super().__init__(seed)
        self.planted = range(9 * at, 9 * at + 8)

    def _patch_buf(self) -> None:
        base = 16 * (self._counter - 1)
        self._buf = [0xFFFFFFFF if base + i in self.planted else w
                     for i, w in enumerate(self._buf)]

    def _refill(self) -> None:
        super()._refill()
        self._patch_buf()

    def next_u32_array(self, k: int):
        start = self._abs_pos()
        out = super().next_u32_array(k)
        for pos in self.planted:
            if start <= pos < start + k:
                out[pos - start] = 0xFFFFFFFF
        if self._buf:
            self._patch_buf()
        return out


def _seed(label: bytes) -> bytes:
    from ark_bulletproofs_tpu_torch.hashes.keccak import sha3_512

    return sha3_512(b"GeneratorsChain" + label)[:32]


def test_farm_matches_host_and_jax_across_chunks(farm):
    curve = curves.secq256k1
    replays = GeneratorsChain.replays
    dev = GeneratorsChain(curve, b"chunked").fast_forward(70)
    got = dev.take(300)  # about 600 attempts: several 256-attempt chunks
    host = GeneratorsChain(curve, b"chunked")
    for _ in range(70):
        curve.rand(host._rng)
    want = [curve.rand(host._rng) for _ in range(300)]
    jax_chain = JaxChain(jax_pkg.curves.secq256k1, b"chunked")
    jax_chain.fast_forward(70)
    assert got == want == jax_chain.take(300)
    assert dev.take(5) == jax_chain.take(5)  # the stream rewound exactly
    assert GeneratorsChain.replays == replays


def test_farm_bulletproof_gens_match_host_and_jax(farm, monkeypatch):
    curve = curves.secq256k1
    dev = BulletproofGens(curve, 130, 1)
    jax_bp = jax_pkg.BulletproofGens(jax_pkg.curves.secq256k1, 130, 1)
    monkeypatch.setattr(GeneratorsChain, "_DEVICE_MIN", 1 << 62)
    host = BulletproofGens(curve, 130, 1)
    assert dev.G_vec == host.G_vec == jax_bp.G_vec
    assert dev.H_vec == host.H_vec == jax_bp.H_vec


def test_farm_zorro_replays_on_host(farm):
    curve = curves.zorro
    replays = GeneratorsChain.replays
    dev = GeneratorsChain(curve, b"G\0\0\0\0")
    got = dev.take(100)
    assert GeneratorsChain.replays == replays + 1
    jax_chain = JaxChain(jax_pkg.curves.zorro, b"G\0\0\0\0")
    assert got == jax_chain.take(100)
    assert dev.take(3) == jax_chain.take(3)


def test_farm_planted_rejection_replays(farm):
    """fast_forward(70) takes about 140 attempts, so take(300)'s third
    chunk of 256 attempts holds the planted attempt 700: the farm evaluates
    two chunks, then replays the rest from the third's start."""
    curve = curves.secq256k1
    label = b"planted"
    replays = GeneratorsChain.replays
    dev = GeneratorsChain(curve, label)
    dev._rng = _Planted(_seed(label), at=700)
    dev.fast_forward(70)
    got = dev.take(300)
    assert GeneratorsChain.replays == replays + 1
    host_rng = _Planted(_seed(label), at=700)
    want = [curve.rand(host_rng) for _ in range(370)][70:]
    jax_chain = JaxChain(jax_pkg.curves.secq256k1, label)
    jax_chain._rng = _Planted(_seed(label), at=700)
    jax_chain.fast_forward(70)
    assert got == want == jax_chain.take(300)
    assert dev.take(4) == [curve.rand(host_rng) for _ in range(4)]
