"""The generator farm's device math (CUDA, csrc/gens_kernels.cu).

Counterpart of ark_bulletproofs_tpu/ops/gens.py. The chain
(generators.py::GeneratorsChain) samples every generator as arkworks'
`Affine::rand` does: `Fp::rand` draws x (eight ChaCha20 words, masked to
the field's bits, redrawn while x >= p; the raw words are x's Montgomery
form), one more word's top bit asks for the larger root, and the attempt
succeeds where x^3 + a x + b is a square. The farm frames the stream
nine words an attempt and evaluates a whole batch of attempts at once:

  gen_candidates <- ark_bulletproofs_tpu/ops/kernels.py:303 mont_mul_tiled,
      as the JAX farm reaches it (its ops/gens.py:99 pow_bits, one product
      launch a step of the square-and-multiply scan) with the XLA ops
      around it and the host's pick of the root: one launch computes every
      attempt's canonical x, its root (picked by the sign word) and
      whether it is on the curve.

`gen_candidates` launches the kernel on CUDA tensors (counted in
`gen_candidates.launches`) and runs its plain version on CPU tensors
(`gen_candidates_plain`: `candidate_roots_plain`, the JAX package's
`_candidate_roots` step for step on ops/field.py's plain product, then the
JAX package's pick by the sign word); any other device raises. The plain
versions serve the tests and chip_smoke.py; no path calls them where a
card is present. The kernel raises the power in fixed windows
(csrc/gens_kernels.cu), the plain version bit by bit as the JAX scan
does; the power is unique, so both give the same bits.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import field as df
from .curve import spec_for
from .kernels import launch
from .limbs import N_LIMBS


@dataclass(frozen=True)
class SqrtSpec:
    """A field's Tonelli-Shanks constants: p - 1 = q 2^s with q odd, the
    exponent (q - 1) / 2 of the one power (from w = a^((q - 1) / 2) come
    both seeds, r = w a and t = w r), z^q for the least non-residue z and
    -1, both in Montgomery form (limbs)."""

    fq: df.FieldSpec
    s: int
    qm1h: int  # (q - 1) / 2
    c0_mont: tuple  # z^q * R mod p
    neg_one_mont: tuple  # (p - 1) * R mod p

    @classmethod
    def create(cls, fq: df.FieldSpec) -> "SqrtSpec":
        p = fq.p
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        return cls(fq=fq, s=s, qm1h=(q - 1) // 2,
                   c0_mont=df._limbs_of(pow(z, q, p) * fq.R % p),
                   neg_one_mont=df._limbs_of((p - 1) * fq.R % p))

    @property
    def qm1h_bits(self) -> tuple:
        """The exponent's bits, MSB first, trimmed to its bit length."""
        e = self.qm1h
        width = max(e.bit_length(), 1)
        return tuple((e >> (width - 1 - i)) & 1 for i in range(width))


_SQRT_SPECS: dict[str, SqrtSpec] = {}

# The kernel's window of exponent bits (csrc/gens_kernels.cu: POW_WIN;
# tests/test_torch_gens.py ties the two).
POW_WIN = 4


# 32-bit multiply instructions of csrc/field.cuh's arithmetic on 8 limbs:
# a Montgomery reduction alone (8 steps of one mul.lo for m and 8 wide
# products of m p, low and high halves), a square (its 36 distinct limb
# products, low and high, and a reduction) and a product (64 and one).
REDC_MULS = 8 * (1 + 2 * 8)
SQR_MULS = 2 * 36 + REDC_MULS
MUL_MULS = 2 * 64 + REDC_MULS


def pow_products(e: int, win: int = POW_WIN) -> int:
    """Field products of the kernel's power a^e in fixed windows of `win`
    bits: the table a^2 .. a^(2^win - 1), `win` squarings a window below
    the top one, and one product a nonzero window."""
    nd = (max(e.bit_length(), 1) + win - 1) // win
    mask = (1 << win) - 1
    return ((1 << win) - 2 + win * (nd - 1)
            + sum(1 for d in range(nd - 1) if (e >> (d * win)) & mask))


def kernel_products(cspec, sq: "SqrtSpec") -> int:
    """Field products of one attempt of gen_candidates_kernel: x^3 (and
    a x), the power, the two seeds, the tail (k - 1 squarings and three
    products for k = s - 1 .. 1), the check r^2 and two from_mont."""
    tail = sum(k + 2 for k in range(1, sq.s))
    return (2 + (not cspec.is_a_zero) + pow_products(sq.qm1h) + 2 + tail + 1
            + 2)


def sliding_schedule(e: int, win: int) -> tuple:
    """(squarings, other products) of a^e by sliding windows of up to
    `win` bits, MSB first: a^2 and the odd powers a^3 .. a^(2^win - 1),
    the first window looked up, then for each later window (starting and
    ending on a 1 bit) its squarings and one product, and a squaring for
    each 0 bit between windows."""
    bits = bin(e)[2:]
    squarings, products = (1 if win > 1 else 0), (1 << (win - 1)) - 1
    first, i = True, 0
    while i < len(bits):
        if bits[i] == "0":
            squarings += 1
            i += 1
            continue
        j = min(i + win, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        if not first:
            squarings += j - i
            products += 1
        first, i = False, j
    return squarings, products


def least_muls(cspec, sq: "SqrtSpec") -> int:
    """The 32-bit multiplies one attempt needs, from the curve and the
    exponent alone, not from the kernel's schedule (gen_candidates's bound
    in chip_smoke.py): x^2 as a square, x^3 (and a x) as products; the
    power by the cheapest sliding window, its squarings at a square's
    cost; the two seeds; s - 1 squarings of t (Euler's criterion, which
    also finds a square's correction); x and y out of Montgomery form as
    reductions. Left out: the tail's products by c, which the data needs
    on some steps only, the powers of c, the same on every lane, and the
    check r^2 (Euler's criterion decides ok)."""
    power = min(sqr * SQR_MULS + mul * MUL_MULS
                for sqr, mul in (sliding_schedule(sq.qm1h, w)
                                 for w in range(1, 9)))
    squares = 1 + (sq.s - 1)  # x^2, then t's
    products = 1 + (not cspec.is_a_zero) + 2  # x^3 (and a x), the seeds
    return squares * SQR_MULS + products * MUL_MULS + power + 2 * REDC_MULS


def sqrt_spec_for(field) -> SqrtSpec:
    sp = _SQRT_SPECS.get(field.name)
    if sp is None:
        sp = SqrtSpec.create(df.spec_for(field))
        _SQRT_SPECS[field.name] = sp
    return sp


def pow_bits_plain(fs: df.FieldSpec, x, bits) -> torch.Tensor:
    """x^e for Montgomery x (16, m); bits: e MSB first. The JAX scan step
    for step: square, multiply, keep the product where the bit is 1."""
    acc = df.const(fs.r_limbs, x.device).expand(x.shape).long()
    for bit in bits:
        acc = df.mont_mul_plain(fs, acc, acc)
        mul = df.mont_mul_plain(fs, acc, x)
        take = torch.full(x.shape[-1:], bool(bit), device=x.device)
        acc = df.select(take, mul, acc)
    return acc


def _eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-2)


def batched_sqrt_plain(sq: SqrtSpec, a) -> tuple:
    """Branch-free batched Tonelli-Shanks, the JAX batched_sqrt. a: (16, m)
    Montgomery. Returns (root, is_square); for a non-square the root is
    garbage; a = 0 gives (0, True)."""
    f = sq.fq
    mm = lambda u, v: df.mont_mul_plain(f, u, v)  # noqa: E731
    a = a.long()
    w = pow_bits_plain(f, a, sq.qm1h_bits)
    r = mm(w, a)  # a^((q + 1) / 2)
    t = mm(w, r)  # a^q
    c = df.const(sq.c0_mont, a.device).expand(a.shape)
    neg1 = df.const(sq.neg_one_mont, a.device)
    for i in range(sq.s - 1, 0, -1):
        d = t
        for _ in range(i - 1):
            d = mm(d, d)
        cond = _eq(d, neg1)
        r = df.select(cond, mm(r, c), r)
        c = mm(c, c)
        t = df.select(cond, mm(t, c), t)
    return r, _eq(mm(r, r), a)


def candidate_roots_plain(cspec, sq: SqrtSpec, x_raw) -> tuple:
    """The JAX `_candidate_roots`: x_raw (16, m) raw limbs below p (x's
    Montgomery form) -> (y, ok, xc): the Tonelli-Shanks root of x^3 + a x
    + b (canonical, int64), whether it is one, and x canonical."""
    f = cspec.fq
    dev = x_raw.device
    x = x_raw.long()
    rhs = df.mont_mul_plain(f, df.mont_mul_plain(f, x, x), x)
    if not cspec.is_a_zero:
        rhs = df.add_plain(f, rhs, df.mont_mul_plain(
            f, df.const(cspec.a_mont_limbs, dev), x))
    rhs = df.add_plain(f, rhs, df.const(cspec.b_mont_limbs, dev))
    root, ok = batched_sqrt_plain(sq, rhs)
    one = df.const(df._limbs_of(1), dev)
    return (df.mont_mul_plain(f, root, one), ok,
            df.mont_mul_plain(f, x, one))


def _words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(m, 8) 32-bit words (int32 or int64) -> (16, m) int64 16-bit limbs."""
    w = w.long() & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        w.shape[0], N_LIMBS).T


def _limbs_to_words(t: torch.Tensor) -> torch.Tensor:
    """(16, m) 16-bit limbs -> (m, 8) int32 words (bit patterns)."""
    t = t.long().T.reshape(-1, 8, 2)
    w = t[..., 0] | (t[..., 1] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def gen_candidates_plain(cspec, sq: SqrtSpec, words: torch.Tensor) -> tuple:
    """The plain version of `gen_candidates` (same arguments and
    results)."""
    y, ok, xc = candidate_roots_plain(cspec, sq, _words_to_limbs(words[:, :8]))
    greatest = words[:, 8] < 0  # the top bit of the sign word
    ny = df.neg_plain(cspec.fq, y)
    larger = torch.zeros_like(ok)  # y > ny, decided from the top limb
    undecided = torch.ones_like(ok)
    for k in range(N_LIMBS - 1, -1, -1):
        larger |= undecided & (y[k] > ny[k])
        undecided &= y[k] == ny[k]
    y = df.select(larger == greatest, y, ny)
    return torch.cat([_limbs_to_words(xc), _limbs_to_words(y)], dim=1), ok


_GEN_WORDS: dict = {}


def gen_words(cspec, sq: SqrtSpec) -> np.ndarray:
    """The 34 uint32 words of csrc/gens_kernels.cu::GenConst (kept alive in
    a cache: ctypes passes a pointer to them)."""
    w = _GEN_WORDS.get(cspec)
    if w is None:
        def words(limbs) -> list[int]:
            v = sum(x << (16 * i) for i, x in enumerate(limbs))
            return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]

        e = sq.qm1h
        w = np.array(words(cspec.b_mont_limbs) + words(sq.c0_mont)
                     + words(sq.neg_one_mont)
                     + [(e >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     + [max(e.bit_length(), 1), sq.s], dtype=np.uint32)
        _GEN_WORDS[cspec] = w
    return w


def gen_candidates(cspec, sq: SqrtSpec, words: torch.Tensor) -> tuple:
    """Evaluate m sampling attempts of a short-Weierstrass curve.

    words: (m, 9) int32, contiguous: an attempt's eight raw x words (its
    `Fp::rand` limbs, masked, below p: x's Montgomery form) and its sign
    word. Returns (xy, ok): xy (m, 16) int32 of 32-bit words, x canonical
    in 0-7 and y in 8-15; ok (m,) bool, whether x is on the curve. y is
    the root the sign word's top bit asks for (the larger one where it is
    1); where ok is False, y is garbage.

    On a CUDA tensor: one launch of csrc/gens_kernels.cu, counted in
    `gen_candidates.launches`; on a CPU tensor: `gen_candidates_plain`."""
    if words.dtype != torch.int32 or words.dim() != 2 or words.shape[1] != 9:
        raise ValueError(f"gen_candidates words: expected an int32 (m, 9) "
                         f"tensor, got {words.dtype} {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("gen_candidates words: tensor must be contiguous")
    dev = words.device
    if dev.type == "cpu":
        return gen_candidates_plain(cspec, sq, words)
    if dev.type != "cuda":
        raise ValueError(f"gen_candidates: unsupported device {dev}")
    m = words.shape[0]
    xy = torch.empty(m, 2 * 8, dtype=torch.int32, device=dev)
    ok = torch.empty(m, dtype=torch.bool, device=dev)
    if m == 0:
        return xy, ok
    launch("gen_candidates", cspec, dev, words.data_ptr(), xy.data_ptr(),
           ok.data_ptr(), m,
           gen_words(cspec, sq).ctypes.data_as(ctypes.c_void_p))
    gen_candidates.launches += 1
    return xy, ok


gen_candidates.launches = 0


def candidate_points(curve, words: np.ndarray, device) -> tuple:
    """The chain's batch: words (m, 9) uint32 attempts (x masked and below
    p) -> (xy, ok) of `gen_candidates` on `device`, the root picked by
    each attempt's sign word. The words go to the device as they are."""
    cspec = spec_for(curve)
    t = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
    return gen_candidates(cspec, sqrt_spec_for(curve.fq), t.to(device))
