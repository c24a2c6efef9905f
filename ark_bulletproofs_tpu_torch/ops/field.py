"""256-bit prime-field arithmetic in Montgomery form.

Counterpart of ark_bulletproofs_tpu/ops/field.py. `mont_mul` (the
product, and with a third operand the product plus or minus it),
`add_sub` (and `add`, `sub`, `neg` through it) and `sum_mod` (and
`dot_mod`) are the wrappers of the CUDA field kernels
(csrc/field_kernels.cu): on a CUDA tensor each launches its kernel and
returns int32 with no device-to-host sync, on a CPU tensor it runs its
plain version (`mont_mul_plain`, `add_plain`, `sub_plain`, `neg_plain`,
`sum_mod_plain`), and on anything else it raises. The plain versions
are plain PyTorch, the plain versions of the CUDA field core
(csrc/field.cuh), which the CPU tests run and chip_smoke.py holds the
kernels against on the card; the group-law plain versions (proj.py,
curve.py) call them directly, so they stay plain on the card. Values
are 16 canonical 16-bit limbs along axis -2 of a (..., 16, L) tensor;
every plain function takes any integer dtype and computes and returns
int64 (torch's CPU uint32 has no add, shift or compare). Every result is
canonical in [0, p), so any correct formula gives bit-equal limbs.

`mont_mul_plain` is vectorised over the limb axis: the 31 column sums of the
schoolbook product on whole tensors, carry normalisation by passes,
and a single-shot REDC (m = t * (-p^-1) mod 2^256, r = (t + m p) / 2^256)
— a few dozen torch calls per product instead of one per limb product.

Montgomery radix R = 2^256, as in the JAX package and arkworks.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .limbs import LIMB_BITS, MASK, N_LIMBS


def _limbs_of(x: int, n: int = N_LIMBS, bits: int = LIMB_BITS) -> tuple:
    m = (1 << bits) - 1
    return tuple((x >> (bits * i)) & m for i in range(n))


@dataclass(frozen=True)
class FieldSpec:
    """Per-field constants (hashable)."""

    name: str
    p: int
    p_limbs: tuple  # (16,) 16-bit limbs of p
    nprime_limbs: tuple  # -p^-1 mod 2^256, 16-bit limbs
    r_limbs: tuple  # R mod p (Montgomery one)
    r2_limbs: tuple  # R^2 mod p
    n0_32: int  # -p^-1 mod 2^32, for the 8 x 32-bit CUDA core

    @classmethod
    def create(cls, name: str, p: int) -> "FieldSpec":
        R = (1 << 256) % p
        nprime = (-pow(p, -1, 1 << 256)) % (1 << 256)
        return cls(
            name=name,
            p=p,
            p_limbs=_limbs_of(p),
            nprime_limbs=_limbs_of(nprime),
            r_limbs=_limbs_of(R),
            r2_limbs=_limbs_of(R * R % p),
            n0_32=nprime & 0xFFFFFFFF,
        )

    @property
    def R(self) -> int:
        return (1 << 256) % self.p


_SPECS: dict[str, FieldSpec] = {}


def spec_for(field) -> FieldSpec:
    """FieldSpec for a field of the port's fields.py."""
    s = _SPECS.get(field.name)
    if s is None:
        s = FieldSpec.create(field.name, field.p)
        _SPECS[field.name] = s
    return s


_CONSTS: dict = {}


def const(limbs: tuple, device) -> torch.Tensor:
    """A (16, 1) int64 column of constant limbs on `device` (cached)."""
    key = (limbs, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(limbs, dtype=torch.int64, device=device)[:, None]
        _CONSTS[key] = t
    return t


# (i + j) for the 256 limb products a_i * b_j, row-major.
_COL_IDX: dict = {}


def _col_idx(device) -> torch.Tensor:
    key = str(device)
    t = _COL_IDX.get(key)
    if t is None:
        r = torch.arange(N_LIMBS, device=device)
        t = (r[:, None] + r[None, :]).reshape(-1)
        _COL_IDX[key] = t
    return t


def _broadcast(sa, sb) -> tuple:
    """The broadcast of two shapes that broadcast (`torch.broadcast_shapes`
    without its checks, which cost about 0.2 ms a call)."""
    sa, sb = tuple(sa), tuple(sb)
    if sa == sb:
        return sa
    k = max(len(sa), len(sb))
    sa = (1,) * (k - len(sa)) + sa
    sb = (1,) * (k - len(sb)) + sb
    return tuple(y if x == 1 else x for x, y in zip(sa, sb))


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 16, L) x (..., 16, L) int64 limbs -> (..., 32, L) column
    sums of the schoolbook product (each < 2^37, exact in int64).

    Small tensors take one outer product and one `index_add_` (fewest
    torch calls); large ones add the 16 shifted rows a_i * b (no 16 x 16
    temporary, several times faster per element)."""
    shape = _broadcast(a.shape, b.shape)
    lead, L = shape[:-2], shape[-1]
    out = torch.zeros(*lead, 2 * N_LIMBS, L, dtype=torch.int64,
                      device=a.device)
    if a.numel() < 4096:
        prod = a.unsqueeze(-2) * b.unsqueeze(-3)  # (..., 16, 16, L)
        out.index_add_(-2, _col_idx(a.device),
                       prod.reshape(*lead, N_LIMBS * N_LIMBS, L))
        return out
    for i in range(N_LIMBS):
        out[..., i:i + N_LIMBS, :] += a[..., i:i + 1, :] * b
    return out


def _norm(x: torch.Tensor, passes: int = 1):
    """Carry-normalise (..., k, L) int64 columns, which may be negative.

    Returns (limbs in [0, 2^16), carry out of the top column); the value
    is limbs + carry * 2^(16k). `passes` unconditional split passes come
    first, each cutting the carries by 16 bits (columns below 2^37 need
    3); then passes repeat while any column still carries, which a run
    of 0xFFFF limbs can cause.
    """
    x = torch.nn.functional.pad(x, (0, 0, 0, 1))  # the carry-out column
    lo, hi = x[..., :-1, :], x[..., 1:, :]
    for _ in range(passes):
        c = lo >> LIMB_BITS  # arithmetic shift: floor for negatives
        lo &= MASK
        hi += c
    while True:
        c = lo >> LIMB_BITS
        if not bool(c.any()):
            return lo, x[..., -1, :]
        lo &= MASK
        hi += c


def _cond_sub_p(fs: FieldSpec, r: torch.Tensor, extra: torch.Tensor):
    """Reduce r + extra * 2^256 (< 2p) to canonical [0, p). For the
    curves with 2p > 2^256 (secq256k1, zorro) `extra` can be 1."""
    d, borrow = _norm(r - const(fs.p_limbs, r.device))
    need = (extra > 0) | (borrow == 0)
    return torch.where(need.unsqueeze(-2), d, r)


def add_plain(fs: FieldSpec, a, b) -> torch.Tensor:
    """a + b mod p for canonical a and b, plain PyTorch (int64)."""
    s, c = _norm(a.long() + b.long())
    return _cond_sub_p(fs, s, c)


def sub_plain(fs: FieldSpec, a, b) -> torch.Tensor:
    """a - b mod p for canonical a and b, plain PyTorch (int64)."""
    d, borrow = _norm(a.long() - b.long())
    dp, _ = _norm(d + const(fs.p_limbs, d.device))
    return torch.where((borrow < 0).unsqueeze(-2), dp, d)


def neg_plain(fs: FieldSpec, a) -> torch.Tensor:
    return sub_plain(fs, torch.zeros_like(a), a)


def mont_mul_plain(fs: FieldSpec, a, b) -> torch.Tensor:
    """a * b * R^-1 mod p, canonical output, for a < 2^256 and canonical
    b (so a * b < p * 2^256 and the REDC result is below 2p)."""
    t = _conv(a.long(), b.long())  # 32 columns < 2^37, value < p^2
    dev = t.device
    if t.numel() < 8192:
        # Single-shot REDC, fewest torch calls: m = t * n' mod 2^256 from
        # the raw low columns (products < 2^53, column sums < 2^57: exact
        # in int64), normalised mod 2^256; then (t + m p) / 2^256.
        m, _ = _norm(_conv(t[..., :N_LIMBS, :],
                           const(fs.nprime_limbs, dev))[..., :N_LIMBS, :], 4)
        s, top = _norm(t + _conv(m, const(fs.p_limbs, dev)), 3)
        return _cond_sub_p(fs, s[..., N_LIMBS:, :], top)
    # Digit-serial REDC, about half the element work for wide tensors:
    # step i clears column i with m_i = t_i * (-p^-1) mod 2^16 and moves
    # its carry up; columns stay below 2^39.
    n0 = fs.nprime_limbs[0]
    p = const(fs.p_limbs, dev)
    for i in range(N_LIMBS):
        m = ((t[..., i, :] & MASK) * n0) & MASK
        t[..., i:i + N_LIMBS, :] += m.unsqueeze(-2) * p
        t[..., i + 1, :] += t[..., i, :] >> LIMB_BITS
    r, top = _norm(t[..., N_LIMBS:, :], 3)
    return _cond_sub_p(fs, r, top)


def _device(name: str, *ts) -> torch.device:
    """The device of the tensors among ts (None skipped); raise unless
    they share one, and it is the CPU or a CUDA device."""
    dev = ts[0].device
    for t in ts[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _shape(*ts) -> tuple:
    shape = tuple(ts[0].shape)
    for t in ts[1:]:
        if t is not None:
            shape = _broadcast(shape, t.shape)
    return shape


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous().reshape(-1, N_LIMBS, t.shape[-1])


def _side(t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """A broadcast operand as the kernels read it against `shape`: (rows_t,
    16, L_t) with rows_t in {1, rows} and L_t in {1, L}, contiguous int32;
    an operand whose leading axes broadcast in any other way is expanded
    over them."""
    lead = tuple(t.shape[:-2])
    if lead != tuple(shape[:-2]) and any(d != 1 for d in lead):
        t = t.expand(*shape[:-2], *t.shape[-2:])
    return _flat(t)


def _signed(sign: int) -> int:
    if sign not in (1, -1):
        raise ValueError(f"sign={sign}: expected +1 or -1")
    return sign


def mont_mul(fs: FieldSpec, a, b, c=None, sign: int = 1) -> torch.Tensor:
    """a * b * R^-1 mod p over (..., 16, L) limbs, b broadcast against a;
    with c, a * b + c (sign = +1) or a * b - c (sign = -1), c broadcast as
    b is. A (16, 1) operand is read with stride 0 on the card. For a <
    2^256 and canonical b and c the result is canonical.

    On CPU tensors: `mont_mul_plain`, then `add_plain` / `sub_plain`
    (int64). On CUDA tensors: one launch of the csrc/field_kernels.cu
    kernel, the add in its registers (int32), counted in
    `mont_mul.launches`. Any other device raises."""
    dev = _device("mont_mul", a, b, c)
    sign = _signed(sign)
    if dev.type == "cpu":
        r = mont_mul_plain(fs, a, b)
        if c is None:
            return r
        return (add_plain if sign > 0 else sub_plain)(fs, r, c)
    shape = _shape(a, b, c)
    if tuple(a.shape) != shape and tuple(b.shape) == shape:
        a, b = b, a  # the product commutes: the broadcast operand second
    x = _flat(a.expand(shape))
    y = _side(b, shape)
    z = None if c is None else _side(c, shape)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    from .kernels import launch

    rows_c, L_c = (1, 1) if z is None else (z.shape[0], z.shape[-1])
    launch("mont_mul", fs, dev, x.data_ptr(), y.data_ptr(),
           None if z is None else z.data_ptr(), out.data_ptr(), x.shape[0],
           x.shape[-1], y.shape[0], y.shape[-1], rows_c, L_c,
           0 if c is None else sign)
    mont_mul.launches += 1
    return out


mont_mul.launches = 0


def add_sub(fs: FieldSpec, a, b, sign: int) -> torch.Tensor:
    """a + b (sign = +1) or a - b (sign = -1) mod p over (..., 16, L)
    canonical limbs, b broadcast against a; a = None stands for zero
    (-b).

    On CPU tensors: `add_plain` / `sub_plain` / `neg_plain` (int64). On
    CUDA tensors: one launch of csrc/field_kernels.cu's add_sub kernel
    (int32), counted in `add_sub.launches`, with no device-to-host sync.
    Any other device raises."""
    dev = _device("add_sub", b, a)
    sign = _signed(sign)
    if dev.type == "cpu":
        a = torch.zeros_like(b) if a is None else a
        return (add_plain if sign > 0 else sub_plain)(fs, a, b)
    shape = _shape(b) if a is None else _shape(a, b)
    if (a is not None and sign > 0 and tuple(a.shape) != shape
            and tuple(b.shape) == shape):
        a, b = b, a  # the sum commutes: the broadcast operand second
    x = None if a is None else _flat(a.expand(shape))
    y = _side(b, shape)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    from .kernels import launch

    launch("add_sub", fs, dev, None if x is None else x.data_ptr(),
           y.data_ptr(), out.data_ptr(), out.numel() // (N_LIMBS * shape[-1]),
           shape[-1], y.shape[0], y.shape[-1], sign)
    add_sub.launches += 1
    return out


add_sub.launches = 0


def add(fs: FieldSpec, a, b) -> torch.Tensor:
    """a + b mod p: `add_sub` (the CUDA kernel on the card)."""
    return add_sub(fs, a, b, 1)


def sub(fs: FieldSpec, a, b) -> torch.Tensor:
    """a - b mod p: `add_sub` (the CUDA kernel on the card)."""
    return add_sub(fs, a, b, -1)


def neg(fs: FieldSpec, a) -> torch.Tensor:
    """-a mod p: `add_sub` (the CUDA kernel on the card)."""
    return add_sub(fs, None, a, -1)


def mul_small(fs: FieldSpec, a, c: int) -> torch.Tensor:
    """a * c for a small non-negative int constant (double-and-add), plain
    PyTorch: the group laws' plain versions (ops/proj.py, ops/curve.py)
    use it."""
    if c == 0:
        return torch.zeros_like(a, dtype=torch.int64)
    acc = None
    addend = a.long()
    while c:
        if c & 1:
            acc = addend if acc is None else add_plain(fs, acc, addend)
        c >>= 1
        if c:
            addend = add_plain(fs, addend, addend)
    return acc


def to_mont(fs: FieldSpec, a) -> torch.Tensor:
    return mont_mul(fs, a, const(fs.r2_limbs, a.device))


def from_mont(fs: FieldSpec, a) -> torch.Tensor:
    return mont_mul(fs, a, const(_limbs_of(1), a.device))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-2)


def mont_one(fs: FieldSpec, lanes: int, device) -> torch.Tensor:
    """(16, lanes) Montgomery ones (R mod p), int32."""
    return const(fs.r_limbs, device).to(torch.int32).expand(
        N_LIMBS, lanes).contiguous()


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """where(mask, a, b) lane-wise over (..., 16, L) limbs; mask (..., L)
    broadcasts against the lanes."""
    return torch.where(mask.unsqueeze(-2), a, b)


def sum_mod_plain(fs: FieldSpec, a) -> torch.Tensor:
    """The plain version of `sum_mod` (int64).

    The int64 limb-column sums are exact (each column below L * 2^16);
    normalised, they give the wide total lo + c * 2^256 with lo < 2^256
    and c < L. Then lo mod p = from_mont(to_mont(lo)) (to_mont takes any
    lo < 2^256) and c * 2^256 mod p = mont_mul(c, R^2)."""
    cols = a.long().sum(dim=-1, keepdim=True)
    lo, c = _norm(cols, 3)
    c_limbs = torch.zeros_like(lo)
    c_limbs[..., 0, :] = c & MASK
    c_limbs[..., 1, :] = c >> LIMB_BITS
    r2 = const(fs.r2_limbs, a.device)
    hi = mont_mul_plain(fs, c_limbs, r2)
    lo = mont_mul_plain(fs, mont_mul_plain(fs, lo, r2),
                        const(_limbs_of(1), a.device))
    return add_plain(fs, lo, hi)


_R2_WORDS: dict = {}


def _r2_words(fs: FieldSpec) -> np.ndarray:
    """R^2 mod p as 8 uint32 words (kept alive: ctypes passes a pointer)."""
    w = _R2_WORDS.get(fs)
    if w is None:
        r2 = fs.R * fs.R % fs.p
        w = np.array([(r2 >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                     dtype=np.uint32)
        _R2_WORDS[fs] = w
    return w


def sum_mod(fs: FieldSpec, a) -> torch.Tensor:
    """Modular sum over the lanes of (..., 16, L) limbs -> (..., 16, 1).
    Montgomery-form linear, so it sums Montgomery and canonical values
    alike.

    On CPU tensors: `sum_mod_plain` (int64). On CUDA tensors: the exact
    int64 column sums (a torch sum), then one launch of
    csrc/field_kernels.cu's sum_mod kernel (one thread a row: the column
    carries and the plain version's products and add; int32), counted in
    `sum_mod.launches`, with no device-to-host sync."""
    dev = _device("sum_mod", a)
    if dev.type == "cpu":
        return sum_mod_plain(fs, a)
    cols = a.sum(dim=-1, dtype=torch.int64).contiguous()  # (..., 16)
    out = torch.empty(*cols.shape, 1, dtype=torch.int32, device=dev)
    rows = cols.numel() // N_LIMBS
    if rows == 0:
        return out
    from .kernels import launch

    launch("sum_mod", fs, dev, cols.data_ptr(), out.data_ptr(), rows,
           _r2_words(fs).ctypes.data_as(ctypes.c_void_p))
    sum_mod.launches += 1
    return out


sum_mod.launches = 0


def dot_mod(fs: FieldSpec, a, b) -> torch.Tensor:
    """Modular inner product over the lanes (Montgomery inputs and
    output): sum_mod(mont_mul(a, b))."""
    return sum_mod(fs, mont_mul(fs, a, b))
