"""256-bit prime-field arithmetic in Montgomery form.

Counterpart of ark_bulletproofs_tpu/ops/field.py. Apart from `mont_mul`
these are plain PyTorch: the plain versions of the CUDA field core
(csrc/field.cuh), which the CPU tests run and chip_smoke.py holds the
kernels against on the card. `mont_mul` is the wrapper of the CUDA
Montgomery-product kernel (csrc/field_kernels.cu): on a CUDA tensor it
launches the kernel and returns int32, on a CPU tensor it runs
`mont_mul_plain`, and on anything else it raises. The group-law plain
versions (proj.py) call `mont_mul_plain` directly, so they stay plain on
the card. Values are
16 canonical 16-bit limbs along axis -2 of a (..., 16, L) tensor; every
function takes any integer dtype and computes and returns int64 (torch's
CPU uint32 has no add, shift or compare). Every result is canonical in
[0, p), so any correct formula gives bit-equal limbs.

`mont_mul_plain` is vectorised over the limb axis: the 31 column sums of the
schoolbook product on whole tensors, carry normalisation by passes,
and a single-shot REDC (m = t * (-p^-1) mod 2^256, r = (t + m p) / 2^256)
— a few dozen torch calls per product instead of one per limb product.

Montgomery radix R = 2^256, as in the JAX package and arkworks.
"""

from __future__ import annotations

from dataclasses import dataclass

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


def add(fs: FieldSpec, a, b) -> torch.Tensor:
    s, c = _norm(a.long() + b.long())
    return _cond_sub_p(fs, s, c)


def sub(fs: FieldSpec, a, b) -> torch.Tensor:
    d, borrow = _norm(a.long() - b.long())
    dp, _ = _norm(d + const(fs.p_limbs, d.device))
    return torch.where((borrow < 0).unsqueeze(-2), dp, d)


def neg(fs: FieldSpec, a) -> torch.Tensor:
    return sub(fs, torch.zeros_like(a), a)


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


def _kernel_operands(a: torch.Tensor, b: torch.Tensor):
    """a and b as the kernel takes them: a (rows, 16, L) and b (rows_b,
    16, L_b) with rows_b in {1, rows} and L_b in {1, L}, contiguous int32.
    The product commutes, so the broadcast operand goes second; operands
    broadcast in any other way are expanded."""
    shape = _broadcast(a.shape, b.shape)
    if tuple(a.shape) != tuple(shape):
        a, b = b, a
    a = a.expand(shape)
    b_lead = tuple(b.shape[:-2])
    if b_lead != tuple(shape[:-2]) and any(d != 1 for d in b_lead):
        b = b.expand(shape)

    def flat(t):
        return t.to(torch.int32).contiguous().reshape(-1, N_LIMBS,
                                                      t.shape[-1])

    return flat(a), flat(b)


def mont_mul(fs: FieldSpec, a, b) -> torch.Tensor:
    """a * b * R^-1 mod p over (..., 16, L) limbs, b broadcast against a
    (a (16, 1) operand is read with stride 0 on the card). For a < 2^256
    and canonical b the result is canonical.

    On CPU tensors: `mont_mul_plain` (int64). On CUDA tensors: the
    csrc/field_kernels.cu kernel (int32), counted in `mont_mul.launches`.
    Any other device raises."""
    dev = a.device
    if b.device != dev:
        raise ValueError(f"mont_mul: tensors on {dev} and {b.device}")
    if dev.type == "cpu":
        return mont_mul_plain(fs, a, b)
    if dev.type != "cuda":
        raise ValueError(f"mont_mul: unsupported device {dev}")
    shape = _broadcast(a.shape, b.shape)
    x, y = _kernel_operands(a, b)
    rows, _, L = x.shape
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    from .kernels import launch

    launch("mont_mul", fs, dev, x.data_ptr(), y.data_ptr(), out.data_ptr(),
           rows, L, y.shape[0], y.shape[-1])
    mont_mul.launches += 1
    return out


mont_mul.launches = 0


def mul_small(fs: FieldSpec, a, c: int) -> torch.Tensor:
    """a * c for a small non-negative int constant (double-and-add)."""
    if c == 0:
        return torch.zeros_like(a, dtype=torch.int64)
    acc = None
    addend = a.long()
    while c:
        if c & 1:
            acc = addend if acc is None else add(fs, acc, addend)
        c >>= 1
        if c:
            addend = add(fs, addend, addend)
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


def sum_mod(fs: FieldSpec, a) -> torch.Tensor:
    """Modular sum over the lanes of (..., 16, L) limbs -> (..., 16, 1).

    The int64 limb-column sums are exact (each column below L * 2^16);
    normalised, they give the wide total lo + c * 2^256 with lo < 2^256
    and c < L. Then lo mod p = from_mont(to_mont(lo)) (to_mont takes any
    lo < 2^256) and c * 2^256 mod p = mont_mul(c, R^2). Montgomery-form
    linear, so it sums Montgomery and canonical values alike."""
    cols = a.long().sum(dim=-1, keepdim=True)
    lo, c = _norm(cols, 3)
    c_limbs = torch.zeros_like(lo)
    c_limbs[..., 0, :] = c & MASK
    c_limbs[..., 1, :] = c >> LIMB_BITS
    r2 = const(fs.r2_limbs, a.device)
    hi = mont_mul(fs, c_limbs, r2)
    lo = from_mont(fs, mont_mul(fs, lo, r2))
    return add(fs, lo, hi)


def dot_mod(fs: FieldSpec, a, b) -> torch.Tensor:
    """Modular inner product over the lanes (Montgomery inputs and
    output): sum_mod(mont_mul(a, b))."""
    return sum_mod(fs, mont_mul(fs, a, b))
