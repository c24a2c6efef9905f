"""The on-device Fiat-Shamir byte layer (counterpart of
ark_bulletproofs_tpu/ops/fs.py) and the wrapper of its CUDA kernel.

The IPA's round chain squeezes each challenge from a Merlin transcript
over the round's L and R (reference src/inner_product_proof.rs:164-231).
Here the byte layer runs on the device, so the rounds of an IPA need no
host round trip (ops/ipa.py::ipa_prove_fs):

  * Keccak-f[1600] on 25 (lo, hi) lane pairs of 32-bit halves in int64
    (CPU torch has no uint32 add, shift or compare);
  * STROBE-128 over a (..., 200) state of bytes (transcript/strobe.py is
    the host model): `absorb`, `squeeze`, `begin_op`, and Merlin's
    `append_message` and `challenge_bytes`;
  * ChaCha20 blocks and arkworks `Fp::rand` with its rejection loop
    (fields.py::Field.rand: the accepted raw limbs are the Montgomery
    form, so a challenge comes out ready for the fold);
  * `mont_pow_pm2` (x^(p-2), the field inverse in Montgomery form) and
    `mont_inv_batch` (one launch of safegcd inverses on the card; its
    plain version Montgomery's trick over the lanes);
  * arkworks' uncompressed point encodings, short-Weierstrass (x || y,
    flags in the top bits of y's last byte) and twisted-Edwards (x || y).

The transcript position (pos, pos_begin) is kept on the host as Python
ints: it depends only on the sequence of operations and their lengths,
never on content, so one position serves a batch of transcripts in
lockstep and the device code has no data-dependent branch. A state is
then (st, pos, pb), st a (..., 200) int64 tensor of bytes.

`fs_round` is one IPA round's Fiat-Shamir step, from the round's S = MSM +
c * Q to the challenge and its inverse, in one launch of
csrc/fs_kernels.cu (one thread per proof); `fs_round_plain` is its plain
version, the composition of the functions above. The JAX package runs
these steps as XLA ops inside one program; eager PyTorch would pay about
a thousand launches a Keccak permutation and some 330 product launches an
inversion, so the port has a kernel where the JAX package has none. The
kernel inverts by safegcd (csrc/fs.cuh, one fq inversion for L's and R's
Z together), the plain version by `mont_pow_pm2`: the inverse is unique,
so the two agree bit for bit (tests/test_torch_fs_inverse.py holds the
kernel's algorithm, transcribed, against both).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from . import field as df
from .curve import is_te, n_coords
from .kernels import check_tensor, launch
from .limbs import N_LIMBS

STROBE_R = 166
FLAG_I, FLAG_A, FLAG_C, FLAG_M = 0x01, 0x02, 0x04, 0x10
M32 = 0xFFFFFFFF
# ChaCha20 blocks that `Fp::rand` may draw from (two candidates a block)
# before it reports a failed draw: 2^-128 for curve25519's scalar field,
# whose candidates are rejected about half the time.
RAND_BLOCKS = 64

# --- Keccak-f[1600] --------------------------------------------------------

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45,
        15, 21, 8, 18, 2, 61, 56, 14]
# rho + pi: dest[y + 5 ((2x + 3y) % 5)] = rotl(src[x + 5y]), as a gather.
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_PI_ROT = [_ROT[s] for s in _PI_SRC]
_CHI_1 = [(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)]
_CHI_2 = [(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)]


def _consts(device):
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)  # noqa
    rot = t(_PI_ROT)
    swap = rot >= 32
    s = rot % 32
    return dict(src=t(_PI_SRC), swap=swap, s=s, inv=32 - s, c1=t(_CHI_1),
                c2=t(_CHI_2))


def keccak_f1600(lo: torch.Tensor, hi: torch.Tensor):
    """Keccak-f[1600] over (..., 25) int64 lanes (x + 5y), each a 64-bit
    lane as its low and high 32-bit halves."""
    if lo.numel() == 0:
        return lo, hi
    k = _consts(lo.device)
    for r in range(24):
        # theta
        l5 = lo.reshape(*lo.shape[:-1], 5, 5)
        h5 = hi.reshape(*hi.shape[:-1], 5, 5)
        clo = l5[..., 0, :] ^ l5[..., 1, :] ^ l5[..., 2, :] ^ l5[..., 3, :] \
            ^ l5[..., 4, :]
        chi = h5[..., 0, :] ^ h5[..., 1, :] ^ h5[..., 2, :] ^ h5[..., 3, :] \
            ^ h5[..., 4, :]
        r1lo = ((clo << 1) | (chi >> 31)) & M32
        r1hi = ((chi << 1) | (clo >> 31)) & M32
        dlo = torch.roll(clo, 1, -1) ^ torch.roll(r1lo, -1, -1)
        dhi = torch.roll(chi, 1, -1) ^ torch.roll(r1hi, -1, -1)
        lo = lo ^ dlo.tile(5)
        hi = hi ^ dhi.tile(5)
        # rho + pi: a gather, then constant rotations (a shift by 32 - 0
        # of a 32-bit value is 0 in int64, so s = 0 needs no case)
        l2, h2 = lo[..., k["src"]], hi[..., k["src"]]
        l2, h2 = torch.where(k["swap"], h2, l2), torch.where(k["swap"], l2,
                                                               h2)
        lo = ((l2 << k["s"]) | (h2 >> k["inv"])) & M32
        hi = ((h2 << k["s"]) | (l2 >> k["inv"])) & M32
        # chi
        lo = lo ^ (~lo[..., k["c1"]] & lo[..., k["c2"]])
        hi = hi ^ (~hi[..., k["c1"]] & hi[..., k["c2"]])
        # iota
        lo[..., 0] ^= _RC[r] & M32
        hi[..., 0] ^= _RC[r] >> 32
    return lo, hi


def _permute(st: torch.Tensor) -> torch.Tensor:
    """Keccak-f over a (..., 200) byte state (25 little-endian lanes)."""
    b = st.reshape(*st.shape[:-1], 25, 8)
    sh = torch.arange(0, 32, 8, device=st.device)
    lo = (b[..., :4] << sh).sum(-1)
    hi = (b[..., 4:] << sh).sum(-1)
    lo, hi = keccak_f1600(lo, hi)
    out = torch.stack([(lo[..., None] >> sh) & 0xFF,
                       (hi[..., None] >> sh) & 0xFF], dim=-2)
    return out.reshape(st.shape)


# --- STROBE-128 and Merlin ------------------------------------------------
#
# st: (..., 200) int64 bytes; data: (..., K) int64 bytes broadcast against
# st's leading axes (per-transcript content, one shared position).


def _run_f(st, pos: int, pb: int):
    st = st.clone()
    st[..., pos] ^= pb
    st[..., pos + 1] ^= 0x04
    st[..., STROBE_R + 1] ^= 0x80
    return _permute(st), 0, 0


def absorb(st, pos: int, pb: int, data: torch.Tensor):
    st = st.clone()
    off, n = 0, data.shape[-1]
    while off < n:
        take = min(STROBE_R - pos, n - off)
        st[..., pos:pos + take] ^= data[..., off:off + take]
        pos += take
        off += take
        if pos == STROBE_R:
            st, pos, pb = _run_f(st, pos, pb)
    return st, pos, pb


def squeeze(st, pos: int, pb: int, n: int):
    """PRF-squeeze n bytes: (st, pos, pb, (..., n) bytes)."""
    st = st.clone()
    out = []
    while n:
        take = min(STROBE_R - pos, n)
        out.append(st[..., pos:pos + take].clone())
        st[..., pos:pos + take] = 0
        pos += take
        n -= take
        if pos == STROBE_R:
            st, pos, pb = _run_f(st, pos, pb)
    return st, pos, pb, torch.cat(out, dim=-1)


def _bytes(bs: bytes, device) -> torch.Tensor:
    return torch.tensor(list(bs), dtype=torch.int64, device=device)


def begin_op(st, pos: int, pb: int, flags: int, force_f: bool):
    """STROBE begin_op (transcript/strobe.py::_begin_op, more = False)."""
    old = pb
    st, pos, pb = absorb(st, pos, pos + 1, _bytes(bytes([old, flags]),
                                                  st.device))
    if force_f and pos != 0:
        st, pos, pb = _run_f(st, pos, pb)
    return st, pos, pb


def append_message(st, pos: int, pb: int, label: bytes, msg: torch.Tensor):
    """Merlin append_message: meta-AD(label || LE32(len)), then AD(msg)."""
    meta = label + msg.shape[-1].to_bytes(4, "little")
    st, pos, pb = begin_op(st, pos, pb, FLAG_M | FLAG_A, False)
    st, pos, pb = absorb(st, pos, pb, _bytes(meta, st.device))
    st, pos, pb = begin_op(st, pos, pb, FLAG_A, False)
    return absorb(st, pos, pb, msg)


def challenge_bytes(st, pos: int, pb: int, label: bytes, n: int):
    """Merlin challenge_bytes: (st, pos, pb, (..., n) bytes)."""
    st, pos, pb = begin_op(st, pos, pb, FLAG_M | FLAG_A, False)
    st, pos, pb = absorb(st, pos, pb,
                         _bytes(label + n.to_bytes(4, "little"), st.device))
    st, pos, pb = begin_op(st, pos, pb, FLAG_I | FLAG_A | FLAG_C, True)
    return squeeze(st, pos, pb, n)


# --- ChaCha20 and arkworks Fp::rand ----------------------------------------

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def chacha20_block(key_words: torch.Tensor, counter: int) -> torch.Tensor:
    """Block `counter` of the ChaCha20 keystream (djb: 64-bit counter,
    zero nonce) for (..., 8) int64 key words: (..., 16) words
    (hashes/chacha.py::chacha20_block_words)."""
    batch = key_words.shape[:-1]
    fixed = [torch.full(batch, v, dtype=torch.int64, device=key_words.device)
             for v in (*_SIGMA,)]
    ctr = [torch.full(batch, v, dtype=torch.int64, device=key_words.device)
           for v in (counter & M32, counter >> 32, 0, 0)]
    init = fixed + list(key_words.unbind(-1)) + ctr
    x = list(init)

    def rotl(v, n):
        return ((v << n) | (v >> (32 - n))) & M32

    def quarter(a, b, c, d):
        a = (a + b) & M32
        d = rotl(d ^ a, 16)
        c = (c + d) & M32
        b = rotl(b ^ c, 12)
        a = (a + b) & M32
        d = rotl(d ^ a, 8)
        c = (c + d) & M32
        b = rotl(b ^ c, 7)
        return a, b, c, d

    for _ in range(10):
        for q in ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
                  (3, 7, 11, 15), (0, 5, 10, 15), (1, 6, 11, 12),
                  (2, 7, 8, 13), (3, 4, 9, 14)):
            out = quarter(*(x[i] for i in q))
            for i, v in zip(q, out):
                x[i] = v
    return torch.stack([(a + b) & M32 for a, b in zip(x, init)], dim=-1)


def _lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b over (16, ...) limbs, little-endian on axis 0."""
    lt = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[1:],
                     dtype=torch.bool, device=a.device)
    for i in range(N_LIMBS):
        lt = torch.where(a[i] == b[i], lt, a[i] < b[i])
    return lt


def _words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) 32-bit words -> (16, ...) 16-bit limbs."""
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2).movedim(
        -1, 0)


def fr_rand_from_seed(fr: df.FieldSpec, seed: torch.Tensor):
    """arkworks `Fp::rand(ChaCha20(seed))` (fields.py::Field.rand): four
    u64 draws per candidate, the top limb masked to the field's bits,
    candidates >= p rejected. seed: (P, 32) int64 bytes. Returns ((16, P)
    int64 Montgomery limbs, (P,) ok); ok is False only if RAND_BLOCKS
    blocks held no accepted candidate (the limbs are then 0)."""
    kw = (seed.reshape(*seed.shape[:-1], 8, 4)
          << torch.arange(0, 32, 8, device=seed.device)).sum(-1)
    shave = 256 - fr.p.bit_length()
    if shave > 32:
        raise ValueError(f"{fr.name}: fewer than 225 bits")
    mask = M32 >> shave
    p = df.const(fr.p_limbs, seed.device)
    u = torch.zeros(N_LIMBS, *seed.shape[:-1], dtype=torch.int64,
                    device=seed.device)
    done = torch.zeros(seed.shape[:-1], dtype=torch.bool, device=seed.device)
    for blk in range(RAND_BLOCKS):
        w = chacha20_block(kw, blk)
        for half in (0, 8):
            c = w[..., half:half + 8].clone()
            c[..., 7] &= mask
            limbs = _words_to_limbs(c)
            ok = _lt(limbs, p.reshape(N_LIMBS, *[1] * (limbs.dim() - 1)))
            u = torch.where(ok & ~done, limbs, u)
            done = done | ok
        if bool(done.all()):
            break
    return u, done


# --- inversions -------------------------------------------------------------


def mont_pow_pm2(fs: df.FieldSpec, x: torch.Tensor, mul=df.mont_mul):
    """x^(p-2) over (16, L) Montgomery limbs: the field inverse, in
    Montgomery form (0 for 0), by 4-bit windows from the top (14 table
    products, then four squarings and one product a digit). `mul` is the
    product: `df.mont_mul` (the kernel on the card) or `mont_mul_plain`."""
    e = fs.p - 2
    ndig = (e.bit_length() + 3) // 4
    one = df.const(fs.r_limbs, x.device).expand(x.shape)
    table = [one, x]
    for _ in range(14):
        table.append(mul(fs, table[-1], x))
    acc = one
    for i in range(ndig):
        d = (e >> (4 * (ndig - 1 - i))) & 0xF
        for _ in range(4):
            acc = mul(fs, acc, acc)
        if d:
            acc = mul(fs, acc, table[d])
    return acc


def mont_inv_batch_plain(fs: df.FieldSpec, z: torch.Tensor,
                         rows=None) -> torch.Tensor:
    """The plain version of `mont_inv_batch`, the JAX package's algorithm:
    Montgomery's trick, inclusive prefix and suffix products over the
    lanes (2 lg B wide products each, Hillis-Steele), one `mont_pow_pm2`
    of the total on one lane, two combining products; then the rows by
    the inverses."""
    mul = df.mont_mul_plain
    B = z.shape[-1]
    iz = df.is_zero(z)
    one = df.const(fs.r_limbs, z.device).expand(z.shape)
    x = df.select(iz, one, z)
    idx = torch.arange(B, device=z.device)

    def scan(sign: int):
        acc, sh = x, 1
        while sh < B:
            keep = idx >= sh if sign > 0 else idx < B - sh
            acc = mul(fs, acc, df.select(
                keep, torch.roll(acc, sign * sh, -1), one))
            sh <<= 1
        return acc

    pre, suf = scan(1), scan(-1)
    tot_inv = mont_pow_pm2(fs, pre[:, B - 1:], mul)
    pre_prev = df.select(idx >= 1, torch.roll(pre, 1, -1), one)
    suf_next = df.select(idx < B - 1, torch.roll(suf, -1, -1), one)
    inv = mul(fs, mul(fs, pre_prev, suf_next), tot_inv)
    inv = df.select(iz, torch.zeros_like(inv), inv)
    return inv if rows is None else mul(fs, rows, inv)


def mont_inv_batch(fs: df.FieldSpec, z: torch.Tensor,
                   rows=None) -> torch.Tensor:
    """Inverses of (16, B) Montgomery elements, in Montgomery form; zero
    lanes return 0. With rows (R, 16, B), rows * z^-1 lane-wise instead
    ((R, 16, B): the table shrink's affine X / Z and Y / Z).

    On CPU tensors: `mont_inv_batch_plain` (int64). On CUDA tensors: one
    launch of csrc/field_kernels.cu's mont_inv_batch kernel (one thread a
    lane, each inverting its own element by safegcd, csrc/inv.cuh; the
    inverse is unique, so it equals the plain version's Fermat power bit
    for bit), int32, counted in `mont_inv_batch.launches`."""
    if z.dim() != 2 or z.shape[0] != N_LIMBS:
        raise ValueError(f"mont_inv_batch: z of shape {tuple(z.shape)}, "
                         f"expected (16, B)")
    B = z.shape[-1]
    if rows is not None and (rows.dim() != 3 or rows.shape[1:] != z.shape):
        raise ValueError(f"mont_inv_batch: rows of shape "
                         f"{tuple(rows.shape)} against z {tuple(z.shape)}")
    dev = df._device("mont_inv_batch", z, rows)
    if dev.type == "cpu":
        return mont_inv_batch_plain(fs, z, rows)
    shape = (N_LIMBS, B) if rows is None else tuple(rows.shape)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    zc = z.to(torch.int32).contiguous()
    rc = None if rows is None else rows.to(torch.int32).contiguous()
    launch("mont_inv_batch", fs, dev, zc.data_ptr(),
           None if rc is None else rc.data_ptr(), out.data_ptr(), B,
           0 if rc is None else rc.shape[0],
           inv_const(fs).ctypes.data_as(ctypes.c_void_p))
    mont_inv_batch.launches += 1
    return out


mont_inv_batch.launches = 0


# --- point encodings --------------------------------------------------------


def limbs_to_bytes_le(limbs: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(16, L) 16-bit limbs -> (L, nbytes) little-endian bytes."""
    b = torch.stack([limbs.long() & 0xFF, limbs.long() >> 8], dim=1)
    b = b.reshape(2 * N_LIMBS, -1).T
    if nbytes <= 2 * N_LIMBS:
        return b[:, :nbytes]
    return torch.nn.functional.pad(b, (0, nbytes - 2 * N_LIMBS))


def point_uncompressed_bytes(fq: df.FieldSpec, xc, yc, inf):
    """arkworks uncompressed short-Weierstrass encoding
    (curves/models.py::SWCurve.serialize_uncompressed) of (16, L)
    canonical coordinates: x || y, y's last byte carrying 1 << 7 when
    -y < y and the identity all zero with 1 << 6. (L, x_size + y_size)."""
    bits = fq.p.bit_length()
    x_size, y_size = (bits + 7) // 8, (bits + 2 + 7) // 8
    neg = _lt(df.neg_plain(fq, yc), yc.long())
    zero = torch.zeros_like(xc)
    xb = limbs_to_bytes_le(df.select(inf, zero, xc), x_size)
    yb = limbs_to_bytes_le(df.select(inf, zero, yc), y_size)
    flag = torch.where(inf, 1 << 6, torch.where(neg, 1 << 7, 0))
    yb[:, -1] |= flag
    return torch.cat([xb, yb], dim=-1)


def te_point_uncompressed_bytes(fq: df.FieldSpec, xc, yc):
    """arkworks uncompressed twisted-Edwards encoding: x || y, no flags
    (the identity is the point (0, 1)). (L, 2 size)."""
    size = (fq.p.bit_length() + 7) // 8
    return torch.cat([limbs_to_bytes_le(xc, size),
                      limbs_to_bytes_le(yc, size)], dim=-1)


def message_len(spec) -> int:
    """Bytes of one encoded L or R."""
    bits = spec.fq.p.bit_length()
    if is_te(spec):
        return 2 * ((bits + 7) // 8)
    return (bits + 7) // 8 + (bits + 2 + 7) // 8


# --- one IPA round's Fiat-Shamir step ---------------------------------------


def _merlin_round(st, pos: int, pb: int, Lb, Rb):
    st, pos, pb = append_message(st, pos, pb, b"L", Lb)
    st, pos, pb = append_message(st, pos, pb, b"R", Rb)
    return challenge_bytes(st, pos, pb, b"u", 32)


def round_positions(spec, pos: int, pb: int) -> tuple[int, int]:
    """(pos, pos_begin) after a round's appends of L, R and its challenge."""
    return _round_positions(message_len(spec), pos, pb)


@functools.lru_cache(maxsize=None)
def _round_positions(msg_len: int, pos: int, pb: int) -> tuple[int, int]:
    """The same operations on an empty batch of states (kept: a round's
    positions depend only on these three numbers)."""
    msg = torch.zeros(0, msg_len, dtype=torch.int64)
    _, pos, pb, _ = _merlin_round(torch.zeros(0, 200, dtype=torch.int64),
                                  pos, pb, msg, msg)
    return pos, pb


def fs_round_plain(spec, fr: df.FieldSpec, S: torch.Tensor, st: torch.Tensor,
                   pos: int, pb: int):
    """The plain version of `fs_round` (same arguments and results)."""
    fq = spec.fq
    mul = df.mont_mul_plain
    S = S.long()
    if is_te(spec):
        zi = mont_pow_pm2(fq, S[3], mul)
        xa, ya = mul(fq, torch.stack([S[0], S[1]]), zi).unbind(0)
        inf = torch.zeros(S.shape[-1], dtype=torch.bool, device=S.device)
    else:
        zi = mont_pow_pm2(fq, S[2], mul)
        zi2 = mul(fq, zi, zi)
        xa, ya = mul(fq, torch.stack([S[0], S[1]]),
                     torch.stack([zi2, mul(fq, zi2, zi)])).unbind(0)
        inf = df.is_zero(S[2])
    xc, yc = mul(fq, torch.stack([xa, ya]),
                 df.const((1,) + (0,) * 15, S.device)).unbind(0)
    if is_te(spec):
        enc = te_point_uncompressed_bytes(fq, xc, yc)
    else:
        enc = point_uncompressed_bytes(fq, xc, yc, inf)
    st, pos, pb, seed = _merlin_round(st.long(), pos, pb, enc[0::2],
                                      enc[1::2])
    u, ok = fr_rand_from_seed(fr, seed)
    ui = mont_pow_pm2(fr, u, mul)
    flags = torch.stack([inf[0::2], inf[1::2], ok])
    return (torch.stack([xc, yc]).int(), torch.stack([u, ui]).int(),
            st.int(), flags.int(), pos, pb)


@functools.lru_cache(maxsize=None)
def inv_const(f: df.FieldSpec) -> np.ndarray:
    """The 9 uint32 words of csrc/inv.cuh's InvConst for one field: R^3
    mod p (8 words; one Montgomery product takes the safegcd inverse
    (xR)^-1 to x^-1 R) and p^-1 mod 2^30. Cached: ctypes passes a pointer
    to them."""
    r3 = pow(f.R, 3, f.p)
    return np.array([(r3 >> (32 * i)) & M32 for i in range(8)]
                    + [pow(f.p, -1, 1 << 30)], dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def inv_words(fq: df.FieldSpec, fr: df.FieldSpec) -> np.ndarray:
    """The 18 words of fs_round's two InvConst: fq's, then fr's
    (`inv_const`). Cached: ctypes passes a pointer to them."""
    return np.concatenate([inv_const(fq), inv_const(fr)])


def fs_round(spec, fr: df.FieldSpec, S: torch.Tensor, st: torch.Tensor,
             pos: int, pb: int):
    """One IPA round's Fiat-Shamir step for P transcripts in lockstep.

    S: (NC, 16, 2P) int32 Montgomery points in the model coordinates
    (Jacobian on a short-Weierstrass curve, extended on a twisted-Edwards
    one), lane 2b the L of transcript b and lane 2b + 1 its R. st: (P,
    200) int32 state bytes at the shared position (pos, pb). Per
    transcript: L and R to affine (1 / Z), encoded, appended as "L" and
    "R", the challenge "u" squeezed and drawn with `Fp::rand`, u inverted.

    Returns (xy (2, 16, 2P) canonical affine coordinates, u (2, 16, P)
    challenges and inverses in Montgomery form, st (P, 200), flags (3, P)
    [L is the identity, R is the identity, ok], pos, pb), all int32. On
    a CUDA tensor one launch of csrc/fs_kernels.cu, counted in
    `fs_round.launches`; on a CPU tensor `fs_round_plain`."""
    nc = n_coords(spec)
    P2 = S.shape[-1]
    P = st.shape[0]
    check_tensor(S, (nc, N_LIMBS, 2 * P), "fs_round S")
    check_tensor(st, (P, 200), "fs_round st")
    if S.device != st.device:
        raise ValueError(f"tensors on {S.device} and {st.device}")
    if S.device.type == "cpu":
        return fs_round_plain(spec, fr, S, st, pos, pb)
    if P == 0:
        raise ValueError("fs_round: empty input")
    if fr.p.bit_length() <= 224:
        raise ValueError(f"fs_round: {fr.name} has fewer than 225 bits")
    dev = S.device
    xy = torch.empty(2, N_LIMBS, P2, dtype=torch.int32, device=dev)
    u = torch.empty(2, N_LIMBS, P, dtype=torch.int32, device=dev)
    st_out = torch.empty_like(st)
    flags = torch.empty(3, P, dtype=torch.int32, device=dev)
    launch("fs_round", spec, dev, S.data_ptr(), st.data_ptr(),
           xy.data_ptr(), u.data_ptr(), st_out.data_ptr(), flags.data_ptr(),
           P, pos, pb, inv_words(spec.fq, fr).ctypes.data_as(ctypes.c_void_p),
           _build.curve_words(fr).ctypes.data_as(ctypes.c_void_p))
    fs_round.launches += 1
    return (xy, u, st_out, flags, *round_positions(spec, pos, pb))


fs_round.launches = 0
