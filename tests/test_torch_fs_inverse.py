"""The field inverse of the port's fs_round kernel (csrc/fs.cuh:
`fe_inv_var`, Bernstein-Yang safegcd in batches of 30 divsteps on signed
30-bit limbs) transcribed into Python, against Python's pow(x, p - 2, p)
and the JAX package's `mont_pow_pm2` on fq and fr of secq256k1, zorro and
curve25519, and its use in the kernel (one fq inversion for L's and R's Z
by Montgomery's trick, identities kept at 0) against JAX `mont_inv_batch`.

The CUDA code itself runs only on a card (tests/test_torch_cuda.py holds
fs_round against its plain version there); this file holds its algorithm:
the transcription keeps the kernel's word widths (uint32 and int32 words,
int64 accumulators), its batch length and its step rules line for line,
and checks at every batch what the kernel relies on without checking:
the low 30 bits cleared before each shift, every int32 store in range,
the loop caps never reached.

Tolerance: exact (the inverse is unique). Inputs: 0, 1, p - 1, R mod p,
R^-1 mod p, powers of two, and numpy-seeded random values.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ark_bulletproofs_tpu as jax_pkg
from ark_bulletproofs_tpu.ops import field as jf
from ark_bulletproofs_tpu.ops import fs as jfs
from ark_bulletproofs_tpu_torch import curves
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops import fs

M32 = 0xFFFFFFFF
M30 = 0x3FFFFFFF
SG_MAX_BATCHES = 40  # csrc/fs.cuh
CURVES = ["secq256k1", "zorro", "curve25519"]


def u32(x: int) -> int:
    return x & M32


def i32(x: int) -> int:
    """A value the kernel stores in an int32: it must fit."""
    assert -(1 << 31) <= x < (1 << 31), x
    return x


def s32(x: int) -> int:
    """(int32_t) of a uint32."""
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def ffs(x: int) -> int:
    """CUDA __ffs: 1 + the index of the lowest set bit (x != 0)."""
    return (x & -x).bit_length()


# --- the transcription of csrc/fs.cuh ------------------------------------


def sg_from_words(w: list[int]) -> list[int]:
    v = []
    for i in range(9):
        j, s = 30 * i // 32, 30 * i - 32 * (30 * i // 32)
        t = w[j]
        if j + 1 < 8:
            t |= w[j + 1] << 32
        v.append((t >> s) & M30)
    return v


def sg_to_words(v: list[int]) -> list[int]:
    out = []
    for j in range(8):
        a, s = 32 * j // 30, 32 * j - 30 * (32 * j // 30)
        t = u32(v[a])
        if a + 1 < 9:
            t |= u32(v[a + 1]) << 30
        if a + 2 < 9:
            t |= (u32(v[a + 2]) << 60) & ((1 << 64) - 1)
        out.append(u32(t >> s))
    return out


def sg_divsteps_30(eta: int, f: int, g: int, stats: dict):
    u, v, q, r = 1, 0, 0, 1
    i = 30
    for it in range(31):
        zeros = ffs(g | u32(M32 << i)) - 1
        g >>= zeros
        u, v = u32(u << zeros), u32(v << zeros)
        eta -= zeros
        i -= zeros
        if i == 0:
            break
        assert it < 30, "the inner loop's cap was reached"
        stats["steps"] += 1
        if eta < 0:
            eta = -eta
            f, g = g, u32(-f)
            u, q = q, u32(-u)
            v, r = r, u32(-v)
        limit = min(eta + 1, i, 5)
        m = M32 >> (32 - limit)
        fi = u32(3 * f) ^ 2  # f^-1 mod 2^5
        assert (f * fi) & 31 == 1
        w = u32(g * u32(-fi)) & m
        g = u32(g + f * w)
        q = u32(q + u * w)
        r = u32(r + v * w)
    else:
        raise AssertionError("divsteps did not finish 30 steps")
    return eta, (s32(u), s32(v), s32(q), s32(r))


def sg_update_de(d, e, t, P, pinv30):
    u, v, q, r = t
    sd, se = d[8] >> 31, e[8] >> 31
    md = i32((u & sd) + (v & se))
    me = i32((q & sd) + (r & se))
    cd = u * d[0] + v * e[0]
    ce = q * d[0] + r * e[0]
    md = i32(md - (u32(pinv30 * u32(cd) + u32(md)) & M30))
    me = i32(me - (u32(pinv30 * u32(ce) + u32(me)) & M30))
    cd += P[0] * md
    ce += P[0] * me
    assert cd & M30 == 0 and ce & M30 == 0
    cd >>= 30
    ce >>= 30
    for i in range(1, 9):
        cd += u * d[i] + v * e[i] + P[i] * md
        ce += q * d[i] + r * e[i] + P[i] * me
        assert abs(cd) < 1 << 63 and abs(ce) < 1 << 63
        d[i - 1] = cd & M30
        e[i - 1] = ce & M30
        cd >>= 30
        ce >>= 30
    d[8], e[8] = i32(cd), i32(ce)


def sg_update_fg(f, g, t):
    u, v, q, r = t
    cf = u * f[0] + v * g[0]
    cg = q * f[0] + r * g[0]
    assert cf & M30 == 0 and cg & M30 == 0
    cf >>= 30
    cg >>= 30
    for i in range(1, 9):
        cf += u * f[i] + v * g[i]
        cg += q * f[i] + r * g[i]
        f[i - 1] = cf & M30
        g[i - 1] = cg & M30
        cf >>= 30
        cg >>= 30
    f[8], g[8] = i32(cf), i32(cg)


def sg_normalize(d, sign, P):
    add = d[8] >> 31
    for i in range(9):
        d[i] = i32(d[i] + (P[i] & add))
    neg = sign >> 31
    for i in range(9):
        d[i] = i32((d[i] ^ neg) - neg)
    for i in range(8):
        d[i + 1] = i32(d[i + 1] + (d[i] >> 30))
        d[i] &= M30
    add = d[8] >> 31
    for i in range(9):
        d[i] = i32(d[i] + (P[i] & add))
    for i in range(8):
        d[i + 1] = i32(d[i + 1] + (d[i] >> 30))
        d[i] &= M30


def words(x: int) -> list[int]:
    return [(x >> (32 * i)) & M32 for i in range(8)]


def from_words(w: list[int]) -> int:
    return sum(v << (32 * i) for i, v in enumerate(w))


def safegcd_inverse(x: int, p: int, pinv30: int, stats: dict) -> int:
    """fe_inv_var before its Montgomery product: x^-1 mod p (0 for 0)."""
    P = sg_from_words(words(p))
    g = sg_from_words(words(x))
    f, d, e = list(P), [0] * 9, [1] + [0] * 8
    eta = -1
    for _ in range(SG_MAX_BATCHES):
        eta, t = sg_divsteps_30(eta, u32(f[0]), u32(g[0]), stats)
        sg_update_de(d, e, t, P, pinv30)
        sg_update_fg(f, g, t)
        stats["batches"] += 1
        if not any(g):
            break
    else:
        raise AssertionError("the batch cap was reached")
    assert sum(v << (30 * i) for i, v in enumerate(f)) in (1, -1) or x == 0
    sg_normalize(d, f[8], P)
    assert all(0 <= v <= M30 for v in d)
    return from_words(sg_to_words(d))


def fe_inv_var(xm: int, f, stats: dict) -> int:
    """fe_inv_var: the Montgomery inverse of a Montgomery xm, through the
    host's constants (ops/fs.py::inv_words) and one Montgomery product."""
    w = fs.inv_words(f, f)[:9].tolist()
    r3, pinv30 = from_words(w[:8]), w[8]
    y = safegcd_inverse(xm, f.p, pinv30, stats)
    return y * r3 * pow(f.R, -1, f.p) % f.p


# --- checks ------------------------------------------------------------------


def _inputs(p: int, R: int, seed: int) -> list[int]:
    raw = np.random.default_rng(seed).integers(0, 1 << 16, size=(24, 16),
                                               dtype=np.uint64)
    rand = [sum(int(v) << (16 * i) for i, v in enumerate(row)) % p
            for row in raw]
    twos = [pow(2, k, p) for k in (1, 29, 30, 31, 60, 128, 255)]
    return [0, 1, p - 1, R % p, pow(R, -1, p)] + twos + rand


def _jax_limbs(vals: list[int]):
    return jnp.asarray(np.array([[(v >> (16 * i)) & 0xFFFF for i in range(16)]
                                 for v in vals], dtype=np.uint32))


def _ints(limbs) -> list[int]:
    return [sum(int(v) << (16 * i) for i, v in enumerate(row))
            for row in np.asarray(limbs)]


FIELDS = [(c, w) for c in CURVES for w in ("fq", "fr")]


@pytest.mark.parametrize("name,which", FIELDS,
                         ids=[f"{c}-{w}" for c, w in FIELDS])
def test_kernel_inverse_matches_pow_and_jax(name, which):
    """The transcribed inverse equals pow(x, p - 2, p) on the plain
    values, and in Montgomery form the JAX package's mont_pow_pm2; one
    batch for 0, at most 25 (Bernstein and Yang's bound for 256 bits)
    for any other input."""
    field = getattr(getattr(curves, name), which)
    f = df.spec_for(field)
    p, R = f.p, f.R
    vals = _inputs(p, R, seed=len(name) + len(which))
    for x in vals:
        stats = {"batches": 0, "steps": 0}
        got = safegcd_inverse(x, p, pow(p, -1, 1 << 30), stats)
        assert got == pow(x, p - 2, p), x
        assert (stats["batches"] == 1) if x == 0 else \
            (1 <= stats["batches"] <= 25), (x, stats)
    xm = [v * R % p for v in vals]
    stats = {"batches": 0, "steps": 0}
    got = [fe_inv_var(x, f, stats) for x in xm]
    jsp = jf.spec_for(getattr(getattr(jax_pkg.curves, name), which))
    want = _ints(jfs.mont_pow_pm2(jsp, _jax_limbs(xm)))
    assert got == want


@pytest.mark.parametrize("name", ["secq256k1", "curve25519"])
def test_montgomery_trick_matches_jax_batch_inverse(name):
    """The kernel's 1 / Z_L and 1 / Z_R from one fq inversion of
    Z_L Z_R (an identity's Z = 0 entering as one and its inverse kept 0)
    equal JAX mont_inv_batch over the same lanes, on a short-Weierstrass
    and the twisted-Edwards base field (zorro's fq inverse is held above;
    each JAX batch inverse costs some 9 s of op-by-op dispatch here)."""
    curve = getattr(curves, name)
    f = df.spec_for(curve.fq)
    p, R = f.p, f.R
    rand = _inputs(p, R, seed=7)[12:]
    pairs = [(0, 0), (0, rand[0]), (rand[1], 0), (R % p, p - 1),
             (rand[2], rand[2])] + list(zip(rand[3::2], rand[4::2]))
    one = R % p
    rinv = pow(R, -1, p)
    got = []
    for zl, zr in pairs:
        zl1, zr1 = zl or one, zr or one
        zz = fe_inv_var(zl1 * zr1 * rinv % p, f, {"batches": 0, "steps": 0})
        got += [0 if zl == 0 else zz * zr1 * rinv % p,
                0 if zr == 0 else zz * zl1 * rinv % p]
    jsp = jf.spec_for(getattr(jax_pkg.curves, name).fq)
    lanes = [z for pair in pairs for z in pair]
    want = _ints(jfs.mont_inv_batch(jsp, _jax_limbs(lanes)))
    assert got == want
    assert got[:2] == [0, 0]


def test_inverse_constants_follow_the_fields():
    """ops/fs.py::inv_words: R^3 mod p and p^-1 mod 2^30 of fq, then fr
    (the 9-word InvConst of csrc/fs.cuh, twice)."""
    c = curves.secq256k1
    fq, fr = df.spec_for(c.fq), df.spec_for(c.fr)
    w = fs.inv_words(fq, fr).tolist()
    assert len(w) == 18
    for f, part in ((fq, w[:9]), (fr, w[9:])):
        assert from_words(part[:8]) == pow(f.R, 3, f.p)
        assert part[8] * f.p % (1 << 30) == 1
