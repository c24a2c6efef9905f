"""The field core's PTX carry chains (csrc/field.cuh) on the CPU.

The CUDA field add, subtract and final subtraction of p are inline PTX on
the condition code (add.cc / addc, sub.cc / subc), which only a card
runs. This file reads each asm block out of field.cuh, runs it through a
small interpreter of those instructions on 32-bit words, and drives
fe_add, fe_sub and fe_cond_sub_p as the C++ does. Their results are
held, bit for bit, to the JAX package's field functions
(ark_bulletproofs_tpu/ops/field.py: add, sub) and to the port's plain
versions (ops/field.py) on the same inputs, made with numpy from a seed,
on the base and scalar fields of the three curves: 0, 1, p - 1, p - 2,
R mod p, values at and above 2^255 where p > 2^255 (secq256k1 and zorro,
whose top carry must survive), and random values; fe_cond_sub_p alone
also on sums r + extra 2^256 below 2p, with the top carry set. A further
test checks that no block takes a carry it did not make or leaves one
behind: the condition code does not survive between asm statements.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from ark_bulletproofs_tpu.ops import field as jf
from ark_bulletproofs_tpu_torch import curves
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD_CUH = os.path.join(ROOT, "ark_bulletproofs_tpu_torch", "csrc",
                         "field.cuh")
M32 = (1 << 32) - 1
FIELDS = [(c, f) for c in (curves.secq256k1, curves.zorro, curves.curve25519)
          for f in ("fq", "fr")]


def _split_top(text: str) -> list[str]:
    """Split an asm statement's body on the colons outside strings."""
    segs, cur, in_str = [], "", False
    for ch in text:
        if ch == '"':
            in_str = not in_str
        if ch == ":" and not in_str:
            segs.append(cur)
            cur = ""
            continue
        cur += ch
    return segs + [cur]


def asm_blocks(src: str, fn: str) -> list:
    """The asm statements of function `fn`: (instructions, outputs, inputs)
    with each operand as (constraint, C expression)."""
    start = src.index(f" {fn}(")
    body = src[start:src.index("\n}\n", start)]
    blocks = []
    for m in re.finditer(r"asm\((.*?)\);", body, re.S):
        segs = _split_top(m.group(1))
        text = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', segs[0]))
        text = text.replace("\\n", "\n").replace("\\t", " ")
        instrs = [s.strip() for s in text.split(";") if s.strip()]

        def ops(seg):
            return re.findall(r'"([=+]?r)"\((.*?)\)(?=\s*,|\s*$)',
                              seg.strip(), re.S)

        blocks.append((instrs, ops(segs[1]), ops(segs[2])))
    return blocks


def run_block(block, env: dict) -> None:
    """Interpret one asm block; operands are C expressions over `env`
    (Python-compatible: a.v[0], cc.p[2] & br), outputs written back."""
    instrs, outs, ins = block
    vals = {}
    for k, (cons, expr) in enumerate(outs + ins):
        vals[f"%{k}"] = None if cons.startswith("=") else \
            eval(expr, {}, env) & M32
    cf = None

    def get(x):
        if x.startswith("%"):
            assert vals[x] is not None, f"{x} read before written"
            return vals[x]
        return int(x, 0)

    for ins_ in instrs:
        op, args = ins_.split(None, 1)
        args = [a.strip() for a in args.split(",")]
        a = [get(x) for x in args[1:]]
        parts = op.split(".")
        base = parts[0]
        cin = 0
        if base in ("addc", "subc"):
            assert cf is not None, f"{ins_}: carry in not made in this block"
            cin = cf
        if base in ("add", "addc"):
            s = a[0] + a[1] + cin
        elif base in ("sub", "subc"):
            s = a[0] - a[1] - cin
        else:
            raise AssertionError(f"unknown instruction {op}")
        res = s & M32
        if "cc" in parts:
            cf = (1 if s < 0 else 0) if base in ("sub", "subc") else s >> 32
        else:
            cf = None  # consumed
        vals[args[0]] = res
    for k, (_, expr) in enumerate(outs):
        exec(f"{expr} = {vals[f'%{k}']}", {}, env)


class _Words:
    def __init__(self, v):
        self.v = list(v)


class _Consts:
    def __init__(self, p: int):
        self.p = [(p >> (32 * i)) & M32 for i in range(8)]


def _fe(x: int) -> _Words:
    return _Words((x >> (32 * i)) & M32 for i in range(8))


def _int(w: _Words) -> int:
    return sum(v << (32 * i) for i, v in enumerate(w.v))


class Chains:
    """field.cuh's functions over the interpreted asm blocks."""

    def __init__(self, src: str):
        self.b = {fn: asm_blocks(src, fn) for fn in
                  ("fe_sub_p_words", "fe_add", "fe_sub")}

    def cond_sub_p(self, r, extra, cc):
        env = {"d": _Words([0] * 8), "r": r, "cc": cc, "br": 0}
        run_block(self.b["fe_sub_p_words"][0], env)
        return env["d"] if extra != 0 or env["br"] == 0 else r

    def add(self, a, b, cc):
        env = {"s": _Words([0] * 8), "a": a, "b": b, "c": 0}
        run_block(self.b["fe_add"][0], env)
        return self.cond_sub_p(env["s"], env["c"], cc)

    def sub(self, a, b, cc):
        env = {"d": _Words([0] * 8), "a": a, "b": b, "br": 0, "cc": cc}
        for block in self.b["fe_sub"]:
            run_block(block, env)
        return env["d"]


@pytest.fixture(scope="module")
def chains():
    with open(FIELD_CUH) as fh:
        return Chains(fh.read())


def _operands(p: int, seed: int):
    """(xs, ys, wide): canonical pairs with the edge values, and sums
    below 2p for the final subtraction, up to 2^256 and past it where
    2p > 2^256."""
    rng = np.random.default_rng(seed)
    R = 1 << 256

    def rand(bound: int, k: int) -> list[int]:
        words = rng.integers(0, 1 << 32, size=(k, 8), dtype=np.uint64)
        return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % bound
                for row in words]

    special = [0, 1, 2, p - 1, p - 2, R % p, p // 2, (p + 1) // 2]
    if p > 1 << 255:
        special += [1 << 255, (1 << 255) + 1, p - 3]
    xs = special + rand(p, 48)
    ys = list(reversed(special)) + rand(p, 48)
    ys[len(special) // 2] = p - 1
    wide = [0, p - 1, p, p + 1, 2 * p - 1, min(R - 1, 2 * p - 1)]
    if 2 * p > R:
        wide += [R, R + 1, 2 * p - 2]
    wide += [x + y for x, y in zip(xs, ys)]
    return xs, ys, wide


def _jax(fn, fs, xs, ys):
    to = lambda v: jnp.asarray(np.array(  # noqa: E731
        [[(x >> (16 * i)) & 0xFFFF for i in range(16)] for x in v],
        dtype=np.uint32))
    out = np.asarray(fn(fs, to(xs), to(ys)))
    return [sum(int(w) << (16 * i) for i, w in enumerate(row)) for row in out]


@pytest.mark.parametrize("curve,which", FIELDS,
                         ids=[f"{c.name}-{f}" for c, f in FIELDS])
def test_chains_match_jax_and_plain(chains, curve, which):
    field = getattr(curve, which)
    p = field.p
    cc = _Consts(p)
    xs, ys, wide = _operands(p, len(curve.name) * 7 + len(which))
    jfs = jf.FieldSpec.create(field.name, p)
    tfs = df.spec_for(field)

    got_add = [_int(chains.add(_fe(x), _fe(y), cc)) for x, y in zip(xs, ys)]
    got_sub = [_int(chains.sub(_fe(x), _fe(y), cc)) for x, y in zip(xs, ys)]
    assert got_add == _jax(jf.add, jfs, xs, ys)
    assert got_sub == _jax(jf.sub, jfs, xs, ys)
    a, b = ints_to_limbs(xs), ints_to_limbs(ys)
    assert got_add == limbs_to_ints(df.add(tfs, a, b))
    assert got_sub == limbs_to_ints(df.sub(tfs, a, b))
    assert got_add == [(x + y) % p for x, y in zip(xs, ys)]
    assert got_sub == [(x - y) % p for x, y in zip(xs, ys)]

    # r + extra 2^256 < 2p -> r mod p, the top carry kept as `extra`
    got = [_int(chains.cond_sub_p(_fe(v), v >> 256, cc)) for v in wide]
    assert got == [v % p for v in wide]


def test_no_carry_crosses_an_asm_statement(chains):
    """Every block's first carry step makes its carry (add.cc, sub.cc)
    and its last consumes it without making one (addc / subc without
    .cc), so no carry is read from or left for another statement."""
    for fn, blocks in chains.b.items():
        for instrs, _, _ in blocks:
            carry = [i.split()[0] for i in instrs]
            assert carry[0].split(".")[0] in ("add", "sub"), fn
            assert "cc" in carry[0].split("."), fn
            assert "cc" not in carry[-1].split("."), fn
            assert carry[-1].split(".")[0] in ("addc", "subc"), fn
    assert len(chains.b["fe_sub"]) == 2
