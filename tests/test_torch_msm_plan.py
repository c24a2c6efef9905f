"""The v2 MSM's column plan (ops/msm2.py::plan_columns, column_split).

The port chooses stage C's column count C for the card: min(C_COLS, n),
raised while B W C lanes under-fill the card (fill_lanes: its SMs times
the scan kernel's launch bounds, which these tests tie to
csrc/msm_kernels.cu) and the scan's depth R = n / C stays DEPTH_RATIO
times stage D's c1 + c2. These tests state the plan at the smoke's shapes, hold it to the JAX package's plan where the
port keeps that (n <= C_COLS), force other plans at small n through the
plan's constants and hold the MSM to the host Pippenger under them (equal
in affine: other plans add in another order, so projective coordinates
differ), and hold the two-level column carries under other splits to a
direct exclusive suffix over the columns. On the CPU the kernels' plain
versions run.
"""

import os
import random
import re

import pytest
import torch

from ark_bulletproofs_tpu.ops import msm2 as jm
from ark_bulletproofs_tpu_torch import curves, engine, msm, seeded_rng
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
from ark_bulletproofs_tpu_torch.ops import msm2
from ark_bulletproofs_tpu_torch.ops.curve import (affine_to_device,
                                                  point_batch_to_host,
                                                  spec_for)

torch.set_num_threads(1)

CURVES = [curves.secq256k1, curves.zorro, curves.curve25519]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ark_bulletproofs_tpu_torch", "csrc")


def _src() -> str:
    """The text of the group-law sources: csrc/msm_kernels.cu (RCB and TE
    points), csrc/point_kernels.cuh (the templates both instantiate) and
    csrc/jac_kernels.cu (Jacobian points), in that order."""
    out = []
    for name in ("msm_kernels.cu", "point_kernels.cuh", "jac_kernels.cu"):
        with open(os.path.join(CSRC, name)) as fh:
            out.append(fh.read())
    return "\n".join(out)
FILL = msm2.fill_lanes("cpu")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


# (n, B) -> (C, R, c1, c2) at the default constants: the smoke's n = 2^20
# MSM (B = 1) doubles from 22,528 and 45,056 lanes, both fewer than the
# 50,688 the card keeps resident, to 90,112 lanes of 256 rows; two sets
# stop at 2048 columns, 128 sets keep the JAX plan; n = 2^16 and 8192
# would need R below 2 (c1 + c2) to grow C; n = 256 keeps C = n.
PLANS = {
    (1 << 20, 1): (4096, 256, 64, 64),
    (1 << 20, 2): (2048, 512, 64, 32),
    (1 << 20, 128): (1024, 1024, 32, 32),
    (1 << 16, 1): (1024, 64, 32, 32),
    (1 << 16, 2): (1024, 64, 32, 32),
    (1 << 16, 128): (1024, 64, 32, 32),
    (8192, 1): (1024, 8, 32, 32),
    (8192, 2): (1024, 8, 32, 32),
    (8192, 128): (1024, 8, 32, 32),
    (256, 1): (256, 1, 16, 16),
    (256, 2): (256, 1, 16, 16),
    (256, 128): (256, 1, 16, 16),
}


@pytest.mark.parametrize("n,B", sorted(PLANS), ids=lambda v: str(v))
def test_plan_at_the_smoke_shapes(n, B):
    g = msm2._Cfg(n, msm2.window_bits(n), B)
    assert (g.C, g.R, g.c1, g.c2) == PLANS[n, B]
    assert g.C * g.R == n and g.c1 * g.c2 == g.C and g.c1 >= g.c2
    assert g.L == B * g.W * g.C
    if g.C > min(msm2.C_COLS, n):  # raised: the card was under-filled
        assert g.L // 2 < FILL
        assert g.R >= msm2.DEPTH_RATIO * (g.c1 + g.c2)
    if 2 * g.C <= n:  # not raised further: card full or too shallow
        c1, c2 = msm2.column_split(2 * g.C)
        assert (g.L >= FILL
                or g.R // 2 < msm2.DEPTH_RATIO * (c1 + c2))


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("B", [1, 2, 128])
def test_plan_keeps_the_jax_columns_up_to_c_cols(n, B):
    c = msm2.window_bits(n)
    g, jg = msm2._Cfg(n, c, B), jm._Cfg(n, c, B)
    assert g.C == min(1024, n)
    assert (g.W, g.BW, g.C, g.R, g.L, g.S) == (jg.W, jg.BW, jg.C, jg.R,
                                               jg.L, jg.S)


def test_fill_rule_raises_columns_only_while_deep_enough(monkeypatch):
    """C doubles from min(C_COLS, n) while the lanes under-fill the card
    and stops at the depth limit, whichever comes first."""
    monkeypatch.setattr(msm2, "C_COLS", 256)
    monkeypatch.setattr(msm2, "DEPTH_RATIO", 0)
    assert msm2.plan_columns(4096, 8, 1, 1 << 14) == 512  # 32 x 512 fill
    assert msm2.plan_columns(4096, 8, 1, 1 << 30) == 4096  # C = n: one row
    monkeypatch.setattr(msm2, "DEPTH_RATIO", 1)
    assert msm2.plan_columns(4096, 8, 1, 1 << 30) == 256  # R 8 < 48
    assert msm2.column_split(4096) == (64, 64)
    assert msm2.column_split(2048) == (64, 32)
    assert msm2.column_split(256) == (16, 16)


def test_fill_lanes_follow_the_scan_launch_bounds():
    """The plan's SCAN_THREADS and SCAN_MIN_BLOCKS are the scan kernel's
    block size and __launch_bounds__ minimum in csrc/msm_kernels.cu, and
    off the card the plan assumes the H100's 132 SMs."""
    src = _src()
    defs = dict(re.findall(r"^#define (SCAN_\w+) (\d+)$", src, re.M))
    assert defs == {"SCAN_THREADS": str(msm2.SCAN_THREADS),
                    "SCAN_MIN_BLOCKS": str(msm2.SCAN_MIN_BLOCKS)}
    assert re.search(r"__launch_bounds__\(SCAN_THREADS, SCAN_MIN_BLOCKS\)"
                     r"\s+suffix_madd_scan_kernel\(", src)
    assert FILL == 132 * 3 * 128 == 50_688


def test_chain_crossover_follows_the_launcher():
    """kernels2.CHAIN_ONE_THREAD_MIN_LANES is the lane count from which
    csrc/msm_kernels.cu's suffix_jac_scan and rowsum launchers run one
    thread a lane, each model's add-only chain takes a group of 8 threads
    below it, and the plans put the n = 2^20 MSM's stage D and F (22 c1
    and 22 M1 lanes) below it and stage D level A of 1024 sets at n = 256
    (16 rows of 1,048,576 lanes: the on-device Fiat-Shamir IPA's table
    shrink, ops/ipa.py SHRINK_SETS) above it."""
    src = _src()
    cross = re.findall(r"^#define CHAIN_ONE_THREAD_MIN_LANES (\d+)$", src,
                       re.M)
    assert cross == [str(k2.CHAIN_ONE_THREAD_MIN_LANES)]
    assert src.count("if (L >= CHAIN_ONE_THREAD_MIN_LANES)") == 2
    # RcbModel's and TeModel's (JacModel's, third, is the double-k-add's)
    assert re.findall(r"static constexpr int ADD_GRP = (\d+);", src)[:2] == [
        "8", "8"]
    big = msm2._Cfg(1 << 20, msm2.window_bits(1 << 20), 1, "cpu")
    assert big.BW * big.c1 == 1408 < k2.CHAIN_ONE_THREAD_MIN_LANES
    batch = msm2._Cfg(256, msm2.window_bits(256), 1024, "cpu")
    assert (batch.c2, batch.BW * batch.c1) == (16, 1_048_576)
    assert k2.CHAIN_ONE_THREAD_MIN_LANES <= batch.BW * batch.c1


def _models(src):
    """{model: the text of its struct} of the group-law sources' point
    models."""
    out = {}
    for name in ("RcbModel", "TeModel", "JacModel"):
        body = src[src.index(f"struct {name}"):]
        out[name] = body[:body.index("\n};\n")]
    return out


def _dka_bands(src):
    """{kk.DKA_BANDS key: (DKA_GROUP4_MIN_LANES, DKA_ONE_THREAD_MIN_LANES)}
    read from the point models (RcbModel's a number for
    both branches, or AZ ? a = 0 : a != 0)."""
    out = {}
    for name, body in _models(src).items():
        vals = [re.search(rf"static constexpr int64_t {c} =\s*([^;]+);",
                          body).group(1).strip()
                for c in ("DKA_GROUP4_MIN_LANES", "DKA_ONE_THREAD_MIN_LANES")]
        if name == "RcbModel":
            pairs = [re.fullmatch(r"AZ \? (\d+) : (\d+)", v).groups()
                     if v.startswith("AZ") else (v, v) for v in vals]
            out["rcb a=0"] = tuple(int(p[0]) for p in pairs)
            out["rcb a"] = tuple(int(p[1]) for p in pairs)
        else:
            out["te" if name == "TeModel" else "jac"] = tuple(map(int, vals))
    return out


def _launcher(src):
    launcher = src[src.index("static void launch_double_k_add("):]
    return launcher[:launcher.index("\n}\n")]


def _extern(src, name):
    body = src[src.index(f'extern "C" int abtpu_{name}('):]
    return body[:body.index("\n}\n")]


def test_jac_double_k_add_crossover_follows_the_launcher():
    """kernels.DKA_BANDS["jac"] holds JacModel's DKA_GROUP4_MIN_LANES and
    DKA_ONE_THREAD_MIN_LANES, the lane counts from which
    csrc/point_kernels.cuh's double-k-add launcher runs a group of 4 threads
    a lane and one thread a lane (for Jacobian points
    double_k_add_kernel); below them JacModel's group of ADD_GRP = 8
    threads a lane (double_k_add_group_kernel), on both Jacobian models.
    The on-device Fiat-Shamir IPA of one proof at n = 256 (its c * Q
    tree's 2h lanes, h = 128 ... 1, and S's 2) takes the group of 8, the
    P = 128 batch's tree (256 h lanes) the three mappings."""
    src = _src()
    g4, one = kk.DKA_BANDS["jac"]
    assert _dka_bands(src)["jac"] == (g4, one)
    launcher = _launcher(src)
    assert re.findall(r"if \(m >= M::(\w+)\)", launcher) == [
        "DKA_ONE_THREAD_MIN_LANES", "DKA_GROUP4_MIN_LANES"]
    assert "double_k_add_group_kernel<M, 4>" in launcher
    assert "double_k_add_group_kernel<M, G>" in launcher
    assert "if constexpr (!M::DKA_WIDE)\n      double_k_add_kernel<M>" in (
        launcher)
    jac = _models(src)["JacModel"]
    assert re.findall(r"static constexpr int ADD_GRP = (\d+);", jac) == ["8"]
    assert "static constexpr bool DKA_WIDE = false;" in jac
    body = _extern(src, "jac_double_k_add")
    assert body.count("launch_double_k_add<JacModel<") == 2
    assert "double_k_add_kernel<" not in body
    assert 2 * 128 < g4 < one
    assert one <= 256 * 128


def test_rcb_te_double_k_add_bands_follow_the_launcher():
    """kernels.DKA_BANDS holds the per-model bands of the point models
    (RcbModel a = 0 and a != 0, TeModel, JacModel), and the RCB and TE
    launchers go through launch_double_k_add for their models: a group of
    8 threads a lane below the first edge, of 4 below the second, one
    thread a lane from it on the throughput kernel (DKA_WIDE; k = 0 on
    its instantiation without the doubling code, whose launch bounds keep
    at least 3 blocks an SM resident). The plans put the
    n = 2^20 MSM's stage D and E adds (BW C and BW S = 90,112 lanes) in
    the one-thread band, and one proof's TE trees (the commit tree's 256
    ... 1 lanes, the c * Q tree's 2h for h = 128 ... 1) in a group band."""
    src = _src()
    bands = _dka_bands(src)
    assert bands == kk.DKA_BANDS
    models = _models(src)
    for name in ("RcbModel", "TeModel"):
        assert "static constexpr bool DKA_WIDE = true;" in models[name]
        blocks = re.search(r"static constexpr int DKA_MIN_BLOCKS = ([^;]+);",
                           models[name]).group(1)
        assert min(map(int, re.findall(r"\d+", blocks))) >= 3, name
        assert re.findall(r"static constexpr int ADD_GRP = (\d+);",
                          models[name]) == ["8"]
    launcher = _launcher(src)
    assert re.findall(r"double_k_add_wide_kernel<M, (\w+)>", launcher) == [
        "false", "true"]
    assert "else if (k == 0)\n      double_k_add_wide_kernel<M, false>" in (
        launcher)
    rcb = _extern(src, "rcb_double_k_add")
    assert re.findall(r"launch_double_k_add<(\w+)>", rcb) == ["RcbA0",
                                                               "RcbA"]
    te = _extern(src, "te_double_k_add")
    assert re.findall(r"launch_double_k_add<(\w+)>", te) == ["TeModel"]
    assert "<<<" not in rcb + te
    big = msm2._Cfg(1 << 20, msm2.window_bits(1 << 20), 1, "cpu")
    assert big.BW * big.C == big.BW * big.S == 90_112
    for key in ("rcb a=0", "rcb a", "te"):
        g4, one = bands[key]
        assert 256 < one <= 90_112, key
        assert 1 <= g4 <= one, key


def _member(body, name):
    return int(re.search(rf"static constexpr int(?:64_t)? {name} = (\d+);",
                         body).group(1))


def test_jac_madd_scan_and_double_chain_bands_follow_the_launcher():
    """kernels.MADD_BANDS["jac"] holds JacModel's MADD_GROUP2_MIN_LANES and
    MADD_ONE_THREAD_MIN_LANES: csrc/jac_kernels.cu's row-scan launcher
    runs one thread a lane from the second edge, a group of 2 threads a
    lane from the first, a group of MADD_GRP = 4 below it; its chain
    launcher runs a group of GRP = 4 threads a lane at every lane count
    (the chain's one-thread band is RcbModel's alone: DBL_WIDE is false).
    Both extern launchers go through them for both Jacobian models and
    launch nothing themselves. A group of 4 holds a level of the mixed add
    (at most 4 products: madd-2007-bl's HH, I, rr^2, (Z1 + H)^2) and of
    the doubling in one round; one set's scan (32 x 512 at n = 256) is in
    the band of a group of 4."""
    src = _src()
    jac = _models(src)["JacModel"]
    assert (_member(jac, "MADD_GROUP2_MIN_LANES"),
            _member(jac, "MADD_ONE_THREAD_MIN_LANES")) == kk.MADD_BANDS["jac"]
    assert _member(jac, "MADD_GRP") == 4
    assert _member(jac, "GRP") == 4
    blocks = re.search(r"static constexpr int MADD_MIN_BLOCKS = ([^;]+);",
                       jac).group(1)
    assert min(map(int, re.findall(r"\d+", blocks))) >= 1
    assert "static constexpr bool DBL_WIDE = false;" in jac
    for launcher, edges, group, kernel, sizes in (
            ("launch_madd_scan", ["MADD_ONE_THREAD_MIN_LANES",
                                  "MADD_GROUP2_MIN_LANES"], "MADD_GRP",
             "madd_scan_kernel", ["1", "2", "G"]),
            ("launch_double_chain", [], "GRP", "double_chain_kernel",
             ["G"])):
        body = src[src.index(f"static void {launcher}("):]
        body = body[:body.index("\n}\n")]
        assert f"constexpr int G = M::{group};" in body
        assert re.findall(r"if \(m >= M::(\w+)\)", body) == edges
        assert re.findall(rf"{kernel}<M, (\w+)>", body) == sizes
        if launcher == "launch_double_chain":  # RcbModel's band only
            assert ("if constexpr (M::DBL_WIDE) {\n    if (m >= "
                    "M::DBL_ONE_THREAD_MIN_LANES && steps == 1 && keep == 0)"
                    " {\n      double_wide_kernel<M>") in body
    for name, launcher in (("jac_madd", "launch_madd_scan"),
                           ("jac_double", "launch_double_chain")):
        body = _extern(src, name)
        assert re.findall(rf"{launcher}<(JacModel<\w+>)>", body) == [
            "JacModel<true>", "JacModel<false>"], name
        assert "<<<" not in body
    g2, one = kk.MADD_BANDS["jac"]
    assert 32 * 16 < g2 <= one


def test_te_madd_scan_and_rcb_double_bands_follow_the_launcher():
    """kernels.MADD_BANDS["te"] holds TeModel's MADD_GROUP2_MIN_LANES and
    MADD_ONE_THREAD_MIN_LANES, and kernels.DBL_BANDS RcbModel's
    DBL_ONE_THREAD_MIN_LANES (a = 0, a != 0): abtpu_te_madd runs the row
    scan of point_kernels.cuh on TeModel (a group of MADD_GRP = 4 threads
    a lane, whose te_madd_grp levels hold at most 4 products, with the
    next row's t2 computed ahead: MADD_AHEAD), abtpu_rcb_double the
    doubling chain at one step on both RCB models (a group of GRP threads
    a lane, and from the edge double_wide_kernel, one thread a lane under
    launch bounds of DBL_MIN_BLOCKS resident blocks), and neither launches
    a kernel itself; TeModel's chain keeps its group at every lane count.
    The one-thread point kernels madd_kernel and double_kernel are gone.
    One set's TE scan at n = 256 (32 x 512) is in the band of a group of
    4."""
    src = _src()
    models = _models(src)
    te, rcb = models["TeModel"], models["RcbModel"]
    assert (_member(te, "MADD_GROUP2_MIN_LANES"),
            _member(te, "MADD_ONE_THREAD_MIN_LANES")) == kk.MADD_BANDS["te"]
    assert _member(te, "MADD_GRP") == 4
    assert _member(te, "MADD_MIN_BLOCKS") >= 1
    assert "static constexpr bool MADD_AHEAD = true;" in te
    assert "static constexpr bool DBL_WIDE = false;" in te
    assert "static constexpr bool DBL_WIDE = true;" in rcb
    edge = re.search(r"static constexpr int64_t DBL_ONE_THREAD_MIN_LANES ="
                     r"\s*([^;]+);", rcb).group(1).strip()
    pair = (re.fullmatch(r"AZ \? (\d+) : (\d+)", edge).groups()
            if edge.startswith("AZ") else (edge, edge))
    assert {"rcb a=0": int(pair[0]), "rcb a": int(pair[1])} == kk.DBL_BANDS
    blocks = re.search(r"static constexpr int DBL_MIN_BLOCKS = ([^;]+);",
                       rcb).group(1)
    assert min(map(int, re.findall(r"\d+", blocks))) >= 1
    body = _extern(src, "te_madd")
    assert re.findall(r"launch_madd_scan<(\w+)>", body) == ["TeModel"]
    body = _extern(src, "rcb_double")
    assert re.findall(r"launch_double_chain<(\w+)>\(P, out, m, 1, 0,",
                      body) == ["RcbA0", "RcbA"]
    assert "<<<" not in _extern(src, "te_madd") + body
    assert "madd_kernel<" not in src.replace("madd_scan_kernel<", "")
    assert "double_kernel<" not in src
    g2, one = kk.MADD_BANDS["te"]
    assert 32 * 16 < g2 <= one
    for key, L in kk.DBL_BANDS.items():
        assert 1 < L <= 1 << 20, key


def _case(curve, n, seed):
    """n bases from 12 random points and their negatives (repeats give
    doublings and cancellations), identity bases, and the scalars 0, 1 and
    r - 1."""
    rng = seeded_rng(seed)
    pool = [curve.rand(rng) for _ in range(12)]
    pool += [curve.neg(P) for P in pool]
    prng = random.Random(seed)
    bases = [pool[prng.randrange(24)] for _ in range(n)]
    bases[1] = bases[9] = curve.zero()
    ks = [prng.randrange(curve.fr.p) for _ in range(n)]
    ks[2], ks[3], ks[4] = 0, 1, curve.fr.p - 1
    ks[9] = curve.fr.p - 1  # times the identity
    return bases, ks


# n = 1024 (c = 8, W = 32) under forced plans: the JAX columns cut to 256
# (R = 4, c1 = c2 = 16), and 256 raised by the fill rule to 512 (R = 2,
# c1 = 32 != 16: 32 x 256 lanes under-fill 2^14, 32 x 512 do not).
FORCED = {
    "C256": ({"C_COLS": 256}, (256, 4, 16, 16)),
    "raised": ({"C_COLS": 256, "DEPTH_RATIO": 0,
                "fill_lanes": lambda device: 1 << 14}, (512, 2, 32, 16)),
}


@pytest.mark.parametrize("plan", sorted(FORCED))
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_msm_under_forced_plans_matches_host(curve, plan, monkeypatch):
    consts, want = FORCED[plan]
    for name, value in consts.items():
        monkeypatch.setattr(msm2, name, value)
    n = 1024
    g = msm2._Cfg(n, msm2.window_bits(n), 1)
    assert (g.C, g.R, g.c1, g.c2) == want
    bases, ks = _case(curve, n, 40 + len(plan))
    assert msm(curve, bases, ks, device="cpu") == curve.msm(bases, ks)


def _random_points(curve, spec, count, seed):
    """(NC, 16, count) device-coordinate points (Z = 1; a sixth of them the
    identity) drawn from 64 random affine points."""
    rng = seeded_rng(seed)
    pool = [curve.rand(rng) for _ in range(64)]
    prng = random.Random(seed)
    X, Y, inf = affine_to_device(
        curve, [pool[prng.randrange(64)] for _ in range(count)], "cpu")
    inf = inf | (torch.arange(count) % 6 == 5)
    P = k2.suffix_madd_scan_plain(
        spec, torch.stack([X, torch.where(inf, 0, Y)]).unsqueeze(1))
    return P[:, 0]


@pytest.mark.parametrize("c1", [4, 8, 64])
def test_stage_carries_under_other_splits(c1):
    """The two-level exclusive column suffix (level A over c2 columns, level
    B over the c1 chunk totals, one add) equals suffix_jac_scan_plain run
    once over all C columns, for splits other than column_split's."""
    curve = curves.secq256k1
    spec = spec_for(curve)
    g = msm2._Cfg(256, 16, 1)  # C = 256, W = 16
    g.c1, g.c2 = c1, g.C // c1
    tot = _random_points(curve, spec, g.L, 70 + c1)  # (NC, 16, BW * C)
    locs = tot.unsqueeze(1)  # (NC, R = 1, 16, L): row 0 the column totals
    got = msm2._stage_carries(g, spec, locs)
    cols = tot.reshape(3, 16, g.BW, g.C).permute(0, 3, 1, 2).contiguous()
    excl, _ = k2.suffix_jac_scan_plain(spec, cols)  # (NC, C, 16, BW)
    want = excl.permute(0, 2, 3, 1).reshape(3, 16, g.L)
    assert point_batch_to_host(curve, got) == point_batch_to_host(curve,
                                                                  want)
