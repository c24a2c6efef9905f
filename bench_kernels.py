#!/usr/bin/env python3
"""The port's n = 2^20 MSM under several column plans, on one CUDA card.

    python3 bench_kernels.py [--out FILE]

What chip_smoke.py does not measure: the v2 MSM at n = 2^20 on secq256k1
and curve25519 (host clock around synchronised calls, median of 5) with
its stage split by CUDA events (chip_smoke.msm_stage_split), under the
port's own plan (ops/msm2.py::plan_columns) and under the column counts
C = 1024, 2048 and 4096 forced in turn; every plan's sum equal in affine
to the own plan's (two plans add in another
order, so projective coordinates differ). Also ptxas's registers and
spills of the scans, the Horner and mont_mul, and the SASS instruction
mix of mont_mul_kernel (one field product, from cuobjdump).

Stages D and F's kernels (suffix_jac_scan, rowsum) under other mappings
than the committed one: csrc/msm_kernels.cu is built again with its
constants changed (CHAIN_VARIANTS: a group of 8 or 4 threads a lane at
every lane count, one thread a lane at every lane count), each variant
bit-equal to the committed kernels, and all timed from CUDA graphs in
turns (committed, variants, variants reversed, committed) on the three
point models at CHAIN_SHAPES, the paths' shapes and the crossover's
neighbours.

The Jacobian jac_double_k_add the same way (JAC_VARIANTS, built from
csrc/jac_kernels.cu: a group of 8 or 4 threads a lane at every lane
count, one thread a lane at every lane count) at k = 0 and 1 on secq256k1 and zorro at every lane count the
paths send (chip_smoke.DKA_LANES, 2 to 786,432), against the committed
launcher's choice; and fs_round at P = 1 and 128 on the three curves
against a build whose safegcd divstep inverts f mod 2^32 by Newton's
iteration (FS_VARIANTS), beside one thread's SM cycles for a Keccak
permutation, a field product and a field inverse (OP_PROBE).

The v1 row scan (jac_madd over R rows in one launch) the same way
(SCAN_VARIANTS, built from csrc/jac_kernels.cu: a group of 8, 4 or 2
threads a lane at every lane count, one thread a lane at every lane count
under launch bounds of 1 to 4 resident blocks) at 32 rows of every lane
count of chip_smoke.SCAN_LANES and at the small rounds' row counts; and
the Q-table chain (jac_double with 255 steps, a group of 4 threads a
lane) at 1 to 65,536 lanes, on secq256k1 and zorro.

The field kernels (csrc/field_kernels.cu): mont_mul's block of 128
threads against 256 and 64 (FIELD_VARIANTS) at the paths' lane counts
(MM_LANES, 1 to 65,536), and the one-launch batch inverse with the
shrink's two rows at INV_BENCH_LANES; and te_double's 255-step chain at 1
and 2 lanes (the TE Q and commit tables). With --parent DIR (a checkout
of the parent commit, e.g. unpacked by `git archive` into the git-ignored
chipwork/), the parent's kernels are built too and its forms timed in
the same turns: its 255 one-step te_double launches and their stack, and
its mont_inv_batch (Montgomery's trick and a Fermat power on its product
kernel).

The TE row scan (te_madd over R rows in one launch) as the Jacobian one
(TE_SCAN_VARIANTS, built from csrc/msm_kernels.cu: a group of 8, 4 or 2
threads a lane, one thread a lane under 1 to 4 resident blocks) at the
same shapes on curve25519; and rcb_double (DBL_VARIANTS: a group of 8, 4
or 2 threads a lane, one thread a lane under 4 to 7 resident blocks or
with no minimum) at DBL_LANES (1 to 2^20) on secq256k1 and zorro. With
--parent, a parent whose te_madd takes one row is timed as one launch and
one copy a row, and its rcb_double as it is, in the same turns. Every
build's ptxas registers and spills are printed.

The v2 MSM's stage-B gather (stage_gather: csrc/gather_kernels.cu's
table kernel and gather kernel) at n = 2^20, B = 1 from a real sort and at
the largest base-map shape a path sends (1,024 sets of 256), against
GATHER_VARIANTS (tiles of 2 to 16 rows and of 512 points, the other block
order, the (m, 2, 16) table of 128-byte rows, no L2 hint or another
evict_last fraction, write-back stores) and the
committed gather kernel on a table packed in torch, with the table's
build and alone; the table kernel against its torch form; the gather
kernel over tables of GATHER_SWEEP rows (what L2 misses cost); with
--parent, the parent's torch stage B in the same turns.

The generator farm's kernel (gen_candidates, csrc/gens_kernels.cu) with
the exponent raised in other fixed windows than the committed POW_WIN
(GENS_VARIANTS: 1, 2, 3 and 5 bits; 1 is the plain bit scan that skips
zero bits), each bit-equal to the committed kernel, timed at 2^21 attempts
on secq256k1 and zorro.

--parts picks the comparisons to run (default all): ops (one thread's
cycles), fs, jac, rcb_te, wide, chains, scan, chain, field, te_chain,
te_scan, rcb_double, stage_gather, gens, msm.

The last line is a JSON object of every number; --out also writes it to
FILE. Needs one card; exits 1 without.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_MSM = 1 << 20
MSM_PLANS = (1024, 2048, 4096)  # stage C's column count at n = 2^20
CSRC = os.path.join(HERE, "ark_bulletproofs_tpu_torch", "csrc")
CROSS = "#define CHAIN_ONE_THREAD_MIN_LANES 16384"
GROUP = ("#define CHAIN_ONE_THREAD_MIN_LANES 16384",
         "#define CHAIN_ONE_THREAD_MIN_LANES 0x7fffffffffffffffLL")
# msm_kernels.cu's text substitutions of each variant of stages D and F
CHAIN_VARIANTS = {
    "group 8": ("msm_kernels.cu", [GROUP]),
    "group 4": ("msm_kernels.cu", [GROUP, (
        "static constexpr int ADD_GRP = 8;",
        "static constexpr int ADD_GRP = 4;")]),
    "one thread": ("msm_kernels.cu",
                   [(CROSS, "#define CHAIN_ONE_THREAD_MIN_LANES 1")]),
}
# (rows, lanes): the paths' (chip_smoke.CHAIN_SHAPES) and the crossover's
CHAIN_SHAPES = [(64, 1408), (64, 22), (16, 1024), (16, 64), (1, 64),
                (16, 8192), (16, 65536), (16, 1048576), (16, 4096),
                (16, 16384), (16, 32768), (16, 131072)]
# The text substitutions of each mapping of the double-k-add launcher
# (point_kernels.cuh's launch_double_k_add), at every lane count, built
# from jac_kernels.cu for the Jacobian launcher and from msm_kernels.cu
# for the RCB and TE ones. "one thread" is the band's kernel
# (double_k_add_wide_kernel on RCB and TE, double_k_add_kernel on
# Jacobian points), "parent one thread" double_k_add_kernel on RCB and TE.
ONE = "if (m >= M::DKA_ONE_THREAD_MIN_LANES) {"
FOUR = "} else if (m >= M::DKA_GROUP4_MIN_LANES) {"
WIDE = "static constexpr bool DKA_WIDE = true;"
DKA_SUBS = {
    "group 8": [(ONE, "if (false) {"), (FOUR, "} else if (false) {")],
    "group 4": [(ONE, "if (false) {"), (FOUR, "} else if (true) {")],
    "one thread": [(ONE, "if (true) {")],
}
JAC_VARIANTS = {f"jac {name}": ("jac_kernels.cu", subs)
                for name, subs in DKA_SUBS.items()}
RCB_TE_VARIANTS = {f"dka {name}": ("msm_kernels.cu", subs)
                   for name, subs in DKA_SUBS.items()}
RCB_TE_VARIANTS["dka parent one thread"] = ("msm_kernels.cu", [
    (ONE, "if (true) {"), (WIDE, "static constexpr bool DKA_WIDE = false;")])
# double_k_add_wide_kernel under other launch bounds on every model
# (blocks an SM keeps resident: 3, 4 or 5, at k = 0 and k > 0; or no
# minimum, as the parent's one-thread kernel), and over a grid of the
# blocks the card keeps resident, each striding over the lanes, instead of
# one block per 128 lanes
BOUNDS = ("__launch_bounds__(DKA_THREADS,\n"
          "                                  DBL ? DKA_DBL_MIN_BLOCKS : "
          "M::DKA_MIN_BLOCKS)")
MIN_BLOCKS = ("static constexpr int DKA_MIN_BLOCKS = AZ ? 3 : 5;",
              "static constexpr int DKA_MIN_BLOCKS = 3;",
              "#define DKA_DBL_MIN_BLOCKS 3")
WIDE_VARIANTS = {
    f"wide {n} blocks": ("msm_kernels.cu", [
        (a, a[:a.rindex("=") + 2] + f"{n};" if "=" in a else a[:-1] + str(n))
        for a in MIN_BLOCKS]) for n in (3, 4, 5)}
WIDE_VARIANTS["wide no minimum"] = ("msm_kernels.cu", [
    (BOUNDS, "__launch_bounds__(DKA_THREADS)")])
ONE_LANE = """  size_t lane = (size_t)blockIdx.x * DKA_THREADS + threadIdx.x;
  if (lane >= (size_t)m) return;
  typename M::P acc = M::load(P, 1, 0, m, lane);
  if (DBL)
    for (int32_t i = 0; i < k; ++i) acc = M::dbl(acc, cc);
  M::store(out, 1, 0, m, lane, M::add(acc, M::load(Q, 1, 0, m, lane), cc));"""
STRIDE = """  for (size_t lane = (size_t)blockIdx.x * DKA_THREADS + threadIdx.x;
       lane < (size_t)m; lane += (size_t)gridDim.x * DKA_THREADS) {
    typename M::P acc = M::load(P, 1, 0, m, lane);
    if (DBL)
      for (int32_t i = 0; i < k; ++i) acc = M::dbl(acc, cc);
    M::store(out, 1, 0, m, lane, M::add(acc, M::load(Q, 1, 0, m, lane), cc));
  }"""
GRID = "<<<(unsigned)((m + DKA_THREADS - 1) / DKA_THREADS), DKA_THREADS, 0,"
RESIDENT = ("<<<(unsigned)((m + DKA_THREADS - 1) / DKA_THREADS < 132 * "
            "M::DKA_MIN_BLOCKS ? (m + DKA_THREADS - 1) / DKA_THREADS : 132 * "
            "M::DKA_MIN_BLOCKS), DKA_THREADS, 0,")
WIDE_VARIANTS["wide resident grid"] = ("msm_kernels.cu", [
    (ONE_LANE, STRIDE), (GRID, RESIDENT)])
# jac_madd's row scan (launch_madd_scan) under each mapping at every lane
# count: a group of 8, 4 or 2 threads a lane, or one thread a lane under
# launch bounds that keep 1 (no minimum), 2, 3 or 4 blocks an SM resident
MADD_ONE = "static constexpr int64_t MADD_ONE_THREAD_MIN_LANES = "
MADD_GRP = "static constexpr int MADD_GRP = "
MADD_G2 = "static constexpr int64_t MADD_GROUP2_MIN_LANES = "
MADD_BLOCKS = "static constexpr int MADD_MIN_BLOCKS = "


def _member(prefix: str, value: str, source: str = "jac_kernels.cu") -> tuple:
    """A substitution of a point model's member `prefix`... = value;,
    whatever its committed value (read from csrc/`source`: JacModel's in
    jac_kernels.cu, TeModel's or RcbModel's in msm_kernels.cu)."""
    with open(os.path.join(CSRC, source)) as fh:
        text = fh.read()
    line = text[text.index(prefix):]
    return (line[:line.index(";") + 1], f"{prefix}{value};")


SCAN_VARIANTS = {
    f"scan group {G}": ("jac_kernels.cu", [
        _member(MADD_GRP, str(G)), _member(MADD_G2, "0x7fffffffffffffffLL"),
        _member(MADD_ONE, "0x7fffffffffffffffLL")]) for G in (8, 4, 2)}
SCAN_VARIANTS.update({
    **{f"scan one thread {n} blocks": ("jac_kernels.cu", [
        _member(MADD_ONE, "0"), _member(MADD_BLOCKS, str(n))])
       for n in (1, 2, 3, 4)}})
# (rows, lanes) of the scan comparison: 32 rows at every lane count the
# paths send (chip_smoke.SCAN_LANES), and the per-round route's small
# rounds (n rows of 8,192 lanes) and prove_batch's one-term MSMs
SCAN_EXTRA = [(16, 8192), (8, 8192), (2, 8192), (1, 8192), (1, 24576)]
# te_madd's row scan (TeModel in msm_kernels.cu) the same way: a group of
# 8, 4 or 2 threads a lane at every lane count, or one thread a lane under
# launch bounds of 1 to 4 resident blocks
TE_SCAN_VARIANTS = {
    f"te scan group {G}": ("msm_kernels.cu", [
        _member(MADD_GRP, str(G), "msm_kernels.cu"),
        _member(MADD_G2, "0x7fffffffffffffffLL", "msm_kernels.cu"),
        _member(MADD_ONE, "0x7fffffffffffffffLL", "msm_kernels.cu")])
    for G in (8, 4, 2)}
TE_SCAN_VARIANTS.update({
    f"te scan one thread {n} blocks": ("msm_kernels.cu", [
        _member(MADD_ONE, "0", "msm_kernels.cu"),
        _member(MADD_BLOCKS, str(n), "msm_kernels.cu")])
    for n in (1, 2, 3, 4)})
# rcb_double (the doubling chain at one step on RcbModel) under each
# mapping at every lane count: a group of 8, 4 or 2 threads a lane, or one
# thread a lane (double_wide_kernel) under launch bounds of 4 to 7
# resident blocks or with no minimum
DBL_ONE = "static constexpr int64_t DBL_ONE_THREAD_MIN_LANES = "
DBL_BLOCKS = "static constexpr int DBL_MIN_BLOCKS = "
RCB_GRP = "static constexpr int GRP = AZ ? 4 : 8;"
DBL_VARIANTS = {
    f"dbl group {G}": ("msm_kernels.cu", [
        (RCB_GRP, f"static constexpr int GRP = {G};"),
        _member(DBL_ONE, "0x7fffffffffffffffLL", "msm_kernels.cu")])
    for G in (8, 4, 2)}
DBL_VARIANTS.update({
    f"dbl one thread {n} blocks": ("msm_kernels.cu", [
        _member(DBL_ONE, "0", "msm_kernels.cu"),
        _member(DBL_BLOCKS, str(n), "msm_kernels.cu")])
    for n in (4, 5, 6, 7)})
DBL_VARIANTS["dbl one thread no minimum"] = ("msm_kernels.cu", [
    _member(DBL_ONE, "0", "msm_kernels.cu"),
    ("__launch_bounds__(DKA_THREADS, M::DBL_MIN_BLOCKS)",
     "__launch_bounds__(DKA_THREADS)")])
DBL_LANES = [1, 1024, 4096, 8192, 16384, 32768, 65536, 1 << 20]
CHAIN_LANES = [1, 2, 8, 64, 512, 2048, 4096, 8192, 16384, 32768, 65536]
# mont_mul's block (csrc/field_kernels.cu's MM_THREADS) at 256 and 64
# threads beside the committed 128, at the paths' lane counts
MM_BLOCK = "#define MM_THREADS 128"
FIELD_VARIANTS = {f"mont_mul {n} threads": ("field_kernels.cu", [
    (MM_BLOCK, f"#define MM_THREADS {n}")]) for n in (256, 64)}
MM_LANES = [1, 2, 2048, 12288, 18432, 65536]
# the batch inverse at the table shrinks' lane counts (chip_smoke's
# INV_LANES: 1,024 at n = 2^16, 8,192 and 512 under the JAX segment plan)
INV_BENCH_LANES = [512, 1024, 8192]
# fs_round with the inverse of f mod 2^32 by Newton's iteration in each
# divstep (the first form of csrc/fs.cuh) instead of the 5-bit step
FIVE_BIT = """    const int limit = min(min(eta + 1, i), 5);
    const uint32_t m = 0xFFFFFFFFu >> (32 - limit);
    const uint32_t fi = (3u * f) ^ 2u;  // f^-1 mod 2^5 (f odd)"""
NEWTON = """    const int limit = min(eta + 1, i);
    const uint32_t m = 0xFFFFFFFFu >> (32 - limit);
    uint32_t fi = (3u * f) ^ 2u;
    fi *= 2u - f * fi;
    fi *= 2u - f * fi;
    fi *= 2u - f * fi;"""
FS_VARIANTS = {"fs newton step": ("fs_kernels.cu", [(FIVE_BIT, NEWTON)])}
# stage_gather (csrc/gather_kernels.cu) under other tiles, row widths,
# block orders, L2 hints and stores: each a text substitution of the
# committed source. "rows fast" puts a lane tile's row tiles in
# consecutive blocks; "128-byte rows" builds and reads an (m, 2, 16)
# table of x and y limbs as the torch stage built it; "no L2 hint" loads
# the table rows with __ldg, not under the evict_last policy;
# "evict_last 0.5" and "0.25" give the policy (createpolicy.fractional)
# to half and to a quarter of the lines, where the committed source gives
# it to all. (An L2 persisting window over the table, which needs the
# context's persisting set-aside, ran 2.3 times slower: PERF.md.)
STAGE_KEEP = "evict_last.b64 %0, 1.0;"
STAGE_STORE = """      const uint32_t w = s[k];
      __stcs(out + o, (int32_t)(w & 0xFFFF));
      __stcs(out + plane + o, (int32_t)(w >> 16));"""


def _stage(a: str, b: str) -> list:
    return [(f"#define {a}", f"#define {b}")]


GATHER_VARIANTS = {
    "rows 4 (64 x 4)": ("gather_kernels.cu",
                        _stage("STAGE_ROWS 8", "STAGE_ROWS 4")),
    "rows 2 (128 x 2)": ("gather_kernels.cu",
                         _stage("STAGE_ROWS 8", "STAGE_ROWS 2")),
    "rows 16 (16 x 16)": ("gather_kernels.cu",
                          _stage("STAGE_ROWS 8", "STAGE_ROWS 16")),
    "512 points (64 x 8)": ("gather_kernels.cu",
                            _stage("STAGE_POINTS 256", "STAGE_POINTS 512")),
    "rows fast": ("gather_kernels.cu", [(
        """  // A row tile's lane tiles in consecutive blocks.
  const int64_t nlt = ((int64_t)L + tl - 1) >> lg_tl;
  const int64_t rt = blockIdx.x / nlt, lt = blockIdx.x - rt * nlt;""",
        """  const int64_t ntr = (R + tr - 1) >> lg_tr;
  const int64_t lt = blockIdx.x / ntr, rt = blockIdx.x - lt * ntr;""")]),
    "128-byte rows": ("gather_kernels.cu", [
        ("constexpr int RW = 16;", "constexpr int RW = 32;"),
        ("      s[t * (RW + 1) + k] = x | (y << 16);",
         """      s[t * (RW + 1) + k] = x;
      s[t * (RW + 1) + 16 + k] = y;"""),
        (STAGE_STORE, """      __stcs(out + o, (int32_t)s[k]);
      __stcs(out + plane + o, (int32_t)s[16 + k]);""")]),
    "no L2 hint": ("gather_kernels.cu", [
        ("q[j] = ld_keep(tbl + (int64_t)row * VEC + f % VEC, keep);",
         "q[j] = __ldg(tbl + (int64_t)row * VEC + f % VEC);")]),
    "evict_last 0.5": ("gather_kernels.cu", [
        (STAGE_KEEP, STAGE_KEEP.replace("1.0", "0.5"))]),
    "evict_last 0.25": ("gather_kernels.cu", [
        (STAGE_KEEP, STAGE_KEEP.replace("1.0", "0.25"))]),
    "write-back stores": ("gather_kernels.cu", [
        ("__stcs(out + o, (int32_t)(w & 0xFFFF));",
         "out[o] = (int32_t)(w & 0xFFFF);"),
        ("__stcs(out + plane + o, (int32_t)(w >> 16));",
         "out[plane + o] = (int32_t)(w >> 16);")]),
}
# The table sizes of the miss sweep: stage B at n = 2^20 with its order
# taken mod m' over a table of m' rows (64 bytes each, packed).
GATHER_SWEEP = (1 << 12, 1 << 16, 1 << 18, 1 << 19, 1 << 20)
# stage_gather's shapes: (n, B, mapped); the largest base_map batch a path
# sends, then stage B at n = 2^20 (the order of a real _stage_sort).
GATHER_SHAPES = [(256, 1024, True), (N_MSM, 1, False)]

# One thread's latency, in SM cycles (clock64), of fs_round's parts:
# Keccak-f[1600] on shared lanes, a chain of fe_mul, a chain of fe_inv_var.
OP_PROBE = r"""
#include <cuda_runtime.h>
#include <string.h>
#include "fs.cuh"
__global__ void op_probe(long long* out, Fe x, CurveConst cc, InvConst ic) {
  __shared__ uint64_t lanes[25][FS_THREADS];
  for (int i = 0; i < 25; ++i) lanes[i][0] = i * 0x9E3779B97F4A7C15ULL ^ x.v[0];
  keccak_f1600(&lanes[0][0]);
  long long t0 = clock64();
  for (int r = 0; r < 16; ++r) keccak_f1600(&lanes[0][0]);
  long long t1 = clock64();
  Fe acc = x;
  for (int r = 0; r < 64; ++r) acc = fe_mul(acc, x, cc);
  long long t2 = clock64();
  Fe inv = acc;
  for (int r = 0; r < 8; ++r) inv = fe_inv_var(inv, cc, ic);
  long long t3 = clock64();
  out[0] = (t1 - t0) / 16;
  out[1] = (t2 - t1) / 64;
  out[2] = (t3 - t2) / 8;
  out[3] = (long long)(lanes[0][0] ^ acc.v[0] ^ inv.v[0]);
}
extern "C" int op_probe_run(void* out, const void* x, const void* cc,
                            const void* ic, void* stream) {
  Fe xv;
  CurveConst c;
  InvConst i;
  memcpy(&xv, x, sizeof xv);
  memcpy(&c, cc, sizeof c);
  memcpy(&i, ic, sizeof i);
  op_probe<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)out, xv, c, i);
  return (int)cudaGetLastError();
}
"""


def sass_mix(lib_path: str, func: str) -> dict:
    """Instruction counts of the SASS of kernel `func` in lib_path."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                       text=True, timeout=600)
    for block in re.split(r"\n\s*Function : ", r.stdout)[1:]:
        name = block.split("\n", 1)[0].strip()
        if func not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)([^;]*);",
                         block)
        mix = {"total": len(ops)}
        for op, args in ops:
            base = op.split(".")[0]
            mix[base] = mix.get(base, 0) + 1
            if op.startswith("IMAD.WIDE"):
                mix["IMAD.WIDE"] = mix.get("IMAD.WIDE", 0) + 1
            if base in ("IMAD", "IADD3") and "c[0x0]" in args:
                mix[f"{base} c[0x0]"] = mix.get(f"{base} c[0x0]", 0) + 1
        return {"function": name, "mix": mix}
    return {"function": None, "error": r.stderr[-500:]}


def in_turns(runs: dict, call, reps: int) -> dict:
    """{name: [ms, ms]}: call(run) for each of runs from a CUDA graph of
    `reps` launches, in turns (each run, then each in reverse order)."""
    import chip_smoke as cs

    times = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        times[name].append(cs.graph_ms(lambda: call(runs[name]), reps))
    return times


def build_variants(build_dir: str, variants: dict) -> dict:
    """Start one nvcc a variant {name: (source, substitutions)}: a copy of
    csrc/ with each substitution made in the files that hold its text,
    the variant's source built into a shared library. Returns {name:
    (process, library path)}."""
    from ark_bulletproofs_tpu_torch.ops import _build

    procs = {}
    for i, (name, (source, subs)) in enumerate(variants.items()):
        d = os.path.join(build_dir, f"variant_{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d, ignore=shutil.ignore_patterns("host"))
        for a, b in subs:
            hit = False
            for f in os.listdir(d):
                path = os.path.join(d, f)
                with open(path) as fh:
                    text = fh.read()
                if a in text:
                    hit = True
                    with open(path, "w") as fh:
                        fh.write(text.replace(a, b))
            if not hit:
                raise RuntimeError(f"{name}: {a!r} not in csrc/")
        lib = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
             os.path.join(d, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return procs


def launcher(lib, name: str):
    """abtpu_<name> of a loaded kernel library, called with a spec and its
    pointer and size arguments on the current stream."""
    import ctypes

    import torch

    from ark_bulletproofs_tpu_torch.ops import _build

    fn = getattr(lib, f"abtpu_{name}")
    fn.argtypes = _build._SIGNATURES[f"abtpu_{name}"]
    fn.restype = ctypes.c_int

    def run(spec, *args):
        words = _build.curve_words(spec)
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(*args, words.ctypes.data_as(ctypes.c_void_p),
                        ctypes.c_void_p(stream)), name)
    return run


def chain_launchers(path: str):
    """(suffix_jac_scan, rowsum) of the kernel library at `path`, each
    taking (spec, T) as the wrappers do, launched on the current stream."""
    import ctypes

    import torch

    lib = ctypes.CDLL(path)
    scan_fn, rowsum_fn = launcher(lib, "suffix_jac_scan"), launcher(
        lib, "rowsum")

    def total(T):
        return torch.empty(T.shape[0], 16, T.shape[-1], dtype=torch.int32,
                           device=T.device)

    def scan(spec, T):
        excl, tot = torch.empty_like(T), total(T)
        scan_fn(spec, T.data_ptr(), excl.data_ptr(), tot.data_ptr(),
                T.shape[1], T.shape[-1])
        return excl, tot

    def rowsum(spec, T):
        out = total(T)
        rowsum_fn(spec, T.data_ptr(), out.data_ptr(), T.shape[1],
                  T.shape[-1])
        return out

    return scan, rowsum


def jac_compare(res: dict, variants: dict, dev) -> None:
    """jac_double_k_add, committed and each variant, at k = 0 and 1 at
    chip_smoke.DKA_LANES on secq256k1 and zorro (model_points: doubling,
    P + (-P) and identity lanes): bit-equal, then ms from CUDA graphs in
    turns into res["jac"]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import kernels as kk
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    runs = {"committed": kk.jac_double_k_add, **variants}
    check = cs.KernelCheck(dev, cs.Bound(1980))
    res["jac"] = {}
    for curve in (curves.secq256k1, curves.zorro):
        spec = spec_for(curve)
        for L in cs.DKA_LANES:
            T, _ = check.model_points(curve, spec, 2, L, L)
            P, Q = T[:, 0].contiguous(), T[:, 1].contiguous()
            for k in (0, 1):
                want = kk.jac_double_k_add(spec, P, Q, k)
                for name, run in runs.items():
                    if not torch.equal(run(spec, P, Q, k), want):
                        res["failures"].append(f"{curve.name} {L} lanes k = "
                                               f"{k}: {name} differs")
                times = in_turns(runs, lambda run: run(spec, P, Q, k), 20)
                key = f"{curve.name} {L} lanes k={k}"
                res["jac"][key] = times
                print(f"  jac_double_k_add {key} (ms, mean of 2): "
                      + "; ".join(f"{name} {statistics.mean(t):.4f}"
                                  for name, t in times.items()), flush=True)
            del T, P, Q
        torch.cuda.empty_cache()


def dka_launchers(path: str) -> dict:
    """{name: run} of the double-k-add launchers of the kernel library at
    `path` (jac_kernels.cu's, or msm_kernels.cu's two), each taking (spec,
    P, Q, k) as the wrappers do."""
    import ctypes

    import torch

    lib = ctypes.CDLL(path)

    def wrap(name):
        fn = launcher(lib, name)

        def run(spec, P, Q, k):
            out = torch.empty_like(P)
            fn(spec, P.data_ptr(), Q.data_ptr(), out.data_ptr(), P.shape[-1],
               k)
            return out
        return run

    return {name: wrap(name) for name in ("jac_double_k_add",
                                          "rcb_double_k_add",
                                          "te_double_k_add")
            if hasattr(lib, f"abtpu_{name}")}


def rcb_te_compare(res: dict, variants: dict, dev, lanes,
                   key: str = "rcb_te") -> None:
    """rcb_double_k_add and te_double_k_add, committed and each variant's
    launcher, at k = 0 and 1 at `lanes` on secq256k1, zorro and curve25519
    (chip_smoke's model_points in RCB projective or TE extended
    coordinates: doubling, P + (-P) and identity lanes): bit-equal, then
    ms from CUDA graphs in turns into res[key]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import kernels as kk
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    check = cs.KernelCheck(dev, cs.Bound(1980))
    res[key] = {}
    for curve in (curves.secq256k1, curves.zorro, curves.curve25519):
        spec = spec_for(curve)
        name = "te_double_k_add" if cs.model(spec) == "te" else (
            "rcb_double_k_add")
        runs = {"committed": getattr(kk, name),
                **{v: runs[name] for v, runs in variants.items()}}
        for L in lanes:
            T, _ = check.model_points(curve, spec, 2, L, L, rcb=True)
            P, Q = T[:, 0].contiguous(), T[:, 1].contiguous()
            del T
            for k in (0, 1):
                want = runs["committed"](spec, P, Q, k)
                for v, run in runs.items():
                    if not torch.equal(run(spec, P, Q, k), want):
                        res["failures"].append(f"{name} {curve.name} {L} "
                                               f"lanes k = {k}: {v} differs")
                del want
                reps = 20 if L <= 1 << 20 else 3
                times = in_turns(runs, lambda run: run(spec, P, Q, k), reps)
                tag = f"{curve.name} {L} lanes k={k}"
                res[key][tag] = times
                print(f"  {name} {tag} (ms, mean of 2): " + "; ".join(
                    f"{v} {statistics.mean(t):.4f}"
                    for v, t in times.items()), flush=True)
            del P, Q
            torch.cuda.empty_cache()


def fs_launcher(path: str):
    """fs_round of the kernel library at `path`, taking (spec, fr, S, st,
    pos, pb) as the wrapper does; returns (xy, u, st, flags)."""
    import ctypes

    import torch

    from ark_bulletproofs_tpu_torch.ops import fs

    fn = launcher(ctypes.CDLL(path), "fs_round")

    def run(spec, fr, S, st, pos, pb):
        P = st.shape[0]
        out = (torch.empty(2, 16, 2 * P, dtype=torch.int32, device=S.device),
               torch.empty(2, 16, P, dtype=torch.int32, device=S.device),
               torch.empty_like(st),
               torch.empty(3, P, dtype=torch.int32, device=S.device))
        fn(spec, S.data_ptr(), st.data_ptr(), *(t.data_ptr() for t in out),
           P, pos, pb, fs.inv_words(spec.fq, fr).ctypes.data_as(
               ctypes.c_void_p),
           _curve_ptr(fr))
        return out

    return run


def _curve_ptr(spec):
    import ctypes

    from ark_bulletproofs_tpu_torch.ops import _build

    return _build.curve_words(spec).ctypes.data_as(ctypes.c_void_p)


def fs_compare(res: dict, variants: dict, dev) -> None:
    """fs_round, committed and each variant, at P = 1 and 128 on the three
    curves (chip_smoke's model points, L = O and R = O lanes on the
    short-Weierstrass curves): bit-equal, then ms from CUDA graphs in turns
    into res["fs_round"]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import field as df
    from ark_bulletproofs_tpu_torch.ops import fs
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    runs = {"committed": lambda *a: fs.fs_round(*a)[:4], **variants}
    check = cs.KernelCheck(dev, cs.Bound(1980))
    res["fs_round"] = {}
    for curve in (curves.secq256k1, curves.zorro, curves.curve25519):
        spec, fr = spec_for(curve), df.spec_for(curve.fr)
        for P in (1, 128):
            S, _ = check.model_points(curve, spec, 1, 2 * P, P)
            S = S[:, 0].contiguous()
            if cs.model(spec) == "sw":  # L = O, and R = O at P = 128
                S[..., [lane for lane in (0, 3) if lane < 2 * P]] = 0
            g = torch.Generator(device=dev).manual_seed(P)
            st = torch.randint(0, 256, (P, 200), generator=g, device=dev,
                               dtype=torch.int32)
            want = fs.fs_round(spec, fr, S, st, 160, 150)[:4]
            for name, run in runs.items():
                got = run(spec, fr, S, st, 160, 150)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    res["failures"].append(f"fs_round {curve.name} P = {P}: "
                                           f"{name} differs")
            times = in_turns(runs, lambda run: run(spec, fr, S, st, 160,
                                                   150), 20)
            key = f"{curve.name} P={P}"
            res["fs_round"][key] = times
            print(f"  fs_round {key} (ms, mean of 2): " + "; ".join(
                f"{name} {statistics.mean(t):.4f}"
                for name, t in times.items()), flush=True)


def op_cycles(build_dir: str) -> dict:
    """OP_PROBE built beside csrc/ and run on one thread for the base and
    scalar fields of secq256k1 and curve25519: SM cycles of one
    keccak_f1600, one fe_mul and one fe_inv_var (mean over a chain)."""
    import ctypes

    import numpy as np
    import torch

    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import _build
    from ark_bulletproofs_tpu_torch.ops import field as df
    from ark_bulletproofs_tpu_torch.ops import fs

    d = os.path.join(build_dir, "op_probe")
    os.makedirs(d, exist_ok=True)
    src, lib = os.path.join(d, "op_probe.cu"), os.path.join(d, "lib.so")
    with open(src, "w") as fh:
        fh.write(OP_PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC,
                    "-shared", "-o", lib, src], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).op_probe_run
    fn.argtypes = [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    out = {}
    x = np.array([0x9E3779B9 * (i + 3) & 0xFFFFFFFF for i in range(8)],
                 dtype=np.uint32)
    x[7] &= 0x0FFFFFFF  # below every p
    for field in (curves.secq256k1.fq, curves.secq256k1.fr,
                  curves.curve25519.fq, curves.curve25519.fr):
        f = df.spec_for(field)
        t = torch.zeros(4, dtype=torch.int64, device="cuda")
        for _ in range(2):  # the second run is the one kept
            _build.check(fn(ctypes.c_void_p(t.data_ptr()),
                            x.ctypes.data_as(ctypes.c_void_p), _curve_ptr(f),
                            fs.inv_words(f, f).ctypes.data_as(
                                ctypes.c_void_p),
                            ctypes.c_void_p(
                                torch.cuda.current_stream().cuda_stream)),
                         "op_probe")
        cyc = dict(zip(("keccak_f1600", "fe_mul", "fe_inv_var"),
                       t.tolist()[:3]))
        out[field.name] = cyc
        print(f"  one thread's SM cycles, {field.name}: {cyc}", flush=True)
    return out


def chain_compare(res: dict, variants: dict, dev) -> None:
    """Stages D and F's kernels, committed and each variant, at
    CHAIN_SHAPES on the three curves: bit-equal, then ms from CUDA graphs
    in turns into res["chains"]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    runs = {"committed": (k2.suffix_jac_scan, k2.rowsum), **variants}
    check = cs.KernelCheck(dev, cs.Bound(1980))
    res["chains"] = {}
    for curve in (curves.secq256k1, curves.zorro, curves.curve25519):
        spec = spec_for(curve)
        for R, L in CHAIN_SHAPES:
            T = k2.suffix_madd_scan(spec, check.affine_rows(curve, spec, R, L,
                                                            R + L))
            T = check.special_rows(spec, T).contiguous()
            want = (k2.suffix_jac_scan(spec, T), k2.rowsum(spec, T))
            for name, (scan, rowsum) in runs.items():
                ex, tot = scan(spec, T)
                if not (torch.equal(ex, want[0][0])
                        and torch.equal(tot, want[0][1])
                        and torch.equal(rowsum(spec, T), want[1])):
                    res["failures"].append(f"{curve.name} {R} x {L}: "
                                           f"{name} differs")
            reps = 20 if L <= 16384 else 5
            times = {name: [] for name in runs}
            for name in [*runs, *reversed(runs)]:
                scan, rowsum = runs[name]
                times[name].append((cs.graph_ms(lambda: scan(spec, T), reps),
                                    cs.graph_ms(lambda: rowsum(spec, T),
                                                reps)))
            key = f"{curve.name} {R} x {L}"
            res["chains"][key] = {
                name: {"suffix_jac_scan_ms": [t[0] for t in ts],
                       "rowsum_ms": [t[1] for t in ts]}
                for name, ts in times.items()}
            print(f"  chains {key} (ms, suffix_jac_scan / rowsum, mean of "
                  f"2): " + "; ".join(
                      f"{name} {statistics.mean(t[0] for t in ts):.4f} / "
                      f"{statistics.mean(t[1] for t in ts):.4f}"
                      for name, ts in times.items()), flush=True)
            del T, want
            torch.cuda.empty_cache()


def scan_launcher(path: str, name: str = "jac_madd"):
    """jac_madd (or `name`: te_madd) over rows of the kernel library at
    `path`, taking the wrapper's arguments."""
    import ctypes

    import torch

    lib = ctypes.CDLL(path)
    madd_fn = launcher(lib, name)

    def scan(spec, P, qx, qy, qi):
        R, _, m = qx.shape
        out = torch.empty((P.shape[0], R, 16, m), dtype=torch.int32,
                          device=P.device)
        madd_fn(spec, P.data_ptr(), qx.data_ptr(), qy.data_ptr(),
                qi.data_ptr(), out.data_ptr(), R, m)
        return out

    return scan


def parent_launchers(parent: str, build_dir: str) -> dict:
    """A parent commit's forms of kernels that a later tree replaced,
    built from its csrc/msm_kernels.cu and csrc/field_kernels.cu (one nvcc
    each, in parallel). Each form calls the parent's launchers with the
    signatures they had before the replacement, so each is for a parent
    of that age: "te_chain" (parts te_chain: a parent whose
    abtpu_te_double takes no step count), `steps` launches of its
    one-step te_double kernel and one stack of the rows, as
    ops/ipa.py::_q_doubles and ops/cache.py::commit_table made the TE
    tables; "inv" (parts field: a parent whose abtpu_mont_mul takes no
    third operand), mont_inv_batch by Montgomery's trick and the Fermat
    power on its product kernel, then the rows' product, as
    ops/ipa.py::_shrink_fs_dev made them; "te_scan" (parts te_scan: a
    parent whose abtpu_te_madd takes no row count), one one-row te_madd
    launch a row and a copy of each row's sum into the output, as
    kernels.madd_scan made the TE row scan; "rcb_double" (parts
    rcb_double), its rcb_double launcher as it is."""
    import ctypes

    import torch

    from ark_bulletproofs_tpu_torch.ops import _build

    src = os.path.join(parent, "ark_bulletproofs_tpu_torch", "csrc")
    d = os.path.join(build_dir, "parent")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d, ignore=shutil.ignore_patterns("host"))
    libs = {name: os.path.join(d, f"{name}.so")
            for name in ("msm_kernels", "field_kernels")}
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                               "-o", lib, os.path.join(d, f"{name}.cu")],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for name, lib in libs.items()]
    for p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the parent:\n{log}")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    msm_lib = ctypes.CDLL(libs["msm_kernels"])
    dbl_fn = msm_lib.abtpu_te_double
    mm_fn = ctypes.CDLL(libs["field_kernels"]).abtpu_mont_mul
    madd_fn = msm_lib.abtpu_te_madd
    rdbl_fn = msm_lib.abtpu_rcb_double
    dbl_fn.argtypes = [vp, vp, i64, vp, vp]
    mm_fn.argtypes = [vp, vp, vp, i64, i64, i64, i64, vp, vp]
    madd_fn.argtypes = [vp, vp, vp, vp, vp, i64, vp, vp]
    rdbl_fn.argtypes = [vp, vp, i64, vp, vp]
    dbl_fn.restype = mm_fn.restype = ctypes.c_int
    madd_fn.restype = rdbl_fn.restype = ctypes.c_int

    def words(spec):
        return _build.curve_words(spec).ctypes.data_as(vp)

    def stream():
        return vp(torch.cuda.current_stream().cuda_stream)

    def te_chain(spec, P, steps):
        rows = [P]
        for _ in range(steps):
            out = torch.empty_like(P)
            _build.check(dbl_fn(rows[-1].data_ptr(), out.data_ptr(),
                                P.shape[-1], words(spec), stream()),
                         "parent te_double")
            rows.append(out)
        return torch.stack(rows, dim=-2)

    def mont_mul(fs, a, b):
        """Its wrapper's launch: a full, b (rows_b, 16, L_b) broadcast."""
        if a.shape[-1] < b.shape[-1] or a.dim() < b.dim():
            a, b = b, a
        a = a.to(torch.int32).contiguous()
        rows, L = a.numel() // (16 * a.shape[-1]), a.shape[-1]
        if b.dim() < a.dim() or b.shape[:-2] != a.shape[:-2]:
            if any(d != 1 for d in b.shape[:-2]):
                b = b.expand(*a.shape[:-1], b.shape[-1])
        b = b.to(torch.int32).contiguous()
        out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
        _build.check(mm_fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows,
                           L, b.numel() // (16 * b.shape[-1]), b.shape[-1],
                           words(fs), stream()), "parent mont_mul")
        return out

    def inv(fs, z, rows):
        """Its mont_inv_batch, the algorithm of mont_inv_batch_plain."""
        from ark_bulletproofs_tpu_torch.ops import field as df
        from ark_bulletproofs_tpu_torch.ops import fs as dfs

        B = z.shape[-1]
        iz = df.is_zero(z)
        one = df.const(fs.r_limbs, z.device).expand(z.shape)
        x = df.select(iz, one, z)
        idx = torch.arange(B, device=z.device)

        def scan(sign):
            acc, sh = x, 1
            while sh < B:
                keep = idx >= sh if sign > 0 else idx < B - sh
                acc = mont_mul(fs, acc, df.select(
                    keep, torch.roll(acc, sign * sh, -1), one))
                sh <<= 1
            return acc

        pre, suf = scan(1), scan(-1)
        tot_inv = dfs.mont_pow_pm2(fs, pre[:, B - 1:], mont_mul)
        pre_prev = df.select(idx >= 1, torch.roll(pre, 1, -1), one)
        suf_next = df.select(idx < B - 1, torch.roll(suf, -1, -1), one)
        out = mont_mul(fs, mont_mul(fs, pre_prev, suf_next), tot_inv)
        return mont_mul(fs, rows, df.select(iz, torch.zeros_like(out), out))

    def te_scan(spec, P, qx, qy, qi):
        """One one-row te_madd launch a row, from row R - 1 up, each
        row's sum copied into the (4, R, 16, m) output."""
        R, _, m = qx.shape
        out = torch.empty((4, R, 16, m), dtype=torch.int32, device=P.device)
        acc = P
        for r in range(R - 1, -1, -1):
            nxt = torch.empty_like(P)
            _build.check(madd_fn(acc.data_ptr(), qx[r].data_ptr(),
                                 qy[r].data_ptr(), qi[r].data_ptr(),
                                 nxt.data_ptr(), m, words(spec), stream()),
                         "parent te_madd")
            out[:, r] = nxt
            acc = nxt
        return out

    def rcb_double(spec, P):
        out = torch.empty_like(P)
        _build.check(rdbl_fn(P.data_ptr(), out.data_ptr(), P.shape[-1],
                             words(spec), stream()), "parent rcb_double")
        return out

    return {"te_chain": te_chain, "inv": inv, "te_scan": te_scan,
            "rcb_double": rcb_double}


def scan_compare(res: dict, variants: dict, dev) -> None:
    """jac_madd's row scan, committed and each variant (and the parent's R
    launches), at 32 rows of chip_smoke.SCAN_LANES and at SCAN_EXTRA on
    secq256k1 and zorro (chip_smoke's scan_operands: doubling,
    cancelling and identity lanes): bit-equal, then ms from CUDA graphs
    in turns into res["scan"]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import kernels as kk
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    runs = {"committed": kk.jac_madd, **variants}
    check = cs.KernelCheck(dev, cs.Bound(1980))
    res["scan"] = {}
    shapes = [(32, L) for L in cs.SCAN_LANES] + SCAN_EXTRA
    for curve in (curves.secq256k1, curves.zorro):
        spec = spec_for(curve)
        for R, L in shapes:
            ops = check.scan_operands(curve, spec, R, L, R + L)
            want = kk.jac_madd(spec, *ops)
            for name, run in runs.items():
                if not torch.equal(run(spec, *ops), want):
                    res["failures"].append(f"scan {curve.name} {R} x {L}: "
                                           f"{name} differs")
            times = in_turns(runs, lambda run: run(spec, *ops), 5)
            key = f"{curve.name} {R} x {L}"
            res["scan"][key] = times
            print(f"  jac_madd scan {key} (ms, mean of 2): " + "; ".join(
                f"{name} {statistics.mean(t):.4f}"
                for name, t in times.items()), flush=True)
            del ops, want
        torch.cuda.empty_cache()


def chain_steps_compare(res: dict, variants: dict, dev) -> None:
    """jac_double's 255-step chain, committed (and the parent's 255
    launches), at CHAIN_LANES on secq256k1 and zorro (row 0
    of model_points, every seventh lane the identity): bit-equal, then ms
    from CUDA graphs in turns into res["chain"]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import kernels as kk
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    runs = {"committed": kk.jac_double, **variants}
    check = cs.KernelCheck(dev, cs.Bound(1980))
    res["chain"] = {}
    for curve in (curves.secq256k1, curves.zorro):
        spec = spec_for(curve)
        for L in CHAIN_LANES:
            T, _ = check.model_points(curve, spec, 1, L, L)
            P = T[:, 0].contiguous()
            P[..., ::7] = 0
            want = kk.jac_double(spec, P, 255)
            for name, run in runs.items():
                if not torch.equal(run(spec, P, 255), want):
                    res["failures"].append(f"chain {curve.name} {L} lanes: "
                                           f"{name} differs")
            times = in_turns(runs, lambda run: run(spec, P, 255), 2)
            key = f"{curve.name} 255 x {L}"
            res["chain"][key] = times
            print(f"  jac_double chain {key} (ms, mean of 2): " + "; ".join(
                f"{name} {statistics.mean(t):.4f}"
                for name, t in times.items()), flush=True)
            del T, P, want
        torch.cuda.empty_cache()


def mont_mul_launcher(path: str):
    """mont_mul (a * b, no third operand) of the kernel library at `path`,
    on (rows, 16, L) operands of one shape."""
    import ctypes

    import torch

    fn = launcher(ctypes.CDLL(path), "mont_mul")

    def run(fs, a, b):
        out = torch.empty_like(a)
        fn(fs, a.data_ptr(), b.data_ptr(), None, out.data_ptr(), a.shape[0],
           a.shape[-1], b.shape[0], b.shape[-1], 1, 1, 0)
        return out

    return run


def field_compare(res: dict, variants: dict, parent, dev) -> None:
    """mont_mul's block size: the committed 128 threads and the variants
    (256, 64) at MM_LANES lanes of one (1, 16, L) pair on secq256k1's fr,
    bit-equal, ms from CUDA graphs in turns into res["mont_mul"]; and the
    batch inverse, the committed one launch (with the shrink's two rows)
    against the parent's mont_inv_batch (Montgomery's trick and the Fermat
    power on its product kernel, then the rows' product) at
    INV_BENCH_LANES on secq256k1's fq, into res["inv"]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import field as df
    from ark_bulletproofs_tpu_torch.ops import fs as dfs

    check = cs.KernelCheck(dev, cs.Bound(1980))
    fr = df.spec_for(curves.secq256k1.fr)
    runs = {"committed": lambda fs, a, b: df.mont_mul(fs, a, b), **variants}
    res["mont_mul"] = {}
    for L in MM_LANES:
        a, b = check.field_operands(fr, 2, L, L).unsqueeze(1).unbind(0)
        want = df.mont_mul(fr, a, b)
        for name, run in runs.items():
            if not torch.equal(run(fr, a, b), want):
                res["failures"].append(f"mont_mul {L}: {name} differs")
        times = in_turns(runs, lambda run: run(fr, a, b), 100)
        res["mont_mul"][L] = times
        print(f"  mont_mul {L} lanes (ms, mean of 2): " + "; ".join(
            f"{name} {statistics.mean(t):.5f}" for name, t in times.items()),
            flush=True)
    fq = df.spec_for(curves.secq256k1.fq)
    runs = {"committed": lambda z, r: dfs.mont_inv_batch(fq, z, r)}
    if parent:
        runs["parent"] = lambda z, r: parent["inv"](fq, z, r)
    res["inv"] = {}
    for B in INV_BENCH_LANES:
        z, x, y = check.field_operands(fq, 3, B, B).unbind(0)
        z[:, ::5] = 0
        rows = torch.stack([x, y])
        want = dfs.mont_inv_batch(fq, z, rows)
        for name, run in runs.items():
            if not torch.equal(run(z, rows).long(), want.long()):
                res["failures"].append(f"inverse {B}: {name} differs")
        times = in_turns(runs, lambda run: run(z, rows), 3)
        res["inv"][B] = times
        print(f"  mont_inv_batch {B} lanes, 2 rows (ms, mean of 2): "
              + "; ".join(f"{name} {statistics.mean(t):.4f}"
                          for name, t in times.items()), flush=True)


def te_chain_compare(res: dict, parent, dev) -> None:
    """te_double's 255-step chain, committed (a group of 8 threads a lane,
    one launch) against the parent's 255 one-step launches and their
    stack, at 1 lane (the TE Q table) and 2 (the commit table) on
    curve25519, bit-equal, ms from CUDA graphs in turns into
    res["te_chain"]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import kernels as kk
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    curve = curves.curve25519
    spec = spec_for(curve)
    check = cs.KernelCheck(dev, cs.Bound(1980))
    runs = {"committed": kk.te_double}
    if parent:
        runs["parent"] = parent["te_chain"]
    res["te_chain"] = {}
    T, _ = check.model_points(curve, spec, 1, 64, 64)
    for L in (1, 2):
        P = T[:, 0, :, 32:32 + L].contiguous()
        want = kk.te_double(spec, P, 255)
        for name, run in runs.items():
            if not torch.equal(run(spec, P, 255), want):
                res["failures"].append(f"te chain {L}: {name} differs")
        times = in_turns(runs, lambda run: run(spec, P, 255), 2)
        res["te_chain"][L] = times
        print(f"  te_double chain 255 x {L} (ms, mean of 2): " + "; ".join(
            f"{name} {statistics.mean(t):.4f}" for name, t in times.items()),
            flush=True)


def te_scan_compare(res: dict, variants: dict, parent, dev) -> None:
    """te_madd's row scan on curve25519, committed and each variant (and
    the parent's one launch and one copy a row), at 32 rows of
    chip_smoke.SCAN_LANES and at SCAN_EXTRA (chip_smoke's scan_operands:
    doubling, cancelling, identity and (0, 1) lanes): bit-equal, then ms
    from CUDA graphs in turns into res["te_scan"]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import kernels as kk
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    runs = {"committed": kk.te_madd, **variants}
    if parent:
        runs["parent"] = parent["te_scan"]
    check = cs.KernelCheck(dev, cs.Bound(1980))
    res["te_scan"] = {}
    curve = curves.curve25519
    spec = spec_for(curve)
    for R, L in [(32, L) for L in cs.SCAN_LANES] + SCAN_EXTRA:
        ops = check.scan_operands(curve, spec, R, L, R + L)
        want = kk.te_madd(spec, *ops)
        for name, run in runs.items():
            if not torch.equal(run(spec, *ops), want):
                res["failures"].append(f"te scan {R} x {L}: {name} differs")
        times = in_turns(runs, lambda run: run(spec, *ops), 5)
        key = f"{R} x {L}"
        res["te_scan"][key] = times
        print(f"  te_madd scan {key} (ms, mean of 2): " + "; ".join(
            f"{name} {statistics.mean(t):.4f}" for name, t in times.items()),
            flush=True)
        del ops, want
    torch.cuda.empty_cache()


def rcb_double_launcher(path: str):
    """rcb_double of the kernel library at `path`, taking (spec, P)."""
    import ctypes

    import torch

    fn = launcher(ctypes.CDLL(path), "rcb_double")

    def run(spec, P):
        out = torch.empty_like(P)
        fn(spec, P.data_ptr(), out.data_ptr(), P.shape[-1])
        return out

    return run


def rcb_double_compare(res: dict, variants: dict, parent, dev) -> None:
    """rcb_double, committed and each variant (and the parent's), at
    DBL_LANES on secq256k1 and zorro (row 0 of chip_smoke's model_points
    in RCB coordinates, identity lanes among them): bit-equal, then ms
    from CUDA graphs in turns into res["rcb_double"]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import kernels as kk
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    runs = {"committed": kk.rcb_double, **variants}
    if parent:
        runs["parent"] = parent["rcb_double"]
    check = cs.KernelCheck(dev, cs.Bound(1980))
    res["rcb_double"] = {}
    for curve in (curves.secq256k1, curves.zorro):
        spec = spec_for(curve)
        for L in DBL_LANES:
            T, _ = check.model_points(curve, spec, 1, L, L, rcb=True)
            P = T[:, 0].contiguous()
            del T
            want = kk.rcb_double(spec, P)
            for name, run in runs.items():
                if not torch.equal(run(spec, P), want):
                    res["failures"].append(f"rcb_double {curve.name} {L}: "
                                           f"{name} differs")
            times = in_turns(runs, lambda run: run(spec, P), 20)
            key = f"{curve.name} {L}"
            res["rcb_double"][key] = times
            print(f"  rcb_double {key} lanes (ms, mean of 2): " + "; ".join(
                f"{name} {statistics.mean(t):.4f}"
                for name, t in times.items()), flush=True)
            del P, want
        torch.cuda.empty_cache()


def stage_gather_launcher(path: str):
    """The stage-B gather of the kernel library at `path`, taking the
    wrapper's arguments: its table kernel (abtpu_stage_table) builds the
    table its gather kernel reads, then abtpu_stage_gather launches; also
    `run.table(X, Y, inf, words)` and `run.kernel(tbl, m, order, R, C, W,
    bm)` alone."""
    import ctypes

    import torch

    from ark_bulletproofs_tpu_torch.ops import _build

    lib = ctypes.CDLL(path)
    fns = {}
    for name in ("stage_table", "stage_gather"):
        fns[name] = getattr(lib, f"abtpu_{name}")
        fns[name].argtypes = _build._SIGNATURES[f"abtpu_{name}"]
        fns[name].restype = ctypes.c_int

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def table(X, Y, inf, words=16):
        tbl = torch.empty(X.shape[1], words, dtype=torch.int32,
                          device=X.device)
        _build.check(fns["stage_table"](
            X.data_ptr(), Y.data_ptr(), inf.data_ptr(), X.stride(0),
            Y.stride(0), X.shape[1], tbl.data_ptr(), stream()),
            "stage_table")
        return tbl

    def kernel(tbl, m, order, R, C, W, bm):
        BW, n = order.shape
        out = torch.empty(2, R, 16, BW * C, dtype=torch.int32,
                          device=order.device)
        _build.check(fns["stage_gather"](
            tbl.data_ptr(), order.data_ptr(),
            0 if bm is None else bm.data_ptr(), out.data_ptr(), m, n, R, C,
            W, BW, int(order.dtype == torch.int64), stream()),
            "stage_gather")
        return out

    def run(X, Y, inf, order, R, C, W, bm=None, words=16):
        return kernel(table(X, Y, inf, words), X.shape[1], order, R, C, W,
                      bm)

    run.table, run.kernel = table, kernel
    return run


def parent_stage_gather(parent: str):
    """The parent's torch stage B: `_stage_gather` of its
    ark_bulletproofs_tpu_torch/ops/msm2.py, compiled alone (it needs only
    torch), called with this tree's plan; or None where the parent's
    stage B is no longer torch (it calls the gather module)."""
    import ast

    import torch

    path = os.path.join(parent, "ark_bulletproofs_tpu_torch", "ops",
                        "msm2.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    fn = next(f for f in tree.body if isinstance(f, ast.FunctionDef)
              and f.name == "_stage_gather")
    if "gather." in ast.unparse(fn):
        return None
    ns = {"torch": torch, "_Cfg": object}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    return ns["_stage_gather"]


def stage_gather_compare(res: dict, variants: dict, parent, dev) -> None:
    """stage_gather at GATHER_SHAPES under msm2's plan (random 16-bit limbs,
    a tenth of them identity rows; a random permutation a row, at n = 2^20
    the order of a real _stage_sort; a base map into 2 n + 3 rows): the
    committed wrapper, each variant, the committed gather kernel on a
    torch-built table and the parent's torch stage B (each bit-equal to
    the plain version first), from CUDA graphs in turns, the table's build
    included; then each build's gather kernel alone on its table, and the
    table kernel against its torch form, in turns; at n = 2^20 also the
    committed gather kernel over tables of GATHER_SWEEP rows (the order
    mod m'), into res["stage_gather"]."""
    import torch

    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch.ops import _build, gather, msm2

    own = stage_gather_launcher(_build.library_path())
    gen = torch.Generator(device=dev).manual_seed(51)
    res["stage_gather"] = {}
    for n, B, mapped in GATHER_SHAPES:
        g = msm2._Cfg(n, msm2.window_bits(n), B, dev)
        m = 2 * n + 3 if mapped else n
        X, Y = (torch.randint(0, 1 << 16, (16, m), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(2))
        inf = torch.rand(m, generator=gen, device=dev) < 0.1
        if mapped:
            order = torch.argsort(torch.rand(g.BW, n, generator=gen,
                                             device=dev), dim=1)
        else:
            scal = torch.randint(0, 1 << 16, (B, 16, n), generator=gen,
                                 device=dev, dtype=torch.int32)
            order, _ = msm2._stage_sort(g, scal)
        bm = (torch.randint(0, m, (B, n), generator=gen, device=dev)
              if mapped else None)
        bm32 = None if bm is None else bm.to(torch.int32)
        args = (X, Y, inf, order, g.R, g.C, g.W)
        words = {name: 32 if name == "128-byte rows" else 16
                 for name in variants}
        runs = {"committed": lambda: gather.stage_gather(*args, bm),
                "torch table": lambda: own.kernel(
                    gather.stage_table_plain(X, Y, inf), m, order, g.R,
                    g.C, g.W,
                    bm32)}
        for name, run in variants.items():
            runs[name] = (lambda run=run, w=words[name]: run(
                *args, bm32, words=w))
        if parent:
            runs["parent torch"] = lambda: parent(g, X, Y, inf, order, bm)
        want = gather.stage_gather_plain(*args, bm)
        for name, run in list(runs.items()):
            try:
                same = torch.equal(run(), want)
            except RuntimeError as e:  # a variant the card refused
                same = f"{e}"
            if same is not True:
                res["failures"].append(f"stage_gather {n} {B}: {name} "
                                       f"differs or fails: {same}")
                del runs[name]
                variants = {k: v for k, v in variants.items() if k != name}
        del want
        torch.cuda.empty_cache()
        key = f"n={n} B={B}{' mapped' if mapped else ''}"
        times = in_turns(runs, lambda run: run(), 2)
        alone = {"committed": own, **variants}
        tables = {name: run.table(X, Y, inf, words.get(name, 16))
                  for name, run in alone.items()}
        kernels = {name: (lambda run=run, name=name: run.kernel(
            tables[name], m, order, g.R, g.C, g.W, bm32))
            for name, run in alone.items()}
        kernel_times = in_turns(kernels, lambda run: run(), 3)
        kernel_times["committed (events)"] = [
            cs.cuda_ms(kernels["committed"], 5)]
        table_times = in_turns(
            {"table kernel": lambda: own.table(X, Y, inf),
             "torch stage_table_plain": lambda: gather.stage_table_plain(
                 X, Y, inf)},
            lambda run: run(), 5)
        out_bytes = 2 * g.R * 16 * g.L * 4
        distinct = int(torch.unique(
            order if bm is None else bm).numel())
        bound = (out_bytes + distinct * 128 + order.numel() * 8
                 + (0 if bm is None else bm32.numel() * 4)
                 ) / cs.HBM_BYTES_PER_S
        entry = {"plan": {"R": g.R, "C": g.C, "W": g.W, "L": g.L},
                 "bound_ms": bound * 1e3, "with_table": times,
                 "kernel_alone": kernel_times, "table": table_times}
        print(f"  stage_gather {key} (R = {g.R}, L = {g.L}; bound "
              f"{bound * 1e3:.4f} ms), ms, mean of 2, table built in the "
              f"call: " + "; ".join(
                  f"{name} {statistics.mean(t):.4f}"
                  for name, t in times.items()), flush=True)
        for what, ts in (("the gather kernel alone on its table",
                          kernel_times), ("the table", table_times)):
            print(f"    {what}: " + "; ".join(
                f"{name} {statistics.mean(t):.4f}"
                for name, t in ts.items()), flush=True)
        del tables, kernels
        if not mapped:
            sweep = {}
            for rows in GATHER_SWEEP:
                o = order % rows
                tbl = own.table(X[:, :rows], Y[:, :rows], inf[:rows])
                sweep[rows] = cs.graph_ms(lambda: own.kernel(
                    tbl, rows, o, g.R, g.C, g.W, None), 3)
                del o, tbl
            entry["table_rows_sweep"] = sweep
            print("    the committed gather kernel over m' table rows (the "
                  "order mod m'): " + "; ".join(
                      f"{rows} rows ({rows * 64 / 2**20:.2f} MiB) "
                      f"{ms:.4f}" for rows, ms in sweep.items()),
                  flush=True)
        res["stage_gather"][key] = entry
        del X, Y, inf, order, bm, bm32
        torch.cuda.empty_cache()


# gens_kernels.cu's window of exponent bits, as ops/gens.py's POW_WIN
# states it (a test ties the two)
GENS_WINDOW = "#define POW_WIN 4"
GENS_VARIANTS = {
    f"gens window {w}": ("gens_kernels.cu",
                         [(GENS_WINDOW, f"#define POW_WIN {w}")])
    for w in (1, 2, 3, 5) if f"#define POW_WIN {w}" != GENS_WINDOW}
GENS_ATTEMPTS = 1 << 21


def gens_launcher(path: str):
    """gen_candidates of the kernel library at `path`, taking (spec, sq,
    words) as the wrapper does."""
    import ctypes

    import torch

    from ark_bulletproofs_tpu_torch.ops import gens

    fn = launcher(ctypes.CDLL(path), "gen_candidates")

    def run(spec, sq, words):
        m = words.shape[0]
        xy = torch.empty(m, 16, dtype=torch.int32, device=words.device)
        ok = torch.empty(m, dtype=torch.bool, device=words.device)
        fn(spec, words.data_ptr(), xy.data_ptr(), ok.data_ptr(), m,
           gens.gen_words(spec, sq).ctypes.data_as(ctypes.c_void_p))
        return xy, ok

    return run


def gens_compare(res: dict, variants: dict, dev) -> None:
    """gen_candidates, committed and each window variant, at GENS_ATTEMPTS
    random attempts (x below p) on secq256k1 and zorro: bit-equal, then ms
    from CUDA graphs in turns into res["gens"]."""
    import numpy as np
    import torch

    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.ops import gens
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    runs = {"committed": lambda spec, sq, w: gens.gen_candidates(spec, sq, w),
            **variants}
    res["gens"] = {}
    for curve in (curves.secq256k1, curves.zorro):
        spec, sq = spec_for(curve), gens.sqrt_spec_for(curve.fq)
        w = np.random.default_rng(5).integers(
            0, 1 << 32, size=(GENS_ATTEMPTS, 9),
            dtype=np.uint64).astype(np.uint32)
        w[:, 7] %= np.uint32(curve.fq.p >> 224)
        w = torch.from_numpy(w.view(np.int32)).to(dev)
        want = gens.gen_candidates(spec, sq, w)
        for name, run in runs.items():
            got = run(spec, sq, w)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                res["failures"].append(f"gens {curve.name}: {name} differs")
        times = in_turns(runs, lambda run: run(spec, sq, w), 3)
        res["gens"][curve.name] = times
        print(f"  gen_candidates {curve.name} {GENS_ATTEMPTS} attempts (ms, "
              f"mean of 2): " + "; ".join(
                  f"{name} {statistics.mean(t):.4f}"
                  for name, t in times.items()), flush=True)
        del w, want
        torch.cuda.empty_cache()


PARTS = ("ops", "fs", "jac", "rcb_te", "wide", "chains", "scan", "chain",
         "field", "te_chain", "te_scan", "rcb_double", "stage_gather", "gens",
         "msm")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--parent")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if parts - set(PARTS):
        ap.error(f"--parts: not among {PARTS}: {sorted(parts - set(PARTS))}")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("bench_kernels: needs one CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ark_bulletproofs_tpu_torch import curves
    from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch.ops import _build, msm2
    from ark_bulletproofs_tpu_torch.ops.curve import (affine_to_device,
                                                      point_batch_to_host,
                                                      spec_for)
    from ark_bulletproofs_tpu_torch.parallel.msm import msm_device_ragged

    dev = torch.device("cuda")
    res = {"card": cs.smi_line(), "failures": []}
    print(f"bench_kernels: {res['card']}, torch {torch.__version__}",
          flush=True)

    t0 = time.perf_counter()
    wanted = {}
    for part, variants in (("chains", CHAIN_VARIANTS), ("jac", JAC_VARIANTS),
                           ("rcb_te", RCB_TE_VARIANTS),
                           ("wide", WIDE_VARIANTS), ("fs", FS_VARIANTS),
                           ("scan", SCAN_VARIANTS),
                           ("te_scan", TE_SCAN_VARIANTS),
                           ("rcb_double", DBL_VARIANTS),
                           ("field", FIELD_VARIANTS),
                           ("stage_gather", GATHER_VARIANTS),
                           ("gens", GENS_VARIANTS)):
        if part in parts:
            wanted.update(variants)
    bench_dir = os.path.join(_build.BUILD_DIR, "bench")
    procs = build_variants(bench_dir, wanted)
    parent = (parent_launchers(args.parent, bench_dir) if args.parent
              and parts & {"field", "te_chain", "te_scan", "rcb_double"}
              else None)
    _build.lib()
    res["build_s"] = time.perf_counter() - t0
    ptx = [line for line in cs.ptxas_report(_build.build_log or "")
           if re.match(r"(suffix_|rowsum|horner|mont_mul|double_k_add|fs_|"
                       r"madd_scan|double_chain|double_wide|stage_|row_|"
                       r"gen_)",
                       line)]
    chains, dkas, fss, scans, fields = {}, {}, {}, {}, {}
    te_scans, dbls, gathers, gensv = {}, {}, {}, {}
    for name, (p, lib) in procs.items():
        log = p.communicate()[0]
        if p.returncode and name in GATHER_VARIANTS:
            res["failures"].append(f"nvcc failed on variant {name}")
            print(f"  nvcc failed on variant {name}:\n{log}", flush=True)
            continue
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        ptx += [f"{name}: {line}" for line in cs.ptxas_report(log)
                if re.match(r"(suffix_jac|rowsum|double_k_add|fs_|madd_scan|"
                            r"double_chain|double_wide|mont_mul|stage_|"
                            r"gen_)",
                            line)]
        if name in CHAIN_VARIANTS:
            chains[name] = chain_launchers(lib)
        elif name in FS_VARIANTS:
            fss[name] = fs_launcher(lib)
        elif name in SCAN_VARIANTS:
            scans[name] = scan_launcher(lib)
        elif name in TE_SCAN_VARIANTS:
            te_scans[name] = scan_launcher(lib, "te_madd")
        elif name in DBL_VARIANTS:
            dbls[name] = rcb_double_launcher(lib)
        elif name in FIELD_VARIANTS:
            fields[name] = mont_mul_launcher(lib)
        elif name in GATHER_VARIANTS:
            gathers[name] = stage_gather_launcher(lib)
        elif name in GENS_VARIANTS:
            gensv[name] = gens_launcher(lib)
        else:
            dkas[name] = dka_launchers(lib)
    res["ptxas"] = ptx
    for line in ptx:
        print(f"  ptxas {line}", flush=True)
    if "ops" in parts:
        res["op_cycles"] = op_cycles(bench_dir)
    if "fs" in parts:
        fs_compare(res, fss, dev)
    if "jac" in parts:
        jac_compare(res, {name: dkas[name]["jac_double_k_add"]
                          for name in JAC_VARIANTS}, dev)
    if "rcb_te" in parts:
        rcb_te_compare(res, {name: dkas[name] for name in RCB_TE_VARIANTS},
                       dev, cs.RT_LANES)
    if "wide" in parts:
        rcb_te_compare(res, {name: dkas[name] for name in WIDE_VARIANTS},
                       dev, [L for L in cs.RT_LANES if L >= 1 << 14], "wide")
    if "chains" in parts:
        chain_compare(res, chains, dev)
    if "scan" in parts:
        scan_compare(res, scans, dev)
    if "chain" in parts:
        chain_steps_compare(res, {}, dev)
    if "field" in parts:
        field_compare(res, fields, parent, dev)
    if "te_chain" in parts:
        te_chain_compare(res, parent, dev)
    if "te_scan" in parts:
        te_scan_compare(res, te_scans, parent, dev)
    if "rcb_double" in parts:
        rcb_double_compare(res, dbls, parent, dev)
    if "stage_gather" in parts:
        stage_gather_compare(res, gathers, args.parent
                             and parent_stage_gather(args.parent), dev)
    if "gens" in parts:
        gens_compare(res, gensv, dev)
    if "ops" in parts:
        res["sass_mont_mul"] = sass_mix(_build.library_path(),
                                        "mont_mul_kernel")
        print(f"  SASS mont_mul_kernel: {res['sass_mont_mul']}", flush=True)

    # the v2 MSM at n = 2^20: median of 5, and its stage split
    res["msm"] = {}
    for curve in ((curves.secq256k1, curves.curve25519) if "msm" in parts
                  else ()):
        spec = spec_for(curve)
        pts = GeneratorsChain(curve, b"chip_smoke msm").take(1 << 13)
        X, Y, inf = affine_to_device(curve, pts, dev)
        reps = N_MSM // (1 << 13)
        X, Y, inf = X.repeat(1, reps), Y.repeat(1, reps), inf.repeat(reps)
        g = torch.Generator(device=dev).manual_seed(2024)
        scal = torch.randint(0, 1 << 16, (1, 16, N_MSM), generator=g,
                             device=dev, dtype=torch.int32)
        scal[:, 15] %= curve.fr.p >> 240  # canonical: below r
        own, ref = msm2.plan_columns, None
        for C in (None, *MSM_PLANS):  # the port's own plan, then forced ones
            if C is not None:
                msm2.plan_columns = lambda *args, C=C: C
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = msm_device_ragged(spec, X, Y, inf, scal)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            aff = point_batch_to_host(curve, got)[0]
            ref = aff if ref is None else ref
            split, out, plan = cs.msm_stage_split(spec, X, Y, inf, scal)
            if C is not None:
                msm2.plan_columns = own
            if point_batch_to_host(curve, out)[0] != aff or aff != ref:
                res["failures"].append(f"msm {curve.name} C={C} differs")
            key = curve.name if C is None else f"{curve.name} C={C}"
            res["msm"][key] = {
                "median_ms": statistics.median(times), "ms": times,
                "affine_hash": hash(aff) & 0xFFFFFFFF,
                "plan": {k: getattr(plan, k) for k in ("C", "R", "c1", "c2",
                                                       "L")},
                "split_ms": split}
            print(f"  msm n=2^20 {key}: median "
                  f"{statistics.median(times):.3f} ms of "
                  f"{[round(t, 3) for t in times]}; plan C={plan.C} "
                  f"R={plan.R} c1={plan.c1} c2={plan.c2}; stages (ms) "
                  f"{ {k: round(v, 4) for k, v in split.items()} }; affine "
                  f"hash {res['msm'][key]['affine_hash']}", flush=True)
            del got, out
        del X, Y, inf, scal
        torch.cuda.empty_cache()

    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    if res["failures"]:
        print(f"bench_kernels: failures {res['failures']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
