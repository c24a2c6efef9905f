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
    "group 8": [GROUP],
    "group 4": [GROUP, ("static constexpr int ADD_GRP = 8;",
                        "static constexpr int ADD_GRP = 4;")],
    "one thread": [(CROSS, "#define CHAIN_ONE_THREAD_MIN_LANES 1")],
}
# (rows, lanes): the paths' (chip_smoke.CHAIN_SHAPES) and the crossover's
CHAIN_SHAPES = [(64, 1408), (64, 22), (16, 1024), (16, 64), (1, 64),
                (16, 8192), (16, 65536), (16, 1048576), (16, 4096),
                (16, 16384), (16, 32768), (16, 131072)]


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


def build_chain_variants(build_dir: str) -> dict:
    """Start one nvcc a CHAIN_VARIANTS entry: msm_kernels.cu with its
    substitutions, beside copies of the headers, into a shared library.
    Returns {name: (process, library path)}."""
    from ark_bulletproofs_tpu_torch.ops import _build

    with open(os.path.join(CSRC, "msm_kernels.cu")) as fh:
        text = fh.read()
    procs = {}
    for i, (name, subs) in enumerate(CHAIN_VARIANTS.items()):
        d = os.path.join(build_dir, f"chain_variant_{i}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in os.listdir(CSRC):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(CSRC, f), d)
        src = text
        for a, b in subs:
            if a not in src:
                raise RuntimeError(f"{name}: {a!r} not in msm_kernels.cu")
            src = src.replace(a, b)
        with open(os.path.join(d, "msm_kernels.cu"), "w") as fh:
            fh.write(src)
        lib = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
             os.path.join(d, "msm_kernels.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return procs


def chain_launchers(path: str):
    """(suffix_jac_scan, rowsum) of the kernel library at `path`, each
    taking (spec, T) as the wrappers do, launched on the current stream."""
    import ctypes

    import torch

    from ark_bulletproofs_tpu_torch.ops import _build

    lib = ctypes.CDLL(path)

    def launcher(name: str):
        fn = getattr(lib, f"abtpu_{name}")
        fn.argtypes = _build._SIGNATURES[f"abtpu_{name}"]
        fn.restype = ctypes.c_int

        def run(spec, *args):
            words = _build.curve_words(spec)
            stream = torch.cuda.current_stream().cuda_stream
            _build.check(fn(*args, words.ctypes.data_as(ctypes.c_void_p),
                            ctypes.c_void_p(stream)), name)
        return run

    scan_fn, rowsum_fn = launcher("suffix_jac_scan"), launcher("rowsum")

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
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
    procs = build_chain_variants(os.path.join(_build.BUILD_DIR, "bench"))
    _build.lib()
    res["build_s"] = time.perf_counter() - t0
    ptx = [line for line in cs.ptxas_report(_build.build_log or "")
           if re.match(r"(suffix_|rowsum|horner|mont_mul)", line)]
    variants = {}
    for name, (p, lib) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        ptx += [f"{name}: {line}" for line in cs.ptxas_report(log)
                if re.match(r"(suffix_jac|rowsum)", line)]
        variants[name] = chain_launchers(lib)
    res["ptxas"] = ptx
    for line in ptx:
        print(f"  ptxas {line}", flush=True)
    chain_compare(res, variants, dev)
    res["sass_mont_mul"] = sass_mix(_build.library_path(), "mont_mul_kernel")
    print(f"  SASS mont_mul_kernel: {res['sass_mont_mul']}", flush=True)

    # the v2 MSM at n = 2^20: median of 5, and its stage split
    res["msm"] = {}
    for curve in (curves.secq256k1, curves.curve25519):
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
