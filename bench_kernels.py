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
spills of the scan, the Horner and mont_mul, and the SASS instruction mix
of mont_mul_kernel (one field product, from cuobjdump).

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
    _build.lib()
    res["build_s"] = time.perf_counter() - t0
    ptx = [line for line in cs.ptxas_report(_build.build_log or "")
           if re.match(r"(suffix_madd_scan|horner|mont_mul)", line)]
    res["ptxas"] = ptx
    for line in ptx:
        print(f"  ptxas {line}", flush=True)
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
