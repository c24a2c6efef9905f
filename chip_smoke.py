#!/usr/bin/env python3
"""Smoke run of ark_bulletproofs_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. build: the card's name, power limit and maximum SM clock, then nvcc
     builds the kernels (csrc/*.cu, one process per source, in parallel)
     for sm_90a into ark_bulletproofs_tpu_torch/_build/ and prints
     ptxas's registers and spills per MSM kernel, and g++ the native host
     library (csrc/host/), which must load;
  2. kernels: each kernel against its plain PyTorch version on the card,
     bit-equal limbs: the MSM kernels on secq256k1 and zorro (RCB) and on
     curve25519 (twisted-Edwards: the TE instantiations of the three
     scans, te_double_k_add and te_double) with identity, doubling and
     P + (-P) lanes, mont_mul on two fr fields at 1,000, 6 x 2048 and
     9 x 2048 lanes, with a (16, 1) operand and with 0, 1 and p - 1 lanes,
     and at the prover's (6, 4, 9) x 16 x 2048 row shapes; then each
     timed at its main-path shape (n = 2^20 MSM on secq256k1 and on
     curve25519; mont_mul at the k = 1024 fold's 6 x 2048 lanes;
     te_double at the commit table's 2 lanes), the kernel alone by
     replaying a CUDA graph of its launches, beside its plain version and
     its bound;
  3. msm: n = 2^20 secq256k1 through the port's `msm`, equal to the native
     host Pippenger, then timed (median of 5) with its peak memory;
  4. shuffle: a k = 1024 secq256k1 shuffle proved on the card through the
     device branches (tabled phase MSMs, vector phase, IPA), with its
     protocol phases on the host clock, proved again on the port's host
     route, the two proofs byte-equal; the card's proof verified on the
     card three times (first, then twice after a gc.collect()), with the
     full garbage collections inside each run; a flipped byte and swapped
     commitments rejected;
  5. batch_verify: the 1024 cached k = 8 proofs accepted, a batch with one
     tampered proof rejected;
  6. msm curve25519: as phase 3, the oracle the pure-Python host
     Pippenger (the native library has no twisted-Edwards branch);
  7. shuffle curve25519: as phase 4 (the witness commitments through the
     device Pedersen batch on the card; on the host route through the
     host's double-and-add);
  8. launches: each path of phases 3-7 (the msm, the card prove, the card
     verify, batch_verify, and curve25519's msm, prove and verify) runs
     with every launch count set to 0 just before it and read just after;
     each of its kernels launched;
  9. traces: the card prove (secq256k1 and curve25519) and the verify
     once more each under torch.profiler, which splits card time from
     host time and names the largest kernels (last, so that no timing
     above runs after a profiler session).

It imports only the port, never jax or the JAX package. Any failure exits
nonzero. The last three lines are the kernels JSON, the card's
`nvidia-smi` name and power limit, and {"ok": true, "device": ...}. Needs
one card; exits 1 at once without one or without the port beside it.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import pickle
import random
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MSM = 1 << 20
N_DISTINCT = 1 << 13
SHUFFLE_K = 1024
BATCH_CACHE = os.path.join(ROOT, "benches",
                           ".cache_batch_secq256k1_k8_n1024.pkl")
L_MAIN = 22 * 1024  # scan lanes at n = 2^20: W * C = 22 * 1024
MM_LANES = 6 * 2048  # the k = 1024 IPA fold's product launch
MSM_CU = "ark_bulletproofs_tpu_torch/csrc/msm_kernels.cu"
# The kernels JSON line, one entry per kernel and point model: (entry
# name, wrapper, model of the paths it counts, source, TPU kernels it
# replaces). "[te]" entries are the twisted-Edwards instantiations of the
# scan launchers; mont_mul counts on every path.
ENTRIES = [
    ("suffix_madd_scan", "suffix_madd_scan", "sw", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:133"),
    ("suffix_jac_scan", "suffix_jac_scan", "sw", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:223"),
    ("rowsum", "rowsum", "sw", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:292"),
    ("rcb_double_k_add", "rcb_double_k_add", "sw", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:853, "
     "ark_bulletproofs_tpu/ops/kernels.py:704"),
    ("mont_mul", "mont_mul", None,
     "ark_bulletproofs_tpu_torch/csrc/field_kernels.cu",
     "ark_bulletproofs_tpu/ops/kernels.py:303"),
    ("suffix_madd_scan[te]", "suffix_madd_scan", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:133, "
     "ark_bulletproofs_tpu/ops/kernels.py:822"),
    ("suffix_jac_scan[te]", "suffix_jac_scan", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:223"),
    ("rowsum[te]", "rowsum", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels2.py:292"),
    ("te_double_k_add", "te_double_k_add", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:806, "
     "ark_bulletproofs_tpu/ops/kernels.py:780"),
    ("te_double", "te_double", "te", MSM_CU,
     "ark_bulletproofs_tpu/ops/kernels.py:794"),
]
SCANS = ("suffix_madd_scan", "suffix_jac_scan", "rowsum")
# The bound: the larger of bytes over the card's memory rate and 32-bit
# multiply instructions over 132 SMs x 64 per clock at the maximum SM
# clock. A field product (csrc/field.cuh::fe_mul) is 8 CIOS steps of
# 8 wide products (16 mul.lo/mul.hi), one mul.lo for m and 8 wide
# products for m * p: 264 instructions. On secq256k1 (a = 0, 3b = 21 by
# double-and-add) csrc/rcb.cuh spends 12 products on an add, 11 on a
# mixed add and 8 on a doubling; on curve25519 csrc/te.cuh spends 11 on
# each (a and d as full products).
HBM_BYTES_PER_S = 3.35e12
MULS_PER_FE_MUL = 264
FE_MULS = {"sw": {"add": 12, "madd": 11, "double": 8},
           "te": {"add": 11, "madd": 11, "double": 11}}
MSM_KERNELS = {"sw": SCANS + ("rcb_double_k_add",),
               "te": SCANS + ("te_double_k_add",)}


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def smi_query(fields: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def smi_line() -> str:
    return smi_query("name,power.limit")


class Bound:
    """Least time the card could take: the larger of the bytes over the
    memory rate and the multiply instructions over the multiply rate."""

    def __init__(self, sm_clock_mhz: float):
        self.muls_per_s = 132 * 64 * sm_clock_mhz * 1e6

    def __call__(self, nbytes: int, muls: int) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = muls / self.muls_per_s
        if t_bytes >= t_ops:
            return t_bytes * 1e3, "bytes"
        return t_ops * 1e3, "operations"


class Launches:
    """Launch counts per path: every wrapper's count is set to 0 just
    before the path runs and read just after it."""

    def __init__(self, wrappers: dict):
        self.wrappers = wrappers
        self.paths = {}

    def run(self, path: str, fn, kernels, spec):
        """Run path `path` on `spec`'s curve; `kernels` must launch."""
        for w in self.wrappers.values():
            w.launches = 0
        out = fn()
        self.paths[path] = ({n: w.launches for n, w in
                             self.wrappers.items()}, kernels, model(spec))
        return out

    def check(self) -> None:
        for path, (counts, _, _) in self.paths.items():
            print(f"   {path}: {counts}", flush=True)
        idle = [(path, n) for path, (counts, kernels, _) in
                self.paths.items() for n in kernels if counts[n] == 0]
        if idle:
            raise AssertionError(f"kernels never launched on their path: "
                                 f"{idle}")

    def total(self, wrapper: str, on_model) -> int:
        """Launches of `wrapper` over the paths of model `on_model` (all
        paths for None)."""
        return sum(counts[wrapper] for counts, _, m in self.paths.values()
                   if on_model in (None, m))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events around `reps` calls,
    after one warm-up: the wrapper's host work included."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per launch of the kernel alone: `reps` calls
    captured in one CUDA graph, replayed once to warm up and once more
    between CUDA events, so no host work lies between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def neg(spec, P):
    """-P for an (NC, ..., 16, L) point or (2, ...) affine tensor: y
    negated on a short-Weierstrass curve, x (and T) on a twisted-Edwards
    one."""
    import torch

    from ark_bulletproofs_tpu_torch.ops import field as df
    from ark_bulletproofs_tpu_torch.ops.curve import is_te

    out = P.clone()
    for c in ((0, 2) if is_te(spec) else (1,)):
        if c < P.shape[0]:
            out[c] = df.neg(spec.fq, P[c]).to(torch.int32)
    return out


def model(spec) -> str:
    from ark_bulletproofs_tpu_torch.ops.curve import is_te

    return "te" if is_te(spec) else "sw"


def entry(name: str, spec) -> str:
    """The kernels JSON entry of wrapper `name` on `spec`'s model."""
    return f"{name}[te]" if name in SCANS and model(spec) == "te" else name


class KernelCheck:
    """Phase 2: kernels against their plain versions on the card. `times`
    holds (kernel ms, plain ms, bound ms, bound_by) per kernel."""

    def __init__(self, dev, bound: Bound):
        self.dev = dev
        self.bound = bound
        self.err = {e[0]: 0 for e in ENTRIES}
        self.times = {}
        self.wrapper_ms = None

    def compare(self, name: str, got, want) -> None:
        import torch

        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(got, want))
        self.err[name] = max(self.err[name], err)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")

    def affine_rows(self, curve, spec, R: int, L: int, seed: int):
        """(2, R, 16, L) affine rows with doubling, P + (-P) and identity
        (y = 0) lanes, and on a twisted-Edwards curve (0, 1) lanes, from a
        pool of 256 chain points and their negatives."""
        import torch

        from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
        from ark_bulletproofs_tpu_torch.ops.curve import affine_to_device

        pts = GeneratorsChain(curve, b"chip_smoke pool").take(256)
        X, Y, _ = affine_to_device(curve, pts, self.dev)
        pool = torch.stack([X, Y])  # (2, 16, 256)
        pool = torch.cat([pool, neg(spec, pool)], dim=2)  # 512 points
        g = torch.Generator(device=self.dev).manual_seed(seed)
        idx = torch.randint(0, 512, (R, L), generator=g, device=self.dev)
        A, B, C = slice(0, L // 8), slice(L // 8, L // 4), slice(L // 4,
                                                                3 * L // 8)
        if R > 1:
            idx[0::2, A] = idx[1::2, A]  # row r = row r + 1: doublings
            idx[0::2, B] = (idx[1::2, B] + 256) % 512  # row r = -(row r+1)
        xy = pool[:, :, idx].permute(0, 2, 1, 3).contiguous()
        ident = torch.rand((R, L), generator=g, device=self.dev) < 0.3
        ident[:, :C.start] = False
        ident[:, C.stop:] = False
        xy[1].masked_fill_(ident.unsqueeze(1), 0)  # y = 0: identity rows
        if model(spec) == "te":  # (0, 1) as an ordinary affine point
            from ark_bulletproofs_tpu_torch.ops import field as df

            D = slice(3 * L // 8, L // 2)
            zy = torch.rand((R, L), generator=g, device=self.dev) < 0.3
            zy[:, :D.start] = False
            zy[:, D.stop:] = False
            zy = zy.unsqueeze(1)
            xy[0].masked_fill_(zy, 0)
            xy[1] = torch.where(zy, df.const(spec.fq.r_limbs, self.dev)
                                .to(torch.int32), xy[1])
        return xy

    @staticmethod
    def special_rows(spec, T):
        """Doubling and P + (-P) lanes in projective rows."""
        L = T.shape[-1]
        if T.shape[1] > 1:
            T[:, 0::2, :, :L // 8] = T[:, 1::2, :, :L // 8]
            T[:, 0::2, :, L // 8:L // 4] = neg(spec, T[:, 1::2, :,
                                                       L // 8:L // 4])
        return T

    def run_curve(self, curve, seed: int, timed: bool) -> None:
        import torch

        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        te = model(spec) == "te"
        nc = 4 if te else 3
        dka = kk.te_double_k_add if te else kk.rcb_double_k_add
        for R in (8, 1024):
            t0 = time.perf_counter()
            xy = self.affine_rows(curve, spec, R, L_MAIN, seed + R)
            locs = k2.suffix_madd_scan(spec, xy)
            plain_ms = host_ms(lambda: self.compare(
                entry("suffix_madd_scan", spec), locs,
                k2.suffix_madd_scan_plain(spec, xy)))
            if timed and R == 1024:
                self.times[entry("suffix_madd_scan", spec)] = (
                    graph_ms(lambda: k2.suffix_madd_scan(spec, xy), 3),
                    plain_ms,
                    *self.bound((2 + nc) * R * 16 * L_MAIN * 4,
                                R * L_MAIN * FE_MULS[model(spec)]["madd"]
                                * MULS_PER_FE_MUL))
            del xy
            T = self.special_rows(spec, locs)
            self.compare(entry("suffix_jac_scan", spec),
                         k2.suffix_jac_scan(spec, T),
                         k2.suffix_jac_scan_plain(spec, T))
            for K in (16, 64):
                if K <= R:
                    Tk = T[:, :K].contiguous()
                    self.compare(entry("rowsum", spec), k2.rowsum(spec, Tk),
                                 k2.rowsum_plain(spec, Tk))
            P = T[:, 0].contiguous()
            Q = T[:, min(1, R - 1)].contiguous()
            Q[..., :L_MAIN // 8] = P[..., :L_MAIN // 8]  # P + P
            Q[..., L_MAIN // 8:L_MAIN // 4] = neg(
                spec, P[..., L_MAIN // 8:L_MAIN // 4])  # P + (-P)
            for k in (0, 1, 12):
                self.compare(dka.__name__, dka(spec, P, Q, k),
                             kk.double_k_add_plain(spec, P, Q, k))
            if te:
                self.compare("te_double", kk.te_double(spec, Q),
                             kk.te_double_plain(spec, Q))
            del T, locs, P, Q
            torch.cuda.empty_cache()
            print(f"   {curve.name} R={R} L={L_MAIN}: all "
                  f"{5 if te else 4} bit-equal "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if timed:
            self.time_main_shapes(curve, spec, seed)

    def time_main_shapes(self, curve, spec, seed: int) -> None:
        """The other kernels at their n = 2^20 main-path shapes: stage D
        level A (64 rows x 22 * 16 lanes), stage F pass 1 (64 rows x 22 *
        64 lanes), stage E bucket add (22 * 4096 lanes); te_double at the
        commit table's 2 lanes (ops/prove.py::_commit_table)."""
        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops import kernels2 as k2

        te = model(spec) == "te"
        nc = 4 if te else 3
        fe = FE_MULS[model(spec)]
        add = fe["add"] * MULS_PER_FE_MUL
        T = k2.suffix_madd_scan(spec, self.affine_rows(curve, spec, 64,
                                                       22 * 64, seed))
        Ta = T[..., :22 * 16].contiguous()
        R, La = Ta.shape[1], Ta.shape[-1]
        self.times[entry("suffix_jac_scan", spec)] = (
            graph_ms(lambda: k2.suffix_jac_scan(spec, Ta), 20),
            host_ms(lambda: k2.suffix_jac_scan_plain(spec, Ta)),
            *self.bound((2 * R + 1) * nc * 16 * La * 4, R * La * add))
        K, Lr = T.shape[1], T.shape[-1]
        self.times[entry("rowsum", spec)] = (
            graph_ms(lambda: k2.rowsum(spec, T), 20),
            host_ms(lambda: k2.rowsum_plain(spec, T)),
            *self.bound((K + 1) * nc * 16 * Lr * 4, K * Lr * add))
        xy = self.affine_rows(curve, spec, 8, 22 * 4096, seed + 1)
        U = k2.suffix_madd_scan(spec, xy)
        P, Q = U[:, 0].contiguous(), U[:, 1].contiguous()
        m = P.shape[-1]
        dka = kk.te_double_k_add if te else kk.rcb_double_k_add
        self.times[dka.__name__] = (
            graph_ms(lambda: dka(spec, P, Q, 0), 20),
            host_ms(lambda: kk.double_k_add_plain(spec, P, Q, 0)),
            *self.bound(3 * nc * 16 * m * 4, m * add))
        if te:
            P2 = P[..., :2].contiguous()
            self.times["te_double"] = (
                graph_ms(lambda: kk.te_double(spec, P2), 100),
                host_ms(lambda: kk.te_double_plain(spec, P2)),
                *self.bound(2 * 4 * 16 * 2 * 4,
                            2 * fe["double"] * MULS_PER_FE_MUL))

    def run_mont_mul(self, curve, seed: int, timed: bool) -> None:
        """mont_mul bit-equal to its plain version on curve.fr, flat and at
        the prover's row shapes, then timed at MM_LANES lanes (the k = 1024
        fold): the kernel alone from a CUDA graph, and the wrapper's rate
        with its host work."""
        import torch

        from ark_bulletproofs_tpu_torch.ops import field as df
        from ark_bulletproofs_tpu_torch.ops.limbs import ints_to_limbs

        fs = df.spec_for(curve.fr)
        p = fs.p
        rng = random.Random(seed)

        def limbs(vals, rows: int, L: int):
            """(rows, 16, L) limbs of rows * L ints, row-major."""
            t = ints_to_limbs(vals, self.dev)
            return t.reshape(16, rows, L).permute(1, 0, 2).contiguous()

        for lanes in (1000, MM_LANES, 9 * 2048):
            xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(lanes - 3)]
            ys = [p - 1, 0, p - 1] + [rng.randrange(p)
                                      for _ in range(lanes - 3)]
            a = ints_to_limbs(xs, self.dev)
            b = ints_to_limbs(ys, self.dev)
            col = ints_to_limbs([ys[5]], self.dev)  # (16, 1): stride 0
            rows = limbs(xs, 2, lanes // 2)
            per_row = limbs(ys[7:9], 2, 1)
            for x, y in ((a, b), (a, col), (col, a), (rows, per_row)):
                self.compare("mont_mul", df.mont_mul(fs, x, y).long(),
                             df.mont_mul_plain(fs, x, y))
        # The prover's launches at k = 1024: the round scalars' (6, 16,
        # 2048) pair, the fold's (4, 16, 2048) against per-row (4, 16, 1)
        # challenges, and the vector phase's (9, 16, 2048) pair.
        for R, Rb, Lb in ((6, 6, 2048), (4, 4, 1), (9, 9, 2048)):
            x = limbs([rng.randrange(p) for _ in range(R * 2048)], R, 2048)
            y = limbs([rng.randrange(p) for _ in range(Rb * Lb)], Rb, Lb)
            self.compare("mont_mul", df.mont_mul(fs, x, y).long(),
                         df.mont_mul_plain(fs, x, y))
        if timed:
            a, b = a[:, :MM_LANES].contiguous(), b[:, :MM_LANES].contiguous()
            self.times["mont_mul"] = (
                graph_ms(lambda: df.mont_mul(fs, a, b), 100),
                host_ms(lambda: df.mont_mul_plain(fs, a, b)),
                *self.bound(3 * 64 * MM_LANES, MM_LANES * MULS_PER_FE_MUL))
            self.wrapper_ms = cuda_ms(lambda: df.mont_mul(fs, a, b), 100)
        torch.cuda.synchronize()
        print(f"   mont_mul {curve.name} fr: bit-equal at 1000, {MM_LANES}"
              f" and {9 * 2048} lanes and at (6, 4, 9) x 16 x 2048",
              flush=True)

    def report(self) -> None:
        for name, (ms, pms, bms, by) in self.times.items():
            print(f"   {name}: kernel {ms:.4f} ms, plain {pms:.1f} ms, "
                  f"bound {bms:.5g} ms ({by})", flush=True)
        print(f"   mont_mul wrapper, host work included: {self.wrapper_ms:.4f}"
              f" ms a call (CUDA events around 100 calls)", flush=True)


def path_name(what: str, curve) -> str:
    return what if curve.name == "secq256k1" else f"{what} {curve.name}"


def phase_msm(curve, launches: Launches) -> None:
    """n = 2^20 MSM through `msm`, equal to the host Pippenger (native
    C++, or for curve25519 pure Python), then the device MSM timed (median
    of 5) with its peak memory."""
    import numpy as np
    import torch

    import ark_bulletproofs_tpu_torch as port
    from ark_bulletproofs_tpu_torch import engine
    from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch.ops.curve import affine_to_device, spec_for
    from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device
    from ark_bulletproofs_tpu_torch.parallel.msm import msm_device_ragged

    t0 = time.perf_counter()
    pts = GeneratorsChain(curve, b"chip_smoke msm").take(N_DISTINCT)
    reps = N_MSM // N_DISTINCT
    bases = pts * reps  # base i is pts[i % 2^13]
    raw = np.random.default_rng(2024).integers(
        0, 1 << 16, size=(N_MSM, 16), dtype=np.uint16).tobytes()
    r = curve.fr.p
    ks = [int.from_bytes(raw[32 * i:32 * i + 32], "little") % r
          for i in range(N_MSM)]
    ksum = [sum(ks[j::N_DISTINCT]) % r for j in range(N_DISTINCT)]
    want = curve.msm(pts, ksum)  # host Pippenger over 2^13 points
    print(f"   inputs and host reference: {time.perf_counter() - t0:.1f} s",
          flush=True)
    spec = spec_for(curve)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = launches.run(path_name("msm", curve),
                       lambda: port.msm(curve, bases, ks),
                       MSM_KERNELS[model(spec)], spec)
    e2e = time.perf_counter() - t0
    if got != want:
        raise AssertionError("n=2^20 MSM differs from the host Pippenger")
    print(f"   port msm == host Pippenger (end to end {e2e:.3f} s)",
          flush=True)
    dev = engine.torch_device()
    X, Y, inf = affine_to_device(curve, pts, dev)
    X, Y, inf = X.repeat(1, reps), Y.repeat(1, reps), inf.repeat(reps)
    scal = scalars_to_device(curve, [ks], dev)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msm_device_ragged(spec, X, Y, inf, scal)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"   device msm {curve.name}: median {med * 1e3:.1f} ms of "
          f"{[round(t * 1e3, 1) for t in times]} -> {N_MSM / med:.0f} "
          f"points/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def tamper_t_x(curve, proof):
    """The proof with one byte of t_x flipped (still a valid scalar)."""
    from ark_bulletproofs_tpu_torch.r1cs import R1CSProof

    blob = bytearray(proof.to_bytes(curve))
    off = 11 * len(curve.serialize_compressed(curve.gen))  # 11 points
    blob[off] ^= 1
    return R1CSProof.from_bytes(curve, bytes(blob))


def must_raise(what: str, fn) -> None:
    from ark_bulletproofs_tpu_torch.errors import R1CSError

    try:
        fn()
    except R1CSError:
        print(f"   {what}: rejected", flush=True)
        return
    raise AssertionError(f"{what}: accepted")


def full_collections() -> int:
    """Full (generation 2) garbage collections so far in this process."""
    return gc.get_stats()[2]["collections"]


def print_phases() -> None:
    """The protocol phases timed since the last reset (host clock)."""
    from ark_bulletproofs_tpu_torch.utils import profiling

    print("\n".join(f"     {line}" for line in
                    profiling.report().splitlines()), flush=True)
    profiling.reset()


def traced(what: str, fn) -> None:
    """Run fn once under torch.profiler and print its wall time, the
    card's busy time (the summed durations of its kernels and copies: one
    stream, so they do not overlap; the phases' annotation ranges are not
    card work and are left out) and the card time of the largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e6)
    busy = sum(t for _, t in by_name.values())
    print(f"   traced {what}: {wall:.3f} s, card busy {busy:.4f} s, host "
          f"{wall - busy:.3f} s, card idle share {1 - busy / wall:.4f}; card "
          f"time by kernel (count, ms), largest first:", flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"     {n:5d} {t * 1e3:9.3f}  {name[:90]}", flush=True)


def phase_shuffle(curve, launches: Launches) -> tuple:
    """k = SHUFFLE_K shuffle: card prove, host-route prove, byte-equal;
    verify on the card; two tamper checks. Returns the card prove and
    the verify as functions, for the traces."""
    import torch

    from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                            ShuffleProof, Transcript,
                                            engine, seeded_rng)
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for
    from ark_bulletproofs_tpu_torch.utils import profiling

    spec = spec_for(curve)
    msm_kernels = MSM_KERNELS[model(spec)]
    prove_kernels = msm_kernels + ("mont_mul",)
    if model(spec) == "te":  # the witness commits' 2^i B table
        prove_kernels += ("te_double",)
    t0 = time.perf_counter()
    pc = PedersenGens.default(curve)
    bp = BulletproofGens(curve, 2 * SHUFFLE_K, 1)
    pyrng = random.Random(1024)
    vals = [pyrng.getrandbits(64) for _ in range(SHUFFLE_K)]
    perm = vals[:]
    pyrng.shuffle(perm)
    label = b"chip_smoke shuffle"
    print(f"   {curve.name} generators: {time.perf_counter() - t0:.1f} s",
          flush=True)

    def prove():
        return ShuffleProof.prove(seeded_rng(1024), pc, bp,
                                  Transcript(label), vals, perm)

    profiling.reset()
    full = full_collections()
    t0 = time.perf_counter()
    sp, ic, oc = launches.run(path_name("prove", curve), prove,
                              prove_kernels, spec)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    card = sp.proof.to_bytes(curve)
    print(f"   {curve.name} card prove k={SHUFFLE_K}: {card_s:.3f} s "
          f"({len(card)} bytes, "
          f"{full_collections() - full} full collections); its phases:",
          flush=True)
    print_phases()
    threshold = engine.config.msm_device_threshold
    engine.config.msm_device_threshold = 1 << 62  # nothing reaches the card
    try:
        t0 = time.perf_counter()
        sp_host, _, _ = prove()
        host_s = time.perf_counter() - t0
    finally:
        engine.config.msm_device_threshold = threshold
    if sp_host.proof.to_bytes(curve) != card:
        raise AssertionError("card proof differs from the host-route proof")
    print(f"   {curve.name} host-route prove k={SHUFFLE_K}: {host_s:.3f} s; "
          f"the two proofs are byte-equal", flush=True)
    def verify():
        ShuffleProof(sp.proof).verify(pc, bp, Transcript(label), ic, oc)

    # The first verify inherits the collector's state from the phases
    # before it, the next two start from a gc.collect(): a full collection
    # that falls inside a run costs it a pass over every live object.
    for run in ("first", "after gc.collect()", "after gc.collect(), again"):
        if run != "first":
            gc.collect()
        profiling.reset()
        full = full_collections()
        t0 = time.perf_counter()
        launches.run(path_name("verify", curve), verify, msm_kernels, spec)
        torch.cuda.synchronize()
        print(f"   {curve.name} verify k={SHUFFLE_K} on the card, {run}: "
              f"accepted, {time.perf_counter() - t0:.3f} s, "
              f"{full_collections() - full} full collections; its phases:",
              flush=True)
        print_phases()
    must_raise("flipped t_x byte", lambda: ShuffleProof(
        tamper_t_x(curve, sp.proof)).verify(pc, bp, Transcript(label), ic,
                                            oc))
    must_raise("swapped commitments", lambda: ShuffleProof(sp.proof).verify(
        pc, bp, Transcript(label), oc, ic))
    return prove, verify


def phase_batch(curve, launches: Launches) -> None:
    from ark_bulletproofs_tpu_torch import (BulletproofGens, PedersenGens,
                                            R1CSProof, ShuffleProof,
                                            Transcript, batch_verify,
                                            seeded_rng)
    from ark_bulletproofs_tpu_torch.ops.curve import spec_for

    with open(BATCH_CACHE, "rb") as fh:
        blobs = pickle.load(fh)  # tracked in the repo: (bytes, [bytes], [bytes])
    pc = PedersenGens.default(curve)
    bp = BulletproofGens(curve, 16, 1)
    decoded = [
        (R1CSProof.from_bytes(curve, pb),
         [curve.deserialize_compressed(b) for b in icb],
         [curve.deserialize_compressed(b) for b in ocb])
        for pb, icb, ocb in blobs
    ]

    def instances(items):
        return [
            (ShuffleProof(p).build_verifier(pc, Transcript(b"bench batch"),
                                            ic, oc), p)
            for p, ic, oc in items
        ]

    inst = instances(decoded)
    t0 = time.perf_counter()
    launches.run("batch_verify",
                 lambda: batch_verify(seeded_rng(1000), inst, pc, bp),
                 MSM_KERNELS["sw"], spec_for(curve))
    dt = time.perf_counter() - t0
    print(f"   batch_verify of {len(decoded)} k=8 proofs: accepted, "
          f"{dt:.3f} s, {len(decoded) / dt:.1f} proofs/s", flush=True)
    bad = list(decoded)
    p, ic, oc = bad[517]
    bad[517] = (tamper_t_x(curve, p), ic, oc)
    must_raise("batch with one tampered proof", lambda: batch_verify(
        seeded_rng(1001), instances(bad), pc, bp))


def ptxas_report(log: str) -> list[str]:
    """One line per kernel instantiation of nvcc's `-Xptxas -v` report:
    kernel, point model, registers, spill stores and loads (bytes)."""
    import re

    models = {"TeModel": "te", "RcbModelILb1E": "rcb a=0",
              "RcbModelILb0E": "rcb a"}
    out, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kern = re.search(r"\d+(\w+?_kernel)", name)
            kind = next((v for k, v in models.items() if k in name), "")
            name = f"{kern.group(1) if kern else name} {kind}".strip()
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ark_bulletproofs_tpu_torch import curves, engine, native
    from ark_bulletproofs_tpu_torch.ops import _build
    from ark_bulletproofs_tpu_torch.ops import field as df
    from ark_bulletproofs_tpu_torch.ops import kernels as kk
    from ark_bulletproofs_tpu_torch.ops import kernels2 as k2

    engine.config.device = "cuda"
    dev = engine.torch_device()
    wrappers = {
        "suffix_madd_scan": k2.suffix_madd_scan,
        "suffix_jac_scan": k2.suffix_jac_scan,
        "rowsum": k2.rowsum,
        "rcb_double_k_add": kk.rcb_double_k_add,
        "mont_mul": df.mont_mul,
        "te_double_k_add": kk.te_double_k_add,
        "te_double": kk.te_double,
    }

    with phase("1 build"):
        smi = smi_line()
        clock = float(smi_query("clocks.max.sm", units=False))
        print(f"   card: {smi}, max SM clock {clock:.0f} MHz; torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        _build.lib()
        print(f"   nvcc sm_90a build: {_build.build_seconds} s -> "
              f"{os.path.relpath(_build.library_path(), ROOT)}", flush=True)
        for line in ptxas_report(_build.build_log or ""):
            print(f"     {line}", flush=True)
        host = native.lib()
        if host is None:
            raise AssertionError("the native host library did not build "
                                 "or load")
        print(f"   native host library: {os.path.relpath(host._name, ROOT)}",
              flush=True)

    check = KernelCheck(dev, Bound(clock))
    with phase("2 kernels vs plain versions"):
        check.run_curve(curves.secq256k1, seed=1, timed=True)
        check.run_curve(curves.zorro, seed=2, timed=False)
        check.run_curve(curves.curve25519, seed=5, timed=True)
        check.run_mont_mul(curves.secq256k1, seed=3, timed=True)
        check.run_mont_mul(curves.zorro, seed=4, timed=False)
        check.report()
    torch.cuda.empty_cache()

    launches = Launches(wrappers)
    with phase("3 msm n=2^20 secq256k1"):
        phase_msm(curves.secq256k1, launches)
    with phase(f"4 shuffle k={SHUFFLE_K} secq256k1"):
        prove, verify = phase_shuffle(curves.secq256k1, launches)
    with phase("5 batch_verify 1024 x k=8"):
        phase_batch(curves.secq256k1, launches)
    with phase("6 msm n=2^20 curve25519"):
        phase_msm(curves.curve25519, launches)
    with phase(f"7 shuffle k={SHUFFLE_K} curve25519"):
        prove_te, _ = phase_shuffle(curves.curve25519, launches)
    with phase("8 launches"):
        launches.check()
    with phase("9 traces"):
        traced(f"secq256k1 card prove k={SHUFFLE_K}", prove)
        traced(f"secq256k1 verify k={SHUFFLE_K}", verify)
        traced(f"curve25519 card prove k={SHUFFLE_K}", prove_te)

    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches.total(wrapper, on_model),
            "max_abs_err": check.err[name],
            "ms": check.times[name][0],
            "plain_ms": check.times[name][1],
            "bound_ms": check.times[name][2],
            "bound_by": check.times[name][3],
            "library_ms": None,
        }
        for name, wrapper, on_model, source, replaces in ENTRIES
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
