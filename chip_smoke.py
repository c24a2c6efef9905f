#!/usr/bin/env python3
"""Smoke run of ark_bulletproofs_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. build: the card's name and power limit, then nvcc builds the four
     kernels (csrc/) for sm_90a into ark_bulletproofs_tpu_torch/_build/;
  2. kernels: each kernel against its plain PyTorch version on the card,
     bit-equal coordinates, on secq256k1 and zorro, with identity,
     doubling and P + (-P) lanes; then each timed at its main-path shape
     (n = 2^20, secq256k1) beside its plain version;
  3. msm: n = 2^20 secq256k1 through the port's `msm`, equal to the native
     host Pippenger, then timed (median of 5);
  4. shuffle: a k = 1024 shuffle proof (shared host prover) verified by
     the port on the card; a flipped byte and swapped commitments rejected;
  5. batch_verify: the 1024 cached k = 8 proofs accepted, a batch with one
     tampered proof rejected;
  6. launches: every kernel launched by phases 3-5.

Any failure exits nonzero. The last three lines are the kernels JSON, the
card's `nvidia-smi` name and power limit, and {"ok": true, "device": ...}.
Needs one card; exits 1 at once without one.
"""

from __future__ import annotations

import contextlib
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
KERNEL_SOURCE = "ark_bulletproofs_tpu_torch/csrc/msm_kernels.cu"
REPLACES = {
    "suffix_madd_scan": "ark_bulletproofs_tpu/ops/kernels2.py:133",
    "suffix_jac_scan": "ark_bulletproofs_tpu/ops/kernels2.py:223",
    "rowsum": "ark_bulletproofs_tpu/ops/kernels2.py:292",
    "rcb_double_k_add": "ark_bulletproofs_tpu/ops/kernels.py:853",
}


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up."""
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


def host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def neg_y(spec, P):
    """-P for a (3, ..., 16, L) projective or (2, ...) affine tensor."""
    import torch

    from ark_bulletproofs_tpu_torch.ops import field as df

    out = P.clone()
    out[1] = df.neg(spec.fq, P[1]).to(torch.int32)
    return out


class KernelCheck:
    """Phase 2: kernels against their plain versions on the card."""

    def __init__(self, dev):
        self.dev = dev
        self.err = {k: 0 for k in REPLACES}
        self.times = {}

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
        lanes, from a pool of 256 chain points and their negatives."""
        import torch

        from ark_bulletproofs_tpu.generators import GeneratorsChain
        from ark_bulletproofs_tpu_torch import engine
        from ark_bulletproofs_tpu_torch.ops.curve import affine_to_device

        with engine.host_backend():
            pts = GeneratorsChain(curve, b"chip_smoke pool").take(256)
        X, Y, _ = affine_to_device(curve, pts, self.dev)
        pool = torch.stack([X, Y])  # (2, 16, 256)
        pool = torch.cat([pool, neg_y(spec, pool)], dim=2)  # 512 points
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
        return xy

    @staticmethod
    def special_rows(spec, T):
        """Doubling and P + (-P) lanes in projective rows."""
        L = T.shape[-1]
        if T.shape[1] > 1:
            T[:, 0::2, :, :L // 8] = T[:, 1::2, :, :L // 8]
            T[:, 0::2, :, L // 8:L // 4] = neg_y(spec, T[:, 1::2, :,
                                                         L // 8:L // 4])
        return T

    def run_curve(self, curve, seed: int, timed: bool) -> None:
        import torch

        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops import kernels2 as k2
        from ark_bulletproofs_tpu_torch.ops.curve import spec_for

        spec = spec_for(curve)
        for R in (8, 1024):
            t0 = time.perf_counter()
            xy = self.affine_rows(curve, spec, R, L_MAIN, seed + R)
            locs = k2.suffix_madd_scan(spec, xy)
            plain_ms = host_ms(lambda: self.compare(
                "suffix_madd_scan", locs,
                k2.suffix_madd_scan_plain(spec, xy)))
            if timed and R == 1024:
                self.times["suffix_madd_scan"] = (
                    cuda_ms(lambda: k2.suffix_madd_scan(spec, xy)), plain_ms)
            del xy
            T = self.special_rows(spec, locs)
            self.compare("suffix_jac_scan", k2.suffix_jac_scan(spec, T),
                         k2.suffix_jac_scan_plain(spec, T))
            for K in (16, 64):
                if K <= R:
                    Tk = T[:, :K].contiguous()
                    self.compare("rowsum", k2.rowsum(spec, Tk),
                                 k2.rowsum_plain(spec, Tk))
            P = T[:, 0].contiguous()
            Q = T[:, min(1, R - 1)].contiguous()
            Q[..., :L_MAIN // 8] = P[..., :L_MAIN // 8]  # P + P
            Q[..., L_MAIN // 8:L_MAIN // 4] = neg_y(
                spec, P[..., L_MAIN // 8:L_MAIN // 4])  # P + (-P)
            for k in (0, 1, 12):
                self.compare("rcb_double_k_add",
                             kk.rcb_double_k_add(spec, P, Q, k),
                             kk.rcb_double_k_add_plain(spec, P, Q, k))
            del T, locs, P, Q
            torch.cuda.empty_cache()
            print(f"   {curve.name} R={R} L={L_MAIN}: all four bit-equal "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if timed:
            self.time_main_shapes(curve, spec, seed)

    def time_main_shapes(self, curve, spec, seed: int) -> None:
        """The other three kernels at their n = 2^20 main-path shapes:
        stage D level A (64 rows x 22 * 16 lanes), stage F pass 1 (64
        rows x 22 * 64 lanes), stage E bucket add (22 * 4096 lanes)."""
        from ark_bulletproofs_tpu_torch.ops import kernels as kk
        from ark_bulletproofs_tpu_torch.ops import kernels2 as k2

        T = k2.suffix_madd_scan(spec, self.affine_rows(curve, spec, 64,
                                                       22 * 64, seed))
        Ta = T[..., :22 * 16].contiguous()
        self.times["suffix_jac_scan"] = (
            cuda_ms(lambda: k2.suffix_jac_scan(spec, Ta)),
            host_ms(lambda: k2.suffix_jac_scan_plain(spec, Ta)))
        self.times["rowsum"] = (
            cuda_ms(lambda: k2.rowsum(spec, T)),
            host_ms(lambda: k2.rowsum_plain(spec, T)))
        xy = self.affine_rows(curve, spec, 8, 22 * 4096, seed + 1)
        U = k2.suffix_madd_scan(spec, xy)
        P, Q = U[:, 0].contiguous(), U[:, 1].contiguous()
        self.times["rcb_double_k_add"] = (
            cuda_ms(lambda: kk.rcb_double_k_add(spec, P, Q, 0)),
            host_ms(lambda: kk.rcb_double_k_add_plain(spec, P, Q, 0)))
        for name, (ms, pms) in self.times.items():
            print(f"   {name}: kernel {ms:.3f} ms, plain {pms:.1f} ms",
                  flush=True)


def phase_msm(curve):
    """n = 2^20 secq256k1 MSM; returns (points/s, end-to-end seconds)."""
    import numpy as np
    import torch

    import ark_bulletproofs_tpu_torch as port
    from ark_bulletproofs_tpu.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch import engine
    from ark_bulletproofs_tpu_torch.ops.curve import affine_to_device, spec_for
    from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device
    from ark_bulletproofs_tpu_torch.parallel.msm import msm_device_ragged

    t0 = time.perf_counter()
    with engine.host_backend():
        pts = GeneratorsChain(curve, b"chip_smoke msm").take(N_DISTINCT)
    reps = N_MSM // N_DISTINCT
    bases = pts * reps  # base i is pts[i % 2^13]
    raw = np.random.default_rng(2024).integers(
        0, 1 << 16, size=(N_MSM, 16), dtype=np.uint16).tobytes()
    r = curve.fr.p
    ks = [int.from_bytes(raw[32 * i:32 * i + 32], "little") % r
          for i in range(N_MSM)]
    ksum = [sum(ks[j::N_DISTINCT]) % r for j in range(N_DISTINCT)]
    want = curve.msm(pts, ksum)  # native C++ Pippenger over 2^13 points
    print(f"   inputs and host reference: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    got = port.msm(curve, bases, ks)
    e2e = time.perf_counter() - t0
    if got != want:
        raise AssertionError("n=2^20 MSM differs from the host Pippenger")
    print(f"   port msm == host Pippenger (end to end {e2e:.3f} s)",
          flush=True)
    dev = engine.torch_device()
    X, Y, inf = affine_to_device(curve, pts, dev)
    X, Y, inf = X.repeat(1, reps), Y.repeat(1, reps), inf.repeat(reps)
    scal = scalars_to_device(curve, [ks], dev)
    spec = spec_for(curve)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msm_device_ragged(spec, X, Y, inf, scal)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"   device msm: median {med * 1e3:.1f} ms of "
          f"{[round(t * 1e3, 1) for t in times]} -> {N_MSM / med:.0f} "
          f"points/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return N_MSM / med, e2e


def tamper_t_x(curve, proof):
    """The proof with one byte of t_x flipped (still a valid scalar)."""
    from ark_bulletproofs_tpu.r1cs import R1CSProof

    blob = bytearray(proof.to_bytes(curve))
    off = 11 * len(curve.serialize_compressed(curve.gen))  # 11 points
    blob[off] ^= 1
    return R1CSProof.from_bytes(curve, bytes(blob))


def must_raise(what: str, fn) -> None:
    from ark_bulletproofs_tpu.errors import R1CSError

    try:
        fn()
    except R1CSError:
        print(f"   {what}: rejected", flush=True)
        return
    raise AssertionError(f"{what}: accepted")


def phase_shuffle(curve) -> float:
    from ark_bulletproofs_tpu import BulletproofGens, PedersenGens, Transcript
    from ark_bulletproofs_tpu.rand import seeded_rng
    from ark_bulletproofs_tpu_torch import ShuffleProof, engine

    with engine.host_backend():
        pc = PedersenGens.default(curve)
        bp = BulletproofGens(curve, 2 * SHUFFLE_K, 1)
    pyrng = random.Random(1024)
    vals = [pyrng.getrandbits(64) for _ in range(SHUFFLE_K)]
    perm = vals[:]
    pyrng.shuffle(perm)
    label = b"chip_smoke shuffle"
    t0 = time.perf_counter()
    sp, ic, oc = ShuffleProof.prove(seeded_rng(1024), pc, bp,
                                    Transcript(label), vals, perm)
    print(f"   host prove k={SHUFFLE_K}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    ShuffleProof(sp.proof).verify(pc, bp, Transcript(label), ic, oc)
    dt = time.perf_counter() - t0
    print(f"   verify k={SHUFFLE_K} on the card: accepted, {dt:.3f} s",
          flush=True)
    must_raise("flipped t_x byte", lambda: ShuffleProof(
        tamper_t_x(curve, sp.proof)).verify(pc, bp, Transcript(label), ic,
                                            oc))
    must_raise("swapped commitments", lambda: ShuffleProof(sp.proof).verify(
        pc, bp, Transcript(label), oc, ic))
    return dt


def phase_batch(curve) -> float:
    from ark_bulletproofs_tpu import BulletproofGens, PedersenGens, Transcript
    from ark_bulletproofs_tpu.r1cs import R1CSProof
    from ark_bulletproofs_tpu.rand import seeded_rng
    from ark_bulletproofs_tpu_torch import ShuffleProof, batch_verify, engine

    with open(BATCH_CACHE, "rb") as fh:
        blobs = pickle.load(fh)  # tracked in the repo: (bytes, [bytes], [bytes])
    with engine.host_backend():
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
    batch_verify(seeded_rng(1000), inst, pc, bp)
    dt = time.perf_counter() - t0
    print(f"   batch_verify of {len(decoded)} k=8 proofs: accepted, "
          f"{dt:.3f} s, {len(decoded) / dt:.1f} proofs/s", flush=True)
    bad = list(decoded)
    p, ic, oc = bad[517]
    bad[517] = (tamper_t_x(curve, p), ic, oc)
    must_raise("batch with one tampered proof", lambda: batch_verify(
        seeded_rng(1001), instances(bad), pc, bp))
    return len(decoded) / dt


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ark_bulletproofs_tpu import curves
    from ark_bulletproofs_tpu_torch import engine
    from ark_bulletproofs_tpu_torch.ops import _build
    from ark_bulletproofs_tpu_torch.ops import kernels as kk
    from ark_bulletproofs_tpu_torch.ops import kernels2 as k2

    engine.config.device = "cuda"
    dev = engine.torch_device()
    wrappers = {
        "suffix_madd_scan": k2.suffix_madd_scan,
        "suffix_jac_scan": k2.suffix_jac_scan,
        "rowsum": k2.rowsum,
        "rcb_double_k_add": kk.rcb_double_k_add,
    }

    with phase("1 build"):
        smi = smi_line()
        print(f"   card: {smi}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}", flush=True)
        _build.lib()
        print(f"   nvcc sm_90a build: {_build.build_seconds} s -> "
              f"{os.path.relpath(_build.library_path(), ROOT)}", flush=True)

    check = KernelCheck(dev)
    with phase("2 kernels vs plain versions"):
        check.run_curve(curves.secq256k1, seed=1, timed=True)
        check.run_curve(curves.zorro, seed=2, timed=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    for w in wrappers.values():
        w.launches = 0
    with phase("3 msm n=2^20 secq256k1"):
        pps, _ = phase_msm(curves.secq256k1)
    with phase(f"4 shuffle k={SHUFFLE_K}"):
        phase_shuffle(curves.secq256k1)
    with phase("5 batch_verify 1024 x k=8"):
        phase_batch(curves.secq256k1)
    launches = {name: w.launches for name, w in wrappers.items()}

    with phase("6 launches"):
        print(f"   {launches}", flush=True)
        idle = [n for n, c in launches.items() if c == 0]
        if idle:
            raise AssertionError(f"kernels never launched: {idle}")

    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": check.err[name],
            "ms": check.times[name][0],
            "plain_ms": check.times[name][1],
        }
        for name in wrappers
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
