"""Build and load the CUDA kernels (csrc/*.cu) at first use.

nvcc compiles each source for sm_90a into an object, all sources at once
in parallel processes, and links them into one shared library with a plain
C interface under ark_bulletproofs_tpu_torch/_build/ (git-ignored), named
by a hash of the sources, so an edited source is rebuilt and an unchanged
one is loaded as it is. The host C++ of csrc/host/ is not in the glob: g++
builds it (native.py). ctypes binds it: every pointer and the stream are
c_void_p, sizes are c_int64, and every entry returns cudaGetLastError(),
which `check` turns into an exception. nvcc runs with `-Xptxas -v`; its
report (registers, spills per kernel) is kept in `build_log`. Nothing here
runs at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None
build_log: str | None = None  # nvcc's output of the build in this process

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
_SIGNATURES = {
    "abtpu_suffix_madd_scan": [_P, _P, _I64, _I64, _P, _P],
    "abtpu_suffix_jac_scan": [_P, _P, _P, _I64, _I64, _P, _P],
    "abtpu_rowsum": [_P, _P, _I64, _I64, _P, _P],
    "abtpu_rcb_double_k_add": [_P, _P, _P, _I64, _I32, _P, _P],
    "abtpu_te_double_k_add": [_P, _P, _P, _I64, _I32, _P, _P],
    "abtpu_te_double": [_P, _P, _I64, _I32, _I32, _P, _P],
    "abtpu_jac_double_k_add": [_P, _P, _P, _I64, _I32, _P, _P],
    "abtpu_jac_double": [_P, _P, _I64, _I32, _I32, _P, _P],
    "abtpu_jac_madd": [_P, _P, _P, _P, _P, _I64, _I64, _P, _P],
    "abtpu_te_madd": [_P, _P, _P, _P, _P, _I64, _I64, _P, _P],
    "abtpu_rcb_double": [_P, _P, _I64, _P, _P],
    "abtpu_horner": [_P, _P, _P, _I64, _I64, _I64, _I32, _P, _P],
    "abtpu_jac_horner": [_P, _P, _P, _I64, _I64, _I64, _I32, _P, _P],
    "abtpu_row_gather": [_P, _P, _P, _I64, _I64, _I32, _P],
    "abtpu_stage_table": [_P, _P, _P, _I64, _I64, _I64, _P, _P],
    "abtpu_stage_gather": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                           _I64, _I32, _P],
    "abtpu_fs_round": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _P, _P, _P,
                       _P],
    "abtpu_mont_mul": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                       _I32, _P, _P],
    "abtpu_add_sub": [_P, _P, _P, _I64, _I64, _I64, _I64, _I32, _P, _P],
    "abtpu_sum_mod": [_P, _P, _I64, _P, _P, _P],
    "abtpu_mont_inv_batch": [_P, _P, _P, _I64, _I64, _P, _P, _P],
    "abtpu_gen_candidates": [_P, _P, _P, _I64, _P, _P, _P],
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> str:
    h = hashlib.sha256()
    for s in _sources():
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"abtpu_msm_{h.hexdigest()[:16]}.so")


def lib() -> ctypes.CDLL:
    """The loaded kernel library; builds it first if needed."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.tmp.{os.getpid()}"
            cus = [s for s in _sources() if s.endswith(".cu")]
            objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
            t0 = time.perf_counter()
            nvcc = _nvcc()
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for s, o in zip(cus, objs)
            ]
            logs = [p.communicate()[0] for p in procs]
            build_log = "\n".join(logs)
            failed = [log for p, log in zip(procs, logs) if p.returncode]
            if not failed:
                r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                   capture_output=True, text=True)
                if r.returncode:
                    failed.append(r.stdout + r.stderr)
            for o in objs:
                if os.path.exists(o):
                    os.unlink(o)
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            os.replace(tmp, out)
            build_seconds = time.perf_counter() - t0
        dll = ctypes.CDLL(out)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = dll
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


_WORDS: dict = {}


def curve_words(spec) -> np.ndarray:
    """The 45 uint32 words of csrc/field.cuh::CurveConst for a CurveSpec
    (short-Weierstrass) or a TECurveSpec (twisted-Edwards), or for a
    FieldSpec the field's p, n0 and R with zero curve words (the field
    kernels read only those). Kept alive in a cache: ctypes passes a
    pointer to them."""
    w = _WORDS.get(spec)
    if w is None:
        fs = getattr(spec, "fq", spec)

        def words(x: int) -> list[int]:
            return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]

        def val(limbs16) -> int:
            return sum(v << (16 * i) for i, v in enumerate(limbs16))

        zero = [0] * 8
        curve = [0] * 28
        if hasattr(spec, "d_mont_limbs"):  # TECurveSpec
            curve = (words(val(spec.a_mont_limbs)) + zero + [0, 0, 0]
                     + words(val(spec.d_mont_limbs)) + [1])
        elif spec is not fs:
            curve = (words(val(spec.a_mont_limbs))
                     + words(val(spec.b3_mont_limbs))
                     + [spec.a_small or 0, spec.b3_small or 0,
                        int(spec.is_a_zero)] + zero + [0])
        w = np.array(words(fs.p) + [fs.n0_32] + words(fs.R) + curve,
                     dtype=np.uint32)
        _WORDS[spec] = w
    return w
