"""ctypes loader for the native host layer (csrc/host/*.cpp).

Builds the shared library on first use if a compiler is available;
callers fall back to the pure-Python implementations when it isn't.
The Python and C++ paths are bit-exact (the JAX package's
tests/test_byte_layer.py runs both on its copy), so which one loads is purely a performance matter.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_lock = threading.Lock()
_lib = None
_tried = False

# csrc/host/, outside the csrc/*.cu glob that ops/_build.py hands to nvcc.
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "host")
_SRCS = [
    os.path.join(_CSRC, "abtpu_host.cpp"),
    os.path.join(_CSRC, "abtpu_msm_cpu.cpp"),
]
_OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_OUT = os.path.join(_OUT_DIR, "libabtpu_host.so")


def _build() -> str | None:
    if os.path.exists(_OUT) and all(
        os.path.getmtime(_OUT) >= os.path.getmtime(s) for s in _SRCS
    ):
        return _OUT
    os.makedirs(_OUT_DIR, exist_ok=True)
    # Build to a temp path and os.replace: `g++ -o` truncates in place,
    # which would fault any live process that still has the old .so
    # mapped (rename leaves the old inode alive for them).
    tmp = _OUT + f".tmp.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        "-o", tmp, *_SRCS,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _OUT)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return _OUT


def lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            L = ctypes.CDLL(path)
            L.abtpu_keccak_f1600.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
            L.abtpu_chacha20_blocks.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint64,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint32),
            ]
            L.abtpu_sha3.argtypes = [
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_uint64,
                ctypes.c_uint8,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint64,
            ]
            L.abtpu_cpu_pippenger.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            L.abtpu_cpu_commit_many.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            L.abtpu_cpu_set_curve.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_int,
            ]
            L.abtpu_strobe_append_msgs.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
            ]
            L.abtpu_strobe_rekey_msgs.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
            ]
            L.abtpu_strobe_rand_fp.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            L.abtpu_strobe_rand_fp.restype = ctypes.c_int
            _lib = L
        except Exception:
            _lib = None
        return _lib


def keccak_f1600_native(lanes: list[int]) -> list[int] | None:
    L = lib()
    if L is None:
        return None
    arr = (ctypes.c_uint64 * 25)(*lanes)
    L.abtpu_keccak_f1600(arr)
    return list(arr)


def keccak_f1600_bytes_native(state: bytearray) -> bool:
    """In-place permutation of a 200-byte state, zero marshaling.

    The state IS 25 little-endian u64 lanes, so the C function mutates
    the bytearray's buffer directly — the int<->bytes lane round trip of
    the list API costs ~25 us/perm in Python, which dominated the STROBE
    transcript at ~20k permutations per k=1024 prove (measured 0.45 s of
    pure marshaling). Returns False when the native library is absent.
    """
    L = lib()
    if L is None:
        return False
    buf = (ctypes.c_uint64 * 25).from_buffer(state)
    L.abtpu_keccak_f1600(buf)
    return True


def strobe_append_msgs_native(strobe, label: bytes, msgs: bytes,
                              msg_len: int, count: int) -> bool:
    """Bulk merlin append_message (shared label, equal-size messages),
    bit-exact with the per-call path; mutates the Strobe128 in place.
    Returns False when the native library is absent."""
    L = lib()
    if L is None:
        return False
    meta = (ctypes.c_int32 * 3)(
        strobe.pos, strobe.pos_begin, strobe.cur_flags
    )
    st = (ctypes.c_uint8 * 200).from_buffer(strobe.state)
    L.abtpu_strobe_append_msgs(
        st, meta, label, len(label), msgs, msg_len, count
    )
    strobe.pos = int(meta[0])
    strobe.pos_begin = int(meta[1])
    strobe.cur_flags = int(meta[2])
    return True


def strobe_rekey_msgs_native(strobe, label: bytes, msgs: bytes,
                             msg_len: int, count: int) -> bool:
    """Bulk rekey_with_witness_bytes (shared label, equal-size
    witnesses), bit-exact with the per-call path; mutates the Strobe128
    in place. Returns False when the native library is absent."""
    L = lib()
    if L is None:
        return False
    meta = (ctypes.c_int32 * 3)(
        strobe.pos, strobe.pos_begin, strobe.cur_flags
    )
    st = (ctypes.c_uint8 * 200).from_buffer(strobe.state)
    L.abtpu_strobe_rekey_msgs(
        st, meta, label, len(label), msgs, msg_len, count
    )
    strobe.pos = int(meta[0])
    strobe.pos_begin = int(meta[1])
    strobe.cur_flags = int(meta[2])
    return True


def strobe_rand_fp_native(strobe, p: int, num_bits: int, n_limbs: int,
                          count: int) -> list[int] | None:
    """Bulk arkworks `Fp::rand` driven off a Python Strobe128 object.

    Runs `count` iterations of the exact merlin-TranscriptRng /
    ark-ff sampling loop (n_limbs x [meta-AD(8u32le) + PRF(8)] per
    attempt, top-limb mask, reject >= p) natively, mutating the
    strobe's state/pos/pos_begin/cur_flags in place. Returns the raw
    accepted samples (Montgomery representation, as ints) or None when
    the native library is absent. Bit-exact with the per-call path
    (tests/test_byte_layer.py). Raises ValueError, with the strobe
    untouched, for n_limbs outside [1, 8], which the native loop refuses.
    """
    L = lib()
    if L is None:
        return None
    shave = 64 * n_limbs - num_bits
    mask = 0 if shave == 64 else ((1 << 64) - 1) >> shave
    plimbs = (ctypes.c_uint64 * n_limbs)(
        *[(p >> (64 * i)) & ((1 << 64) - 1) for i in range(n_limbs)]
    )
    meta = (ctypes.c_int32 * 3)(
        strobe.pos, strobe.pos_begin, strobe.cur_flags
    )
    st = (ctypes.c_uint8 * 200).from_buffer(strobe.state)
    out = (ctypes.c_uint64 * (n_limbs * count))()
    if L.abtpu_strobe_rand_fp(st, meta, plimbs, mask, n_limbs, count, out):
        raise ValueError(f"strobe_rand_fp_native: n_limbs={n_limbs} is "
                         f"outside [1, 8]")
    strobe.pos = int(meta[0])
    strobe.pos_begin = int(meta[1])
    strobe.cur_flags = int(meta[2])
    res = []
    for e in range(count):
        v = 0
        for l in range(n_limbs):
            v |= int(out[e * n_limbs + l]) << (64 * l)
        res.append(v)
    return res


def chacha20_blocks_native(key_words, counter0: int, nblocks: int):
    """Returns the 16*nblocks u32 keystream words as a numpy uint32 array,
    or None."""
    L = lib()
    if L is None:
        return None
    import numpy as np

    key = (ctypes.c_uint32 * 8)(*key_words)
    out = np.empty(16 * nblocks, dtype=np.uint32)
    L.abtpu_chacha20_blocks(
        key, counter0, nblocks,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def sha3_native(data: bytes, rate: int, domain: int, out_len: int) -> bytes | None:
    L = lib()
    if L is None:
        return None
    out = (ctypes.c_uint8 * out_len)()
    L.abtpu_sha3(data, len(data), rate, domain, out, out_len)
    return bytes(out)


def cpu_pippenger_marshal(pts, scalars):
    """Pack points/scalars into the raw byte buffers the C++ MSM takes."""
    n = len(pts)
    xs = bytearray(32 * n)
    ys = bytearray(32 * n)
    inf = bytearray(n)
    ss = bytearray(32 * n)
    for i, P in enumerate(pts):
        if P is None:
            inf[i] = 1
        else:
            xs[32 * i:32 * i + 32] = P[0].to_bytes(32, "little")
            ys[32 * i:32 * i + 32] = P[1].to_bytes(32, "little")
    for i, k in enumerate(scalars):
        ss[32 * i:32 * i + 32] = k.to_bytes(32, "little")
    return bytes(xs), bytes(ys), bytes(inf), bytes(ss), n


def cpu_pippenger_raw(xs, ys, inf, ss, n, c: int = 0, curve=None):
    """Run the C++ Pippenger on pre-marshalled buffers → Jacobian ints."""
    L = lib()
    if L is None:
        return None
    if curve is None:
        from . import curves

        curve = curves.secq256k1
    if not set_curve_native(curve):
        return None
    out = (ctypes.c_uint8 * 96)()
    L.abtpu_cpu_pippenger(xs, ys, inf, ss, n, c, out)
    raw = bytes(out)
    return (
        int.from_bytes(raw[:32], "little"),
        int.from_bytes(raw[32:64], "little"),
        int.from_bytes(raw[64:96], "little"),
    )


_active_curve: list = [None]


def set_curve_native(curve) -> bool:
    """Point the native SW-curve layer at `curve` (4x64-limb fq only).

    The C++ field constants default to secq256k1; this recomputes and
    installs (p, R^2, -p^{-1}, R, a*R) for any other curve so zorro (and
    secp256k1) share the native Pippenger/commit paths. Returns False
    when unsupported (TE model or fq wider than 4x64)."""
    L = lib()
    if L is None:
        return False
    if not hasattr(curve, "b") or curve.fq.num_bits > 256:
        return False
    if _active_curve[0] == curve.name:
        return True
    p = curve.fq.p
    R = 1 << 256
    L.abtpu_cpu_set_curve(
        p.to_bytes(32, "little"),
        (R * R % p).to_bytes(32, "little"),
        (-pow(p, -1, 1 << 64)) % (1 << 64),
        (R % p).to_bytes(32, "little"),
        (curve.a * R % p).to_bytes(32, "little"),
        1 if curve.a == 0 else 0,
    )
    _active_curve[0] = curve.name
    return True


def commit_many_native(B, B_blinding, values, blinds, p: int):
    """Batched Pedersen commitments v_i*B + r_i*B~ via the native
    fixed-base window tables. Returns a list of Jacobian (X, Y, Z) int
    tuples, or None when the native library is unavailable."""
    L = lib()
    if L is None:
        return None
    n = len(values)
    xs = B[0].to_bytes(32, "little") + B_blinding[0].to_bytes(32, "little")
    ys = B[1].to_bytes(32, "little") + B_blinding[1].to_bytes(32, "little")
    vs = b"".join((v % p).to_bytes(32, "little") for v in values)
    rs = b"".join((r % p).to_bytes(32, "little") for r in blinds)
    out = (ctypes.c_uint8 * (96 * n))()
    L.abtpu_cpu_commit_many(xs, ys, vs, rs, n, out)
    raw = bytes(out)
    return [
        (
            int.from_bytes(raw[96 * i:96 * i + 32], "little"),
            int.from_bytes(raw[96 * i + 32:96 * i + 64], "little"),
            int.from_bytes(raw[96 * i + 64:96 * i + 96], "little"),
        )
        for i in range(n)
    ]


def cpu_pippenger_native(pts, scalars, c: int = 0, curve=None):
    """Single-core C++ Pippenger (the measured CPU baseline; any curve
    `set_curve_native` accepts — secq256k1 default, zorro, secp256k1).

    `pts`: list of (x, y) affine ints or None for infinity; `scalars`:
    list of ints. Returns the Jacobian result as (X, Y, Z) ints, or None
    when the native library is unavailable.
    """
    if lib() is None:
        return None
    return cpu_pippenger_raw(*cpu_pippenger_marshal(pts, scalars), c=c,
                             curve=curve)
