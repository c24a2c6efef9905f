"""STROBE-128 duplex construction over Keccak-f[1600].

This is the sponge object underlying the Merlin transcript (the reference
uses the `merlin` v3 crate, reference: src/transcript.rs:6). Implemented
from the STROBE v1.0.2 specification (strobe.sourceforge.io) restricted to
the operations Merlin needs: meta-AD, AD, PRF, and KEY.

Security level 128 -> sponge rate R = 200 - 2*(128/8) - 2 = 166 bytes.
"""

from __future__ import annotations

from ..hashes.keccak import keccak_f1600_bytes

STROBE_R = 166

FLAG_I = 1 << 0
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    """Minimal STROBE-128 object with Merlin's operation subset."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes | None = None, _clone: bool = False):
        if _clone:
            return
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600_bytes(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        if protocol_label is not None:
            self.meta_ad(protocol_label, False)

    def clone(self) -> "Strobe128":
        c = Strobe128(_clone=True)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c

    # --- internal sponge plumbing -------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        # Chunked between sponge wraps: one big-int XOR per chunk
        # instead of a Python per-byte loop (the loop measured ~100 ms
        # of a k=1024 shuffle prove across its ~2048 point appends).
        off, n = 0, len(data)
        while off < n:
            take = min(STROBE_R - self.pos, n - off)
            p = self.pos
            seg = int.from_bytes(bytes(self.state[p:p + take]), "little")
            chk = int.from_bytes(data[off:off + take], "little")
            self.state[p:p + take] = (seg ^ chk).to_bytes(take, "little")
            self.pos += take
            off += take
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        off, n = 0, len(data)
        while off < n:
            take = min(STROBE_R - self.pos, n - off)
            self.state[self.pos:self.pos + take] = data[off:off + take]
            self.pos += take
            off += take
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        off = 0
        while off < n:
            take = min(STROBE_R - self.pos, n - off)
            out[off:off + take] = self.state[self.pos:self.pos + take]
            self.state[self.pos:self.pos + take] = bytes(take)
            self.pos += take
            off += take
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("cannot continue operation with different flags")
            return
        if flags & FLAG_T:
            raise ValueError("transport operations are not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # --- Merlin's operation subset ------------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)
