"""Scalar/vector polynomial utilities (reference src/util.rs).

Host representations use Python ints; the prover offloads the large
elementwise vector work to the device backend when sizes warrant it.
"""

from __future__ import annotations


def exp_iter(field, x: int):
    """Infinite iterator over 1, x, x^2, ... (reference src/util.rs:35-58)."""
    cur = 1
    while True:
        yield cur
        cur = cur * x % field.p


def exp_vec(field, x: int, n: int) -> list[int]:
    out = [0] * n
    cur = 1
    for i in range(n):
        out[i] = cur
        cur = cur * x % field.p
    return out


def inner_product(field, a: list[int], b: list[int]) -> int:
    """<a, b> over the field (reference src/inner_product_proof.rs:390-399)."""
    if len(a) != len(b):
        raise ValueError("inner_product: length mismatch")
    return sum(x * y for x, y in zip(a, b)) % field.p


class VecPoly3:
    """Degree-3 vector polynomial a + b*x + c*x^2 + d*x^3
    (reference src/util.rs:13-18)."""

    __slots__ = ("field", "c0", "c1", "c2", "c3")

    def __init__(self, field, n: int):
        self.field = field
        self.c0 = [0] * n
        self.c1 = [0] * n
        self.c2 = [0] * n
        self.c3 = [0] * n

    @staticmethod
    def special_inner_product(l: "VecPoly3", r: "VecPoly3") -> "Poly6":
        """Inner product exploiting l.c0 == 0 and r.c2 == 0, yielding t1..t6
        (reference src/util.rs:75-93). Note t2 of the commitment is folded
        into the V term; see the prover."""
        f = l.field
        t1 = inner_product(f, l.c1, r.c0)
        t2 = (inner_product(f, l.c1, r.c1) + inner_product(f, l.c2, r.c0)) % f.p
        t3 = (inner_product(f, l.c2, r.c1) + inner_product(f, l.c3, r.c0)) % f.p
        t4 = (inner_product(f, l.c1, r.c3) + inner_product(f, l.c3, r.c1)) % f.p
        t5 = inner_product(f, l.c2, r.c3)
        t6 = inner_product(f, l.c3, r.c3)
        return Poly6(f, t1, t2, t3, t4, t5, t6)

    def eval(self, x: int) -> list[int]:
        p = self.field.p
        return [
            (a + x * (b + x * (c + x * d))) % p
            for a, b, c, d in zip(self.c0, self.c1, self.c2, self.c3)
        ]

    def clear(self) -> None:
        """Best-effort secret hygiene: overwrite coefficient buffers.

        The reference zeroizes witness buffers via clear_on_drop
        (src/util.rs:113-140). Python ints are immutable so true zeroization
        is impossible; we drop references and overwrite the lists, and
        document the limitation (SURVEY.md §5)."""
        for buf in (self.c0, self.c1, self.c2, self.c3):
            for i in range(len(buf)):
                buf[i] = 0


class Poly6:
    """Degree-6 scalar polynomial without constant term
    (reference src/util.rs:23-30)."""

    __slots__ = ("field", "t1", "t2", "t3", "t4", "t5", "t6")

    def __init__(self, field, t1, t2, t3, t4, t5, t6):
        self.field = field
        self.t1, self.t2, self.t3 = t1, t2, t3
        self.t4, self.t5, self.t6 = t4, t5, t6

    def eval(self, x: int) -> int:
        p = self.field.p
        return (
            x * (self.t1 + x * (self.t2 + x * (self.t3 + x * (self.t4 + x * (self.t5 + x * self.t6)))))
        ) % p

    def clear(self) -> None:
        self.t1 = self.t2 = self.t3 = self.t4 = self.t5 = self.t6 = 0


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n; 1 for n == 0 (Rust usize semantics,
    relied on by the prover's padding at reference src/r1cs/prover.rs:574)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
