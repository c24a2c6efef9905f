"""Variables and linear combinations with operator overloading.

API parity with reference src/r1cs/linear_combination.rs. Coefficients are
field elements of the constraint system's scalar field; a `Variable` is
tagged with its field so `x - z` and `3 * x` read like the Rust API.
"""

from __future__ import annotations


class Variable:
    """A wire in the constraint system (reference linear_combination.rs:14-27)."""

    COMMITTED = "committed"
    MUL_LEFT = "ml"
    MUL_RIGHT = "mr"
    MUL_OUT = "mo"
    ONE = "one"

    __slots__ = ("kind", "index", "field")

    def __init__(self, kind: str, index: int, field):
        self.kind = kind
        self.index = index
        self.field = field

    def __repr__(self):
        return f"Variable({self.kind}, {self.index})"

    def __eq__(self, other):
        return (
            isinstance(other, Variable)
            and self.kind == other.kind
            and self.index == other.index
        )

    def __hash__(self):
        return hash((self.kind, self.index))

    # -- promotion to LinearCombination ---------------------------------

    def lc(self) -> "LinearCombination":
        return LinearCombination(self.field, [(self, 1)])

    def __add__(self, other):
        return self.lc() + other

    def __radd__(self, other):
        return self.lc() + other

    def __sub__(self, other):
        return self.lc() - other

    def __rsub__(self, other):
        return -(self.lc() - other)

    def __neg__(self):
        return -self.lc()

    def __mul__(self, scalar: int):
        return LinearCombination(self.field, [(self, scalar % self.field.p)])

    def __rmul__(self, scalar: int):
        return self.__mul__(scalar)


class LinearCombination:
    """Sum of (Variable, coefficient) terms. Terms are kept as appended
    (duplicates allowed); flattening accumulates them, matching the
    reference's representation (linear_combination.rs:85-87)."""

    __slots__ = ("field", "terms")

    def __init__(self, field, terms=None):
        self.field = field
        self.terms: list[tuple[Variable, int]] = list(terms) if terms else []

    @classmethod
    def from_value(cls, field, value) -> "LinearCombination":
        if isinstance(value, LinearCombination):
            return value
        if isinstance(value, Variable):
            return value.lc()
        return cls(field, [(Variable(Variable.ONE, 0, field), int(value) % field.p)])

    def _coerce(self, other) -> "LinearCombination":
        return LinearCombination.from_value(self.field, other)

    def __add__(self, other):
        o = self._coerce(other)
        return LinearCombination(self.field, self.terms + o.terms)

    def __radd__(self, other):
        return self._coerce(other) + self

    def __sub__(self, other):
        o = self._coerce(other)
        p = self.field.p
        return LinearCombination(
            self.field, self.terms + [(v, (p - c) % p) for v, c in o.terms]
        )

    def __rsub__(self, other):
        return self._coerce(other) - self

    def __neg__(self):
        p = self.field.p
        return LinearCombination(self.field, [(v, (p - c) % p) for v, c in self.terms])

    def __mul__(self, scalar: int):
        s = int(scalar) % self.field.p
        return LinearCombination(self.field, [(v, c * s % self.field.p) for v, c in self.terms])

    def __rmul__(self, scalar: int):
        return self.__mul__(scalar)

    def __repr__(self):
        return f"LinearCombination({self.terms})"
