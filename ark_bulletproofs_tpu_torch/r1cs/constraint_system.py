"""Constraint-system interfaces (reference src/r1cs/constraint_system.rs).

The gadget is run twice — once against the Prover (with witness values) and
once against the Verifier (symbolic) — and both must replay identical
transcript operations so Fiat-Shamir challenges agree (reference
constraint_system.rs:10-18).
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class ConstraintSystem(ABC):
    """multiply / allocate / allocate_multiplier / constrain / transcript."""

    @abstractmethod
    def transcript(self): ...

    @abstractmethod
    def multiply(self, left, right): ...

    @abstractmethod
    def allocate(self, assignment=None): ...

    @abstractmethod
    def allocate_multiplier(self, input_assignments=None): ...

    @abstractmethod
    def multipliers_len(self) -> int: ...

    @abstractmethod
    def constrain(self, lc) -> None: ...


class RandomizableConstraintSystem(ConstraintSystem):
    """Supports deferring constraints to the randomized second phase
    (reference constraint_system.rs:84-110)."""

    @abstractmethod
    def specify_randomized_constraints(self, callback) -> None: ...


class RandomizedConstraintSystem(ConstraintSystem):
    """Phase-two view: can squeeze challenge scalars bound to the first-phase
    commitments (reference constraint_system.rs:117-135)."""

    @abstractmethod
    def challenge_scalar(self, label: bytes) -> int: ...
