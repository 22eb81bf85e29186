"""ScalarWitness: exact-integer-until-forced-to-scalar witness arithmetic.

Upstream counterpart: slingshot/zkvm/src/scalar_witness.rs — arithmetic stays
in SignedInteger (overflow-checked) as long as possible so range-related
reasoning stays exact; falls back to scalars mod ℓ on overflow or mixing.
"""

from __future__ import annotations

from ..constants import L
from ..gadgets.signed_integer import SignedInteger
from ..oracle import scalar as sc
from .encoding import Writer


class ScalarWitness:
    """Integer(SignedInteger) | Scalar(int)."""

    __slots__ = ("integer", "scalar")

    def __init__(self, integer: SignedInteger | None = None,
                 scalar: int | None = None):
        assert (integer is None) != (scalar is None)
        self.integer = integer
        self.scalar = scalar

    @staticmethod
    def from_integer(v: int) -> "ScalarWitness":
        si = SignedInteger.checked(v)
        if si is None:
            return ScalarWitness(scalar=v % L)
        return ScalarWitness(integer=si)

    @staticmethod
    def from_scalar(v: int) -> "ScalarWitness":
        return ScalarWitness(scalar=v % L)

    def is_integer(self) -> bool:
        return self.integer is not None

    def to_scalar(self) -> int:
        if self.integer is not None:
            return self.integer.to_scalar()
        return self.scalar

    def to_u64(self) -> int | None:
        """Exact u64 if representable (needed by `range` on open commitments)."""
        if self.integer is None:
            return None
        return self.integer.to_u64()

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other: "ScalarWitness") -> "ScalarWitness":
        if self.integer is not None and other.integer is not None:
            s = self.integer.checked_add(other.integer)
            if s is not None:
                return ScalarWitness(integer=s)
        return ScalarWitness(scalar=(self.to_scalar() + other.to_scalar()) % L)

    def __mul__(self, other: "ScalarWitness") -> "ScalarWitness":
        if self.integer is not None and other.integer is not None:
            s = self.integer.checked_mul(other.integer)
            if s is not None:
                return ScalarWitness(integer=s)
        return ScalarWitness(scalar=self.to_scalar() * other.to_scalar() % L)

    def __neg__(self) -> "ScalarWitness":
        if self.integer is not None:
            s = SignedInteger.checked(-self.integer.v)
            if s is not None:
                return ScalarWitness(integer=s)
        return ScalarWitness(scalar=(-self.to_scalar()) % L)

    def encode(self, w: Writer):
        w.write_bytes(sc.to_bytes(self.to_scalar()))

    def __eq__(self, other):
        if isinstance(other, ScalarWitness):
            return self.to_scalar() == other.to_scalar()
        if isinstance(other, int):
            return self.to_scalar() == other % L
        return NotImplemented

    def __repr__(self):
        if self.integer is not None:
            return f"ScalarWitness(int {self.integer.v})"
        return f"ScalarWitness(scalar {self.scalar})"
