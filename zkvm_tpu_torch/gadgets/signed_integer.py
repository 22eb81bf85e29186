"""Exact signed integers for witness arithmetic.

Upstream counterpart: slingshot/spacesuit/src/signed_integer.rs — integers
kept exact (no scalar wraparound) until explicitly converted; arithmetic
returns None on overflow out of the representable range, mirroring the
checked ops used by ZkVM's ScalarWitness (SURVEY.md §2.6).
"""

from __future__ import annotations

from ..constants import L

_MAX = (1 << 64) - 1


class SignedInteger:
    """Integer in [-(2^64-1), 2^64-1] with checked arithmetic."""

    __slots__ = ("v",)

    def __init__(self, v: int):
        if not -_MAX <= v <= _MAX:
            raise OverflowError("SignedInteger out of range")
        self.v = int(v)

    @staticmethod
    def checked(v: int) -> "SignedInteger | None":
        try:
            return SignedInteger(v)
        except OverflowError:
            return None

    def checked_add(self, other: "SignedInteger") -> "SignedInteger | None":
        return SignedInteger.checked(self.v + other.v)

    def checked_sub(self, other: "SignedInteger") -> "SignedInteger | None":
        return SignedInteger.checked(self.v - other.v)

    def checked_mul(self, other: "SignedInteger") -> "SignedInteger | None":
        return SignedInteger.checked(self.v * other.v)

    def to_u64(self) -> int | None:
        return self.v if 0 <= self.v <= _MAX else None

    def to_scalar(self) -> int:
        return self.v % L

    def is_negative(self) -> bool:
        return self.v < 0

    def __eq__(self, other):
        if isinstance(other, SignedInteger):
            return self.v == other.v
        if isinstance(other, int):
            return self.v == other
        return NotImplemented

    def __hash__(self):
        return hash(self.v)

    def __repr__(self):
        return f"SignedInteger({self.v})"
