"""Value types for the Cloak protocol.

Upstream counterpart: slingshot/spacesuit/src/value.rs — Value {q: u64-range
quantity, f: flavor scalar} and AllocatedValue {variables + optional witness}.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..proofs.r1cs.lc import LinearCombination, Variable


@dataclass(frozen=True)
class Value:
    """A cleartext (quantity, flavor) pair."""
    q: int
    f: int

    def is_zero(self) -> bool:
        return self.q == 0 and self.f == 0

    @staticmethod
    def zero() -> "Value":
        return Value(0, 0)


@dataclass
class AllocatedValue:
    """Constraint-system variables for one value (+ prover-side witness)."""
    q: Variable | LinearCombination
    f: Variable | LinearCombination
    assignment: Value | None = None


def allocate_value(cs, v: Value | None) -> AllocatedValue:
    """Allocate (q, f) as one multiplier pair (upstream Value::allocate:
    uses the pending-multiplier slots so two allocations share a multiplier)."""
    q = cs.allocate(None if v is None else v.q)
    f = cs.allocate(None if v is None else v.f)
    return AllocatedValue(q=q, f=f, assignment=v)
