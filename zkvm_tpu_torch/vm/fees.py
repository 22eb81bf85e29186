"""Fee mechanics (upstream: slingshot/zkvm/src/fees.rs).

FeeRate tracks (fee, size) for mempool ordering; the VM enforces the
protocol-wide maximum so fee arithmetic never overflows.
"""

from __future__ import annotations

from dataclasses import dataclass

from .errors import FeeOverflow

MAX_FEE = 1 << 48  # upstream caps fees well below u64 to keep sums exact


def check_fee(total: int, added: int) -> int:
    new_total = total + added
    if added < 0 or added > MAX_FEE or new_total > MAX_FEE:
        raise FeeOverflow(f"fee overflow: {new_total}")
    return new_total


@dataclass(frozen=True, order=True)
class FeeRate:
    """fee/size ordering without division (compare via cross products)."""
    fee: int
    size: int

    def combine(self, other: "FeeRate") -> "FeeRate":
        return FeeRate(self.fee + other.fee, self.size + other.size)

    def less_than(self, other: "FeeRate") -> bool:
        return self.fee * other.size < other.fee * self.size
