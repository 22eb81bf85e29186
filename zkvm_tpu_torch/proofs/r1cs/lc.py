"""Variables and linear combinations over the constraint system.

Upstream counterpart: bulletproofs/src/r1cs/linear_combination.rs —
Variable::{MultiplierLeft, MultiplierRight, MultiplierOutput, Committed, One}
and LinearCombination as Vec<(Variable, Scalar)> with operator overloading.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...constants import L


@dataclass(frozen=True)
class Variable:
    kind: str  # "ml" | "mr" | "mo" | "v" | "one"
    index: int = 0

    # interned instances: gadget loops create the same (kind, index)
    # variables over and over, and frozen-dataclass construction was the
    # single hottest line of a full-tx VM replay.  Value semantics (eq /
    # hash) are unchanged — the caches just reuse instances.
    @staticmethod
    def multiplier_left(i: int) -> "Variable":
        try:
            return _ML_CACHE[i]
        except IndexError:
            _grow(_ML_CACHE, "ml", i)
            return _ML_CACHE[i]

    @staticmethod
    def multiplier_right(i: int) -> "Variable":
        try:
            return _MR_CACHE[i]
        except IndexError:
            _grow(_MR_CACHE, "mr", i)
            return _MR_CACHE[i]

    @staticmethod
    def multiplier_output(i: int) -> "Variable":
        try:
            return _MO_CACHE[i]
        except IndexError:
            _grow(_MO_CACHE, "mo", i)
            return _MO_CACHE[i]

    @staticmethod
    def committed(j: int) -> "Variable":
        try:
            return _V_CACHE[j]
        except IndexError:
            _grow(_V_CACHE, "v", j)
            return _V_CACHE[j]

    # -- arithmetic sugar: promote to LinearCombination ---------------------
    def _lc(self) -> "LinearCombination":
        return LinearCombination([(self, 1)])

    def __add__(self, other):
        return self._lc() + other

    def __radd__(self, other):
        return self._lc() + other

    def __sub__(self, other):
        return self._lc() - other

    def __rsub__(self, other):
        return (-self._lc()) + other

    def __neg__(self):
        return -self._lc()

    def __mul__(self, k):
        return self._lc() * k

    __rmul__ = __mul__


_ML_CACHE: list["Variable"] = []
_MR_CACHE: list["Variable"] = []
_MO_CACHE: list["Variable"] = []
_V_CACHE: list["Variable"] = []


def _grow(cache: list, kind: str, i: int, _chunk: int = 1024) -> None:
    lo = len(cache)
    cache.extend(Variable(kind, j) for j in range(lo, i + _chunk))


ONE = Variable("one", 0)


def _as_lc(x) -> "LinearCombination":
    if isinstance(x, LinearCombination):
        return x
    if isinstance(x, Variable):
        return x._lc()
    if isinstance(x, int):
        return LinearCombination([(ONE, x % L)])
    raise TypeError(f"cannot convert {type(x)} to LinearCombination")


class LinearCombination:
    """Sparse sum of (Variable, scalar) terms."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms: list[tuple[Variable, int]] = list(terms or [])

    def __add__(self, other):
        o = _as_lc(other)
        return LinearCombination(self.terms + o.terms)

    __radd__ = __add__

    def __sub__(self, other):
        o = _as_lc(other)
        return LinearCombination(
            self.terms + [(v, (-c) % L) for v, c in o.terms]
        )

    def __rsub__(self, other):
        return _as_lc(other) - self

    def __neg__(self):
        return LinearCombination([(v, (-c) % L) for v, c in self.terms])

    def __mul__(self, k: int):
        k = int(k) % L
        return LinearCombination([(v, c * k % L) for v, c in self.terms])

    __rmul__ = __mul__

    def __repr__(self):
        return " + ".join(f"{c}*{v.kind}{v.index}" for v, c in self.terms) or "0"
