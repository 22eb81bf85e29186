"""Shared constraint-system machinery: flattening and metrics.

Upstream counterpart: bulletproofs/src/r1cs/constraint_system.rs (the
ConstraintSystem / RandomizedConstraintSystem traits and Metrics struct);
the flattening logic lives in both prover.rs and verifier.rs upstream and is
factored out here.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...constants import L
from .lc import LinearCombination


@dataclass
class Metrics:
    """upstream r1cs::Metrics: sizes of the constraint system."""
    multipliers: int
    constraints: int
    phase_one_constraints: int
    phase_two_constraints: int


def flatten_constraints(
    constraints: list[LinearCombination], z: int, n: int, m: int
) -> tuple[list[int], list[int], list[int], list[int], int]:
    """Fold all constraints with powers of z into per-wire weight vectors.

    Returns (wL, wR, wO, wV, wc) such that for an honest witness
    <wL,a_L> + <wR,a_R> + <wO,a_O> - <wV,v> - wc = 0.
    (Signs follow upstream: z^{q+1} weights; committed/constant terms negated.)
    """
    wL = [0] * n
    wR = [0] * n
    wO = [0] * n
    wV = [0] * m
    wc = 0
    exp_z = z % L
    # deferred mod: products stay < 2^512 and additions are cheap; one
    # reduction per wire at the end (constraints are the VM-replay hot loop)
    for lc in constraints:
        for var, coeff in lc.terms:
            w = exp_z * coeff
            if var.kind == "ml":
                wL[var.index] += w
            elif var.kind == "mr":
                wR[var.index] += w
            elif var.kind == "mo":
                wO[var.index] += w
            elif var.kind == "v":
                wV[var.index] -= w
            elif var.kind == "one":
                wc -= w
            else:  # pragma: no cover
                raise ValueError(f"unknown variable kind {var.kind}")
        exp_z = exp_z * z % L
    return ([v % L for v in wL], [v % L for v in wR], [v % L for v in wO],
            [v % L for v in wV], wc % L)
