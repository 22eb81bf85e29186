"""Shared constraint-system machinery: flattening and metrics.

Upstream counterpart: bulletproofs/src/r1cs/constraint_system.rs (the
ConstraintSystem / RandomizedConstraintSystem traits and Metrics struct);
the flattening logic lives in both prover.rs and verifier.rs upstream and is
factored out here.
"""

from __future__ import annotations

import ctypes
from array import array
from dataclasses import dataclass

from ... import native
from ...constants import L
from ..scalarvec import ScalarVec
from .lc import LinearCombination


@dataclass
class Metrics:
    """upstream r1cs::Metrics: sizes of the constraint system."""
    multipliers: int
    constraints: int
    phase_one_constraints: int
    phase_two_constraints: int


_KIND_ID = {"ml": 0, "mr": 1, "mo": 2, "v": 3, "one": 4}


def flatten_constraints_vec(constraints: list[LinearCombination], z: int,
                            n: int, m: int, pad: int = 0):
    """flatten_constraints in one native call (scalarvec.cpp scl_flatten):
    -> (wL, wR, wO as ScalarVecs of length n + pad, the pad zero, wV a
    list of m ints, wc).  Each term goes to the library as (constraint,
    kind, index, coefficient); a kind byte's bit 7 marks a negated
    coefficient and bit 6 one of 64 bits or more, passed as a 32-byte
    scalar."""
    terms = [(q, var, coeff) for q, lc in enumerate(constraints)
             for var, coeff in lc.terms]
    qs = array("i", [t[0] for t in terms])
    idxs = array("i", [t[1].index for t in terms])
    kinds = bytearray()
    c64 = array("Q")
    big = bytearray()
    for _, var, coeff in terms:
        k = _KIND_ID[var.kind]
        c = int(coeff)
        if c < 0:
            k |= 0x80
            c = -c
        if c >> 64:
            k |= 0x40
            big += (c % L).to_bytes(32, "little")
            c = 0
        kinds.append(k)
        c64.append(c)
    width = n + pad
    outs = [ctypes.create_string_buffer(max(32 * width, 1)) for _ in range(3)]
    out_v = ctypes.create_string_buffer(max(32 * m, 1))
    out_c = ctypes.create_string_buffer(32)
    native.lib().scl_flatten(
        qs.tobytes(), bytes(kinds), idxs.tobytes(), c64.tobytes(), bytes(big),
        len(qs), (int(z) % L).to_bytes(32, "little"), n, m, *outs, out_v,
        out_c)
    raw_v = out_v.raw
    wV = [int.from_bytes(raw_v[32 * j: 32 * j + 32], "little")
          for j in range(m)]
    wL, wR, wO = (ScalarVec(o.raw[:32 * width], width) for o in outs)
    return wL, wR, wO, wV, int.from_bytes(out_c.raw, "little")


def flatten_constraints(
    constraints: list[LinearCombination], z: int, n: int, m: int
) -> tuple[list[int], list[int], list[int], list[int], int]:
    """flatten_constraints_vec's pure-Python twin: fold all constraints
    with powers of z into per-wire weight vectors.

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
