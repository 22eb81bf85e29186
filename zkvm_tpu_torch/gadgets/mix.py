"""Mix gadgets: 2-way move-or-merge and the k-merge chain.

Upstream counterpart: slingshot/spacesuit/src/mix.rs — a single multiplier
enforces (A,B -> C,D) is EITHER a move (C=A, D=B) OR a merge (same flavor,
C=0, D.q=A.q+B.q).  Equations are combined with powers of a transcript
challenge, so the gadget is a randomized (phase-2) constraint.
"""

from __future__ import annotations

from ..constants import L
from ..proofs.r1cs.lc import _as_lc
from .value import AllocatedValue, Value, allocate_value


def mix_gadget(cs, A: AllocatedValue, B: AllocatedValue,
               C: AllocatedValue, D: AllocatedValue):
    """Constrain (A,B) -> (C,D) to be a move or a merge."""

    def randomized(rcs):
        w = rcs.challenge_scalar(b"mix challenge")
        w2 = w * w % L
        w3 = w2 * w % L
        # left == 0  <=>  move: C=A and D=B (q and f each)
        left = (
            (_as_lc(A.q) - C.q)
            + (_as_lc(A.f) - C.f) * w
            + (_as_lc(B.q) - D.q) * w2
            + (_as_lc(B.f) - D.f) * w3
        )
        # right == 0 <=>  merge: C.q=0, A.f=B.f, D.q=A.q+B.q, D.f=A.f
        # (C.f is unconstrained in a merge: C carries zero quantity)
        right = (
            _as_lc(C.q)
            + (_as_lc(A.f) - B.f) * w
            + (_as_lc(D.q) - A.q - B.q) * w2
            + (_as_lc(D.f) - A.f) * w3
        )
        _, _, o = rcs.multiply(left, right)
        rcs.constrain(_as_lc(o))

    cs.specify_randomized_constraints(randomized)


def k_merge_gadget(cs, inputs: list[AllocatedValue]) -> list[AllocatedValue]:
    """Chain of mixes turning a flavor-sorted list into a list where each
    flavor's total sits in one entry and the rest are zero values
    (upstream KMergeGadget).  Returns the merged output list (k entries).

    The prover allocates the intermediate running values; the verifier
    allocates unassigned variables.
    """
    k = len(inputs)
    if k == 0:
        return []
    if k == 1:
        return inputs

    have_witness = all(v.assignment is not None for v in inputs)

    outputs: list[AllocatedValue] = []
    mid = inputs[0]
    for i in range(1, k):
        nxt = inputs[i]
        if have_witness:
            a, b = mid.assignment, nxt.assignment
            if a.f == b.f and not a.is_zero() and not b.is_zero():
                # merge: C = zero, new mid = (a.q+b.q, f)
                c_val = Value.zero()
                d_val = Value((a.q + b.q), a.f)
            else:
                # move: C = a, new mid = b
                c_val = a
                d_val = b
        else:
            c_val = d_val = None
        C = allocate_value(cs, c_val)
        D = allocate_value(cs, d_val)
        mix_gadget(cs, mid, nxt, C, D)
        outputs.append(C)
        mid = D
    outputs.append(mid)
    return outputs
