"""The Cloak gadget: constrain a k-in/k-out confidential value transfer.

Upstream counterpart: slingshot/spacesuit/src/cloak.rs (SURVEY.md §3.5):

    inputs --shuffle--> sorted --k_merge--> merged
                                              \\
                                        value shuffle
                                              //
   outputs --shuffle--> sorted' --k_merge--> merged'

Merging each side by flavor reduces conservation-per-flavor to "merged is a
permutation of merged'"; every output quantity is 64-bit range checked.
This produces the bulk of R1CS multipliers in a real transaction (~64 per
output).
"""

from __future__ import annotations

from ..proofs.r1cs.lc import _as_lc
from .mix import k_merge_gadget
from .range import range_proof_gadget
from .shuffle import value_shuffle_gadget
from .value import AllocatedValue, Value, allocate_value


def _pad_to(cs, values: list[AllocatedValue], k: int) -> list[AllocatedValue]:
    have_witness = all(v.assignment is not None for v in values)
    out = list(values)
    while len(out) < k:
        zv = allocate_value(cs, Value.zero() if have_witness else None)
        # padding must be an actual zero value
        cs.constrain(_as_lc(zv.q))
        cs.constrain(_as_lc(zv.f))
        out.append(zv)
    return out


def _sorted_copy(cs, values: list[AllocatedValue]) -> list[AllocatedValue]:
    """Allocate a flavor-sorted permutation of `values` and constrain it to
    be a permutation via a value shuffle."""
    have_witness = all(v.assignment is not None for v in values)
    if have_witness:
        ordered = sorted(
            (v.assignment for v in values), key=lambda x: (x.f, x.q)
        )
        alloc = [allocate_value(cs, v) for v in ordered]
    else:
        alloc = [allocate_value(cs, None) for _ in values]
    value_shuffle_gadget(cs, values, alloc)
    return alloc


def cloak(cs, inputs: list[AllocatedValue], outputs: list[AllocatedValue],
          range_bits: int = 64):
    """Constrain: outputs are a per-flavor-conserving rearrangement of inputs,
    with every output quantity range-checked to `range_bits` bits."""
    if not inputs or not outputs:
        raise ValueError("cloak requires at least one input and one output")
    k = max(len(inputs), len(outputs))

    # range checks on the declared outputs (before padding)
    for o in outputs:
        assignment = None if o.assignment is None else o.assignment.q
        range_proof_gadget(cs, _as_lc(o.q), range_bits, assignment)

    ins = _pad_to(cs, inputs, k)
    outs = _pad_to(cs, outputs, k)

    merged_in = k_merge_gadget(cs, _sorted_copy(cs, ins))
    merged_out = k_merge_gadget(cs, _sorted_copy(cs, outs))
    value_shuffle_gadget(cs, merged_in, merged_out)
