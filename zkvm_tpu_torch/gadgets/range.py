"""In-R1CS n-bit range gadget.

Upstream counterpart: slingshot/spacesuit/src/range_proof.rs — per bit one
multiplier (1-b)*b = 0 with a + b = 1, recomposition constraint at the end.
This is the gadget form of the range check (BASELINE config 3); the standalone
Bulletproofs RangeProof (proofs/rangeproof.py) is the aggregated native form.
"""

from __future__ import annotations

from ..constants import L
from ..proofs.r1cs.lc import LinearCombination, _as_lc


def range_proof_gadget(cs, v, n: int, assignment: int | None = None):
    """Constrain v (an LC) to be an n-bit unsigned integer.

    Prover passes the integer assignment; verifier passes None.
    """
    v = _as_lc(v)
    # accumulate the recomposition terms in one list: building it with
    # repeated `v = v - b*2^i` copies the growing term list every bit
    # (O(n^2) tuples — ~40% of a full-tx VM replay at n=64)
    from ..proofs.r1cs.lc import ONE

    recomp = list(v.terms)
    exp_2 = 1
    minus_one = L - 1
    constrain = cs.constrain
    for i in range(n):
        bit = None if assignment is None else (assignment >> i) & 1
        a, b, o = cs.allocate_multiplier(
            None if bit is None else ((1 - bit) % L, bit)
        )
        # b is a bit: a*b = 0 with a = 1 - b (terms built directly — the
        # operator chain allocates 3 LCs per bit and this is the VM-replay
        # hot loop)
        constrain(LinearCombination([(o, 1)]))
        constrain(LinearCombination([(a, 1), (b, 1), (ONE, minus_one)]))
        recomp.append((b, (-exp_2) % L))
        exp_2 = (exp_2 * 2) % L
    # v == sum b_i 2^i
    constrain(LinearCombination(recomp))
