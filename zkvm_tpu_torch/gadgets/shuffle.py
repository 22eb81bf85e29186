"""Permutation (shuffle) gadgets.

Upstream counterpart: slingshot/spacesuit/src/shuffle.rs — the scalar
k-shuffle via the randomized product argument prod(x_i - z) == prod(y_i - z),
and the value shuffle that first compresses each (q, f) pair to one scalar
with a challenge weight.
"""

from __future__ import annotations

from ..constants import L
from ..proofs.r1cs.lc import _as_lc
from .value import AllocatedValue


def _product_chain(rcs, terms):
    """Multiplier chain computing prod(terms); returns the output LC."""
    if len(terms) == 1:
        return terms[0]
    _, _, acc = rcs.multiply(terms[0], terms[1])
    for t in terms[2:]:
        _, _, acc = rcs.multiply(_as_lc(acc), t)
    return _as_lc(acc)


def scalar_shuffle_gadget(cs, x, y):
    """Constrain y to be a permutation of x (lists of LCs/variables)."""
    assert len(x) == len(y)
    if len(x) == 0:
        return
    if len(x) == 1:
        cs.constrain(_as_lc(x[0]) - y[0])
        return

    def randomized(rcs):
        z = rcs.challenge_scalar(b"shuffle challenge")
        px = _product_chain(rcs, [_as_lc(xi) - z for xi in x])
        py = _product_chain(rcs, [_as_lc(yi) - z for yi in y])
        rcs.constrain(px - py)

    cs.specify_randomized_constraints(randomized)


def value_shuffle_gadget(cs, x: list[AllocatedValue], y: list[AllocatedValue]):
    """Constrain y to be a permutation of x as (q, f) pairs: compress each
    value to q + w*f with a challenge w, then scalar-shuffle."""
    assert len(x) == len(y)
    if len(x) == 0:
        return
    if len(x) == 1:
        cs.constrain(_as_lc(x[0].q) - y[0].q)
        cs.constrain(_as_lc(x[0].f) - y[0].f)
        return

    def randomized(rcs):
        w = rcs.challenge_scalar(b"value shuffle challenge")
        z = rcs.challenge_scalar(b"value shuffle prod challenge")

        def compress(v):
            # q + w*(q*f): injective on (q, f) for q != 0 under random w,
            # and every zero-quantity value collapses to 0 regardless of
            # flavor — so (0, any_flavor) matches the cloak padding zeros.
            _, _, qf = rcs.multiply(_as_lc(v.q), _as_lc(v.f))
            return _as_lc(v.q) + _as_lc(qf) * w

        cx = [compress(v) for v in x]
        cy = [compress(v) for v in y]
        px = _product_chain(rcs, [c - z for c in cx])
        py = _product_chain(rcs, [c - z for c in cy])
        rcs.constrain(px - py)

    cs.specify_randomized_constraints(randomized)
