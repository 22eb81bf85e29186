"""Commitments, Expressions, and Constraints — the VM's bridge into R1CS.

Upstream counterpart: slingshot/zkvm/src/constraints.rs (SURVEY.md §2.6):
- Commitment: a Pedersen commitment, opaque (verifier) or open (prover);
- Expression: a linear combination over R1CS variables with a ScalarWitness
  assignment on the prover side;
- Constraint: a boolean tree (eq/and/or/not) over expressions, flattened into
  the constraint system with challenge-mixed composition on `verify`.

The port keeps the prover-side fields (witnesses, assignments) so that the
VM's one interpreter reads as the JAX package's; its verifier delegate
leaves them empty.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..constants import L
from ..oracle import scalar as sc
from ..proofs.generators import PedersenGens
from ..proofs.r1cs.lc import ONE, LinearCombination, _as_lc
from .errors import CommitmentNotOpen, TypeMismatch
from .scalar_witness import ScalarWitness


@dataclass
class Commitment:
    """Closed: just the compressed point.  Open: value + blinding as well."""
    point: bytes
    witness: tuple[ScalarWitness, int] | None = None  # (value, blinding)

    @staticmethod
    def blinded(value: ScalarWitness,
                blinding: int | None = None) -> "Commitment":
        """value*B + blinding*B_blinding on the host (the oracle's point
        arithmetic; the VM opens one per `issue`, its flavor's), with a
        random blinding from os.urandom when none is given."""
        if blinding is None:
            blinding = sc.from_bytes_mod_order_wide(os.urandom(64))
        pc = PedersenGens()
        pt = pc.commit(value.to_scalar(), blinding).compress()
        return Commitment(pt, witness=(value, blinding))

    @staticmethod
    def unblinded(value: ScalarWitness) -> "Commitment":
        return Commitment.blinded(value, 0)

    @staticmethod
    def closed(point: bytes) -> "Commitment":
        return Commitment(point, None)

    def assignment(self) -> ScalarWitness | None:
        return None if self.witness is None else self.witness[0]

    def ensure_open(self) -> tuple[ScalarWitness, int]:
        if self.witness is None:
            raise CommitmentNotOpen("commitment has no witness")
        return self.witness

    def to_bytes(self) -> bytes:
        return self.point


@dataclass
class Expression:
    """Linear combination over CS variables, with optional witness value."""
    lc: LinearCombination
    assignment: ScalarWitness | None = None

    @staticmethod
    def constant(k: int) -> "Expression":
        return Expression(
            LinearCombination([(ONE, k % L)]),
            ScalarWitness.from_integer(k),
        )

    def __add__(self, other: "Expression") -> "Expression":
        a = None
        if self.assignment is not None and other.assignment is not None:
            a = self.assignment + other.assignment
        return Expression(self.lc + other.lc, a)

    def __sub__(self, other: "Expression") -> "Expression":
        return self + (-other)

    def __neg__(self) -> "Expression":
        a = None if self.assignment is None else -self.assignment
        return Expression(-self.lc, a)

    def multiply(self, other: "Expression", cs) -> "Expression":
        """Introduce a multiplier constraint l*r=o (the `mul` opcode)."""
        _, _, o = cs.multiply(self.lc, other.lc)
        a = None
        if self.assignment is not None and other.assignment is not None:
            a = self.assignment * other.assignment
        return Expression(_as_lc(o), a)


@dataclass
class Constraint:
    """eq(e1,e2) | and(c1,c2) | or(c1,c2) | not(c)."""
    kind: str
    exprs: list[Expression] = field(default_factory=list)
    subs: list["Constraint"] = field(default_factory=list)

    @staticmethod
    def eq(e1: Expression, e2: Expression) -> "Constraint":
        return Constraint("eq", exprs=[e1, e2])

    @staticmethod
    def and_(c1: "Constraint", c2: "Constraint") -> "Constraint":
        return Constraint("and", subs=[c1, c2])

    @staticmethod
    def or_(c1: "Constraint", c2: "Constraint") -> "Constraint":
        return Constraint("or", subs=[c1, c2])

    @staticmethod
    def not_(c: "Constraint") -> "Constraint":
        return Constraint("not", subs=[c])

    # -- verification -------------------------------------------------------
    def verify(self, cs):
        """Add this constraint tree to the CS (the `verify` opcode).

        Flattening happens in the randomized phase: `and` mixes sub-
        expressions with a challenge, `or` multiplies them, `not` proves
        non-zeroness with an inverse witness (upstream constraints.rs).
        """
        tree = self

        def randomized(rcs):
            expr = tree._flatten(rcs)
            rcs.constrain(expr.lc)

        cs.specify_randomized_constraints(randomized)

    def _flatten(self, rcs) -> Expression:
        """Produce an expression that is 0 iff the constraint holds."""
        if self.kind == "eq":
            return self.exprs[0] - self.exprs[1]
        if self.kind == "and":
            f1 = self.subs[0]._flatten(rcs)
            f2 = self.subs[1]._flatten(rcs)
            w = rcs.challenge_scalar(b"and challenge")
            a = None
            if f1.assignment is not None and f2.assignment is not None:
                a = ScalarWitness.from_scalar(
                    (f1.assignment.to_scalar() + w * f2.assignment.to_scalar()) % L
                )
            return Expression(f1.lc + f2.lc * w, a)
        if self.kind == "or":
            f1 = self.subs[0]._flatten(rcs)
            f2 = self.subs[1]._flatten(rcs)
            return f1.multiply(f2, rcs)
        if self.kind == "not":
            f = self.subs[0]._flatten(rcs)
            # prove f != 0: witness w with f*w = 1
            if f.assignment is not None:
                fv = f.assignment.to_scalar()
                wv = sc.invert(fv) if fv != 0 else 0
                w_var = rcs.allocate(wv)
            else:
                w_var = rcs.allocate(None)
            _, _, o = rcs.multiply(f.lc, _as_lc(w_var))
            # o must equal 1; the flattened expr is (o - 1)
            return Expression(
                _as_lc(o) - 1,
                None if f.assignment is None else ScalarWitness.from_integer(0),
            )
        raise TypeMismatch(f"unknown constraint kind {self.kind}")
