"""Typed stack items with copy/move (linearity) discipline.

Upstream counterpart: slingshot/zkvm/src/types.rs (SURVEY.md §2.6):

  Item      = String | Program | Contract | Value | WideValue | Variable
            | Expression | Constraint
  Copyable  = String, Program               (dup)
  Droppable = String, Program, Variable, Expression, Constraint   (drop)
  Portable  = String, Program, Value        (can live in contract payloads)

Value/WideValue/Contract are linear: they must be consumed exactly once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .constraints import Commitment, Constraint, Expression
from .errors import TypeMismatch, TypeNotCopyable, TypeNotDroppable, TypeNotPortable


@dataclass
class String:
    """Binary string; prover side may carry a structured witness
    (upstream String::Opaque vs witness-bearing variants)."""
    bytes: bytes
    witness: Any = None  # Commitment | ScalarWitness | Predicate | CallProof...

    def copy(self) -> "String":
        return String(self.bytes, self.witness)


@dataclass
class ProgramItem:
    bytecode: bytes

    def copy(self) -> "ProgramItem":
        return ProgramItem(self.bytecode)


@dataclass
class VariableItem:
    """A high-level (committed) variable before conversion to an expression
    (upstream Variable item; `var` pushes it, `expr` converts it)."""
    commitment: Commitment
    r1cs_var: Any = None  # assigned lazily when attached to the CS


@dataclass
class Value:
    """qty and flavor Pedersen commitments — a linear, portable item."""
    qty: Commitment
    flv: Commitment


@dataclass
class WideValue:
    """Unfrozen value: qty/flavor as expressions, possibly negative qty
    (created by `borrow`); linear, NOT portable."""
    qty_expr: Expression
    flv_expr: Expression


@dataclass
class ContractItem:
    predicate: Any          # Predicate (predicate.py)
    payload: list           # list of portable items
    anchor: bytes           # 32 bytes


COPYABLE = (String, ProgramItem)
DROPPABLE = (String, ProgramItem, VariableItem, Expression, Constraint)
PORTABLE = (String, ProgramItem, Value)


def check_copyable(item):
    if not isinstance(item, COPYABLE):
        raise TypeNotCopyable(f"{type(item).__name__} is not copyable")
    return item


def check_droppable(item):
    if not isinstance(item, DROPPABLE):
        raise TypeNotDroppable(f"{type(item).__name__} is not droppable")
    return item


def check_portable(item):
    if not isinstance(item, PORTABLE):
        raise TypeNotPortable(f"{type(item).__name__} is not portable")
    return item


def expect(item, ty, what: str):
    if not isinstance(item, ty):
        raise TypeMismatch(
            f"expected {what}, got {type(item).__name__}"
        )
    return item
