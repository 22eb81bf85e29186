"""Contracts: predicate-locked bundles of portable items with unique anchors.

Upstream counterpart: slingshot/zkvm/src/contract.rs (SURVEY.md §2.6):
Contract {predicate, payload, anchor}; ContractID = Merlin hash of the
serialized contract; anchors ratchet to guarantee global uniqueness of ids.
"""

from __future__ import annotations

from ..constants import LABEL_ZKVM_CONTRACTID
from ..oracle.merlin import Transcript
from .constraints import Commitment
from .encoding import Reader, Writer
from .errors import FormatError
from .predicate import Predicate
from .types import ContractItem, ProgramItem, String, Value


def serialize_contract(c: ContractItem) -> bytes:
    w = Writer()
    w.write_bytes(c.predicate.to_bytes())
    w.write_bytes(c.anchor)
    w.write_u32(len(c.payload))
    for item in c.payload:
        if isinstance(item, String):
            w.write_u8(0)
            w.write_prefixed_bytes(item.bytes)
        elif isinstance(item, ProgramItem):
            w.write_u8(1)
            w.write_prefixed_bytes(item.bytecode)
        elif isinstance(item, Value):
            w.write_u8(2)
            w.write_bytes(item.qty.point)
            w.write_bytes(item.flv.point)
        else:  # pragma: no cover
            raise FormatError(f"non-portable payload item {type(item).__name__}")
    return w.to_bytes()


def parse_contract(data: bytes) -> ContractItem:
    r = Reader(data)
    predicate = Predicate(r.read_u8x32())
    anchor = r.read_u8x32()
    n = r.read_u32()
    if n > 2**16:
        raise FormatError("payload too large")
    payload = []
    for _ in range(n):
        ty = r.read_u8()
        if ty == 0:
            payload.append(String(r.read_prefixed_bytes()))
        elif ty == 1:
            payload.append(ProgramItem(r.read_prefixed_bytes()))
        elif ty == 2:
            qty = Commitment.closed(r.read_u8x32())
            flv = Commitment.closed(r.read_u8x32())
            payload.append(Value(qty, flv))
        else:
            raise FormatError(f"unknown payload item type {ty}")
    if not r.done():
        raise FormatError("trailing bytes in contract")
    return ContractItem(predicate, payload, anchor)


def contract_id(c: ContractItem) -> bytes:
    t = Transcript(LABEL_ZKVM_CONTRACTID)
    t.append_message(b"contract", serialize_contract(c))
    return t.challenge_bytes(b"id", 32)


def ratchet_anchor(anchor: bytes) -> bytes:
    """Derive the next anchor in the intra-tx chain."""
    t = Transcript(LABEL_ZKVM_CONTRACTID)
    t.append_message(b"ratchet", anchor)
    return t.challenge_bytes(b"anchor", 32)
