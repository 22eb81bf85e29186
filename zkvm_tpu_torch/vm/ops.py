"""Instruction set: opcodes, encoding, parsing.

Upstream counterpart: slingshot/zkvm/src/ops.rs (SURVEY.md §2.6).  The exact
upstream opcode byte values cannot be re-verified offline (SURVEY.md §7.3 ⚠);
this table is the canonical assignment for this stack, kept in one place so a
cross-validation sweep against the Rust encoder is a constants-only change.

Wire format: one opcode byte; immediates are LE32 (dup/roll/output/contract
counts, cloak m:n) or LE32-length-prefixed byte strings (push/program).
`alloc` carries an optional prover-side witness that never hits the wire.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .encoding import Reader, Writer
from .errors import FormatError

# opcode byte table (canonical for this stack)
OPCODES = {
    "push": 0x00, "program": 0x01, "drop": 0x02, "dup": 0x03, "roll": 0x04,
    "const": 0x05, "var": 0x06, "alloc": 0x07, "mintime": 0x08,
    "maxtime": 0x09, "expr": 0x0A, "neg": 0x0B, "add": 0x0C, "mul": 0x0D,
    "eq": 0x0E, "range": 0x0F, "and": 0x10, "or": 0x11, "not": 0x12,
    "verify": 0x13, "unblind": 0x14, "issue": 0x15, "borrow": 0x16,
    "retire": 0x17, "cloak": 0x18, "fee": 0x19, "input": 0x1A,
    "output": 0x1B, "contract": 0x1C, "log": 0x1D, "call": 0x1E,
    "signtx": 0x1F, "signid": 0x20, "signtag": 0x21, "ext": 0x22,
}
OPNAMES = {v: k for k, v in OPCODES.items()}

# immediate kinds
_DATA_OPS = {"push", "program"}          # length-prefixed bytes
_U32_OPS = {"dup", "roll", "output", "contract"}
_U32x2_OPS = {"cloak"}                   # m:n


@dataclass
class Instruction:
    op: str
    data: bytes | None = None      # for push/program
    k: int | None = None           # for dup/roll/output/contract, cloak m
    n: int | None = None           # for cloak n
    witness: Any = None            # prover-only payload (push witness, alloc)

    def encode(self, w: Writer):
        if self.op not in OPCODES:
            raise FormatError(f"unknown op {self.op}")
        w.write_u8(OPCODES[self.op])
        if self.op in _DATA_OPS:
            w.write_prefixed_bytes(self.data or b"")
        elif self.op in _U32_OPS:
            w.write_u32(self.k or 0)
        elif self.op in _U32x2_OPS:
            w.write_u32(self.k or 0)
            w.write_u32(self.n or 0)

    @staticmethod
    def parse(r: Reader) -> "Instruction":
        byte = r.read_u8()
        if byte not in OPNAMES:
            raise FormatError(f"unknown opcode byte {byte:#x}")
        op = OPNAMES[byte]
        if op in _DATA_OPS:
            return Instruction(op, data=r.read_prefixed_bytes())
        if op in _U32_OPS:
            return Instruction(op, k=r.read_u32())
        if op in _U32x2_OPS:
            k = r.read_u32()
            n = r.read_u32()
            return Instruction(op, k=k, n=n)
        return Instruction(op)


def encode_program(instructions: list[Instruction]) -> bytes:
    w = Writer()
    for ins in instructions:
        ins.encode(w)
    return w.to_bytes()


def parse_program(data: bytes) -> list[Instruction]:
    r = Reader(data)
    out = []
    while not r.done():
        out.append(Instruction.parse(r))
    return out
