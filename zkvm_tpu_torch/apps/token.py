"""Token issuance helpers (upstream slingshot/token/src/lib.rs):
an asset is identified by its issuer predicate + metadata; `issue_program`
assembles the instruction sequence that mints qty units and locks them to a
recipient predicate.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..oracle import scalar as sc
from ..vm.constraints import Commitment
from ..vm.ops import Instruction
from ..vm.scalar_witness import ScalarWitness
from ..vm.vm import _flavor_scalar


@dataclass
class Token:
    issuer_predicate: bytes  # compressed point
    metadata: bytes

    @property
    def flavor(self) -> int:
        return _flavor_scalar(self.issuer_predicate, self.metadata)


def _rand_scalar() -> int:
    return sc.from_bytes_mod_order_wide(os.urandom(64))


def issue_program(
    token: Token,
    qty: int,
    recipient_predicate: bytes,
) -> tuple[list[Instruction], Commitment, Commitment]:
    """Instructions minting `qty` of `token` into an output locked by
    `recipient_predicate`.  Returns (program, out_qty, out_flv) — the output
    commitments the recipient needs to spend later.
    """
    qty_com = Commitment.blinded(ScalarWitness.from_integer(qty), _rand_scalar())
    out_qty = Commitment.blinded(ScalarWitness.from_integer(qty), _rand_scalar())
    out_flv = Commitment.blinded(
        ScalarWitness.from_scalar(token.flavor), _rand_scalar()
    )
    program = [
        Instruction("push", data=token.issuer_predicate),
        Instruction("push", data=token.metadata),
        Instruction("push", data=qty_com.point, witness=qty_com),
        Instruction("issue"),
        Instruction("signtx"),
        Instruction("push", data=out_flv.point, witness=out_flv),
        Instruction("push", data=out_qty.point, witness=out_qty),
        Instruction("cloak", k=1, n=1),
        Instruction("push", data=recipient_predicate),
        Instruction("output", k=1),
    ]
    return program, out_qty, out_flv
