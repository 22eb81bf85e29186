"""Account/receiver helpers (upstream slingshot/accounts/src/lib.rs):
receivers describe expected payments; accounts track spendable utxos (with
their open commitments) and build payment transactions over them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..constants import L
from ..oracle import scalar as sc
from ..vm.constraints import Commitment
from ..vm.contract import parse_contract
from ..vm.ops import Instruction
from ..vm.scalar_witness import ScalarWitness
from ..vm.types import Value


def _rand_scalar() -> int:
    return sc.from_bytes_mod_order_wide(os.urandom(64))


@dataclass
class Receiver:
    """What a payee hands to a payer: predicate + expected (qty, flavor)."""
    predicate: bytes
    qty: int
    flavor: int


@dataclass
class Utxo:
    """A spendable output tracked by the wallet: the serialized contract and
    the open commitments of its single Value payload."""
    output_bytes: bytes
    qty: Commitment
    flv: Commitment

    def contract_with_witness(self):
        c = parse_contract(self.output_bytes)
        c.payload = [Value(self.qty, self.flv)]
        return c


@dataclass
class Account:
    predicate: bytes               # this account's locking predicate
    utxos: list[Utxo] = field(default_factory=list)

    def balance(self, flavor: int) -> int:
        total = 0
        for u in self.utxos:
            v, _ = u.qty.ensure_open()
            fv, _ = u.flv.ensure_open()
            if fv.to_scalar() == flavor % L:
                total += v.to_scalar()
        return total


def pay_program(
    sources: list[Utxo],
    receiver: Receiver,
    change_predicate: bytes | None = None,
) -> tuple[list[Instruction], Utxo, Utxo | None]:
    """Spend `sources` (same flavor), pay `receiver`, return change.

    Returns (program, receiver_utxo_template, change_utxo_template); the
    templates' output_bytes are filled from the verified tx's log by the
    caller (they carry the open commitments needed to spend later).
    """
    total = 0
    flavor = None
    for u in sources:
        v, _ = u.qty.ensure_open()
        f, _ = u.flv.ensure_open()
        total += v.to_scalar()
        if flavor is None:
            flavor = f.to_scalar()
        elif flavor != f.to_scalar():
            raise ValueError("mixed flavors in payment sources")
    if total < receiver.qty:
        raise ValueError("insufficient funds")
    if flavor != receiver.flavor % L:
        raise ValueError("flavor mismatch")
    change = total - receiver.qty

    program: list[Instruction] = []
    for u in sources:
        program.append(
            Instruction("push", data=u.output_bytes,
                        witness=u.contract_with_witness())
        )
        program.append(Instruction("input"))
        program.append(Instruction("signtx"))

    out_qty = Commitment.blinded(
        ScalarWitness.from_integer(receiver.qty), _rand_scalar()
    )
    out_flv = Commitment.blinded(
        ScalarWitness.from_scalar(flavor), _rand_scalar()
    )
    outputs = [(out_flv, out_qty)]
    chg_qty = chg_flv = None
    if change > 0:
        chg_qty = Commitment.blinded(
            ScalarWitness.from_integer(change), _rand_scalar()
        )
        chg_flv = Commitment.blinded(
            ScalarWitness.from_scalar(flavor), _rand_scalar()
        )
        outputs.append((chg_flv, chg_qty))

    for flv, qty in outputs:
        program.append(Instruction("push", data=flv.point, witness=flv))
        program.append(Instruction("push", data=qty.point, witness=qty))
    program.append(Instruction("cloak", k=len(sources), n=len(outputs)))

    # outputs are pushed back in order; lock receiver first, then change
    # stack after cloak: [recv_value, change_value?]; output:1 pops the top,
    # so lock change first (top), then receiver.
    if change > 0:
        if change_predicate is None:
            # default: change returns to the first source's own predicate
            change_predicate = parse_contract(
                sources[0].output_bytes
            ).predicate.point
        program.append(Instruction("push", data=change_predicate))
        program.append(Instruction("output", k=1))
    program.append(Instruction("push", data=receiver.predicate))
    program.append(Instruction("output", k=1))

    recv_utxo = Utxo(b"", out_qty, out_flv)
    chg_utxo = Utxo(b"", chg_qty, chg_flv) if change > 0 else None
    return program, recv_utxo, chg_utxo
