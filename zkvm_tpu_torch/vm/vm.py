"""The ZkVM stack machine.

Upstream counterpart: slingshot/zkvm/src/vm.rs (SURVEY.md §2.6/§3.3): ONE
interpreter serves both prover and verifier via a delegate — the prover's
delegate opens commitments and records witnesses; the verifier's keeps
commitments opaque and accumulates deferred PointOps.  Every instruction is
host-side-cheap; all heavy math exits through the R1CS constraint system and
the deferred point-op batch (the device seams).

The port keeps the interpreter whole: the prover's delegate is in
vm/prover.py, the verifier's in vm/verifier.py.
"""

from __future__ import annotations

from ..constants import L, LABEL_ZKVM_TXID
from ..crypto.starsig import Signature, VerificationKey, verify_op
from ..gadgets.cloak import cloak as cloak_gadget
from ..gadgets.range import range_proof_gadget
from ..gadgets.value import AllocatedValue
from ..gadgets.value import Value as GadgetValue
from ..oracle import scalar as sc
from ..oracle.merlin import Transcript
from ..proofs.r1cs.lc import LinearCombination, ONE, _as_lc
from . import types as T
from .constraints import Commitment, Constraint, Expression
from .contract import (
    contract_id, parse_contract, ratchet_anchor, serialize_contract,
)
from .encoding import Writer
from .errors import (
    AnchorMissing, CommitmentNotOpen, ExtensionsDisabled, FormatError,
    RangeCheckFailure, StackUnderflow, TypeMismatch, VMError,
)
from .fees import check_fee
from .ops import Instruction, parse_program
from .point_ops import PointOp
from .predicate import CallProof, Predicate, taproot_check_op
from .scalar_witness import ScalarWitness
from .tx import TxEntry, TxHeader, tx_id
from .types import (
    ContractItem, ProgramItem, String, Value, VariableItem, WideValue,
)


def _flavor_scalar(predicate_bytes: bytes, metadata: bytes) -> int:
    """Issued-asset flavor = H(issuance predicate, metadata)
    (upstream Value::issue_flavor)."""
    t = Transcript(b"ZkVM.issue")
    t.append_message(b"predicate", predicate_bytes)
    t.append_message(b"metadata", metadata)
    return sc.from_bytes_mod_order_wide(t.challenge_bytes(b"flavor", 64))


class VM:
    """delegate must provide:
    - cs: r1cs Prover or Verifier
    - is_prover: bool
    - commit_variable(commitment: Commitment) -> r1cs Variable
    """

    def __init__(self, header: TxHeader, program: bytes | list[Instruction],
                 delegate):
        header.validate()
        self.header = header
        self.delegate = delegate
        self.cs = delegate.cs
        if isinstance(program, (bytes, bytearray)):
            self.instructions = parse_program(bytes(program))
        else:
            self.instructions = list(program)
        self.stack: list = []
        self.txlog: list[TxEntry] = [TxEntry.header(header)]
        self.signtx_keys: list[bytes] = []  # predicate points to sign txid
        self.point_ops: list[PointOp] = []
        self.total_fee = 0
        # anchor chain seeded from the header (see contract.py docstring)
        w = Writer()
        header.encode(w)
        t = Transcript(LABEL_ZKVM_TXID)
        t.append_message(b"anchor-seed", w.to_bytes())
        self.last_anchor = t.challenge_bytes(b"anchor", 32)

    # ------------------------------------------------------------- stack ops
    def push(self, item):
        self.stack.append(item)

    def pop(self):
        if not self.stack:
            raise StackUnderflow("pop from empty stack")
        return self.stack.pop()

    def pop_expect(self, ty, what):
        return T.expect(self.pop(), ty, what)

    # ----------------------------------------------------------------- run
    def run(self) -> None:
        for ins in self.instructions:
            self.step(ins)

    def finalize_txid(self) -> bytes:
        return tx_id(self.txlog)

    def step(self, ins: Instruction) -> None:
        handler = getattr(self, f"_op_{ins.op}", None)
        if handler is None:
            raise FormatError(f"unimplemented op {ins.op}")
        handler(ins)

    # ------------------------------------------------------------ opcodes
    def _op_push(self, ins):
        self.push(String(ins.data, witness=ins.witness))

    def _op_program(self, ins):
        self.push(ProgramItem(ins.data))

    def _op_drop(self, ins):
        T.check_droppable(self.pop())

    def _op_dup(self, ins):
        k = ins.k or 0
        if k >= len(self.stack):
            raise StackUnderflow(f"dup:{k}")
        item = self.stack[-1 - k]
        T.check_copyable(item)
        self.push(item.copy())

    def _op_roll(self, ins):
        k = ins.k or 0
        if k >= len(self.stack):
            raise StackUnderflow(f"roll:{k}")
        item = self.stack.pop(-1 - k)
        self.push(item)

    def _op_const(self, ins):
        s = self.pop_expect(String, "string (scalar)")
        if len(s.bytes) != 32:
            raise FormatError("const expects a 32-byte scalar")
        v = sc.from_canonical_bytes(s.bytes)
        self.push(Expression(
            LinearCombination([(ONE, v)]), ScalarWitness.from_scalar(v)
        ))

    def _op_var(self, ins):
        s = self.pop_expect(String, "string (commitment)")
        if len(s.bytes) != 32:
            raise FormatError("var expects a 32-byte commitment")
        com = (
            s.witness
            if isinstance(s.witness, Commitment) and s.witness.point == s.bytes
            else Commitment.closed(s.bytes)
        )
        self.push(VariableItem(com))

    def _op_expr(self, ins):
        v = self.pop_expect(VariableItem, "variable")
        self.push(self._variable_to_expression(v))

    def _variable_to_expression(self, v: VariableItem) -> Expression:
        r1cs_var = self.delegate.commit_variable(v.commitment)
        return Expression(_as_lc(r1cs_var), v.commitment.assignment())

    def _op_alloc(self, ins):
        if self.delegate.is_prover:
            if ins.witness is None:
                raise CommitmentNotOpen("alloc requires a prover witness")
            w = ScalarWitness.from_integer(ins.witness) \
                if isinstance(ins.witness, int) else ins.witness
            var = self.cs.allocate(w.to_scalar())
            self.push(Expression(_as_lc(var), w))
        else:
            var = self.cs.allocate(None)
            self.push(Expression(_as_lc(var), None))

    def _op_mintime(self, ins):
        self.push(Expression.constant(self.header.mintime_ms))

    def _op_maxtime(self, ins):
        self.push(Expression.constant(self.header.maxtime_ms))

    def _op_neg(self, ins):
        e = self.pop_expect(Expression, "expression")
        self.push(-e)

    def _op_add(self, ins):
        e2 = self.pop_expect(Expression, "expression")
        e1 = self.pop_expect(Expression, "expression")
        self.push(e1 + e2)

    def _op_mul(self, ins):
        e2 = self.pop_expect(Expression, "expression")
        e1 = self.pop_expect(Expression, "expression")
        self.push(e1.multiply(e2, self.cs))

    def _op_eq(self, ins):
        e2 = self.pop_expect(Expression, "expression")
        e1 = self.pop_expect(Expression, "expression")
        self.push(Constraint.eq(e1, e2))

    def _op_range(self, ins):
        e = self.pop_expect(Expression, "expression")
        assignment = None
        if self.delegate.is_prover:
            if e.assignment is None:
                raise CommitmentNotOpen("range requires an assignment")
            assignment = e.assignment.to_u64()
            if assignment is None:
                raise RangeCheckFailure("value is not a u64")
        range_proof_gadget(self.cs, e.lc, 64, assignment)
        self.push(e)

    def _op_and(self, ins):
        c2 = self.pop_expect(Constraint, "constraint")
        c1 = self.pop_expect(Constraint, "constraint")
        self.push(Constraint.and_(c1, c2))

    def _op_or(self, ins):
        c2 = self.pop_expect(Constraint, "constraint")
        c1 = self.pop_expect(Constraint, "constraint")
        self.push(Constraint.or_(c1, c2))

    def _op_not(self, ins):
        c = self.pop_expect(Constraint, "constraint")
        self.push(Constraint.not_(c))

    def _op_verify(self, ins):
        c = self.pop_expect(Constraint, "constraint")
        c.verify(self.cs)

    def _op_unblind(self, ins):
        v_str = self.pop_expect(String, "string (scalar)")
        V_str = self.pop_expect(String, "string (commitment)")
        v = sc.from_canonical_bytes(v_str.bytes)
        # defer: V - v*B == 0
        self.point_ops.append(PointOp(
            primary=(-v) % L, secondary=None, arbitrary=[(1, V_str.bytes)],
        ))
        self.push(Expression.constant(v))

    # ------------------------------------------------------------ value ops
    def _commitment_from_string(self, s: String) -> Commitment:
        if len(s.bytes) != 32:
            raise FormatError("expected 32-byte commitment")
        if isinstance(s.witness, Commitment) and s.witness.point == s.bytes:
            return s.witness
        return Commitment.closed(s.bytes)

    def _op_issue(self, ins):
        qty_str = self.pop_expect(String, "string (qty commitment)")
        metadata = self.pop_expect(String, "string (metadata)")
        pred_str = self.pop_expect(String, "string (predicate)")

        qty = self._commitment_from_string(qty_str)
        flavor = _flavor_scalar(pred_str.bytes, metadata.bytes)
        flv = Commitment.unblinded(ScalarWitness.from_scalar(flavor))

        value = Value(qty, flv)
        # constrain flavor commitment to the computed constant
        flv_expr = self._variable_to_expression(VariableItem(flv))
        self.cs.constrain(flv_expr.lc - flavor)
        # range check the issued quantity
        qty_expr = self._variable_to_expression(VariableItem(qty))
        assignment = None
        if self.delegate.is_prover:
            assignment = qty.ensure_open()[0].to_u64()
            if assignment is None:
                raise RangeCheckFailure("issued qty is not a u64")
        range_proof_gadget(self.cs, qty_expr.lc, 64, assignment)

        self.txlog.append(TxEntry.issue(qty.point, flv.point))
        contract = ContractItem(
            predicate=Predicate(pred_str.bytes),
            payload=[value],
            anchor=self._take_anchor(),
        )
        self.push(contract)

    def _op_borrow(self, ins):
        flv_str = self.pop_expect(String, "string (flavor commitment)")
        qty_str = self.pop_expect(String, "string (qty commitment)")
        qty = self._commitment_from_string(qty_str)
        flv = self._commitment_from_string(flv_str)
        qty_expr = self._variable_to_expression(VariableItem(qty))
        flv_expr = self._variable_to_expression(VariableItem(flv))
        assignment = None
        if self.delegate.is_prover:
            assignment = qty.ensure_open()[0].to_u64()
            if assignment is None:
                raise RangeCheckFailure("borrowed qty is not a u64")
        range_proof_gadget(self.cs, qty_expr.lc, 64, assignment)
        neg_wide = WideValue(qty_expr=-qty_expr, flv_expr=flv_expr)
        self.push(neg_wide)
        self.push(Value(qty, flv))

    def _op_retire(self, ins):
        v = self.pop_expect(Value, "value")
        self.txlog.append(TxEntry.retire(v.qty.point, v.flv.point))

    def _op_fee(self, ins):
        s = self.pop_expect(String, "string (fee amount)")
        if len(s.bytes) != 8:
            raise FormatError("fee expects an 8-byte LE amount")
        amount = int.from_bytes(s.bytes, "little")
        self.total_fee = check_fee(self.total_fee, amount)
        self.txlog.append(TxEntry.fee(amount))

    def _op_cloak(self, ins):
        m, n = ins.k or 0, ins.n or 0
        # pop n output (flv, qty) commitment pairs (top: last output's qty)
        out_pairs = []
        for _ in range(n):
            qty_str = self.pop_expect(String, "string (qty commitment)")
            flv_str = self.pop_expect(String, "string (flavor commitment)")
            out_pairs.append((
                self._commitment_from_string(qty_str),
                self._commitment_from_string(flv_str),
            ))
        out_pairs.reverse()
        # pop m input values (Value or WideValue)
        inputs = []
        for _ in range(m):
            item = self.pop()
            if not isinstance(item, (Value, WideValue)):
                raise TypeMismatch("cloak inputs must be values")
            inputs.append(item)
        inputs.reverse()

        in_alloc = [self._value_to_allocated(v) for v in inputs]
        out_values = []
        out_alloc = []
        for qty, flv in out_pairs:
            val = Value(qty, flv)
            out_values.append(val)
            out_alloc.append(self._value_to_allocated(val))
        # range checks happen inside the cloak gadget for outputs
        cloak_gadget(self.cs, in_alloc, out_alloc, range_bits=64)
        for val in out_values:
            self.push(val)

    def _value_to_allocated(self, v) -> AllocatedValue:
        if isinstance(v, Value):
            qty_expr = self._variable_to_expression(VariableItem(v.qty))
            flv_expr = self._variable_to_expression(VariableItem(v.flv))
        else:  # WideValue
            qty_expr, flv_expr = v.qty_expr, v.flv_expr
        assignment = None
        if self.delegate.is_prover:
            if qty_expr.assignment is None or flv_expr.assignment is None:
                raise CommitmentNotOpen("cloak requires open commitments")
            q = qty_expr.assignment.to_scalar()
            # negative borrow quantities are exact signed integers
            if qty_expr.assignment.is_integer():
                q = qty_expr.assignment.integer.v
            assignment = GadgetValue(q, flv_expr.assignment.to_scalar())
        return AllocatedValue(
            q=qty_expr.lc, f=flv_expr.lc, assignment=assignment
        )

    # -------------------------------------------------------- contract ops
    def _take_anchor(self) -> bytes:
        if self.last_anchor is None:
            raise AnchorMissing("no anchor available")
        anchor = self.last_anchor
        self.last_anchor = ratchet_anchor(anchor)
        return anchor

    def _op_input(self, ins):
        s = self.pop_expect(String, "string (serialized contract)")
        contract = parse_contract(s.bytes)
        cid = contract_id(contract)
        self.txlog.append(TxEntry.input_(cid))
        self.last_anchor = ratchet_anchor(cid)
        # re-anchor the contract object with its id for downstream unlocking
        contract.anchor = cid
        # prover may carry payload witnesses for the parsed contract
        if isinstance(s.witness, ContractItem):
            contract = s.witness
            contract.anchor = cid
        self.push(contract)

    def _op_output(self, ins):
        contract = self._build_contract(ins.k or 0)
        self.txlog.append(TxEntry.output(serialize_contract(contract)))

    def _op_contract(self, ins):
        self.push(self._build_contract(ins.k or 0))

    def _build_contract(self, k: int) -> ContractItem:
        pred_str = self.pop_expect(String, "string (predicate)")
        if len(pred_str.bytes) != 32:
            raise FormatError("predicate must be 32 bytes")
        payload = []
        for _ in range(k):
            payload.append(T.check_portable(self.pop()))
        payload.reverse()
        return ContractItem(
            predicate=Predicate(pred_str.bytes),
            payload=payload,
            anchor=self._take_anchor(),
        )

    def _op_log(self, ins):
        s = self.pop_expect(String, "string")
        self.txlog.append(TxEntry.data(s.bytes))

    def _op_call(self, ins):
        proof_str = self.pop_expect(String, "string (call proof)")
        prog = self.pop_expect(ProgramItem, "program")
        contract = self.pop_expect(ContractItem, "contract")
        proof = (
            proof_str.witness
            if isinstance(proof_str.witness, CallProof)
            else CallProof.from_bytes(proof_str.bytes)
        )
        self.point_ops.append(
            taproot_check_op(contract.predicate, prog.bytecode, proof)
        )
        for item in contract.payload:
            self.push(item)
        for sub in parse_program(prog.bytecode):
            self.step(sub)

    def _op_signtx(self, ins):
        contract = self.pop_expect(ContractItem, "contract")
        self.signtx_keys.append(contract.predicate.point)
        for item in contract.payload:
            self.push(item)

    def _op_signid(self, ins):
        self._sign_individual(use_tag=False)

    def _op_signtag(self, ins):
        self._sign_individual(use_tag=True)

    def _sign_individual(self, use_tag: bool):
        """signid/signtag: verify a standalone schnorr signature by the
        contract predicate over the contract id (signid) or over the tag —
        the last payload String (signtag)."""
        sig_str = self.pop_expect(String, "string (signature)")
        prog = self.pop_expect(ProgramItem, "program")
        contract = self.pop_expect(ContractItem, "contract")
        cid = contract_id(contract)
        if use_tag:
            if not contract.payload or not isinstance(contract.payload[-1], String):
                raise TypeMismatch("signtag requires a tag string in payload")
            msg_label, msg = b"tag", contract.payload[-1].bytes
        else:
            msg_label, msg = b"contract", cid
        t = Transcript(b"ZkVM.signid" if not use_tag else b"ZkVM.signtag")
        t.append_message(msg_label, msg)
        t.append_message(b"prog", prog.bytecode)
        sig = Signature.from_bytes(sig_str.bytes)
        self.point_ops.append(
            verify_op(sig, t, VerificationKey(contract.predicate.point))
        )
        for item in contract.payload:
            self.push(item)
        for sub in parse_program(prog.bytecode):
            self.step(sub)

    def _op_ext(self, ins):
        if self.header.version == 1:
            raise ExtensionsDisabled("ext is disabled in version 1")
        # future extension: no-op

    # ------------------------------------------------------------- checks
    def check_stack_clean(self):
        if self.stack:
            raise VMError(
                f"stack not empty at end of program: {len(self.stack)} items"
            )
