"""The committed ZkVM transaction fixture (zkvm_tpu_torch/data/
txs_block256.bin) parses in both packages, and its stored txids are the
JAX package's verifier's.

It holds a block of 256 distinct transactions — 192 issue -> cloak ->
output (as the JAX package's bench builds them) and 64 payments of two
issued outputs each into two outputs (apps.accounts.pay_program, a Cloak
2x2) — then one transaction each for taproot `call`, `signid`, `signtag`,
`unblind`, `borrow`/`retire` and `fee` (as tests/test_zkvm_ops.py builds
them, borrow/retire as a valid transaction).

Regenerate it with the JAX package's prover (keys, and the blindings and
nonces its API takes, come from a seed; fused_verify_tx_batch verifies
every transaction on the host before the file is written):
    python tests/test_torch_tx_fixture.py
"""

import os
import random
import sys
from pathlib import Path

if __name__ == "__main__":      # run as a script: import from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens  # noqa: E402
from zkvm_tpu.vm import Tx as JTx
from zkvm_tpu.vm import verify_tx as jverify_tx
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.vm import Tx

SEED = 20261017
HEADER = (1, 0, 10_000)       # TxHeader(version, mintime_ms, maxtime_ms)


def test_tx_fixture_parses_and_holds_the_jax_txids():
    cap, records = fixture.load_txs()
    kinds = [r.kind for r in records]
    assert kinds[:256] == ["issue"] * 192 + ["payment"] * 64
    assert kinds[256:] == list(fixture.TX_KINDS[2:])
    # distinct transactions; txids hash the log alone, which `signid`,
    # `signtag` and `unblind` leave as the header entry
    assert len({r.wire for r in records}) == len(records)
    assert len({r.txid for r in records[:256]}) == 256
    for r in records:
        assert Tx.from_bytes(r.wire).to_bytes() == r.wire
        assert JTx.from_bytes(r.wire).to_bytes() == r.wire
    bp = JBulletproofGens(cap)
    for r in records[:8] + records[256:]:
        assert jverify_tx(JTx.from_bytes(r.wire), bp).id == r.txid


# ---------------------------------------------------------------- generator
def _coverage(rng, bp, header):
    """[(kind, Tx)] for the opcodes the block does not reach."""
    from zkvm_tpu.constants import L
    from zkvm_tpu.crypto.starsig import VerificationKey, sign
    from zkvm_tpu.oracle import scalar as sc
    from zkvm_tpu.oracle.merlin import Transcript
    from zkvm_tpu.vm import Instruction, build_tx
    from zkvm_tpu.vm.constraints import Commitment
    from zkvm_tpu.vm.contract import contract_id
    from zkvm_tpu.vm.encoding import Writer
    from zkvm_tpu.vm.ops import encode_program
    from zkvm_tpu.vm.predicate import Predicate, PredicateTree
    from zkvm_tpu.vm.scalar_witness import ScalarWitness
    from zkvm_tpu.vm.types import ContractItem, String
    from zkvm_tpu.vm.vm import _flavor_scalar

    key = rng.randrange(1, L)
    pred = VerificationKey.from_secret(key).point
    out = []

    # taproot `call`: a contract locked under a tree of two leaves
    leaf = encode_program([Instruction("log")])
    tree = PredicateTree(pred, [leaf, encode_program([Instruction("drop")])])
    out.append(("call", build_tx([
        Instruction("push", data=b"payload-data"),
        Instruction("push", data=tree.predicate().point),
        Instruction("contract", k=1),
        Instruction("program", data=leaf),
        Instruction("push", data=tree.call_proof(0).to_bytes()),
        Instruction("call"),
    ], header, bp)[0]))

    # signid / signtag over the contract the VM makes first (its anchor is
    # the header's anchor seed)
    inner = encode_program([Instruction("drop")])
    w = Writer()
    header.encode(w)
    t = Transcript(b"ZkVM.txid")
    t.append_message(b"anchor-seed", w.to_bytes())
    anchor = t.challenge_bytes(b"anchor", 32)
    cid = contract_id(ContractItem(Predicate(pred), [String(b"the-tag")],
                                   anchor))
    for op, label, msg_label, msg in (
            ("signid", b"ZkVM.signid", b"contract", cid),
            ("signtag", b"ZkVM.signtag", b"tag", b"the-tag")):
        tsig = Transcript(label)
        tsig.append_message(msg_label, msg)
        tsig.append_message(b"prog", inner)
        nonce = (tsig.clone().build_rng()
                 .rekey_with_witness_bytes(b"x", sc.to_bytes(key))
                 .finalize(rng.randbytes(32)))
        out.append((op, build_tx([
            Instruction("push", data=b"the-tag"),
            Instruction("push", data=pred),
            Instruction("contract", k=1),
            Instruction("program", data=inner),
            Instruction("push", data=sign(tsig, key, nonce).to_bytes()),
            Instruction(op),
        ], header, bp)[0]))

    # unblind a commitment with a zero blinding
    com = Commitment.blinded(ScalarWitness.from_integer(777), 0)
    out.append(("unblind", build_tx([
        Instruction("push", data=com.point, witness=com),
        Instruction("push", data=sc.to_bytes(777)),
        Instruction("unblind"),
        Instruction("drop"),
    ], header, bp)[0]))

    # borrow 20 of an issued flavor, retire the borrowed value, and cloak
    # the issued 50 with the borrowed -20 into one output of 30
    meta = b"borrow-meta"
    flavor = _flavor_scalar(pred, meta)

    def blinded(v, integer=True):
        w = (ScalarWitness.from_integer(v) if integer
             else ScalarWitness.from_scalar(v))
        return Commitment.blinded(w, rng.randrange(L))

    issued, bq, bf = blinded(50), blinded(20), blinded(flavor, False)
    oq, of = blinded(30), blinded(flavor, False)
    out.append(("borrow_retire", build_tx([
        Instruction("push", data=pred),
        Instruction("push", data=meta),
        Instruction("push", data=issued.point, witness=issued),
        Instruction("issue"),
        Instruction("signtx"),
        Instruction("push", data=bq.point, witness=bq),
        Instruction("push", data=bf.point, witness=bf),
        Instruction("borrow"),
        Instruction("retire"),
        Instruction("push", data=of.point, witness=of),
        Instruction("push", data=oq.point, witness=oq),
        Instruction("cloak", k=2, n=1),
        Instruction("push", data=pred),
        Instruction("output", k=1),
    ], header, bp, {pred: key})[0]))

    out.append(("fee", build_tx([
        Instruction("push", data=(10).to_bytes(8, "little")),
        Instruction("fee"),
    ], header, bp)[0]))
    return out


def _block(rng, bp, header):
    """192 issues (64 pairs of one token each, then 64 single tokens) and
    64 payments, payment k spending pair k's two outputs."""
    from zkvm_tpu.apps import Token, issue_program
    from zkvm_tpu.apps.accounts import Receiver, Utxo, pay_program
    from zkvm_tpu.constants import L
    from zkvm_tpu.crypto.starsig import VerificationKey
    from zkvm_tpu.vm import build_tx

    issues, payments = [], []
    for k in range(128):
        key = rng.randrange(1, L)
        pred = VerificationKey.from_secret(key).point
        token = Token(pred, b"block-%d" % k)
        utxos = []
        for _ in range(2 if k < 64 else 1):
            qty = 10 + rng.randrange(1000)
            prog, out_q, out_f = issue_program(token, qty, pred)
            tx, vtx = build_tx(prog, header, bp, {pred: key})
            issues.append(("issue", tx))
            utxos.append(Utxo(vtx.outputs[0], out_q, out_f))
        if k < 64:
            total = sum(u.qty.witness[0].to_u64() for u in utxos)
            payee = VerificationKey.from_secret(rng.randrange(1, L)).point
            prog, _, _ = pay_program(utxos, Receiver(payee, total // 2,
                                                     token.flavor))
            payments.append(("payment", build_tx(prog, header, bp,
                                                 {pred: key})[0]))
    return issues + payments


def main():
    os.environ["ZKVM_TX_DEVICE"] = "0"     # verify on the host engine
    os.environ["ZKVM_HOST_PROCS"] = "1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from zkvm_tpu.parallel.tx_batch import fused_verify_tx_batch
    from zkvm_tpu.vm import TxHeader

    rng = random.Random(SEED)
    header = TxHeader(*HEADER)
    bp = JBulletproofGens(512)
    made = _block(rng, bp, header) + _coverage(rng, bp, header)
    txs = [JTx.from_bytes(tx.to_bytes()) for _, tx in made]
    cap = max(_padded_n(tx) for tx in txs)
    verified = fused_verify_tx_batch(txs, JBulletproofGens(cap))
    records = [fixture.TxRecord(kind, tx.to_bytes(), v.id)
               for (kind, _), tx, v in zip(made, txs, verified, strict=True)]
    fixture.dump_txs(fixture.TXS_BLOCK, cap, records)
    print(f"wrote {fixture.TXS_BLOCK}: {len(records)} transactions, "
          f"generator capacity {cap}, "
          f"{fixture.TXS_BLOCK.stat().st_size} bytes")


def _padded_n(tx) -> int:
    """The proof's padded multiplier count, 2^(its IPP rounds)."""
    from zkvm_tpu.proofs.r1cs import R1CSProof as JR1CSProof
    return 1 << len(JR1CSProof.from_bytes(tx.proof).ipp_proof.L_vec)


if __name__ == "__main__":
    main()
