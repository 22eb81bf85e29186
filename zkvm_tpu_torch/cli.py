"""Command-line interface of the port (the role of the upstream actix demo
node, SURVEY.md §2.8), with the JAX package's commands, arguments and JSON
keys.  Every command takes --device: "cuda" runs every group operation on
the card, "cpu" the kernels' plain versions.  Without it the engine comes
from utils.Config.from_env() (ZKVM_TPU_ENGINE, default "cuda";
ZKVM_TPU_MSM_WBITS).  The commands' times go through utils.Timer into the
process's metrics registry.

  python -m zkvm_tpu_torch.cli keygen                      -> secret/predicate pair
  python -m zkvm_tpu_torch.cli issue --key-file k.json ... -> build+verify an issue tx
  python -m zkvm_tpu_torch.cli verify --tx-file tx.bin     -> verify a serialized tx
  python -m zkvm_tpu_torch.cli rangeproof --bits 64 -v 123 -> prove+verify roundtrip
  python -m zkvm_tpu_torch.cli batch-verify --count 32     -> prove, then one batch check
  python -m zkvm_tpu_torch.cli node-demo --blocks 3        -> mine, then cold-sync a peer

The reference's bench-msm runs its own benchmark harness; the port's waits
for the port's benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .utils import Config, Timer, metrics


def _engine(args):
    cfg = Config.from_env()
    if args.device is not None:
        cfg.engine = args.device
    return cfg.make_engine()


def _ms(name: str) -> float:
    """The last time recorded under `name`, in ms to 0.1."""
    return round(metrics.timings_ms[name][-1], 1)


def _cmd_keygen(args):
    from .crypto.starsig import VerificationKey
    from .oracle import scalar as sc
    secret = sc.from_bytes_mod_order_wide(os.urandom(64))
    pred = VerificationKey.from_secret(secret, _engine(args)).point
    print(json.dumps({"secret": hex(secret), "predicate": pred.hex()}))


def _cmd_rangeproof(args):
    from .oracle import scalar as sc
    from .proofs.generators import BulletproofGens, PedersenGens
    from .proofs.rangeproof import RangeProof
    from .proofs.transcript import ProofTranscript

    eng = _engine(args)
    pc, bp = PedersenGens(), BulletproofGens(args.bits)
    blinding = sc.from_bytes_mod_order_wide(os.urandom(64))
    with Timer("rangeproof.prove"):
        proof, V = RangeProof.prove_single(
            bp, pc, ProofTranscript(b"zkvm_tpu.cli"), args.value, blinding,
            args.bits, engine=eng)
    wire = proof.to_bytes()
    with Timer("rangeproof.verify"):
        RangeProof.from_bytes(wire).verify_single(
            bp, pc, ProofTranscript(b"zkvm_tpu.cli"), V, args.bits,
            engine=eng)
    print(json.dumps({
        "bits": args.bits, "proof_bytes": len(wire),
        "prove_ms": _ms("rangeproof.prove"),
        "verify_ms": _ms("rangeproof.verify"),
        "commitment": V.hex(),
    }))


def _cmd_batch_verify(args):
    """Prove a batch of range proofs, then verify them all in ONE combined
    MSM on the engine's fused device path."""
    from .oracle import scalar as sc
    from .proofs.generators import BulletproofGens, PedersenGens
    from .proofs.rangeproof import RangeProof, batch_verify
    from .proofs.transcript import ProofTranscript

    eng = _engine(args)
    pc, bp = PedersenGens(), BulletproofGens(args.bits)
    proofs, transcripts, vcs = [], [], []
    with Timer("batch.prove"):
        for i in range(args.count):
            proof, V = RangeProof.prove_single(
                bp, pc, ProofTranscript(b"zkvm_tpu.cli.batch"),
                (args.value + i) % (1 << args.bits),
                sc.from_bytes_mod_order_wide(os.urandom(64)), args.bits,
                engine=eng)
            proofs.append(proof)
            transcripts.append(ProofTranscript(b"zkvm_tpu.cli.batch"))
            vcs.append([V])
    with Timer("batch.verify"):
        batch_verify(proofs, bp, pc, transcripts, vcs, args.bits, engine=eng)
    t_verify = metrics.timings_ms["batch.verify"][-1] / 1e3
    print(json.dumps({
        "count": args.count, "bits": args.bits,
        "engine": f"{eng.device.type}-fused",
        "prove_ms_total": _ms("batch.prove"),
        "batch_verify_ms": _ms("batch.verify"),
        "verifies_per_sec": round(args.count / t_verify, 1),
    }))


def _cmd_issue(args):
    from .apps import Token, issue_program
    from .proofs.generators import BulletproofGens
    from .vm import Tx, TxHeader, build_tx, verify_tx

    eng = _engine(args)
    with open(args.key_file) as f:
        key = json.load(f)
    secret = int(key["secret"], 16)
    pred = bytes.fromhex(key["predicate"])
    token = Token(pred, args.metadata.encode())
    program, out_qty, out_flv = issue_program(token, args.qty, pred)
    bp = BulletproofGens(1024)
    tx, verified = build_tx(
        program, TxHeader(1, 0, 2**63 - 1), bp, {pred: secret}, engine=eng
    )
    verify_tx(Tx.from_bytes(tx.to_bytes()), bp, engine=eng)
    if args.out:
        with open(args.out, "wb") as f:
            f.write(tx.to_bytes())
    print(json.dumps({
        "txid": verified.id.hex(), "tx_bytes": len(tx.to_bytes()),
        "outputs": len(verified.outputs), "flavor": hex(token.flavor),
    }))


def _cmd_verify(args):
    from .proofs.generators import BulletproofGens
    from .vm import Tx, verify_tx

    eng = _engine(args)
    with open(args.tx_file, "rb") as f:
        tx = Tx.from_bytes(f.read())
    bp = BulletproofGens(1024)
    with Timer("verify_tx"):
        verified = verify_tx(tx, bp, engine=eng)
    print(json.dumps({
        "txid": verified.id.hex(),
        "log": [e.kind for e in verified.log],
        "fee": verified.fee,
        "verify_ms": _ms("verify_tx"),
    }))


def _cmd_node_demo(args):
    """Two-node blockchain demo: A issues a token and mines, then spends it
    block by block, and B cold-syncs over the wire protocol (the role of the
    upstream actix demo node).  Every transaction is built and verified on
    the engine."""
    import random

    from .apps import Token, issue_program
    from .chain import BlockchainState
    from .chain.block import block_id
    from .chain.node import Node, sync
    from .constants import L
    from .crypto.starsig import VerificationKey
    from .oracle import scalar as sc
    from .proofs.generators import BulletproofGens
    from .vm import Instruction, TxHeader, build_tx
    from .vm.constraints import Commitment
    from .vm.contract import parse_contract
    from .vm.types import Value

    eng = _engine(args)
    r = random.Random(args.seed)
    bp = BulletproofGens(1024)
    secret = sc.from_bytes_mod_order_wide(
        r.getrandbits(512).to_bytes(64, "little"))
    pred = VerificationKey.from_secret(secret, eng).point
    header = TxHeader(1, 0, 2**63 - 1)

    a = Node(BlockchainState.make_initial(timestamp_ms=1000), bp, engine=eng)
    b = Node(BlockchainState.make_initial(timestamp_ms=1000), bp, engine=eng)

    token = Token(pred, b"cli-demo")
    prog, out_qty, out_flv = issue_program(token, args.qty, pred)
    tx, v = build_tx(prog, header, bp, {pred: secret}, engine=eng)
    a.submit_tx(tx)
    a.make_block(timestamp_ms=2000)

    out_bytes = v.outputs[0]
    for i in range(args.blocks - 1):
        c = parse_contract(out_bytes)
        c.payload = [Value(out_qty, out_flv)]
        nq = Commitment.blinded(out_qty.ensure_open()[0], r.randrange(L))
        nf = Commitment.blinded(out_flv.ensure_open()[0], r.randrange(L))
        prog2 = [
            Instruction("push", data=out_bytes, witness=c),
            Instruction("input"), Instruction("signtx"),
            Instruction("push", data=nf.point, witness=nf),
            Instruction("push", data=nq.point, witness=nq),
            Instruction("cloak", k=1, n=1),
            Instruction("push", data=pred), Instruction("output", k=1),
        ]
        tx, v = build_tx(prog2, header, bp, {pred: secret}, engine=eng)
        a.submit_tx(tx)
        a.make_block(timestamp_ms=3000 + i)
        out_bytes = v.outputs[0]
        out_qty, out_flv = nq, nf

    rounds = sync(b, a)
    ok = block_id(a.tip) == block_id(b.tip)
    print(json.dumps({
        "height": b.tip.height,
        "sync_rounds": rounds,
        "tips_agree": ok,
        "utxoroot": b.state.utreexo.state_hash().hex(),
        "live_utxos": len(b.utxos.proofs),
    }))
    if not ok:
        sys.exit(1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zkvm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="default: $ZKVM_TPU_ENGINE, else cuda")

    sub.add_parser("keygen", parents=[common]).set_defaults(fn=_cmd_keygen)

    bv = sub.add_parser("batch-verify", parents=[common])
    bv.add_argument("--count", type=int, default=32)
    bv.add_argument("--bits", type=int, default=64)
    bv.add_argument("--value", type=int, default=1234)
    bv.set_defaults(fn=_cmd_batch_verify)

    rp = sub.add_parser("rangeproof", parents=[common])
    rp.add_argument("--bits", type=int, default=64, choices=[8, 16, 32, 64])
    rp.add_argument("-v", "--value", type=int, default=1234567)
    rp.set_defaults(fn=_cmd_rangeproof)

    iss = sub.add_parser("issue", parents=[common])
    iss.add_argument("--key-file", required=True)
    iss.add_argument("--qty", type=int, default=100)
    iss.add_argument("--metadata", default="cli-token")
    iss.add_argument("--out")
    iss.set_defaults(fn=_cmd_issue)

    ver = sub.add_parser("verify", parents=[common])
    ver.add_argument("--tx-file", required=True)
    ver.set_defaults(fn=_cmd_verify)

    nd = sub.add_parser("node-demo", parents=[common])
    nd.add_argument("--blocks", type=int, default=3)
    nd.add_argument("--qty", type=int, default=100)
    nd.add_argument("--seed", type=int, default=7)
    nd.set_defaults(fn=_cmd_node_demo)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
