"""The committed keys and MPC fixture (zkvm_tpu_torch/data/
keys_mpc_seeded.bin) holds the JAX package's keytree derivations,
PredicateTree values, taproot `call` transaction and multi-host MPC
commitments, which chip_smoke.py holds the card's against.

It holds (fixture.py's KeysMpcFixture has the layout): two keytree cases
(Xprv.random of a seed, a child by account); two PredicateTrees (a key
over two leaves, another over three); the taproot `call` transaction that
opens the first tree's leaf 0 (the JAX build_tx's wire, txid, fee and
log); and 4 hosts x 8 parties of 64-bit values with their blindings and
the JAX package's value commitments, with the party positions its dealer
names when host 1 corrupts its first share.  The values, blindings and
keys come from a seed.

The test re-makes the small cases with the JAX package and the MPC case's
commitments.  Regenerate the file with the JAX package (it verifies the
transaction and the distributed proof before the file is written):
    python tests/test_torch_keys_mpc_fixture.py
"""

import random
import sys
from pathlib import Path

if __name__ == "__main__":      # run as a script: import from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from zkvm_tpu.constants import L  # noqa: E402
from zkvm_tpu.crypto.keytree import Xprv as JXprv
from zkvm_tpu.crypto.starsig import VerificationKey as JVerificationKey
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.vm import Instruction as JInstruction
from zkvm_tpu.vm import Tx as JTx
from zkvm_tpu.vm import build_tx as jbuild_tx
from zkvm_tpu.vm import verify_tx as jverify_tx
from zkvm_tpu.vm.ops import encode_program as jencode_program
from zkvm_tpu.vm.predicate import PredicateTree as JPredicateTree
from zkvm_tpu.vm.tx import TxHeader as JTxHeader
from zkvm_tpu_torch import fixture

SEED = 20261018
HEADER = (1, 0, 10_000)
CALL_CAPACITY = 16            # BulletproofGens capacity of the call tx
MPC_LABEL = b"zkvm_tpu_torch mpc hosts"
MPC_HOSTS, MPC_PARTIES, MPC_N = 4, 8, 64
CORRUPT_HOST = 1


def _keytree_cases() -> list[fixture.KeytreeCase]:
    r = random.Random(SEED)
    out = []
    for seed, account in ((b"\x42" * 64, 7), (r.randbytes(64), 1 << 40)):
        xprv = JXprv.random(seed)
        xpub = xprv.to_xpub()

        def sel(t, a=account):
            t.append_u64(b"account", a)
        child = xprv.derive_key(sel)
        out.append(fixture.KeytreeCase(
            seed, account, xprv.scalar_key, xprv.dk, xpub.point,
            child.scalar_key, child.dk, xpub.derive_key(sel).point))
    return out


def _leaves(k: int) -> list[bytes]:
    ops = [[JInstruction("log")], [JInstruction("drop")],
           [JInstruction("drop"), JInstruction("drop")]]
    return [jencode_program(p) for p in ops[:k]]


def _predicate_cases() -> list[fixture.PredicateCase]:
    r = random.Random(SEED + 1)
    out = []
    for k in (2, 3):
        key = JVerificationKey.from_secret(r.randrange(1, L)).point
        tree = JPredicateTree(key, _leaves(k))
        out.append(fixture.PredicateCase(
            key, tree.progs, tree.adjustment_factor(),
            tree.predicate().point,
            [tree.call_proof(i).to_bytes() for i in range(k)]))
    return out


def _call_case(preds) -> fixture.CallTxCase:
    c = preds[0]
    payload = b"payload-data"
    program = fixture.taproot_call_program(
        JInstruction, c.predicate, c.progs[0], c.call_proofs[0], payload)
    tx, vtx = jbuild_tx(program, JTxHeader(*HEADER),
                        JBulletproofGens(CALL_CAPACITY))
    return fixture.CallTxCase(0, 0, payload, HEADER, tx.to_bytes(), vtx.id,
                              vtx.fee, tuple(e.encode() for e in vtx.log))


def _mpc_inputs():
    r = random.Random(SEED + 2)
    m = MPC_HOSTS * MPC_PARTIES
    return ([r.randrange(1 << MPC_N) for _ in range(m)],
            [r.randrange(L) for _ in range(m)])


def _commitments(values, blindings) -> list[bytes]:
    pc = JPedersenGens()
    return [pc.commit(v, b).compress() for v, b in zip(values, blindings)]


def _split(xs):
    return [xs[h * MPC_PARTIES:(h + 1) * MPC_PARTIES]
            for h in range(MPC_HOSTS)]


def test_keys_mpc_fixture_holds_the_jax_packages_values():
    fx = fixture.load_keys_mpc()
    assert fx.keytree == _keytree_cases()
    preds = _predicate_cases()
    assert fx.predicates == preds
    call = _call_case(preds)
    assert (call.txid, call.fee, call.log) == (fx.call.txid, fx.call.fee,
                                               fx.call.log)
    assert (JTx.from_bytes(call.wire).program
            == JTx.from_bytes(fx.call.wire).program)
    values, blindings = _mpc_inputs()
    m = fx.mpc
    assert (m.values, m.blindings) == (values, blindings)
    assert (m.n, m.party_counts) == (MPC_N, [MPC_PARTIES] * MPC_HOSTS)
    assert m.commitments == _commitments(values, blindings)
    assert m.bad_shares == [CORRUPT_HOST * MPC_PARTIES]


def main():
    from zkvm_tpu.parallel import mpc_hosts as jmpc_hosts
    from zkvm_tpu.proofs.errors import MPCError
    from zkvm_tpu.proofs.transcript import ProofTranscript

    preds = _predicate_cases()
    call = _call_case(preds)
    assert jverify_tx(JTx.from_bytes(call.wire),
                      JBulletproofGens(CALL_CAPACITY)).id == call.txid
    values, blindings = _mpc_inputs()
    bp, pc = JBulletproofGens(MPC_N, MPC_HOSTS * MPC_PARTIES), JPedersenGens()
    proof, vcs = jmpc_hosts.distributed_prove(
        bp, pc, MPC_LABEL, _split(values), _split(blindings), MPC_N)
    proof.verify_multiple(bp, pc, ProofTranscript(MPC_LABEL), vcs, MPC_N)
    assert vcs == _commitments(values, blindings)
    try:
        jmpc_hosts.distributed_prove(
            bp, pc, MPC_LABEL, _split(values), _split(blindings), MPC_N,
            corrupt={CORRUPT_HOST: fixture.corrupt_first_share(jmpc_hosts)})
        raise AssertionError("the corrupted share was accepted")
    except MPCError as e:
        bad = e.bad_shares
    fx = fixture.KeysMpcFixture(
        _keytree_cases(), preds, call,
        fixture.MpcCase(MPC_LABEL, MPC_N, [MPC_PARTIES] * MPC_HOSTS, values,
                        blindings, vcs, CORRUPT_HOST, bad))
    fixture.dump_keys_mpc(fixture.KEYS_MPC, fx)
    assert fixture.load_keys_mpc() == fx
    print(f"wrote {fixture.KEYS_MPC} ({fixture.KEYS_MPC.stat().st_size} "
          f"bytes): call txid {call.txid.hex()}, bad shares {bad}")


if __name__ == "__main__":
    main()
