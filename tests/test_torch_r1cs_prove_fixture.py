"""The committed R1CS prover fixture (zkvm_tpu_torch/data/
prove_r1cs_seeded.bin) holds the JAX package's R1CS proofs on a seeded
witness RNG and its build_tx's transactions on seeded blindings, which
chip_smoke.py holds the card's against.

It holds five cases (fixture.py's R1CSProveCase has the layout): a Cloak
4x4 with 64-bit values (512 padded multipliers, two phases) and 512
committed 64-bit values under range gadgets (2^15 multipliers, one
phase), each proved with rng = fixture.witness_rng(seed); then two signed
issues of one token and a payment that spends both (a Cloak 2x2, MuSig
with two parties), the apps' blindings drawn from
fixture.seeded_blindings(seed).  The R1CS witness and the nonces of those
transactions stay random, so their txids, fees, logs and programs are the
fixed part.

Regenerate it with the JAX package (it verifies every case before the
file is written):
    python tests/test_torch_r1cs_prove_fixture.py
"""

import random
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":      # run as a script: import from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from zkvm_tpu.apps import Token as JToken  # noqa: E402
from zkvm_tpu.apps import accounts as jaccounts
from zkvm_tpu.apps import issue_program as jissue_program
from zkvm_tpu.apps import token as jtoken
from zkvm_tpu.apps.accounts import Receiver as JReceiver
from zkvm_tpu.apps.accounts import Utxo as JUtxo
from zkvm_tpu.apps.accounts import pay_program as jpay_program
from zkvm_tpu.constants import L
from zkvm_tpu.crypto.starsig import VerificationKey as JVerificationKey
from zkvm_tpu.gadgets import Value as JValue
from zkvm_tpu.gadgets import allocate_value as jallocate_value
from zkvm_tpu.gadgets import cloak as jcloak
from zkvm_tpu.gadgets import range_proof_gadget as jrange_proof_gadget
from zkvm_tpu.oracle.merlin import Transcript as JTranscript
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.r1cs import Prover as JProver
from zkvm_tpu.proofs.r1cs import R1CSProof as JR1CSProof
from zkvm_tpu.proofs.r1cs import Verifier as JVerifier
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu.vm import Tx as JTx
from zkvm_tpu.vm import TxHeader as JTxHeader
from zkvm_tpu.vm import build_tx as jbuild_tx
from zkvm_tpu.vm import verify_tx as jverify_tx
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.proofs.r1cs import R1CSProof
from zkvm_tpu_torch.vm import Tx, encode_program

CLOAK_LABEL = b"zkvm_tpu_torch r1cs prove cloak"
RANGE_LABEL = b"zkvm_tpu_torch r1cs prove range"
CLOAK_INS = [(5, 7777), (10, 8888), (2, 7777), (7, 8888)]
CLOAK_OUTS = [(7, 7777), (6, 8888), (4, 8888), (7, 8888)]
RANGE_COUNT, BITS = 512, 64
TX_SEED = b"tx-blindings"
TOKEN_META = b"prove-fixture-token"
HEADER = (1, 0, 10_000)       # TxHeader(version, mintime_ms, maxtime_ms)


def _jax_rng(seed: bytes):
    return (JTranscript(b"test-witness-rng").build_rng()
            .rekey_with_witness_bytes(b"seed", seed).finalize(b"\x00" * 32))


def _cloak_case() -> fixture.R1CSProveCase:
    seed = b"r1cs-cloak"
    prover = JProver(JPedersenGens(), JProofTranscript(CLOAK_LABEL),
                     rng=_jax_rng(seed))
    ins = [jallocate_value(prover, JValue(q, f)) for q, f in CLOAK_INS]
    outs = [jallocate_value(prover, JValue(q, f)) for q, f in CLOAK_OUTS]
    jcloak(prover, ins, outs, range_bits=BITS)
    wire = prover.prove(JBulletproofGens(512)).to_bytes()
    return fixture.R1CSProveCase(
        "cloak", 512, seed, CLOAK_LABEL, wire,
        (len(CLOAK_INS), len(CLOAK_OUTS), BITS),
        [x for v in CLOAK_INS + CLOAK_OUTS for x in v], [], [])


def _range_case() -> fixture.R1CSProveCase:
    seed = b"r1cs-range"
    rs = np.random.default_rng(2028)
    prover = JProver(JPedersenGens(), JProofTranscript(RANGE_LABEL),
                     rng=_jax_rng(seed))
    values, blindings, commitments = [], [], []
    for _ in range(RANGE_COUNT):
        v = int(rs.integers(0, 2**63)) * 2 + int(rs.integers(0, 2))
        b = int.from_bytes(rs.bytes(32), "little") % L
        com, var = prover.commit(v, b)
        jrange_proof_gadget(prover, var, BITS, v)
        values.append(v)
        blindings.append(b)
        commitments.append(com)
    wire = prover.prove(JBulletproofGens(1 << 15)).to_bytes()
    return fixture.R1CSProveCase("range", 1 << 15, seed, RANGE_LABEL, wire,
                                 (BITS,), values, blindings, commitments)


def _tx_case(kind, qty, key, points, tx, vtx) -> fixture.R1CSProveCase:
    padded = 1 << len(JR1CSProof.from_bytes(tx.proof).ipp_proof.L_vec)
    return fixture.R1CSProveCase(
        kind, padded, TX_SEED, TOKEN_META, tx.to_bytes(), (qty,), [], [key],
        points, vtx.id, vtx.fee, tuple(e.encode() for e in vtx.log))


def _tx_cases() -> list[fixture.R1CSProveCase]:
    """Two issues of one token to its issuer and a payment of half their
    sum to a payee, spending both (the fixture block's shapes)."""
    r = random.Random(2029)
    key = r.randrange(1, L)
    pred = JVerificationKey.from_secret(key).point
    payee = JVerificationKey.from_secret(r.randrange(1, L)).point
    token = JToken(pred, TOKEN_META)
    header = JTxHeader(*HEADER)
    bp = JBulletproofGens(512)
    cases, utxos = [], []
    with fixture.seeded_blindings(TX_SEED, [jtoken, jaccounts]):
        for qty in (10 + r.randrange(1000), 10 + r.randrange(1000)):
            prog, out_q, out_f = jissue_program(token, qty, pred)
            tx, vtx = jbuild_tx(prog, header, bp, {pred: key})
            utxos.append(JUtxo(vtx.outputs[0], out_q, out_f))
            cases.append(_tx_case("issue", qty, key, [pred], tx, vtx))
        paid = sum(u.qty.witness[0].to_u64() for u in utxos) // 2
        prog, _, _ = jpay_program(utxos, JReceiver(payee, paid, token.flavor))
        tx, vtx = jbuild_tx(prog, header, bp, {pred: key})
        cases.append(_tx_case("payment", paid, key, [pred, payee], tx, vtx))
    return cases


def test_r1cs_prove_fixture_holds_the_jax_provers_bytes():
    cases = fixture.load_prove_r1cs()
    assert [c.kind for c in cases] == ["cloak", "range", "issue", "issue",
                                       "payment"]
    cloak, rng_case = cases[:2]
    for c in (cloak, rng_case):
        assert R1CSProof.from_bytes(c.wire).to_bytes() == c.wire
        assert JR1CSProof.from_bytes(c.wire).to_bytes() == c.wire
    # the Cloak is re-made by the JAX prover; the 2^15 case only parses
    assert _cloak_case() == cloak
    assert (rng_case.gens_capacity, rng_case.params) == (1 << 15, (BITS,))
    assert len(rng_case.values) == len(rng_case.scalars) == RANGE_COUNT
    assert len(set(rng_case.points)) == RANGE_COUNT
    lg = len(R1CSProof.from_bytes(rng_case.wire).ipp_proof.L_vec)
    assert lg == 15
    # the transactions: the JAX verifier's txid, fee and log, and the
    # port's apps rebuild each program
    bp = JBulletproofGens(max(c.gens_capacity for c in cases[2:]))
    for c, (prog, header, keys) in zip(cases[2:],
                                       fixture.tx_programs(cases)):
        tx = Tx.from_bytes(c.wire)
        assert tx.to_bytes() == c.wire == JTx.from_bytes(c.wire).to_bytes()
        assert encode_program(prog) == tx.program
        assert (header.version, header.mintime_ms, header.maxtime_ms) == HEADER
        assert keys == {c.points[0]: c.scalars[0]}
        vtx = jverify_tx(JTx.from_bytes(c.wire), bp)
        assert (vtx.id, vtx.fee, tuple(e.encode() for e in vtx.log)) == (
            c.txid, c.fee, c.log)


def main():
    cases = [_cloak_case(), _range_case()] + _tx_cases()
    pc = JPedersenGens()
    for c in cases[:2]:
        verifier = JVerifier(JProofTranscript(c.label))
        if c.kind == "cloak":
            ins = [jallocate_value(verifier, None) for _ in CLOAK_INS]
            outs = [jallocate_value(verifier, None) for _ in CLOAK_OUTS]
            jcloak(verifier, ins, outs, range_bits=BITS)
        else:
            for com in c.points:
                jrange_proof_gadget(verifier, verifier.commit(com), BITS,
                                    None)
        verifier.verify(JR1CSProof.from_bytes(c.wire), pc,
                        JBulletproofGens(c.gens_capacity))
    bp = JBulletproofGens(512)
    for c in cases[2:]:
        assert jverify_tx(JTx.from_bytes(c.wire), bp).id == c.txid
    fixture.dump_prove_r1cs(fixture.PROVE_R1CS, cases)
    print(f"wrote {fixture.PROVE_R1CS} "
          f"({fixture.PROVE_R1CS.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
