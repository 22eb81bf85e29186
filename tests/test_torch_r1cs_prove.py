"""R1CS proving and transaction building in the port, held byte for byte
against the JAX package on the same seeded witness RNG, values and
blindings.

Everything runs on an engine over the port's oracle (the base Engine's
plain prover calls and InnerProductProof.create_plain), so that no MSM
twin runs.  Item 1: a one-phase and a two-phase circuit equal the JAX
Prover's proofs and verify under both packages; the native ScalarVec
chain equals its VecPoly3 twin; TorchEngine("cpu").msm_batch runs groups
of different window widths (a 1,024-multiplier phase's 2,049 and 1,025
points) each at its own width, with one fetch.  Item 2: a signed issue
built by the port's build_tx has the JAX build_tx's txid, fee, log and
program, and verifies under both packages; MuSig's two-party signature
verifies under both packages' starsig, and a changed share is named.
"""

import random

import pytest
import torch

from zkvm_tpu.crypto.starsig import Signature as JSignature
from zkvm_tpu.crypto.starsig import VerificationKey as JVerificationKey
from zkvm_tpu.crypto.starsig import verify as jstarsig_verify
from zkvm_tpu.gadgets import Value as JValue
from zkvm_tpu.gadgets import allocate_value as jallocate_value
from zkvm_tpu.gadgets import cloak as jcloak
from zkvm_tpu.gadgets import range_proof_gadget as jrange_proof_gadget
from zkvm_tpu.oracle.merlin import Transcript as JTranscript
from zkvm_tpu.proofs.errors import ProofError as JProofError
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.r1cs import Prover as JProver
from zkvm_tpu.proofs.r1cs import R1CSProof as JR1CSProof
from zkvm_tpu.proofs.r1cs import Verifier as JVerifier
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu.vm import Instruction as JInstruction
from zkvm_tpu.vm import Tx as JTx
from zkvm_tpu.vm import TxHeader as JTxHeader
from zkvm_tpu.vm import build_tx as jbuild_tx
from zkvm_tpu.vm import verify_tx as jverify_tx
from zkvm_tpu.vm.constraints import Commitment as JCommitment
from zkvm_tpu.vm.scalar_witness import ScalarWitness as JScalarWitness
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.constants import L
from zkvm_tpu_torch.crypto import musig, starsig
from zkvm_tpu_torch.gadgets import (Value, allocate_value, cloak,
                                    range_proof_gadget)
from zkvm_tpu_torch.kernels import engine as engine_mod
from zkvm_tpu_torch.kernels import msm
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.kernels.words import points_words, to_device, words_to_points
from zkvm_tpu_torch.oracle import edwards, scalar
from zkvm_tpu_torch.oracle.merlin import Transcript
from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint
from zkvm_tpu_torch.proofs.engine import Engine
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.r1cs import Prover, R1CSProof, Verifier
from zkvm_tpu_torch.proofs.r1cs.prover import (evaluate, polynomials,
                                               polynomials_plain)
from zkvm_tpu_torch.proofs.scalarvec import ScalarVec
from zkvm_tpu_torch.proofs.transcript import ProofTranscript
from zkvm_tpu_torch.proofs.util import powers
from zkvm_tpu_torch.vm import Instruction, Tx, TxHeader, build_tx, verify_tx
from zkvm_tpu_torch.vm.constraints import Commitment
from zkvm_tpu_torch.vm.scalar_witness import ScalarWitness

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)


class OracleEngine(Engine):
    """msm on the port's oracle: double-and-add under 16 points, else
    Pippenger's buckets over 4-bit windows."""

    def msm(self, scalars, points):
        if hasattr(scalars, "to_ints"):
            scalars = scalars.to_ints()
        ks = [int(k) % L for k in scalars]
        eps = [p.ep for p in points]
        if len(ks) != len(eps):
            raise ValueError("one scalar per point")
        acc = edwards.IDENTITY
        if len(eps) < 16:
            for k, p in zip(ks, eps):
                acc = edwards.add(acc, edwards.scalar_mul(k, p))
            return RistrettoPoint(acc)
        for shift in range(252, -1, -4):
            for _ in range(4):
                acc = edwards.double(acc)
            buckets = [edwards.IDENTITY] * 16
            for k, p in zip(ks, eps):
                d = k >> shift & 15
                if d:
                    buckets[d] = edwards.add(buckets[d], p)
            run = edwards.IDENTITY
            for d in range(15, 0, -1):
                run = edwards.add(run, buckets[d])
                acc = edwards.add(acc, run)
        return RistrettoPoint(acc)


def _jax_rng(seed: bytes):
    return (JTranscript(b"test-witness-rng").build_rng()
            .rekey_with_witness_bytes(b"seed", seed).finalize(b"\x00" * 32))


def _flipped(wire: bytes) -> bytes:
    bad = bytearray(wire)
    bad[11 * 32] ^= 1                         # t_x's low bit
    return bytes(bad)


CLOAK_INS = [(5, 7), (3, 9)]
CLOAK_OUTS = [(3, 9), (5, 7)]


def _lay(cs, circuit, value=None, V=None, jax=False):
    """Lay `circuit` ("range": one committed value under an 8-bit range
    gadget; "cloak": a Cloak 2x2 at 8 bits) on a prover (value = (v,
    blinding) given) or a verifier (the range's commitment V given)."""
    alloc, cl, rg, val = ((jallocate_value, jcloak, jrange_proof_gadget,
                           JValue) if jax else
                          (allocate_value, cloak, range_proof_gadget, Value))
    prove = value is not None
    if circuit == "range":
        var = cs.commit(*value)[1] if prove else cs.commit(V)
        rg(cs, var, 8, value[0] if prove else None)
        return
    vals = [alloc(cs, val(q, f) if prove else None)
            for q, f in CLOAK_INS + CLOAK_OUTS]
    cl(cs, vals[:2], vals[2:], range_bits=8)


def test_r1cs_proofs_equal_the_jax_prover_and_verify_in_both(monkeypatch):
    eng, pc, jpc = OracleEngine(), PedersenGens(), JPedersenGens()
    label = b"port-r1cs-prove-test"
    for circuit, cap, phases in (("range", 8, 1), ("cloak", 64, 2)):
        seed = circuit.encode()
        value = (200, 123456789)
        prover = Prover(pc, ProofTranscript(label),
                        rng=fixture.witness_rng(seed), engine=eng)
        jprover = JProver(jpc, JProofTranscript(label), rng=_jax_rng(seed))
        _lay(prover, circuit, value)
        _lay(jprover, circuit, value, jax=True)
        wire = prover.prove(BulletproofGens(cap)).to_bytes()
        assert wire == jprover.prove(JBulletproofGens(cap)).to_bytes()
        assert (prover.num_phase1_multipliers < len(prover.a_L)) == (
            phases == 2)
        V = pc.commit(*value).compress() if circuit == "range" else None
        for w, accept in ((wire, True), (_flipped(wire), False)):
            verifier = Verifier(ProofTranscript(label))
            _lay(verifier, circuit, V=V)
            assert eng.msm_is_identity(*verifier.verification_job(
                R1CSProof.from_bytes(w), BulletproofGens(cap), pc)) == accept
            jverifier = JVerifier(JProofTranscript(label))
            _lay(jverifier, circuit, V=V, jax=True)
            try:
                jverifier.verify(JR1CSProof.from_bytes(w), jpc,
                                 JBulletproofGens(cap))
                jok = True
            except JProofError:
                jok = False
            assert jok == accept

    # the ScalarVec chain equals its VecPoly3 twin
    r = random.Random(15)
    n = 8
    vecs = [[r.randrange(L) for _ in range(n)] for _ in range(8)]
    y, x = r.randrange(1, L), r.randrange(1, L)
    exp_y, exp_y_inv = powers(y, n), powers(scalar.invert(y), n)
    lc, rc, t = polynomials(*(ScalarVec.from_ints(v)
                              for v in vecs + [exp_y, exp_y_inv]))
    l_poly, r_poly, t_plain = polynomials_plain(*vecs, exp_y, exp_y_inv)
    assert t.t == t_plain.t and t.t[0] == 0
    l_vec, r_vec = evaluate(lc, rc, x)
    assert (l_vec.to_ints(), r_vec.to_ints()) == (l_poly.eval(x),
                                                  r_poly.eval(x))
    assert t.eval(x) == sum(a * b for a, b in zip(l_poly.eval(x),
                                                  r_poly.eval(x))) % L

    # msm_batch over a 1,024-multiplier phase's groups (2n + 1 = 2,049
    # points on the large route, n + 1 = 1,025 on the small) and smaller
    # ones: each group at its own width, one K4 fold per width, one fetch
    calls, fetches = [], []
    ident = words_to_points(to_device(points_words([edwards.IDENTITY]),
                                      "cpu"))

    def record(points, digits, wbits, config=None):
        calls.append((points.shape[2], digits.shape[0], wbits))
        return ident.expand(4, -1, digits.shape[1]).contiguous()

    def fetch(folded):
        fetches.append(folded.shape[2])
        return real_fetch(folded)

    real_fetch = engine_mod.points_to_ints
    monkeypatch.setattr(engine_mod, "window_totals", record)
    monkeypatch.setattr(engine_mod, "points_to_ints", fetch)
    sizes = [2049, 1025, 3, 0, 2049]
    got = TorchEngine("cpu").msm_batch([[1] * k for k in sizes],
                                       [[pc.B] * k for k in sizes], ct=False)
    assert sorted(calls) == sorted((k, k, msm.best_wbits(k))
                                   for k in sizes if k)
    assert {w for *_, w in calls} == {8, 11} and fetches == [4]
    assert [p.compress() for p in got] == [bytes(32)] * 5


def test_build_tx_equals_the_jax_build_tx_and_musig_signs():
    eng = OracleEngine()
    r = random.Random(2015)
    key, blinding, qty = r.randrange(1, L), r.randrange(L), 1234
    pred = starsig.VerificationKey.from_secret(key, eng).point
    assert pred == JVerificationKey.from_secret(key).point
    meta = b"port-build-tx"

    def issue(instr, com, witness):
        """A signed issue of one token to its issuer, without a Cloak."""
        c = com.blinded(witness.from_integer(qty), blinding)
        return [instr("push", data=pred), instr("push", data=meta),
                instr("push", data=c.point, witness=c), instr("issue"),
                instr("signtx"), instr("push", data=pred),
                instr("output", k=1)]

    header = (1, 0, 10_000)
    bp, jbp = BulletproofGens(64), JBulletproofGens(64)
    tx, vtx = build_tx(issue(Instruction, Commitment, ScalarWitness),
                       TxHeader(*header), bp, {pred: key}, engine=eng)
    jtx, jvtx = jbuild_tx(issue(JInstruction, JCommitment, JScalarWitness),
                          JTxHeader(*header), jbp, {pred: key})
    assert tx.program == jtx.program
    assert (vtx.id, vtx.fee) == (jvtx.id, jvtx.fee)
    assert [e.encode() for e in vtx.log] == [e.encode() for e in jvtx.log]
    assert jverify_tx(JTx.from_bytes(tx.to_bytes()), jbp).id == vtx.id
    assert verify_tx(Tx.from_bytes(tx.to_bytes()), bp, engine=eng).id == \
        vtx.id

    # MuSig with two parties, verified by both packages' starsig
    keys = [r.randrange(1, L) for _ in range(2)]
    t = Transcript(b"port-musig")
    t.append_message(b"msg", b"two parties")
    sig, X = musig.sign_multi(keys, t, eng)
    starsig.verify(sig, t, X, engine=eng)
    jt = JTranscript(b"port-musig")
    jt.append_message(b"msg", b"two parties")
    jstarsig_verify(JSignature.from_bytes(sig.to_bytes()), jt,
                    JVerificationKey(X.point))

    # the dealer names party 1 when its share is changed
    multikey = musig.Multikey([starsig.VerificationKey.from_secret(x, eng)
                               for x in keys])
    parties = [musig.Party(multikey, x, i, t.clone(), eng)
               for i, x in enumerate(keys)]
    pres = [p.precommitment() for p in parties]
    coms = [p.commitment() for p in parties]
    shares = [p.share(pres, coms) for p in parties]
    shares[1] = (shares[1] + 1) % L
    with pytest.raises(musig.MusigError) as e:
        musig.aggregate_shares(multikey, t, coms, shares, eng)
    assert e.value.bad_parties == [1]
