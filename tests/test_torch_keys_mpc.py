"""Key derivation, taproot predicates and the multi-host MPC in the port
(crypto/keytree.py, vm/predicate.py's PredicateTree, parallel/
mpc_hosts.py), held against the JAX package and its committed values
(zkvm_tpu_torch/data/keys_mpc_seeded.bin).

Item 1: keytree derivations equal zkvm_tpu.crypto.keytree's (as
tests/test_crypto.py derives: public derivation matches private); each
PredicateTree's adjustment, predicate and call proofs equal the
reference's, its predicate made on TorchEngine("cpu") (K17's twin); the
taproot `call` transaction built by the port's build_tx has the JAX
build_tx's txid, fee, log and program; the MPC wire formats' bytes equal
the reference's and junk is refused.  Item 2: distributed_prove at 2
hosts x 2 parties, n = 16, verifies under both packages' verifiers and
names a corrupted share's party as the reference does; with one host
and a seeded TranscriptRng the proof equals the JAX package's byte for
byte.  The MPC's group operations run on the JAX package's native MSM
(test_torch_ct._RefEngine), which keeps the item inside its budget;
tests/test_torch_ct.py holds the K17 and K18 routes the card runs them
on.
"""

import random

import pytest
import torch

from test_torch_ct import _RefEngine
from test_torch_r1cs_prove import _jax_rng
from zkvm_tpu.crypto.keytree import Xprv as JXprv
from zkvm_tpu.oracle.ristretto import RistrettoPoint as JRistrettoPoint
from zkvm_tpu.parallel import mpc_hosts as jmpc_hosts
from zkvm_tpu.proofs.errors import MPCError as JMPCError
from zkvm_tpu.proofs.errors import ProofError as JProofError
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.mpc import BitCommitment as JBitCommitment
from zkvm_tpu.proofs.mpc import PolyCommitment as JPolyCommitment
from zkvm_tpu.proofs.mpc import ProofShare as JProofShare
from zkvm_tpu.proofs.rangeproof import RangeProof as JRangeProof
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.constants import L
from zkvm_tpu_torch.crypto import Xprv
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.parallel import mpc_hosts
from zkvm_tpu_torch.proofs.errors import MPCError
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint
from zkvm_tpu_torch.proofs.mpc import (BitCommitment, PolyCommitment,
                                       ProofShare)
from zkvm_tpu_torch.proofs.rangeproof import RangeProof
from zkvm_tpu_torch.proofs.transcript import ProofTranscript
from zkvm_tpu_torch.vm import Instruction, Tx, TxHeader, build_tx
from zkvm_tpu_torch.vm.predicate import PredicateTree

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)


def test_keytree_predicate_tree_and_taproot_call_equal_the_jax_package():
    fx = fixture.load_keys_mpc()
    eng = TorchEngine("cpu")
    for k in fx.keytree:
        def sel(t, a=k.account):
            t.append_u64(b"account", a)
        xprv = Xprv.random(k.seed)
        xpub = xprv.to_xpub(eng)
        child = xprv.derive_key(sel, eng)
        assert (xprv.scalar_key, xprv.dk, xpub.point) == (k.scalar, k.dk,
                                                          k.point)
        assert (child.scalar_key, child.dk) == (k.child_scalar, k.child_dk)
        assert xpub.derive_key(sel, eng).point == k.child_point
        assert child.to_xpub(eng).point == k.child_point
    jx = JXprv.random(fx.keytree[0].seed)
    assert jx.to_xpub().point == fx.keytree[0].point

    for c in fx.predicates:
        tree = PredicateTree(c.key_point, c.progs)
        assert tree.adjustment_factor() == c.adjustment
        assert tree.signing_key_adjustment() == c.adjustment
        assert tree.predicate(eng).point == c.predicate
        assert [tree.call_proof(i).to_bytes()
                for i in range(len(c.progs))] == c.call_proofs

    call = fx.call
    c = fx.predicates[call.tree]
    tree = PredicateTree(c.key_point, c.progs)
    program = fixture.taproot_call_program(
        Instruction, tree.predicate(eng).point, c.progs[call.leaf],
        tree.call_proof(call.leaf).to_bytes(), call.payload)
    tx, vtx = build_tx(program, TxHeader(*call.header), BulletproofGens(16),
                       engine=_RefEngine())
    assert (vtx.id, vtx.fee, tuple(e.encode() for e in vtx.log)) == (
        call.txid, call.fee, call.log)
    assert tx.program == Tx.from_bytes(call.wire).program

    # the wire formats: the reference's bytes on the same messages
    r = random.Random(18)
    pts = [RistrettoPoint.hash_from_bytes_sha3_512(bytes([i]))
           for i in range(3)]
    jpts = [JRistrettoPoint.decompress(p.compress()) for p in pts]
    vj = pts[0].compress()
    shares = [(r.randrange(L), r.randrange(L), r.randrange(L),
               [r.randrange(L) for _ in range(3)], [r.randrange(L)])]
    for ours, theirs in (
            (mpc_hosts.serialize_bit_commitments(
                [BitCommitment(vj, pts[1], pts[2])]),
             jmpc_hosts.serialize_bit_commitments(
                 [JBitCommitment(vj, jpts[1], jpts[2])])),
            (mpc_hosts.serialize_poly_commitments(
                [PolyCommitment(pts[2], pts[0])]),
             jmpc_hosts.serialize_poly_commitments(
                 [JPolyCommitment(jpts[2], jpts[0])])),
            (mpc_hosts.serialize_shares([ProofShare(*s) for s in shares]),
             jmpc_hosts.serialize_shares([JProofShare(*s) for s in shares])),
            (mpc_hosts.serialize_challenge("poly", 5, L - 1),
             jmpc_hosts.serialize_challenge("poly", 5, L - 1))):
        assert ours == theirs
    back = mpc_hosts.deserialize_shares(mpc_hosts.serialize_shares(
        [ProofShare(*s) for s in shares]))
    assert [s.__dict__ for s in back] == [ProofShare(*s).__dict__
                                          for s in shares]
    assert mpc_hosts.deserialize_bit_commitments(
        mpc_hosts.serialize_bit_commitments(
            [BitCommitment(vj, pts[1], pts[2])]))[0].A_j == pts[1]
    bad = bytearray(mpc_hosts.serialize_challenge("bit", 1, 2))
    bad[-32:] = (L + 1).to_bytes(32, "little")
    for parse, junk in (
            (mpc_hosts.deserialize_challenge, bytes(bad)),
            (mpc_hosts.deserialize_challenge, b"\x09" + bytes(4)),
            (mpc_hosts.deserialize_shares,
             mpc_hosts.serialize_shares([]) + b"\x00")):
        with pytest.raises(MPCError):
            parse(junk)


def test_distributed_prove_verifies_and_attributes_a_bad_share():
    eng = _RefEngine()
    bp, pc = BulletproofGens(16, 4), PedersenGens()
    jbp, jpc = JBulletproofGens(16, 4), JPedersenGens()
    r = random.Random(19)
    values = [[r.randrange(1 << 16) for _ in range(2)] for _ in range(2)]
    blindings = [[r.randrange(L) for _ in range(2)] for _ in range(2)]
    proof, vcs = mpc_hosts.distributed_prove(
        bp, pc, b"mpc hosts", values, blindings, 16, engines=[eng, eng])
    assert vcs == [jpc.commit(v, b).compress() for v, b in
                   zip(sum(values, []), sum(blindings, []))]
    wire = proof.to_bytes()
    RangeProof.from_bytes(wire).verify_multiple(
        bp, pc, ProofTranscript(b"mpc hosts"), vcs, 16, engine=eng)
    JRangeProof.from_bytes(wire).verify_multiple(
        jbp, jpc, JProofTranscript(b"mpc hosts"), vcs, 16)
    bad = bytearray(wire)
    bad[4 * 32] ^= 1                          # t_x's low bit
    with pytest.raises(JProofError):
        JRangeProof.from_bytes(bytes(bad)).verify_multiple(
            jbp, jpc, JProofTranscript(b"mpc hosts"), vcs, 16)

    # host 1 corrupts its first share: the dealer names party 2, as the
    # reference's does
    with pytest.raises(MPCError) as ours:
        mpc_hosts.distributed_prove(
            bp, pc, b"mpc byz", values, blindings, 16, engines=[eng, eng],
            corrupt={1: fixture.corrupt_first_share(mpc_hosts)})
    with pytest.raises(JMPCError) as theirs:
        jmpc_hosts.distributed_prove(
            jbp, jpc, b"mpc byz", values, blindings, 16,
            corrupt={1: fixture.corrupt_first_share(jmpc_hosts)})
    assert ours.value.bad_shares == theirs.value.bad_shares == [2]

    # one host, a seeded witness RNG: the JAX package's bytes
    one, jone = (f(bp_, pc_, b"mpc one", [values[0]], [blindings[0]], 16,
                   rng=rng, **kw)[0].to_bytes()
                 for f, bp_, pc_, rng, kw in (
                     (mpc_hosts.distributed_prove, bp, pc,
                      fixture.witness_rng(b"one"), {"engines": [eng]}),
                     (jmpc_hosts.distributed_prove, jbp, jpc,
                      _jax_rng(b"one"), {})))
    assert one == jone
