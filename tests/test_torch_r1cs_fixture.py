"""The committed R1CS fixtures — a Cloak 4x4 with 64-bit values
(zkvm_tpu_torch/data/r1cs_cloak4x4_64.bin, 512 padded multipliers) and 512
committed values under 64-bit range gadgets (r1cs_range512x64.bin, 2^15
multipliers) — parse in both packages, and the Cloak one verifies under
both on the CPU.

Regenerate both with the JAX package's prover (each is verified by the
JAX package before it is written):
    python tests/test_torch_r1cs_fixture.py
"""

import sys
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":      # run as a script: import from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from zkvm_tpu.constants import L  # noqa: E402
from zkvm_tpu.gadgets import Value as JValue
from zkvm_tpu.gadgets import allocate_value as jallocate_value
from zkvm_tpu.gadgets import cloak as jcloak
from zkvm_tpu.gadgets import range_proof_gadget as jrange_proof_gadget
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.r1cs import Prover as JProver
from zkvm_tpu.proofs.r1cs import R1CSProof as JR1CSProof
from zkvm_tpu.proofs.r1cs import Verifier as JVerifier
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.r1cs import R1CSProof

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

CLOAK_LABEL = b"zkvm_tpu_torch r1cs cloak"
RANGE_LABEL = b"zkvm_tpu_torch r1cs range"
CLOAK_INS = [(5, 7777), (10, 8888), (2, 7777), (7, 8888)]
CLOAK_OUTS = [(7, 7777), (6, 8888), (4, 8888), (7, 8888)]
RANGE_COUNT, BITS = 512, 64


def _jax_verifier(fx):
    """The JAX package's Verifier with the fixture's circuit laid on it."""
    verifier = JVerifier(JProofTranscript(fx.label))
    if fx.circuit == "cloak":
        k_in, k_out, bits = fx.params
        ins = [jallocate_value(verifier, None) for _ in range(k_in)]
        outs = [jallocate_value(verifier, None) for _ in range(k_out)]
        jcloak(verifier, ins, outs, range_bits=bits)
    else:
        (bits,) = fx.params
        for com in fx.commitments:
            jrange_proof_gadget(verifier, verifier.commit(com), bits, None)
    return verifier


def test_r1cs_fixtures_parse():
    cloak_fx = fixture.load_r1cs(fixture.R1CS_CLOAK)
    assert (cloak_fx.label, cloak_fx.circuit, cloak_fx.gens_capacity,
            cloak_fx.params, cloak_fx.commitments) == (
        CLOAK_LABEL, "cloak", 512, (4, 4, BITS), [])
    range_fx = fixture.load_r1cs(fixture.R1CS_RANGE)
    assert (range_fx.label, range_fx.circuit, range_fx.gens_capacity,
            range_fx.params) == (RANGE_LABEL, "range", 1 << 15, (BITS,))
    assert len(set(range_fx.commitments)) == RANGE_COUNT
    for fx in (cloak_fx, range_fx):
        proof = R1CSProof.from_bytes(fx.wire)
        assert proof.to_bytes() == fx.wire
        assert JR1CSProof.from_bytes(fx.wire).to_bytes() == fx.wire
        lg = fx.gens_capacity.bit_length() - 1
        assert len(proof.ipp_proof.L_vec) == lg
        assert len(fx.wire) == 32 * (14 + 2 * lg + 2)


def test_cloak_fixture_verifies_under_both_packages():
    fx = fixture.load_r1cs(fixture.R1CS_CLOAK)
    _jax_verifier(fx).verify(JR1CSProof.from_bytes(fx.wire), JPedersenGens(),
                             JBulletproofGens(fx.gens_capacity))
    fixture.r1cs_verifier(fx).verify(
        R1CSProof.from_bytes(fx.wire), PedersenGens(),
        BulletproofGens(fx.gens_capacity), device="cpu")


def _regenerate():
    rs = np.random.default_rng(2027)
    pc = JPedersenGens()

    prover = JProver(pc, JProofTranscript(CLOAK_LABEL))
    ins = [jallocate_value(prover, JValue(q, f)) for q, f in CLOAK_INS]
    outs = [jallocate_value(prover, JValue(q, f)) for q, f in CLOAK_OUTS]
    jcloak(prover, ins, outs, range_bits=BITS)
    proof = prover.prove(JBulletproofGens(512))
    cloak_fx = fixture.R1CSFixture(CLOAK_LABEL, "cloak", 512,
                                   (len(CLOAK_INS), len(CLOAK_OUTS), BITS),
                                   [], proof.to_bytes())

    prover = JProver(pc, JProofTranscript(RANGE_LABEL))
    commitments = []
    for _ in range(RANGE_COUNT):
        v = int(rs.integers(0, 2**63)) * 2 + int(rs.integers(0, 2))
        com, var = prover.commit(v, int.from_bytes(rs.bytes(32), "little") % L)
        commitments.append(com)
        jrange_proof_gadget(prover, var, BITS, v)
    proof = prover.prove(JBulletproofGens(1 << 15))
    range_fx = fixture.R1CSFixture(RANGE_LABEL, "range", 1 << 15, (BITS,),
                                   commitments, proof.to_bytes())

    for fx, path in ((cloak_fx, fixture.R1CS_CLOAK),
                     (range_fx, fixture.R1CS_RANGE)):
        _jax_verifier(fx).verify(JR1CSProof.from_bytes(fx.wire), pc,
                                 JBulletproofGens(fx.gens_capacity))
        fixture.dump_r1cs(path, fx)


if __name__ == "__main__":
    _regenerate()
