"""The port's serving path against the JAX package on the CPU (the kernels'
plain versions): batch_verify_device_pipelined gives, batch for batch, the
port's one-shot batch_verify_device verdicts and the JAX host
batch_verify's, a tampered batch included; TorchEngine.msm_start /
msm_finish_is_identity equal the JAX oracle's identity test, with the
scalars as a list and as a ScalarVec.
"""

import random

import torch

from zkvm_tpu.constants import L
from zkvm_tpu.oracle import edwards as joe
from zkvm_tpu.oracle import ristretto as jrst
from zkvm_tpu.proofs.errors import VerificationError as JVerificationError
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.rangeproof import RangeProof as JRangeProof
from zkvm_tpu.proofs.rangeproof import batch_verify as jbatch_verify
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch.kernels.batch_verify_device import (
    batch_verify_device, batch_verify_device_pipelined)
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.rangeproof import RangeProof
from zkvm_tpu_torch.proofs.scalarvec import ScalarVec
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

# the suite runs in several worker processes and these tensors are small
torch.set_num_threads(1)

LABEL, N = b"fused-batch", 8


def _jax_proofs(nb, seed):
    """nb JAX-proved 8-bit proofs (m = 1) from a seed -> wires, commitments."""
    r = random.Random(seed)
    bp, pc = JBulletproofGens(N, 1), JPedersenGens()
    out = []
    for _ in range(nb):
        proof, vcs = JRangeProof.prove_multiple(
            bp, pc, JProofTranscript(LABEL), [r.randrange(1 << N)],
            [r.randrange(L)], N)
        out.append((proof.to_bytes(), vcs))
    return out


def test_pipelined_equals_one_shot_and_jax():
    recs = _jax_proofs(2, seed=3)
    bad = JRangeProof.from_bytes(recs[0][0])
    bad.t_x = (bad.t_x + 1) % L
    streams = [[w for w, _ in recs], [bad.to_bytes(), recs[1][0]],
               [w for w, _ in recs]]
    vcs = [v for _, v in recs]

    def port(wires):
        return ([RangeProof.from_bytes(w) for w in wires],
                [ProofTranscript(LABEL) for _ in wires], vcs)

    def jax(wires):
        try:
            jbatch_verify([JRangeProof.from_bytes(w) for w in wires],
                          JBulletproofGens(N, 1), JPedersenGens(),
                          [JProofTranscript(LABEL) for _ in wires], vcs, N)
        except JVerificationError:
            return False
        return True

    bp, pc = BulletproofGens(N, 1), PedersenGens()
    timings = {}
    got = batch_verify_device_pipelined([port(w) for w in streams], bp, pc, N,
                                        device="cpu", timings=timings)
    assert got == [True, False, True]
    assert timings["batches"] == 3 and len(timings["device_s"]) == 3
    assert got == [jax(w) for w in streams]
    # the one-shot path on the two distinct batches, under the pipeline's
    # default entropies (the stream's first two)
    for k, wires in enumerate(streams[:2]):
        proofs, transcripts, v = port(wires)
        assert batch_verify_device(proofs, bp, pc, transcripts, v, N,
                                   bytes([k + 1]) * 32, "cpu") == got[k]


def test_msm_start_finish_equals_oracle():
    r = random.Random(88)
    jpts = [jrst.RistrettoPoint.from_uniform_bytes(
        r.getrandbits(512).to_bytes(64, "little")) for _ in range(24)]
    pts = [RistrettoPoint.decompress(p.compress()) for p in jpts]
    ks = [r.randrange(L) for _ in range(24)]
    eng = TorchEngine("cpu")
    expect = jrst.RistrettoPoint(joe.IDENTITY)
    for k, p in zip(ks, jpts):
        expect = expect + p * k
    assert eng.msm_finish_is_identity(eng.msm_start(ks, pts)) is False
    assert expect.is_identity() is False
    # s P + s (-P) pairs, the scalars as a ScalarVec: the identity
    pairs, sc = [], []
    for i in range(0, 24, 2):
        s = r.randrange(L)
        neg = jrst.RistrettoPoint(joe.neg(jpts[i].ep))
        pairs += [pts[i], RistrettoPoint.decompress(neg.compress())]
        sc += [s, s]
    assert eng.msm_finish_is_identity(
        eng.msm_start(ScalarVec.from_ints(sc), pairs))
    assert eng.msm_finish_is_identity(eng.msm_start([], []))
