"""The repaired mixed-aggregation batch_verify (zkvm_tpu_torch.proofs.
rangeproof, on the CPU) against the JAX package's verdict: a batch of
proofs with m = 1, 2, 4 and 2, valid, with one t_x changed and with one
non-canonical encoding.  The fused device path, which needs one m, still
refuses the batch; batch_verify now takes the host-assembled MSM through
the engine, as the JAX package does."""

import pytest
import torch

from test_torch_engine import _gens, _records, _tamper, _verdict
from zkvm_tpu.proofs import rangeproof as jrp
from zkvm_tpu.proofs.errors import ProofError as JProofError
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch.kernels import batch_verify_device as bvd
from zkvm_tpu_torch.proofs.errors import FormatError, ProofError
from zkvm_tpu_torch.proofs.rangeproof import RangeProof, batch_verify
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

ENTROPY = b"\x05" * 32


def _mixed_batch(how):
    recs = _records()
    batch = [recs[1][0], recs[2][0], recs[4][0], recs[2][1]]
    if how != "valid":
        batch[2] = _tamper(batch[2], how)
    return batch


@pytest.mark.parametrize("hows", [("valid",), ("t_x", "encoding")],
                         ids=["valid", "tampered"])
def test_mixed_batch_verify_agrees_with_jax(hows):
    jbp, jpc, bp, pc = _gens()
    for how in hows:
        batch = _mixed_batch(how)
        proofs = [RangeProof.from_bytes(w) for _, w, _ in batch]
        transcripts = [ProofTranscript(lb) for lb, _, _ in batch]
        vcs = [v for _, _, v in batch]
        with pytest.raises(FormatError, match="one aggregation size"):
            bvd.prepare_batch_inputs(proofs, bp, pc, transcripts, vcs, 64,
                                     ENTROPY)
        jax_v = _verdict(lambda: jrp.batch_verify(
            [jrp.RangeProof.from_bytes(w) for _, w, _ in batch], jbp, jpc,
            [JProofTranscript(lb) for lb, _, _ in batch], vcs, 64, ENTROPY),
            (JProofError, ValueError))
        timings = {}
        port_v = _verdict(lambda: batch_verify(
            [RangeProof.from_bytes(w) for _, w, _ in batch], bp, pc,
            [ProofTranscript(lb) for lb, _, _ in batch], vcs, 64, ENTROPY,
            device="cpu", timings=timings), (ProofError, ValueError))
        assert port_v == jax_v == {"valid": "accept", "t_x": "reject",
                                   "encoding": "ValueError"}[how], how
        if how == "valid":
            assert timings["msm_size"] == 2 + 2 * 64 * 4 + 17 + 20 + 24 + 20
