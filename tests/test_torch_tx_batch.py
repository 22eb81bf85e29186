"""The port's tx batch (zkvm_tpu_torch.parallel.tx_batch) against the JAX
package's on a 3-transaction batch of mixed circuit sizes from the
committed fixture: a `fee` transaction (padded_n 1), then an issue and a
payment (padded_n 256), so the G/H accumulators grow mid-batch.

_chunk_precompute must equal the JAX package's (encoding mode) byte for
byte; fused_verify_tx_batch and verify_tx_batch on TorchEngine("cpu") must
accept the batch and reject it with the issue's proof tampered, the fused
check's attribution naming that transaction.
"""

import pytest
import torch

from zkvm_tpu.parallel.tx_batch import _chunk_precompute as j_chunk_precompute
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.parallel.tx_batch import (_chunk_precompute,
                                              fused_verify_tx_batch,
                                              verify_tx_batch)
from zkvm_tpu_torch.proofs.errors import VerificationError
from zkvm_tpu_torch.proofs.generators import BulletproofGens
from zkvm_tpu_torch.vm import Tx

# the suite runs in several worker processes and these tensors are small
torch.set_num_threads(1)

ENTROPY = bytes(range(32))


def _batch():
    cap, recs = fixture.load_txs()
    batch = [recs[261], recs[0], recs[192]]
    assert [r.kind for r in batch] == ["fee", "issue", "payment"]
    return cap, batch


def test_chunk_precompute_equals_jax():
    cap, batch = _batch()
    wires = [r.wire for r in batch]
    out, head, g_buf, h_buf, dyn_s, dyn_enc = _chunk_precompute(
        wires, BulletproofGens(cap), ENTROPY, TorchEngine("cpu"))
    jout, jhead, jg_buf, jh_buf, jdyn_s, jdyn_enc = j_chunk_precompute(
        wires, (cap, 1), ENTROPY, enc_mode=True)
    assert [v.id for v in out] == [v.id for v in jout] == [r.txid
                                                           for r in batch]
    assert head == jhead
    assert g_buf == jg_buf and h_buf == jh_buf and len(g_buf) == 32 * 256
    assert dyn_s == jdyn_s
    assert dyn_enc == jdyn_enc and len(dyn_enc) == 32 * len(dyn_s)


def test_tx_batches_accept_and_reject_on_the_cpu():
    cap, batch = _batch()
    bp, eng = BulletproofGens(cap), TorchEngine("cpu")
    txs = [Tx.from_bytes(r.wire) for r in batch]
    ids = [r.txid for r in batch]
    timings = {}
    assert [v.id for v in fused_verify_tx_batch(
        txs, bp, ENTROPY, engine=eng, timings=timings)] == ids
    # 2 + 2 * 256 generator columns and 81 dynamic points
    assert (timings["aggregated_keys"], timings["msm_size"]) == (2, 595)
    assert [v.id for v in verify_tx_batch(txs, bp, ENTROPY,
                                          engine=eng)] == ids
    bad = [txs[0], Tx.from_bytes(fixture.tampered_tx(batch[1].wire, "proof")),
           txs[2]]
    with pytest.raises(VerificationError, match=r"\(tx 1\)"):
        fused_verify_tx_batch(bad, bp, ENTROPY, engine=eng)
    with pytest.raises(VerificationError, match=r"\(job 1\)"):
        verify_tx_batch(bad, bp, ENTROPY, engine=eng)
