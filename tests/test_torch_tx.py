"""The port's ZkVM verifier (zkvm_tpu_torch.vm) against the JAX package's
on the committed transactions (zkvm_tpu_torch/data/txs_block256.bin): one
issue, one payment and the coverage transactions (taproot `call`,
`signid`, `signtag`, `unblind`, `borrow`/`retire`, `fee`).

precompute_tx must give the JAX package's host pieces exactly: txid, log,
fee, every deferred PointOp, and the R1CS job's scalars (its points
compressed).  verify_tx on TorchEngine("cpu") (the kernels' plain
versions) accepts a payment and rejects it with a flipped proof byte.
"""

import pytest
import torch

from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.errors import VerificationError as JVerificationError
from zkvm_tpu.vm import Tx as JTx
from zkvm_tpu.vm import verify_tx as jverify_tx
from zkvm_tpu.vm.verifier import precompute_tx as jprecompute_tx
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.proofs.errors import VerificationError
from zkvm_tpu_torch.proofs.generators import BulletproofGens
from zkvm_tpu_torch.vm import Tx
from zkvm_tpu_torch.vm.verifier import precompute_tx, verify_tx

# the suite runs in several worker processes and these tensors are small
torch.set_num_threads(1)


def _ops(ops):
    return [(op.primary, op.secondary, op.arbitrary) for op in ops]


def _log(vtx):
    return [(e.kind, e.payload) for e in vtx.log]


def test_precompute_tx_equals_jax():
    cap, recs = fixture.load_txs()
    cases = [recs[0], recs[192]] + recs[256:]
    assert [r.kind for r in cases] == ["issue", "payment"] + list(
        fixture.TX_KINDS[2:])
    bp, jbp, eng = BulletproofGens(cap), JBulletproofGens(cap), TorchEngine("cpu")
    for rec in cases:
        vtx, ops, (scalars, points) = precompute_tx(Tx.from_bytes(rec.wire),
                                                    bp, eng)
        jvtx, jops, (jscalars, jpoints) = jprecompute_tx(
            JTx.from_bytes(rec.wire), jbp)
        assert vtx.id == jvtx.id == rec.txid, rec.kind
        assert _log(vtx) == _log(jvtx) and vtx.fee == jvtx.fee, rec.kind
        assert _ops(ops) == _ops(jops) and (ops or rec.kind == "fee"), rec.kind
        assert scalars == jscalars, rec.kind
        assert [p.compress() for p in points] == [p.compress()
                                                  for p in jpoints], rec.kind


def test_verify_tx_accepts_and_rejects_on_the_cpu():
    cap, recs = fixture.load_txs()
    rec = recs[192]
    bp, eng = BulletproofGens(cap), TorchEngine("cpu")
    timings = {}
    vtx = verify_tx(Tx.from_bytes(rec.wire), bp, engine=eng, timings=timings)
    assert vtx.id == rec.txid and len(vtx.outputs) == 2
    assert timings["msm_size"] == 549 and timings["aggregated_key_s"] > 0
    bad = fixture.tampered_tx(rec.wire, "proof")
    with pytest.raises(JVerificationError):   # the JAX package rejects it too
        jverify_tx(JTx.from_bytes(bad), JBulletproofGens(cap))
    with pytest.raises(VerificationError, match="R1CS"):
        verify_tx(Tx.from_bytes(bad), bp, device="cpu")
