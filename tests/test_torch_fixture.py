"""The committed fixture zkvm_tpu_torch/data/rangeproofs_n64_m1.bin — the
port's only source of real proofs on a machine without JAX — verifies
under both packages, and a flipped byte is rejected by both.

Regenerate it with the JAX package's prover:
    python tests/test_torch_fixture.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

if __name__ == "__main__":      # run as a script: import from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from zkvm_tpu.constants import L  # noqa: E402
from zkvm_tpu.proofs import rangeproof as jrp
from zkvm_tpu.proofs.errors import ProofError as JProofError
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.proofs.errors import ProofError
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.rangeproof import RangeProof, batch_verify
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

LABEL = b"zkvm_tpu_torch fixture"
COUNT = 64


def _jax_accepts(label, n, records):
    try:
        jrp.batch_verify([jrp.RangeProof.from_bytes(w) for w, _ in records],
                         JBulletproofGens(n, 1), JPedersenGens(),
                         [JProofTranscript(label) for _ in records],
                         [v for _, v in records], n)
        return True
    except (JProofError, ValueError):
        return False


def _port_accepts(label, n, records):
    try:
        batch_verify([RangeProof.from_bytes(w) for w, _ in records],
                     BulletproofGens(n, 1), PedersenGens(),
                     [ProofTranscript(label) for _ in records],
                     [v for _, v in records], n, device="cpu")
        return True
    except (ProofError, ValueError):
        return False


def test_fixture_verifies_under_both_packages():
    label, n, m, records = fixture.load()
    assert (label, n, m, len(records)) == (LABEL, 64, 1, COUNT)
    assert len({w for w, _ in records}) == COUNT
    assert _jax_accepts(label, n, records)
    assert _port_accepts(label, n, records)


@pytest.mark.parametrize("offset", [5, 300])   # the A point, an L point
def test_flipped_byte_rejected_by_both(offset):
    label, n, _, records = fixture.load()
    recs = records[:4]
    w = bytearray(recs[2][0])
    w[offset] ^= 0x01
    recs = recs[:2] + [(bytes(w), recs[2][1])] + recs[3:]
    assert not _jax_accepts(label, n, recs)
    assert not _port_accepts(label, n, recs)


def _regenerate():
    rs = np.random.default_rng(2026)
    bp, pc = JBulletproofGens(64, 1), JPedersenGens()
    records = []
    for _ in range(COUNT):
        value = int(rs.integers(0, 2**63)) * 2 + int(rs.integers(0, 2))
        blinding = int.from_bytes(rs.bytes(32), "little") % L
        proof, vc = jrp.RangeProof.prove_single(
            bp, pc, JProofTranscript(LABEL), value, blinding, 64)
        records.append((proof.to_bytes(), [vc]))
    fixture.dump(fixture.FIXTURE, LABEL, 64, 1, records)


if __name__ == "__main__":
    _regenerate()
