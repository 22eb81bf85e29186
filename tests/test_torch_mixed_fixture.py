"""The committed fixture zkvm_tpu_torch/data/rangeproofs_n64_mixed.bin — range
proofs of mixed aggregation sizes (16 each of m = 2, 4 and 8, and 2 of
m = 32, 64-bit values) — verifies under both packages as one batch, and a
flipped byte is rejected by both.

Regenerate it with the JAX package's prover:
    python tests/test_torch_mixed_fixture.py
"""

import functools
import sys
from pathlib import Path

import numpy as np
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

LABEL = b"zkvm_tpu_torch mixed fixture"
SIZES = {2: 16, 4: 16, 8: 16, 32: 2}      # m -> proofs


@functools.lru_cache(maxsize=None)
def _jax_gens(n):
    return JBulletproofGens(n, 32)


@functools.lru_cache(maxsize=None)
def _port_gens(n):
    return BulletproofGens(n, 32)


def _jax_accepts(label, n, records):
    try:
        jrp.batch_verify([jrp.RangeProof.from_bytes(w) for w, _ in records],
                         _jax_gens(n), JPedersenGens(),
                         [JProofTranscript(label) for _ in records],
                         [v for _, v in records], n)
        return True
    except (JProofError, ValueError):
        return False


def _port_accepts(label, n, records):
    try:
        batch_verify([RangeProof.from_bytes(w) for w, _ in records],
                     _port_gens(n), PedersenGens(),
                     [ProofTranscript(label) for _ in records],
                     [v for _, v in records], n, device="cpu")
        return True
    except (ProofError, ValueError):
        return False


def test_mixed_fixture_verifies_under_both_packages():
    label, n, records = fixture.load_mixed()
    assert (label, n) == (LABEL, 64)
    ms = [len(v) for _, v in records]
    assert {m: ms.count(m) for m in set(ms)} == SIZES
    assert len({w for w, _ in records}) == len(records)
    assert _jax_accepts(label, n, records)
    assert _port_accepts(label, n, records)


def test_flipped_byte_rejected_by_both():
    label, n, records = fixture.load_mixed()
    first = {}
    for rec in records:
        first.setdefault(len(rec[1]), rec)
    for offset in (5, 300):                     # the A point, an L point
        recs = [first[2], first[4], first[8]]
        w = bytearray(recs[1][0])
        w[offset] ^= 0x01
        recs[1] = (bytes(w), recs[1][1])
        assert not _jax_accepts(label, n, recs)
        assert not _port_accepts(label, n, recs)


def _regenerate():
    rs = np.random.default_rng(2027)
    bp, pc = _jax_gens(64), JPedersenGens()
    records = []
    for m, count in SIZES.items():
        for _ in range(count):
            values = [int(rs.integers(0, 2**63)) * 2 + int(rs.integers(0, 2))
                      for _ in range(m)]
            blinds = [int.from_bytes(rs.bytes(32), "little") % L
                      for _ in range(m)]
            proof, vcs = jrp.RangeProof.prove_multiple(
                bp, pc, JProofTranscript(LABEL), values, blinds, 64)
            records.append((proof.to_bytes(), list(vcs)))
    if not _jax_accepts(LABEL, 64, records):
        raise RuntimeError("the JAX package rejects the new proofs")
    fixture.dump_mixed(fixture.FIXTURE_MIXED, LABEL, 64, records)


if __name__ == "__main__":
    _regenerate()
