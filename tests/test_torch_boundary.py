"""The port's boundary: no module of zkvm_tpu_torch, and not chip_smoke.py,
imports JAX or the JAX package; and its entry points run on the card unless
the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

import zkvm_tpu_torch
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.kernels import (combine, decompress, gather, msm,
                                    pointwise, sort)
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.parallel.tx_batch import fused_verify_tx_batch
from zkvm_tpu_torch.proofs.engine import get_engine
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.r1cs import R1CSProof
from zkvm_tpu_torch.proofs.rangeproof import RangeProof, batch_verify
from zkvm_tpu_torch.proofs.transcript import ProofTranscript
from zkvm_tpu_torch.vm import Tx, verify_tx

ROOT = Path(zkvm_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "zkvm_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted(ROOT.rglob("*.py")) + [ROOT.parent / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {name}"


def test_entry_point_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    label, n, _, records = fixture.load()
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_verify([RangeProof.from_bytes(w) for w, _ in records[:2]],
                     BulletproofGens(n, 1), PedersenGens(),
                     [ProofTranscript(label) for _ in records[:2]],
                     [v for _, v in records[:2]], n)
    fx = fixture.load_r1cs(fixture.R1CS_CLOAK)
    with pytest.raises(RuntimeError, match="CUDA"):
        fixture.r1cs_verifier(fx).verify(R1CSProof.from_bytes(fx.wire),
                                         PedersenGens(), BulletproofGens(1))
    _, recs = fixture.load_txs()
    txs = [Tx.from_bytes(r.wire) for r in recs[:2]]
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_tx(txs[0], BulletproofGens(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_verify_tx_batch(txs, BulletproofGens(1))


def test_engine_entry_points_without_device_need_cuda():
    """The default engine is a TorchEngine on the card: without one, the
    engine and the entry points that ride it raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_engine()
    label1, n, _, recs1 = fixture.load()
    label, _, recs = fixture.load_mixed()
    wire, vcs = next(r for r in recs if len(r[1]) == 2)
    bp, pc = BulletproofGens(n, 2), PedersenGens()
    with pytest.raises(RuntimeError, match="CUDA"):
        RangeProof.from_bytes(wire).verify_multiple(
            bp, pc, ProofTranscript(label), vcs, n)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_verify([RangeProof.from_bytes(recs1[0][0]),
                      RangeProof.from_bytes(wire)], bp, pc,
                     [ProofTranscript(label1), ProofTranscript(label)],
                     [recs1[0][1], vcs], n)


def test_kernel_wrappers_refuse_non_cuda_devices():
    """A wrapper takes its plain version only for a CPU tensor; anything
    else must be a CUDA tensor, never a silent fallback."""
    meta = torch.empty((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        decompress.ristretto_decode(meta)
    with pytest.raises(ValueError, match="CUDA"):
        combine.horner_check(torch.empty((4, 10, 1, 20), dtype=torch.int32,
                                         device="meta"), 13)
    with pytest.raises(ValueError, match="CUDA"):
        combine.horner_fold(torch.empty((4, 10, 1, 20), dtype=torch.int32,
                                        device="meta"), 13)
    with pytest.raises(ValueError, match="CUDA"):
        msm.bucket_fold(torch.empty((4, 10, 256), dtype=torch.int32,
                                    device="meta"), 2, 128)
    pts = torch.empty((4, 10, 64), dtype=torch.int32, device="meta")
    fe = torch.empty((10, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pointwise.seg_combine(pts, pts, torch.empty((64,), dtype=torch.int32,
                                                    device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        pointwise.point_add(pts, pts)
    with pytest.raises(ValueError, match="CUDA"):
        pointwise.mul(fe, fe)
    with pytest.raises(ValueError, match="CUDA"):
        pointwise.add(fe, fe)
    with pytest.raises(ValueError, match="CUDA"):
        msm.window_totals_small(pts, torch.zeros((64, 32), dtype=torch.int32,
                                                 device="meta"), 8)
    keys = torch.empty((2, 64), dtype=torch.int64, device="meta")
    offsets = torch.empty((2, 129), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        msm.bucket_accumulate(keys, offsets, pts, 128, 6)
    with pytest.raises(ValueError, match="CUDA"):
        sort.radix_sort(keys)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_words(torch.empty((64, 32), dtype=torch.int32,
                                        device="meta"), keys)
    with pytest.raises(ValueError, match="CUDA"):
        msm.bucket_accumulate_words(
            keys, offsets, torch.empty((2, 64, 32), dtype=torch.int32,
                                       device="meta"), 128, 6)
    with pytest.raises(ValueError, match="CUDA"):
        msm.bucket_accumulate_affine(
            keys, offsets, torch.empty((2, 64, 16), dtype=torch.int32,
                                       device="meta"), 128, 6)
