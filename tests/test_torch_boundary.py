"""The port's boundary: no module of zkvm_tpu_torch, and not chip_smoke.py,
imports JAX or the JAX package; and its entry points run on the card unless
the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

import zkvm_tpu_torch
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.kernels import combine, decompress, msm
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.rangeproof import RangeProof, batch_verify
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

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
        msm.bucket_fold(torch.empty((4, 10, 256), dtype=torch.int32,
                                    device="meta"), 2, 128)
