"""The port's boundary: no module of zkvm_tpu_torch, and not chip_smoke.py,
imports JAX or the JAX package, and the native host library is built from
the port's own sources alone; its entry points run on the card unless the
caller asks for the CPU; and nothing falls back silently (a wrapper given
a tensor on neither the CPU nor a card, a native library that fails to
build)."""

import ast
import re
import sys
from pathlib import Path

import pytest
import torch

import zkvm_tpu_torch
from zkvm_tpu_torch import fixture, native
from zkvm_tpu_torch import micro as micro_bench
from zkvm_tpu_torch.chain import BlockchainState, Mempool
from zkvm_tpu_torch.chain.node import Node
from zkvm_tpu_torch.chain.p2p import SecurePeer
from zkvm_tpu_torch.crypto import musig, starsig
from zkvm_tpu_torch.crypto import Xprv
from zkvm_tpu_torch.kernels import (combine, decompress, fixed_base, gather,
                                    micro, msm, msm_ct, pointwise, sort)
from zkvm_tpu_torch.kernels.batch_verify_device import (
    batch_verify_device_pipelined)
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.parallel.mpc_hosts import distributed_prove
from zkvm_tpu_torch.parallel.tx_batch import fused_verify_tx_batch
from zkvm_tpu_torch.proofs.engine import get_engine
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.ipp import InnerProductProof
from zkvm_tpu_torch.oracle.merlin import Transcript
from zkvm_tpu_torch.proofs.r1cs import Prover, R1CSProof
from zkvm_tpu_torch.proofs.rangeproof import RangeProof, batch_verify
from zkvm_tpu_torch.proofs.transcript import ProofTranscript
from zkvm_tpu_torch.utils import Config
from zkvm_tpu_torch.vm import Instruction, Tx, TxHeader, build_tx, verify_tx
from zkvm_tpu_torch.vm.predicate import PredicateTree

ROOT = Path(zkvm_tpu_torch.__file__).resolve().parent
# the JAX package, and its micro-benchmarks (bench/pallas_micro.py)
FORBIDDEN = ("jax", "jaxlib", "zkvm_tpu", "bench", "pallas_micro")


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
    # the native loader compiles and hashes files under native/ only, and
    # the sources include nothing of the repo but native/field51.h
    here = ROOT / "native"
    assert native.SRC_DIR == here and native.BUILD_DIR.parent == here
    for name in native.SOURCES + native.HEADERS:
        src = (native.SRC_DIR / name).resolve()
        assert src.parent == here and src.exists(), name
        local = re.findall(r'#include\s+"([^"]+)"', src.read_text())
        assert set(local) <= {"field51.h"}, (name, local)


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
    with pytest.raises(RuntimeError, match="CUDA"):
        micro_bench.main([])


def test_engine_entry_points_without_device_need_cuda():
    """The default engine is a TorchEngine on the card: without one, the
    engine and the entry points that ride it raise: the verifiers, the
    provers, the signers, build_tx, the serving pipeline, the node, its
    mempool and channel, and the configuration's engine."""
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
    # the prover: its commitments and the inner-product argument
    with pytest.raises(RuntimeError, match="CUDA"):
        RangeProof.prove_single(bp, pc, ProofTranscript(label), 5, 7, n)
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.commit_batch([5], [7])
    with pytest.raises(RuntimeError, match="CUDA"):
        InnerProductProof.create(ProofTranscript(label), pc.B, [1, 1], [1, 1],
                                 bp.G(2, 1), bp.H(2, 1), [1, 2], [3, 4])
    # the R1CS prover, the signers and build_tx
    prover = Prover(pc, ProofTranscript(label))
    prover.allocate_multiplier((2, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        prover.prove(bp)
    with pytest.raises(RuntimeError, match="CUDA"):
        Prover(pc, ProofTranscript(label)).commit(5, 7)
    with pytest.raises(RuntimeError, match="CUDA"):
        starsig.VerificationKey.from_secret(5)
    with pytest.raises(RuntimeError, match="CUDA"):
        starsig.sign(Transcript(b"msg"), 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        musig.sign_multi([5, 6], Transcript(b"msg"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_tx([Instruction("push", data=(10).to_bytes(8, "little")),
                  Instruction("fee")], TxHeader(), bp)
    # key derivation, taproot predicates and the multi-host MPC
    with pytest.raises(RuntimeError, match="CUDA"):
        Xprv.random(bytes(64)).to_xpub()
    with pytest.raises(RuntimeError, match="CUDA"):
        PredicateTree(bytes(32), [b"leaf"]).predicate()
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed_prove(bp, pc, b"mpc", [[5]], [[7]], n)
    # the serving pipeline, the node and its channel, the configuration
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_verify_device_pipelined(
            [([RangeProof.from_bytes(recs1[0][0])], [ProofTranscript(label1)],
              [recs1[0][1]])], BulletproofGens(n, 1), pc, n)
    with pytest.raises(RuntimeError, match="CUDA"):
        Mempool(bp)
    with pytest.raises(RuntimeError, match="CUDA"):
        Node(BlockchainState.make_initial(1000), bp)
    with pytest.raises(RuntimeError, match="CUDA"):
        SecurePeer.handshake(None, None, None, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Config().apply()


def test_kernel_wrappers_refuse_non_cuda_devices(monkeypatch, tmp_path):
    """A wrapper takes its plain version only for a CPU tensor; anything
    else must be a CUDA tensor, never a silent fallback.  Nor is there one
    for the native host library: a failing or missing compiler raises, with
    the compiler's output."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "COMPILER", [
        sys.executable, "-c",
        "import sys; sys.stderr.write('no such compiler'); sys.exit(1)"])
    with pytest.raises(RuntimeError, match="failed to build(.|\n)*no such "
                                           "compiler"):
        native.lib()
    monkeypatch.setattr(native, "COMPILER", [str(tmp_path / "missing-g++")])
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.lib()
    assert not list(tmp_path.glob("*.so"))
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
    for form in micro.MUL_FORMS:
        with pytest.raises(ValueError, match="CUDA"):
            micro.micro_mul(fe, fe, 8, form)
    for variant in micro.PARTS:
        with pytest.raises(ValueError, match="CUDA"):
            micro.micro_parts(fe, fe, variant, 8)
    for chain in (micro.micro_add_chain, micro.micro_add_chain_lanes):
        with pytest.raises(ValueError, match="CUDA"):
            chain(pts, pts, 8)
    with pytest.raises(ValueError, match="CUDA"):
        msm.window_totals_small(pts, torch.zeros((64, 32), dtype=torch.int32,
                                                 device="meta"), 8)
    digits = torch.empty((64, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fixed_base.table(pts[:, :, :1])
    with pytest.raises(ValueError, match="CUDA"):
        fixed_base.fixed_base_ct(torch.empty((64, 8, 4, 10),
                                             dtype=torch.int32,
                                             device="meta"), digits)
    with pytest.raises(ValueError, match="CUDA"):
        msm_ct.msm_ct(pts, digits, [64])
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
