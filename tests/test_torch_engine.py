"""The port's Engine seam on the CPU (zkvm_tpu_torch.kernels.engine.TorchEngine
and the range-proof entry points that ride it) against the JAX package:
MSMs against its host Engine through the shared word format
(convert.from_jax_msm_words), and verify_multiple verdicts against its
own, valid and tampered (mixed-aggregation batch_verify:
test_torch_mixed_batch.py).  Proofs come from the committed fixtures (made
by the JAX package's prover)."""

import functools

import numpy as np
import torch

from zkvm_tpu.kernels import pallas_msm as pm
from zkvm_tpu.oracle.ristretto import RistrettoPoint as JPoint
from zkvm_tpu.proofs import rangeproof as jrp
from zkvm_tpu.proofs.engine import Engine as JEngine
from zkvm_tpu.proofs.errors import ProofError as JProofError
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch import convert, fixture
from zkvm_tpu_torch.constants import L, P
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.kernels.frontend import (combine_window_totals,
                                             window_totals_from_words)
from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint
from zkvm_tpu_torch.proofs.errors import ProofError
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.rangeproof import RangeProof
from zkvm_tpu_torch.proofs.scalarvec import ScalarVec
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

def _same_point(a, b):
    return all((a[i] * b[2] - b[i] * a[2]) % P == 0 for i in (0, 1, 3))


@functools.lru_cache(maxsize=None)
def _gens():
    return (JBulletproofGens(64, 4), JPedersenGens(), BulletproofGens(64, 4),
            PedersenGens())


@functools.lru_cache(maxsize=None)
def _records():
    """{m: [(label, wire, vcs)]}: m = 1 from the m = 1 fixture, 2 and 4 from
    the mixed one."""
    label1, _, _, recs1 = fixture.load()
    label, _, recs = fixture.load_mixed()
    out = {1: [(label1, w, v) for w, v in recs1[:2]]}
    for w, v in recs:
        out.setdefault(len(v), []).append((label, w, v))
    return out


def _tamper(rec, how):
    label, wire, vcs = rec
    p = jrp.RangeProof.from_bytes(wire)
    if how == "t_x":
        p.t_x = (p.t_x + 1) % L
    elif how == "encoding":                      # S + p: not canonical
        p.S = (int.from_bytes(p.S, "little") + P).to_bytes(32, "little")
    return label, p.to_bytes(), vcs


def _verdict(fn, errors):
    try:
        fn()
        return "accept"
    except errors as e:
        return type(e).__name__ if isinstance(e, ValueError) else "reject"


def test_engine_msm_matches_jax_host_engine():
    """100 points (the small route) with random scalars, one of them zero,
    through both frontends."""
    rs = np.random.default_rng(80)
    jpts = [JPoint.from_uniform_bytes(rs.bytes(64)) for _ in range(100)]
    ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(100)]
    ks[7] = 0
    want = JEngine().msm(ks, jpts).ep

    pw, sw = pm.pack_words([p.ep for p in jpts], ks)      # padded to 128
    totals = window_totals_from_words(*convert.from_jax_msm_words(pw, sw,
                                                                  "cpu"), 8)
    assert _same_point(combine_window_totals(totals, 8), want)

    eng = TorchEngine("cpu")
    pts = [RistrettoPoint(p.ep) for p in jpts]
    got = eng.msm(ScalarVec.from_ints(ks), pts)
    assert _same_point(got.ep, want)
    assert pts[0]._words is not None                     # words cached
    assert eng.msm_is_identity(ks + [L - 1], pts + [got])


def test_verify_multiple_agrees_with_jax():
    """m = 2 valid and with t_x + 1; m = 4 valid and with a non-canonical
    encoding (ValueError from the host decode in both packages)."""
    jbp, jpc, bp, pc = _gens()
    for m, how in ((2, "valid"), (2, "t_x"), (4, "valid"), (4, "encoding")):
        label, wire, vcs = _tamper(_records()[m][0], how)
        jax_v = _verdict(
            lambda: jrp.RangeProof.from_bytes(wire).verify_multiple(
                jbp, jpc, JProofTranscript(label), vcs, 64),
            (JProofError, ValueError))
        port_v = _verdict(lambda: RangeProof.from_bytes(wire).verify_multiple(
            bp, pc, ProofTranscript(label), vcs, 64, device="cpu"),
            (ProofError, ValueError))
        assert port_v == jax_v == {"valid": "accept", "t_x": "reject",
                                   "encoding": "ValueError"}[how], (m, how)
