"""The bucket pipeline's word and affine configurations on the CPU (plain
versions of K9-K12 in zkvm_tpu_torch.kernels), through TorchEngine, against
K2's plain version and the JAX package's host Engine.msm on the same points
and scalars.  Integers compare exactly; points compare by
cross-multiplication.  The configurations' switches and the affine
prelude are in test_torch_msm_prelude.py."""

import functools

import numpy as np
import pytest
import torch

from zkvm_tpu.oracle.ristretto import RistrettoPoint as JPoint
from zkvm_tpu.proofs.engine import Engine as JEngine
from zkvm_tpu_torch.constants import L, P
from zkvm_tpu_torch.kernels import field as F
from zkvm_tpu_torch.kernels import msm
from zkvm_tpu_torch.kernels import scalarmod as sm
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.kernels.frontend import combine_window_totals
from zkvm_tpu_torch.kernels.words import (points_to_words, points_words,
                                          to_device, words_to_points)
from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

N, WBITS = 2100, 11      # just above the small route, so the bucket pipeline


def _same_points(a, b):
    A, B = F.unpack_points(a), F.unpack_points(b)
    return all(bool(F.is_zero(F.sub(F.mul(A[i], B[2]), F.mul(B[i], A[2])))
                    .all()) for i in (0, 1, 3))


def _same_point(a, b):
    return all((a[i] * b[2] - b[i] * a[2]) % P == 0 for i in (0, 1, 3))


@functools.lru_cache(maxsize=None)
def _case():
    """(extended points with loose Z != 1, scalars, the JAX host engine's
    MSM).  32 random points tiled, each scaled projectively by a random
    factor, so the affine prelude has real inversions to do."""
    rs = np.random.default_rng(72)
    base = [RistrettoPoint.from_uniform_bytes(rs.bytes(64)).ep
            for _ in range(32)]
    pts = []
    for i in range(N):
        X, Y, Z, T = base[i % 32]
        f = int.from_bytes(rs.bytes(32), "little") % P or 1
        pts.append((X * f % P, Y * f % P, Z * f % P, T * f % P))
    ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(N)]
    ks[3] = 0
    return pts, ks, JEngine().msm(ks, [JPoint(p) for p in pts]).ep


@functools.lru_cache(maxsize=None)
def _default_totals():
    """K2's window totals on the same limbs and digits."""
    pts, ks, _ = _case()
    points = words_to_points(to_device(points_words(pts), "cpu"))
    return msm.window_totals_large(
        points, sm.signed_digits(sm.ints_to_limbs(ks), WBITS), WBITS,
        msm.MsmConfig())


@pytest.mark.parametrize("config", [
    msm.MsmConfig(sort=True, gather=True), msm.MsmConfig(affine=True)],
    ids=["sort+gather", "affine"])
def test_window_totals_configs_match_k2_and_oracle(config):
    """Through TorchEngine("cpu", wbits, config): K9 + K10 + K11's twins
    give the default pipeline's (K2's) window totals word for word; K10 +
    K12's the same points in other coordinates; both combine to the JAX
    package's host MSM.  (The default is held against the oracle in
    test_torch_msm.py.)"""
    pts, ks, want = _case()
    totals, wbits = TorchEngine("cpu", WBITS, config).window_totals(
        ks, [RistrettoPoint(p) for p in pts])
    assert wbits == WBITS
    if config.gather:
        assert torch.equal(points_to_words(totals),
                           points_to_words(_default_totals()))
    else:
        assert _same_points(totals, _default_totals())
    assert _same_point(combine_window_totals(totals, WBITS), want)
