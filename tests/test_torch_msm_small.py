"""The port's small-MSM route (zkvm_tpu_torch.kernels.msm.window_totals_small,
plain K5/K6 on the CPU) against the port's bucket pipeline and the JAX
package's oracle MSM, on the same points and digits; and the route
dispatch at 2,048 points.  (The JAX package's own small route,
pallas_msm._bucket_totals, takes over 20 s in interpret mode on the CPU
even at 8 points, so it is not run here; K5 and K6 themselves are held
against its Pallas kernels in test_torch_pointwise.py.)"""

import numpy as np
import pytest
import torch

from zkvm_tpu.kernels import pallas_msm as pm
from zkvm_tpu.oracle import edwards as oe
from zkvm_tpu.oracle.ristretto import RistrettoPoint
from zkvm_tpu_torch.constants import L, P
from zkvm_tpu_torch.kernels import combine, msm
from zkvm_tpu_torch.kernels import field as F
from zkvm_tpu_torch.kernels import scalarmod as sm
from zkvm_tpu_torch.kernels.words import points_to_ints, points_words, to_device, words_to_points

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)


def _same(a, b):
    return all((a[i] * b[2] - b[i] * a[2]) % P == 0 for i in (0, 1, 3))


def _case(n, seed, kind):
    """Points with torsion components and the identity.  "random" scalars
    have a zero, a repeated value and a small one, so runs and empty
    buckets occur in every window; "equal" gives every point but one the
    same scalar, so each window's longest run is n - 1 points and the scan
    runs all its steps."""
    rs = np.random.default_rng(seed)
    pts = [RistrettoPoint.from_uniform_bytes(rs.bytes(64)).ep for _ in range(n - 1)]
    pts.append(oe.IDENTITY)
    ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(n)]
    if kind == "equal":
        ks = [ks[1]] * (n - 1) + [0]
    else:
        ks[0], ks[2], ks[3] = 0, ks[5], 3
    return pts, ks


@pytest.mark.parametrize("n,wbits,kind", [(16, 8, "random"), (64, 8, "random"),
                                          (131, 9, "random"), (33, 8, "equal")])
def test_small_route_matches_large_route_and_oracle(n, wbits, kind):
    pts, ks = _case(n, 32 + n, kind)
    digits = sm.signed_digits(sm.ints_to_limbs(ks), wbits)
    points = words_to_points(to_device(points_words(pts), "cpu"))
    small = msm.window_totals_small(points, digits, wbits)
    large = msm.window_totals_large(points, digits, wbits)
    assert all(_same(a, b) for a, b in zip(points_to_ints(small),
                                           points_to_ints(large)))
    acc = combine.horner_fold_plain(small.unsqueeze(2), wbits)
    assert _same(tuple(F.fe_to_ints(c)[0] for c in acc),
                 oe.multiscalar_mul(ks, pts))


def test_dispatch_at_2048_points(monkeypatch):
    """window_totals sends n <= 2048 (padded_msm_size(n) < 4096 in the JAX
    package) to the small route and larger n to the bucket pipeline; the
    window width model picks each route's own optimum."""
    calls = []
    monkeypatch.setattr(msm, "window_totals_small", lambda *a: calls.append("small"))
    monkeypatch.setattr(msm, "window_totals_large", lambda *a: calls.append("large"))
    for n in (2048, 2049):
        msm.window_totals(None, torch.zeros((n, 32), dtype=torch.int32), 8)
    assert calls == ["small", "large"]
    assert pm.padded_msm_size(2048) < pm.SEQ_LANES * pm.SEQ_BLOCK
    assert pm.padded_msm_size(2049) == pm.SEQ_LANES * pm.SEQ_BLOCK
    assert [msm.route(n) for n in (1, 1055, 2048, 2049, 66091)] == [
        "small", "small", "small", "large", "large"]
    assert msm.best_wbits(1055) == msm.best_wbits(2048) == 8
    assert msm.best_wbits(2049) == msm.best_wbits(66091) == 11
