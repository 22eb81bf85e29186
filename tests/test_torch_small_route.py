"""The small MSM route's kernels by their plain twins
(zkvm_tpu_torch.kernels.msm small_scan_plain, the bucket sums of K5s, and
bucket_fold_plain, K3's fold, in its one-launch shape at nb = 128) against
the JAX package's oracle: the bucket sums bucket by bucket, the fold
against Σ_b b · B_b of the oracle's bucket sums, and the route's totals
against the bucket pipeline and the oracle MSM.  (The JAX package's own small route, pallas_msm._bucket_totals,
takes over 20 s in interpret mode on the CPU even at 8 points, so it is
not run here; the elementwise K5 and K6 stay held against its Pallas
kernels in test_torch_pointwise.py.)"""

import re
from pathlib import Path

import numpy as np
import torch

from zkvm_tpu.oracle import edwards as oe
from zkvm_tpu.oracle.ristretto import RistrettoPoint
from zkvm_tpu_torch.constants import L, P
from zkvm_tpu_torch.kernels import msm
from zkvm_tpu_torch.kernels import field as F
from zkvm_tpu_torch.kernels import scalarmod as sm
from zkvm_tpu_torch.kernels.words import (points_to_ints, points_words,
                                          to_device, words_to_points)

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

WBITS = 8
NB = 1 << (WBITS - 1)


def _same(a, b):
    return all((a[i] * b[2] - b[i] * a[2]) % P == 0 for i in (0, 1, 3))


def _points(rs, n):
    return [RistrettoPoint.from_uniform_bytes(rs.bytes(64)).ep
            for _ in range(n)]


def _digits(rs, n, nw):
    """Signed digits (n, nw) with one pattern per window: 0 empty; 1 one
    run of n - 1 equal digits; 2 top-heavy (magnitudes 1 and 2, both
    signs); 3 negative only; 4 a single point; 5 runs of 5 across the
    edges of the 3-record chunks here; the rest random in [-NB, NB]."""
    d = rs.integers(-NB, NB + 1, size=(n, nw))
    d[:, 0] = 0
    d[:, 1] = 7
    d[-1, 1] = 0
    d[:, 2] = rs.integers(1, 3, n) * rs.choice([-1, 1], n)
    d[:, 3] = -rs.integers(1, NB + 1, n)
    d[:, 4] = 0
    d[n // 2, 4] = -NB
    d[:, 5] = 1 + (np.arange(n) // 5) % NB
    return torch.tensor(d, dtype=torch.int32)


def test_small_scan_and_fold_against_oracle_bucket_by_bucket():
    """K5s's twin at the kernel's shape (128 chunks of 3 records a window,
    the twin's copies of the kernel's compile-time shape equal to the
    source's): every bucket equal to the oracle's sum of its signed
    points, empty ones the identity; K3's twin on those buckets (32 groups
    of 4, one pass): Σ_b b · B_b of the oracle's buckets, and the totals
    those of the bucket pipeline (K2/K3's twins)."""
    text = (Path(msm.__file__).parent / "csrc" / "small_scan.cu").read_text()
    shape = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert (int(shape["kGroups"]), int(shape["kCluster"])) == (
        msm.SMALL_GROUPS, msm.SMALL_CLUSTER)
    assert msm.fold_shape(NB)[:2] == (32, 1)
    rs = np.random.default_rng(81)
    n = 300
    eps = _points(rs, n)
    nw = sm.num_windows(WBITS)
    digits = _digits(rs, n, nw)
    points = words_to_points(to_device(points_words(eps), "cpu"))
    keys, shift = msm.pack_keys(digits)
    keys = torch.sort(keys, dim=1).values.contiguous()

    want = [[oe.IDENTITY] * NB for _ in range(nw)]
    for i, ep in enumerate(eps):
        for w in range(nw):
            dv = int(digits[i, w])
            if dv:
                want[w][abs(dv) - 1] = oe.add(want[w][abs(dv) - 1],
                                              ep if dv > 0 else oe.neg(ep))
    buckets = msm.small_scan_plain(keys, points, NB, shift)
    assert buckets.shape == (4, F.NL, nw * NB) and buckets.dtype == torch.int32
    ints = points_to_ints(buckets)
    assert all(_same(ints[w * NB + b], want[w][b])
               for w in range(nw) for b in range(NB))

    totals = []
    for w in range(nw):                  # Σ_b (b + 1) B_b by running sums
        run, tot = oe.IDENTITY, oe.IDENTITY
        for b in range(NB - 1, -1, -1):
            run = oe.add(run, want[w][b])
            tot = oe.add(tot, run)
        totals.append(tot)
    large = msm.window_totals_large(points, digits, WBITS)
    got = msm.bucket_fold_plain(buckets, nw, NB)
    assert got.shape == (4, F.NL, nw)
    assert all(_same(a, b) for a, b in zip(points_to_ints(got), totals))
    assert all(_same(a, b) for a, b in zip(points_to_ints(large), totals))


def test_small_route_totals_match_large_route_and_oracle_msm():
    """window_totals_small (the two twins after the sort) on a single
    point, and on scalars near L (negative digits in every window) with a
    repeated one: its totals equal the bucket pipeline's as points, and
    their Horner fold (by the oracle) the oracle MSM."""
    rs = np.random.default_rng(82)
    for n in (1, 24):
        eps = _points(rs, n)
        ks = [L - 1 - int.from_bytes(rs.bytes(4), "little") for _ in range(n)]
        if n > 1:
            ks[3] = ks[7] = ks[9]
        digits = sm.signed_digits(sm.ints_to_limbs(ks), WBITS)
        points = words_to_points(to_device(points_words(eps), "cpu"))
        small = points_to_ints(msm.window_totals_small(points, digits, WBITS))
        large = msm.window_totals_large(points, digits, WBITS)
        assert all(_same(a, b) for a, b in zip(small, points_to_ints(large)))
        acc = small[-1]
        for total in small[-2::-1]:
            for _ in range(WBITS):
                acc = oe.double(acc)
            acc = oe.add(acc, total)
        assert _same(acc, oe.multiscalar_mul(ks, eps))
