"""The chunked bucket sums (plain K2, msm.bucket_accumulate_plain) on a
hand-built digit pattern, bucket by bucket against the oracle, and the
two-pass weighted fold (plain K3, msm.bucket_fold_plain) against a direct
Σ_b b·B_b from the oracle, as exact Edwards points."""

import numpy as np
import torch

from zkvm_tpu.constants import P
from zkvm_tpu.oracle import edwards as oe
from zkvm_tpu.oracle.ristretto import RistrettoPoint as JPoint
from zkvm_tpu_torch.kernels import msm
from zkvm_tpu_torch.kernels.words import (points_to_ints, points_words,
                                          to_device, words_to_points)

torch.set_num_threads(1)


def _same_point(a, b):
    return all((a[i] * b[2] - b[i] * a[2]) % P == 0 for i in (0, 1, 3))


def _points(rs, n):
    base = [JPoint.from_uniform_bytes(rs.bytes(64)).ep for _ in range(n)]
    return base, words_to_points(to_device(points_words(base), "cpu"))


def test_chunked_bucket_sums_on_crafted_runs():
    """Window 0 in sorted order (chunks of 16 records, and of 4): 10 zero
    digits, then runs of magnitude 1 (6 records), 2 (16, starting and
    ending on chunk edges), 3 (40, starting on an edge and crossing
    several), 5 (28), with every third digit negative; window 1 holds no
    nonzero digit; window 2 one run of all 100 records, all negative."""
    rs = np.random.default_rng(71)
    n, wbits = 100, 4
    nb = 1 << (wbits - 1)
    base, points = _points(rs, n)
    mags = [0] * 10 + [1] * 6 + [2] * 16 + [3] * 40 + [5] * 28
    perm = rs.permutation(n)            # the points' order before the sort
    digits = np.zeros((n, 3), np.int32)
    for k, i in enumerate(perm):
        digits[i, 0] = -mags[k] if k % 3 == 0 else mags[k]
    digits[:, 2] = -nb
    digits = torch.from_numpy(digits)
    keys, offsets, shift = msm.sort_keys(digits, nb)
    assert offsets[0].tolist() == [10, 16, 32, 72, 72, 100, 100, 100, 100]
    for chunk in (16, 4):
        got = points_to_ints(msm.bucket_accumulate_plain(
            keys, offsets, points, nb, shift, chunk))
        for w in range(3):
            for b in range(nb):
                want = oe.IDENTITY
                for i in range(n):
                    d = int(digits[i, w])
                    if abs(d) == b + 1:
                        want = oe.add(want, base[i] if d > 0
                                      else oe.neg(base[i]))
                assert _same_point(got[w * nb + b], want), (chunk, w, b)


def test_two_pass_fold_matches_direct_weighted_sum():
    """Σ_b b·B_b over nw = 2 windows of random bucket points (a few left
    the identity) at nb = 128 (one block a window) and 1,024 (eight), and
    at nb = 32, 2 and 1, where a block holds fewer groups than a warp."""
    rs = np.random.default_rng(72)
    base, base_pts = _points(rs, 31)
    for nb in (128, 1024, 32, 2, 1):
        nw = 2
        pick = rs.integers(0, 31, size=nw * nb)
        buckets = base_pts[:, :, pick].clone()
        empty = rs.choice(nw * nb, size=min(5, nb), replace=False)
        buckets[:, :, empty] = 0
        buckets[1:3, 0, empty] = 1
        got = points_to_ints(msm.bucket_fold_plain(buckets, nw, nb))
        for w in range(nw):
            weight = [0] * len(base)
            for b in range(nb):
                if w * nb + b not in empty:
                    weight[pick[w * nb + b]] += b + 1
            want = oe.IDENTITY
            for k, p in zip(weight, base):
                want = oe.add(want, oe.scalar_mul(k, p))
            assert _same_point(got[w], want), (nb, w)
