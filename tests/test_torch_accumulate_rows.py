"""The word and affine bucket sums (plain K11 and K12,
msm.bucket_accumulate_words_plain and bucket_accumulate_affine_plain) on
K2's chunked levels, at n = 300 points (three levels: 300 -> 20 -> 6
records a window), bucket by bucket against the JAX package's Edwards
oracle and against K2's twin as points.  The rows come from point_rows and
to_affine_words on points with Z != 1, gathered into sorted order."""

import functools

import numpy as np
import pytest
import torch

from zkvm_tpu.constants import P
from zkvm_tpu.oracle import edwards as oe
from zkvm_tpu.oracle.ristretto import RistrettoPoint as JPoint
from zkvm_tpu_torch.kernels import field as F
from zkvm_tpu_torch.kernels import msm
from zkvm_tpu_torch.kernels.gather import gather_words_plain
from zkvm_tpu_torch.kernels.words import (points_to_ints, points_words,
                                          to_device, words_to_points)

torch.set_num_threads(1)

N, WBITS = 300, 5
NB = 1 << (WBITS - 1)


def _same_point(a, b):
    return all((a[i] * b[2] - b[i] * a[2]) % P == 0 for i in (0, 1, 3))


def _same_points(a, b):
    A, B = F.unpack_points(a), F.unpack_points(b)
    return all(bool(F.is_zero(F.sub(F.mul(A[i], B[2]), F.mul(B[i], A[2])))
                    .all()) for i in (0, 1, 3))


@functools.lru_cache(maxsize=None)
def _case():
    """(extended points, their limbs, digits (N, 5), sorted keys, offsets,
    index bits, K2's twin's bucket sums).  Windows, in sorted order:
      0: 11 zero digits, then runs of 1, 20, 33 (starting on a
         first-level chunk edge and crossing the next), 100 (crossing
         chunks 2-5, so that its pieces cross the second level's chunk
         edge at record 8), 64 and 71 records, every third digit negative;
      1: no nonzero digit (an empty window);
      2: one run of all N (every digit equal);
      3: random negative digits only;
      4: random digits in [-NB, NB], zeros among them."""
    rs = np.random.default_rng(91)
    pts = []
    for _ in range(N):
        X, Y, Z, T = JPoint.from_uniform_bytes(rs.bytes(64)).ep
        f = int.from_bytes(rs.bytes(32), "little") % P or 1
        pts.append((X * f % P, Y * f % P, Z * f % P, T * f % P))
    limbs = words_to_points(to_device(points_words(pts), "cpu"))
    runs = [(0, 11), (1, 1), (2, 20), (3, 33), (5, 100), (7, 64), (NB, 71)]
    mags = [m for m, k in runs for _ in range(k)]
    assert len(mags) == N
    digits = np.zeros((N, 5), np.int64)
    for k, i in enumerate(rs.permutation(N)):
        digits[i, 0] = -mags[k] if k % 3 == 0 else mags[k]
    digits[:, 2] = 6
    digits[:, 3] = -rs.integers(1, NB + 1, N)
    digits[:, 4] = rs.integers(-NB, NB + 1, N)
    digits = torch.from_numpy(digits.astype(np.int32))
    keys, offsets, shift = msm.sort_keys(digits, NB)
    assert msm.accumulate_levels(N) == [N, 20, 6]
    assert offsets[0, :8].tolist() == [11, 12, 32, 65, 65, 165, 165, 229]
    k2 = msm.bucket_accumulate_plain(keys, offsets, limbs, NB, shift)
    return pts, limbs, digits, keys, offsets, shift, k2


@pytest.mark.parametrize("config", ["words", "affine"])
def test_row_bucket_sums_match_oracle_and_k2(config):
    """Every bucket of every window equals the oracle's sum of its signed
    points, and the twin's sums equal K2's as points."""
    pts, limbs, digits, keys, offsets, shift, k2 = _case()
    perm = keys & ((1 << shift) - 1)
    if config == "words":
        rows = gather_words_plain(msm.point_rows(limbs), perm)
        got = msm.bucket_accumulate_words_plain(keys, offsets, rows, NB,
                                                shift)
    else:
        rows = gather_words_plain(msm.to_affine_words(limbs), perm)
        got = msm.bucket_accumulate_affine_plain(keys, offsets, rows, NB,
                                                 shift)
    assert _same_points(got, k2)
    got_ints = points_to_ints(got)
    for w in range(digits.shape[1]):
        want = [oe.IDENTITY] * NB
        for i, d in enumerate(digits[:, w].tolist()):
            if d:
                want[abs(d) - 1] = oe.add(want[abs(d) - 1],
                                          pts[i] if d > 0 else oe.neg(pts[i]))
        for b in range(NB):
            assert _same_point(got_ints[w * NB + b], want[b]), (w, b)
