"""The chunked bucket sums (plain K2, msm.bucket_accumulate_plain) folded by
the two-pass weighted fold (plain K3, msm.bucket_fold_plain) at n = 4,113
points, against the JAX package's host combine_window_totals and the
oracle's Σ k_i·P_i, as exact Edwards points: random scalars, and one
scalar for every point, which puts each window's n digits in one run that
crosses every chunk edge."""

import numpy as np
import pytest
import torch

from zkvm_tpu.constants import L, P
from zkvm_tpu.kernels.limbs import ints_to_limbs
from zkvm_tpu.kernels.pallas_msm import combine_window_totals
from zkvm_tpu.oracle import edwards as oe
from zkvm_tpu.oracle.ristretto import RistrettoPoint as JPoint
from zkvm_tpu_torch.kernels import msm
from zkvm_tpu_torch.kernels import scalarmod as sm
from zkvm_tpu_torch.kernels.words import (points_to_ints, points_words,
                                          to_device, words_to_points)

torch.set_num_threads(1)

N, BASE = 4113, 61


def _same_point(a, b):
    return all((a[i] * b[2] - b[i] * a[2]) % P == 0 for i in (0, 1, 3))


def _oracle_msm(ks, base):
    """Σ k_i·P_i for P_i = base[i % len(base)]: one scalar multiplication
    per base point, of the sum of its scalars."""
    acc = oe.IDENTITY
    for j, p in enumerate(base):
        acc = oe.add(acc, oe.scalar_mul(sum(ks[j::len(base)]), p))
    return acc


@pytest.mark.parametrize("wbits", [8, 13])
def test_chunked_bucket_sums_fold_to_oracle_msm(wbits):
    rs = np.random.default_rng(500 + wbits)
    base = [JPoint.from_uniform_bytes(rs.bytes(64)).ep for _ in range(BASE)]
    points = words_to_points(to_device(
        points_words([base[i % BASE] for i in range(N)]), "cpu"))
    nb = 1 << (wbits - 1)
    for kind in ("random", "equal"):
        if kind == "random":
            ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(N)]
            ks[3] = ks[70] = 0
        else:
            ks = [int.from_bytes(rs.bytes(32), "little") % L] * N
        digits = sm.signed_digits(sm.ints_to_limbs(ks), wbits)
        assert int((digits < 0).sum()) > 0
        keys, offsets, shift = msm.sort_keys(digits, nb)
        if kind == "equal":          # one run of n per window with a digit
            runs = offsets[:, 1:] - offsets[:, :-1]
            assert set(runs.max(1).values.tolist()) <= {0, N}
        buckets = msm.bucket_accumulate_plain(keys, offsets, points, nb, shift)
        totals = msm.bucket_fold_plain(buckets, digits.shape[1], nb)
        tot = points_to_ints(totals)
        packed = np.stack([ints_to_limbs([t[c] for t in tot]).T
                           for c in range(4)])
        assert _same_point(combine_window_totals(packed, wbits),
                           _oracle_msm(ks, base)), kind
