"""The port's window totals (plain versions of K2/K3, zkvm_tpu_torch.kernels.msm)
and Horner combine (plain K4, .combine) against the JAX package's host
combine_window_totals and the oracle's Σ k_i·P_i, as exact Edwards points."""

import functools

import numpy as np
import pytest
import torch

from zkvm_tpu.constants import L, P
from zkvm_tpu.kernels.limbs import ints_to_limbs
from zkvm_tpu.kernels.pallas_msm import combine_window_totals
from zkvm_tpu.oracle import edwards as oe
from zkvm_tpu.oracle.ristretto import BASEPOINT as JBASE
from zkvm_tpu.oracle.ristretto import RistrettoPoint as JPoint
from zkvm_tpu_torch.kernels import combine, msm
from zkvm_tpu_torch.kernels import field as F
from zkvm_tpu_torch.kernels import scalarmod as sm
from zkvm_tpu_torch.kernels.words import (points_to_ints, points_words,
                                          to_device, words_to_points)

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

PAD = 17      # identity points with zero scalars, as a padded batch has


def _same_point(a, b):
    return all((a[i] * b[2] - b[i] * a[2]) % P == 0 for i in (0, 1, 3))


@functools.lru_cache(maxsize=None)
def _case(n: int, kind: str):
    """(points, scalars, oracle Σ k_i·P_i) from a numpy seed.  Points are
    64 random Edwards representatives (torsion components included), tiled,
    so duplicates occur; a few scalars are zero; kind "equal" gives every
    point the same scalar, so each window has one run of all n digits."""
    rs = np.random.default_rng(41 + n)
    base = [JPoint.from_uniform_bytes(rs.bytes(64)).ep for _ in range(64)]
    real = n - PAD if n > 64 else n
    pts = [base[i % 64] for i in range(real)] + [oe.IDENTITY] * (n - real)
    if kind == "equal":
        ks = [int.from_bytes(rs.bytes(32), "little") % L] * real
    else:
        ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(real)]
        ks[1] = ks[5] = 0
    ks += [0] * (n - real)
    return pts, ks, oe.multiscalar_mul(ks, pts)


@pytest.mark.parametrize("n,wbits,kind", [(64, 8, "random"), (64, 13, "random"),
                                          (4113, 8, "random"),
                                          (4113, 13, "random"),
                                          (256, 13, "equal")])
def test_window_totals_combine_to_oracle_msm(n, wbits, kind):
    pts, ks, want = _case(n, kind)
    digits = sm.signed_digits(sm.ints_to_limbs(ks), wbits)
    assert int(digits.abs().max()) <= 1 << (wbits - 1)
    assert int((digits < 0).sum()) > 0
    points = words_to_points(to_device(points_words(pts), "cpu"))
    totals = msm.window_totals(points, digits, wbits)          # (4, 10, nw)

    # the JAX package's host combine, fed the canonical totals
    tot = points_to_ints(totals)
    packed = np.stack([ints_to_limbs([t[c] for t in tot]).T for c in range(4)])
    assert _same_point(combine_window_totals(packed, wbits), want)

    acc = combine.horner_fold_plain(totals.unsqueeze(2), wbits)
    got = tuple(F.fe_to_ints(c)[0] for c in acc)
    assert _same_point(got, want)
    assert combine.horner_check(totals.unsqueeze(2), wbits).tolist() == [
        int(JPoint(want).is_identity())]


def test_identity_check_accepts_torsion_coset():
    """An MSM summing to the identity passes, and so does one summing to the
    2-torsion point (0, -1): the check is the Ristretto coset test x = 0 or
    y = 0, not equality with (0, 1, 1, 0).  A non-identity sum fails."""
    rs = np.random.default_rng(43)
    k = int.from_bytes(rs.bytes(32), "little") % L
    q = JBASE * (k + 7)                               # of prime order
    torsion = (0, P - 1, 1, 0)
    cases = [
        ([q.ep, q.ep], [k, L - k], 1),
        ([q.ep, q.ep, torsion], [k, L - k, 1], 1),
        ([q.ep, q.ep], [k, L - k + 1], 0),
    ]
    for pts, ks, want in cases:
        points = words_to_points(to_device(points_words(pts), "cpu"))
        digits = sm.signed_digits(sm.ints_to_limbs(ks), 8)
        totals = msm.window_totals(points, digits, 8)
        assert combine.horner_check(totals.unsqueeze(2), 8).tolist() == [want]


def test_wbits_choice_and_canonical_recode():
    for n in (16, 181, 17538, 69762, 1 << 20):
        assert 8 <= msm.best_wbits(n) <= 16
    assert torch.equal(sm.signed_digits(sm.ints_to_limbs([L - 1]), 13),
                       sm.signed_digits(sm.ints_to_limbs([2 * L - 1]), 13))
