"""The port's mod-ℓ tensor arithmetic (zkvm_tpu_torch.kernels.scalarmod)
against Python integers — the semantics the JAX package's scalarmod holds
to — including limbs at the bounds its overflow audit allows."""

import numpy as np
import pytest
import torch

from zkvm_tpu.constants import L
from zkvm_tpu.kernels import msm as jmsm
from zkvm_tpu_torch.kernels import scalarmod as sm
from zkvm_tpu_torch.kernels.words import scalar_words, to_device

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)


def _ints(rs, n):
    return [int.from_bytes(rs.bytes(32), "little") % L for _ in range(n)]


def _value(x):
    return [sum(int(v) << (26 * i) for i, v in enumerate(col))
            for col in x.T.tolist()]


def _extreme():
    """Reduced-form limbs at the audit's bound, both signs and mixed."""
    ext = torch.full((10, 4), (1 << 28) - 1, dtype=torch.int64)
    ext[:, 1] *= -1
    ext[::2, 2] *= -1
    ext[:, 3] = torch.tensor([(1 << 28) - 1] * 9 + [-(1 << 18)])
    return ext


def test_mul_add_neg_accumulate_chain():
    rs = np.random.default_rng(61)
    xs, ys = _ints(rs, 200) + [0, 1, L - 1], _ints(rs, 200) + [L - 1, L - 1, 1]
    a, b = sm.ints_to_limbs(xs), sm.ints_to_limbs(ys)
    q, want = sm.mul_lm(a, b), [x * y % L for x, y in zip(xs, ys)]
    for _ in range(8):
        q = sm.add_lm(sm.neg_lm(sm.mul_lm(q, q)), a)
        want = [(x - w * w) % L for w, x in zip(want, xs)]
        assert int(q.abs().max()) < 1 << 28
    assert sm.limbs_to_ints(q) == want
    acc = sm.accumulate_lm(torch.stack([q, a], dim=1), 1)
    assert sm.limbs_to_ints(acc) == [(w + x) % L for w, x in zip(want, xs)]


def test_extreme_limbs_stay_in_bounds():
    ext = _extreme()
    vals = [v % L for v in _value(ext)]
    for out, want in ((sm.mul_lm(ext, ext), [v * v % L for v in vals]),
                      (sm.add_lm(ext, ext), [2 * v % L for v in vals]),
                      (sm.neg_lm(ext), [-v % L for v in vals]),
                      (sm.accumulate_lm(ext.unsqueeze(1).expand(10, 4096, 4), 1),
                       [4096 * v % L for v in vals])):
        assert sm.limbs_to_ints(out) == want
        assert int(out.abs().max()) < 1 << 28
    assert _value(sm.canonical(ext)) == vals


@pytest.mark.parametrize("wbits", [8, 11, 13, 16])
def test_signed_digits_match_jax_recoder(wbits):
    """Canonical scalars recode to the JAX package's signed radix-2^w digits
    (kernels/msm.py signed_digits_radix_2w) exactly."""
    rs = np.random.default_rng(62 + wbits)
    xs = _ints(rs, 64) + [0, 1, L - 1, (1 << 252) - 1]
    got = sm.signed_digits(sm.decode_words_last(
        to_device(scalar_words(xs), "cpu")), wbits)
    want = jmsm.signed_digits_radix_2w(xs, wbits)
    assert got.shape[1] == sm.num_windows(wbits)
    assert np.array_equal(got.numpy(), want)
    assert int(got.abs().max()) <= 1 << (wbits - 1)
