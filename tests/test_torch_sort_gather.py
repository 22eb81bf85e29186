"""K9's and K10's plain versions (zkvm_tpu_torch.kernels.sort.radix_sort,
.gather.gather_words, on the CPU) against the JAX package's Pallas kernels
they replace, pallas_msm.sort_rows_device and gather_rows_words, run in
interpret mode, and against numpy.  Integers compare exactly."""

import jax.numpy as jnp
import numpy as np
import torch

from zkvm_tpu.kernels import pallas_msm as pm
from zkvm_tpu_torch.kernels import msm, sort
from zkvm_tpu_torch.kernels.gather import gather_words

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)


def test_radix_sort_matches_pallas_sort_numpy_and_torch():
    """(2, 300) keys below 2^31 with ties, fully sorted (bits [0, 63), eight
    passes): the same rows as the Pallas bitonic sort and np.sort.  A sort
    by a middle range of bits keeps equal digits in input order (stable).
    Then the MSM's own packed int64 keys, at an n that is not a power of
    two, through sort_keys, which sorts only their (|digit|, sign) bits:
    the same keys and run offsets as torch.sort of the whole keys."""
    rs = np.random.default_rng(70)
    x = rs.integers(0, 2**31 - 1, size=(2, 300), dtype=np.int64)
    x[0, :20] = x[0, 20]
    got = sort.radix_sort(torch.from_numpy(x)).numpy()
    want = np.asarray(pm.sort_rows_device(jnp.asarray(x.astype(np.int32)),
                                          interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x, axis=1))
    assert [b for _, b in sort.passes(0, 63)] == [8] * 7 + [7]

    mid = sort.radix_sort(torch.from_numpy(x), 9, 21).numpy()
    order = np.argsort((x >> 9) & 0xFFF, axis=1, kind="stable")
    np.testing.assert_array_equal(mid, np.take_along_axis(x, order, axis=1))

    digits = torch.tensor(rs.integers(-128, 129, size=(1000, 4)),
                          dtype=torch.int32)
    keys, offsets, shift = msm.sort_keys(digits, 128)
    assert torch.equal(keys, torch.sort(msm.pack_keys(digits)[0], 1).values)
    got, got_off, got_shift = msm.sort_keys(digits, 128, radix=True)
    assert torch.equal(got, keys) and torch.equal(got_off, offsets)
    assert got_shift == shift


def test_gather_words_matches_pallas_gather():
    """(32, 256) word planes and 5 windows of permutations, as the JAX
    package's own parity test; the port's rows are the planes transposed."""
    rs = np.random.RandomState(3)
    src = rs.randint(-2**31, 2**31 - 1, size=(32, 256),
                     dtype=np.int64).astype(np.int32)
    perm = np.stack([rs.permutation(256) for _ in range(5)])
    want = np.asarray(pm.gather_rows_words(
        jnp.asarray(src), jnp.asarray(perm.astype(np.int32)), interpret=True))
    got = gather_words(torch.from_numpy(np.ascontiguousarray(src.T)),
                       torch.from_numpy(perm))
    assert tuple(got.shape) == (5, 256, 32)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 1), want)
    affine = gather_words(torch.from_numpy(np.ascontiguousarray(src[:16].T)),
                          torch.from_numpy(perm))
    np.testing.assert_array_equal(affine.numpy().transpose(0, 2, 1),
                                  want[:, :16])
