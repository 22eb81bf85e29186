"""The bucket pipeline's configuration switches (zkvm_tpu_torch.kernels.msm.
MsmConfig.from_env, the JAX package's names and values) and the affine
configuration's prelude on the CPU: to_affine_words against the JAX
package's pallas_msm.to_affine_words, field.invert and field.batch_invert
against Fermat's pow.  Integers compare exactly."""

import jax
import numpy as np
import torch

from zkvm_tpu.kernels import pallas_msm as pm
from zkvm_tpu_torch.constants import P
from zkvm_tpu_torch.kernels import field as F
from zkvm_tpu_torch.kernels import msm
from zkvm_tpu_torch.kernels.words import (points_words, to_device,
                                          words_to_ints, words_to_points)
from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)


def test_config_from_env(monkeypatch):
    """The JAX package's switches, names, values and precedence."""
    for var in ("ZKVM_MSM_SORT", "ZKVM_MSM_GATHER", "ZKVM_MSM_AFFINE"):
        monkeypatch.delenv(var, raising=False)
    assert msm.MsmConfig.from_env() == msm.MsmConfig()
    monkeypatch.setenv("ZKVM_MSM_AFFINE", "1")
    assert msm.MsmConfig.from_env() == msm.MsmConfig(affine=True)
    monkeypatch.setenv("ZKVM_MSM_GATHER", "pallas")
    monkeypatch.setenv("ZKVM_MSM_SORT", "xla")
    assert msm.MsmConfig.from_env() == msm.MsmConfig(gather=True)
    monkeypatch.setenv("ZKVM_MSM_SORT", "pallas")
    assert msm.MsmConfig.from_env() == msm.MsmConfig(sort=True, gather=True)


def test_affine_prelude_matches_jax():
    """8 random points, each scaled projectively by a random factor (so
    Z != 1): to_affine_words against the JAX package's, jitted (it runs
    batch_zinv_lm, whose eager call alone takes ~18 s on a CPU); the
    inversions against Fermat's pow."""
    rs = np.random.default_rng(73)
    eps = []
    for _ in range(8):
        X, Y, Z, T = RistrettoPoint.from_uniform_bytes(rs.bytes(64)).ep
        f = int.from_bytes(rs.bytes(32), "little") % P or 1
        eps.append((X * f % P, Y * f % P, Z * f % P, T * f % P))
    pts = words_to_points(to_device(points_words(eps), "cpu"))
    want = np.asarray(jax.jit(pm.to_affine_words)(pm.pack_points_lm(eps))
                      ).view(np.uint32)                            # (16, 8)
    got = msm.to_affine_words(pts).numpy().view(np.uint32)         # (8, 16)
    np.testing.assert_array_equal(got.T, want)

    z = pts[2].to(torch.int64)
    zinv = F.fe_to_ints(F.batch_invert(z))
    assert zinv == [pow(e[2], P - 2, P) for e in eps]
    assert F.fe_to_ints(F.invert(z[:, :4])) == zinv[:4]
    assert words_to_ints(np.ascontiguousarray(got[:1, :8]))[0] == (
        eps[0][0] * zinv[0] % P)
