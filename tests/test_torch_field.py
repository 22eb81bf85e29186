"""The port's plain field and Edwards arithmetic (zkvm_tpu_torch.kernels.field,
the twin of the CUDA header csrc/field25519.cuh) against the JAX package's
Pallas kernels in interpret mode and the oracle, on the same inputs."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zkvm_tpu.kernels.limbs as lb
from zkvm_tpu.kernels import pallas_field as pf
from zkvm_tpu.kernels import pallas_msm as pm
from zkvm_tpu.oracle import edwards as oe
from zkvm_tpu.oracle.ristretto import RistrettoPoint
from zkvm_tpu_torch import constants as C
from zkvm_tpu_torch.kernels import field as F

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

LANES = pf.LANE_TILE  # 512


def _field_ints(rs, n):
    return [int.from_bytes(rs.bytes(32), "little") % C.P for _ in range(n)]


def _points(rs, n):
    return [RistrettoPoint.from_uniform_bytes(rs.bytes(64)).ep for _ in range(n)]


def _eq_proj(a, b):
    return all((a[i] * b[2] - b[i] * a[2]) % C.P == 0 for i in (0, 1, 3))


def test_mul_sqr_match_pallas_mul():
    rs = np.random.default_rng(11)
    xs = _field_ints(rs, LANES - 3) + [0, 1, C.P - 1]
    ys = _field_ints(rs, LANES - 3) + [C.P - 1, C.P - 1, C.P - 1]
    jax_out = pf.mul(jnp.asarray(lb.ints_to_limbs(xs).T),
                     jnp.asarray(lb.ints_to_limbs(ys).T), interpret=True)
    want = lb.limbs_to_field_ints(np.asarray(jax_out).T)
    a, b = F.ints_to_fe(xs), F.ints_to_fe(ys)
    assert F.fe_to_ints(F.mul(a, b)) == want
    assert F.fe_to_ints(F.sqr(a)) == [x * x % C.P for x in xs]
    assert F.fe_to_ints(F.sub(F.add(a, b), F.neg(b))) == [
        (x + 2 * y) % C.P for x, y in zip(xs, ys)]


def test_freeze_and_limb_bounds():
    """Extreme carried limbs freeze to the canonical value; the bound check
    trips past the mul precondition."""
    hi = [int(0.52 * (1 << w)) for w in F.W]
    h = torch.tensor([hi, [-v for v in hi], [0] * 10, [(1 << w) - 1 for w in F.W]],
                     dtype=torch.int64).T
    frozen = F.freeze(h)
    for col_in, col_out in zip(h.T.tolist(), frozen.T.tolist()):
        assert sum(v << o for v, o in zip(col_out, F.OFFS)) == F.limbs_to_int(col_in)
        assert all(0 <= v < (1 << w) for v, w in zip(col_out, F.W))
    F.debug_assert_limb_bounds(h)
    with pytest.raises(AssertionError):
        F.debug_assert_limb_bounds(h * 4)


def test_point_add_matches_pallas_point_add_lm():
    rs = np.random.default_rng(12)
    p, q = _points(rs, 32), _points(rs, 32)
    p, q = p * (LANES // 32), q * (LANES // 32)
    out = pm.point_add_lm(pm.pack_points_lm(p), pm.pack_points_lm(q),
                          interpret=True)
    want = list(zip(*(lb.limbs_to_field_ints(np.asarray(c).T) for c in out)))
    pt = lambda pts: tuple(F.ints_to_fe([e[i] for e in pts]) for i in range(4))
    got = list(zip(*(F.fe_to_ints(c) for c in F.point_add(pt(p), pt(q)))))
    assert got == want     # same formula, so equal as projective coordinates


def test_point_double_matches_oracle():
    rs = np.random.default_rng(13)
    p = _points(rs, 16) + [oe.IDENTITY]
    pt = tuple(F.ints_to_fe([e[i] for e in p]) for i in range(4))
    got = list(zip(*(F.fe_to_ints(c) for c in F.point_double(pt))))
    for g, e in zip(got, p):
        assert _eq_proj(g, oe.double(e))
        assert (g[3] * g[2] - g[0] * g[1]) % C.P == 0


def test_cuda_header_constants():
    """The limb constants spelled out in csrc/field25519.cuh are d, 2d and
    sqrt(-1)."""
    src = (Path(F.__file__).parent / "csrc" / "field25519.cuh").read_text()
    for name, value in (("kD", C.EDWARDS_D), ("kD2", C.EDWARDS_D2),
                        ("kSqrtM1", C.SQRT_M1)):
        body = re.search(name + r"\[10\] = \{([^}]*)\}", src).group(1)
        assert [int(v) for v in body.split(",")] == F.int_to_limbs(value)
