"""The port's elementwise kernels K5-K8 (zkvm_tpu_torch.kernels.pointwise, by
their plain versions on the CPU) against the JAX package's Pallas kernels
in interpret mode — pallas_msm.seg_combine_lm and pallas_field.mul, add
and point_add — on the same inputs, compared as integers mod p; K5 and K6
also at ragged batch sizes."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zkvm_tpu.kernels.limbs as lb
from zkvm_tpu.kernels import pallas_field as pf
from zkvm_tpu.kernels import pallas_msm as pm
from zkvm_tpu.oracle import edwards as oe
from zkvm_tpu.oracle.ristretto import RistrettoPoint
from zkvm_tpu_torch.constants import P
from zkvm_tpu_torch.kernels import field as F
from zkvm_tpu_torch.kernels import pointwise
from zkvm_tpu_torch.kernels.words import points_to_ints, points_words, to_device, words_to_points

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

B = pf.LANE_TILE  # 512


def _points(rs, n):
    """n points: 32 random group elements (torsion-free and with torsion
    components) tiled, and the identity."""
    base = [RistrettoPoint.from_uniform_bytes(rs.bytes(64)).ep for _ in range(31)]
    base.append(oe.IDENTITY)
    return [base[i % 32] for i in range(n)]


def _port_points(eps):
    return words_to_points(to_device(points_words(eps), "cpu"))


def _jax_ints(coords):
    """JAX (NLIMBS, B) coordinates -> per point (X, Y, Z, T) ints mod p."""
    return list(zip(*(lb.limbs_to_field_ints(np.asarray(c).T) for c in coords)))


@functools.lru_cache(maxsize=None)
def _pallas_run(op):
    """op's JAX kernel, in interpret mode, on two tiles (2 x 512 lanes) of
    seeded inputs: -> p, q, flags (seg_combine) or None, and the outputs
    as ints.  One run serves every batch size of the op (a prefix), since
    the kernel treats its lanes independently."""
    rs = np.random.default_rng(21 if op == "point_add" else 22)
    p, q = _points(rs, 2 * B), _points(rs, 2 * B)[::-1]
    if op == "point_add":
        return p, q, None, _jax_ints(pf.point_add(
            tuple(pm.pack_points_lm(p)), tuple(pm.pack_points_lm(q)),
            interpret=True))
    flags = (rs.random(2 * B) < 0.3).astype(np.int32)
    want = _jax_ints(pm.seg_combine_lm(
        pm.pack_points_lm(p), pm.pack_points_lm(q),
        jnp.asarray(flags[None]), interpret=True))
    for i in np.flatnonzero(flags):
        assert want[i] == tuple(c % P for c in q[i])
    return p, q, flags, want


# B = 512 (one tile) and ragged batches (24: under a tile; 517: a partial
# second tile, and a partial warp of four-lane groups on the card)
POINT_CASES = [pytest.param(op, n, id=op if n == B else f"{op}-{n}")
               for op in ("point_add", "seg_combine") for n in (B, 24, 517)]


@pytest.mark.parametrize("op, n", POINT_CASES)
def test_point_kernels_match_pallas(op, n):
    p, q, flags, want = _pallas_run(op)
    if op == "point_add":
        got = pointwise.point_add(_port_points(p[:n]), _port_points(q[:n]))
    else:
        got = pointwise.seg_combine(_port_points(p[:n]), _port_points(q[:n]),
                                    torch.from_numpy(flags[:n]))
    assert got.shape == (4, F.NL, n) and got.dtype == torch.int32
    assert points_to_ints(got) == want[:n]  # same formula: equal coordinates


@pytest.mark.parametrize("op", ["mul", "add"])
def test_field_kernels_match_pallas(op):
    rs = np.random.default_rng(23 if op == "mul" else 24)
    xs = [int.from_bytes(rs.bytes(32), "little") % P for _ in range(B - 3)]
    ys = [int.from_bytes(rs.bytes(32), "little") % P for _ in range(B - 3)]
    xs += [0, 1, P - 1]
    ys += [P - 1, P - 1, P - 1]
    jax_fn = pf.mul if op == "mul" else pf.add
    want = lb.limbs_to_field_ints(np.asarray(jax_fn(
        jnp.asarray(lb.ints_to_limbs(xs).T), jnp.asarray(lb.ints_to_limbs(ys).T),
        interpret=True)).T)
    port_fn = pointwise.mul if op == "mul" else pointwise.add
    got = port_fn(F.ints_to_fe(xs).to(torch.int32), F.ints_to_fe(ys).to(torch.int32))
    assert got.shape == (F.NL, B) and got.dtype == torch.int32
    assert F.fe_to_ints(got) == want
    F.debug_assert_limb_bounds(got.to(torch.int64), 0.52)     # carried


def test_any_batch_size():
    """The port's entry points take batches that are no multiple of 512."""
    rs = np.random.default_rng(25)
    n = 37
    p, q = _points(rs, n), _points(rs, n)[::-1]
    got = points_to_ints(pointwise.point_add(_port_points(p), _port_points(q)))
    for g, a, b in zip(got, p, q):
        w = oe.add(a, b)
        assert all((g[i] * w[2] - w[i] * g[2]) % P == 0 for i in (0, 1, 3))
    xs = [int.from_bytes(rs.bytes(32), "little") % P for _ in range(n)]
    a = F.ints_to_fe(xs).to(torch.int32)
    assert F.fe_to_ints(pointwise.mul(a, a)) == [x * x % P for x in xs]
    assert F.fe_to_ints(pointwise.add(a, a)) == [2 * x % P for x in xs]
