"""The port's field and point micro-kernels K13-K16 (zkvm_tpu_torch.kernels.micro,
by their plain twins on the CPU) against the JAX package's micro-benchmark
kernels (bench/pallas_micro.py), on the same seeded 13-bit limbs, carried
across by convert.from_jax_limbs13 and compared as field values mod p.

bench/ is no package, so pallas_micro.py is loaded by its path.  Rows 17
and 20 (_pallas_binop, _make_add_chain) run in Pallas interpret mode.  Rows
18 and 19 run their kernel bodies eagerly on (20, 8, 128) planes through a
stand-in for the refs: _make_add_chain_planes does not finish in interpret
mode on the CPU in a minute.  _mul_roll has no CPU rule outside a kernel,
so the roll form runs only in interpret mode."""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

import zkvm_tpu.kernels.limbs as lb
from zkvm_tpu.constants import EDWARDS_D2 as JAX_D2
from zkvm_tpu.kernels import pallas_field as pf
from zkvm_tpu_torch import micro as micro_bench
from zkvm_tpu_torch.constants import EDWARDS_D2, P
from zkvm_tpu_torch.convert import from_jax_limbs13
from zkvm_tpu_torch.kernels import field as F
from zkvm_tpu_torch.kernels import micro

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _reference():
    path = Path(__file__).resolve().parents[1] / "bench" / "pallas_micro.py"
    spec = importlib.util.spec_from_file_location("pallas_micro", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Ref:
    """A stand-in for a Pallas ref, so that a kernel body runs eagerly on
    jnp arrays: a read indexes the array, a write replaces what it names."""

    def __init__(self, x):
        self.x = x

    def __getitem__(self, k):
        return self.x[k]

    def __setitem__(self, k, v):
        self.x = v if k is Ellipsis else self.x.at[k].set(v)


def _body(kernel, *arrays, n_out=1):
    outs = [_Ref(jnp.zeros_like(arrays[0])) for _ in range(n_out)]
    kernel(*map(_Ref, arrays), *outs)
    return [o.x for o in outs]


def _ints(x):
    """JAX (20, ...) limbs -> their values mod p, lane by lane."""
    return lb.limbs_to_field_ints(np.asarray(x).reshape(20, -1).T)


def _port(x):
    return from_jax_limbs13(np.asarray(x).reshape(20, -1), device="cpu")


def _add_py(p, q):
    """add-2008-hwcd-3 (a = -1, k = 2d) on ints mod p."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A, B = (Y1 - X1) * (Y2 - X2), (Y1 + X1) * (Y2 + X2)
    C, D = T1 * EDWARDS_D2 * T2, 2 * Z1 * Z2
    E, Fv, G, H = B - A, D - C, D + C, B + A
    return E * Fv % P, G * H % P, Fv * G % P, E * H % P


def test_rows_17_18_mul_and_parts_match_pallas_micro():
    """Row 17: K13 (both forms) and K14's chain against _pallas_binop with
    the pad kernel at depth 1 and the roll chain at depth 2, B = 512.  Row
    18, B = 1,024: raw bit for bit on the same int32 arrays; mul and chain
    (depth 1, 2) mod p; carry (a + b after 8 passes) mod p; prod's columns,
    weighted by 2^ceil(25.5 i), equal to _mul_planes' a b mod p."""
    pm = _reference()
    rng = np.random.default_rng(17)
    a, b = (pm.rand_limbs(rng, (512,)) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        by_depth = {
            1: pm._pallas_binop(pf._mul_kernel, 512)(a, b),
            2: pm._pallas_binop(pm._chain_kernel_factory(pm._mul_roll, 2),
                                512)(a, b)}
    xa, xb = _port(a), _port(b)
    av, bv = _ints(a), _ints(b)
    assert F.fe_to_ints(xa) == av and F.fe_to_ints(xb) == bv
    for depth, jax_out in by_depth.items():
        want = _ints(jax_out)
        assert want == [x * pow(y, depth, P) % P for x, y in zip(av, bv)]
        outs = [micro.micro_mul(xa, xb, depth, form)
                for form in micro.MUL_FORMS]
        outs.append(micro.micro_parts(xa, xb, "chain", depth))
        for got in outs:
            assert got.dtype == torch.int32 and F.fe_to_ints(got) == want
            F.debug_assert_limb_bounds(got.to(torch.int64), 0.52)

    a3, b3 = (pm.rand_limbs(rng, (8, 128)) for _ in range(2))
    xa, xb = _port(a3), _port(b3)
    av, bv = _ints(a3), _ints(b3)
    jax_mul = {1: _ints(_body(pm._mul_kernel_planes, a3, b3)[0]),
               2: _ints(_body(pm._chain_kernel_planes(2), a3, b3)[0])}
    assert jax_mul[1] == [x * y % P for x, y in zip(av, bv)]
    for depth, want in jax_mul.items():
        assert F.fe_to_ints(micro.micro_parts(xa, xb, "chain", depth)) == want
    # raw: the same int32 arrays, the port's (10, 2,048) view of them
    raw_in = [torch.from_numpy(np.array(x).reshape(10, -1)) for x in (a3, b3)]
    jax_raw = _body(pm._raw_kernel_planes, a3, b3)[0]
    for depth in (1, 2):
        got = micro.micro_parts(*raw_in, "raw", depth)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(jax_raw).reshape(10, -1))
        jax_raw = _body(pm._raw_kernel_planes, jax_raw, b3)[0]
    want = _ints(_body(pm._carry_kernel_planes, a3, b3)[0])
    assert want == [(x + y) % P for x, y in zip(av, bv)]
    for depth in (1, 2):
        got = micro.micro_parts(xa, xb, "carry", depth)
        assert F.fe_to_ints(got) == want
        F.debug_assert_limb_bounds(got.to(torch.int64), 0.52)
    _body(pm._prod_kernel_planes, a3, b3)      # the reference's 400 products
    cols = micro.micro_parts(xa, xb, "prod", 1)
    assert cols.dtype == torch.int64 and F.fe_to_ints(cols) == jax_mul[1]
    # depth 2: the columns of (the first columns cut to the limb widths) b
    mask = torch.tensor([(1 << w) - 1 for w in F.W]).view(10, 1)
    assert F.fe_to_ints(micro.micro_parts(xa, xb, "prod", 2)) == [
        x * y % P for x, y in zip(F.fe_to_ints(cols & mask), bv)]


def test_rows_19_20_add_chains_match_pallas_micro():
    """K15's and K16's twins against _make_add_chain_planes' body (row 19,
    B = 1,024) and _make_add_chain with pf._vmem_mul in interpret mode (row
    20, B = 512; depth 2 is the same kernel again on p and its output),
    coordinate by coordinate mod p, and against the formula on Python ints,
    at depth 1 and 2; then the entry point's every variant on the CPU at a
    tiny size."""
    pm = _reference()
    assert JAX_D2 == EDWARDS_D2
    rng = np.random.default_rng(19)
    planes = [pm.rand_limbs(rng, (8, 128)) for _ in range(8)]
    d2_limbs = [int(v) for v in lb.int_to_limbs(JAX_D2)]
    row19 = {d: _body(pm._add_chain_kernel_planes(d, d2_limbs), *planes,
                      n_out=4) for d in (1, 2)}
    lm = [pm.rand_limbs(rng, (512,)) for _ in range(8)]
    with pltpu.force_tpu_interpret_mode():
        chain = pm._make_add_chain(pf._vmem_mul, 1, 512)
        q1 = chain(*lm, pm._d2_tile())
        row20 = {1: q1, 2: chain(*lm[:4], *q1, pm._d2_tile())}
    for coords, jax_out in ((planes, row19), (lm, row20)):
        p, q = (torch.stack([_port(c) for c in coords[k:k + 4]])
                for k in (0, 4))
        pv = list(zip(*(_ints(c) for c in coords[:4])))
        qv = list(zip(*(_ints(c) for c in coords[4:])))
        for depth in (1, 2):
            qv = [_add_py(x, y) for x, y in zip(pv, qv)]
            want = [_ints(c) for c in jax_out[depth]]
            assert want == [list(c) for c in zip(*qv)]
            for twin in (micro.micro_add_chain, micro.micro_add_chain_lanes):
                got = twin(p, q, depth)
                assert got.shape == p.shape and got.dtype == torch.int32
                assert [F.fe_to_ints(c) for c in got] == want
    rows = micro_bench.run(device="cpu", B=16, sat_b=24, sat_depth=2,
                           steps=2, reps=1, log=lambda *a, **k: None)
    assert {r["variant"] for r in rows} == set(micro_bench.VARIANTS)
    assert {r["step"] for r in rows if "step" in r} == {
        "fe_mul", "lf_mul", "pt_add", "lane_add"}
