
"""The port's batched range-proof verification (zkvm_tpu_torch.kernels.
batch_verify_device and proofs.rangeproof.batch_verify, on the CPU) against
the JAX package: host inputs byte for byte, the scalar synthesis mod ℓ,
and accept/reject end to end."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm_tpu.constants import L, P
from zkvm_tpu.kernels import batch_verify_device as jbvd
from zkvm_tpu.kernels.limbs import limbs_to_int
from zkvm_tpu.proofs import rangeproof as jrp
from zkvm_tpu.proofs.errors import ProofError as JProofError
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch import convert
from zkvm_tpu_torch.kernels import batch_verify_device as bvd
from zkvm_tpu_torch.kernels import scalarmod as sm
from zkvm_tpu_torch.proofs.errors import VerificationError
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.rangeproof import RangeProof, batch_verify
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

N = 64
LABEL = b"torch port batch"
ENTROPY = b"\x07" * 32


@functools.lru_cache(maxsize=None)
def _jax_gens():
    return JBulletproofGens(N, 2), JPedersenGens()


@functools.lru_cache(maxsize=None)
def _port_gens():
    return BulletproofGens(N, 2), PedersenGens()


@functools.lru_cache(maxsize=None)
def _wires(m: int, n: int = N, nb: int = 3):
    """nb proofs of m n-bit values each, made with the JAX package's prover
    from a numpy seed: [(wire bytes, [value commitments])]."""
    rs = np.random.default_rng(50 + m + n)
    bp, pc = _jax_gens()
    out = []
    for _ in range(nb):
        values = [int(v) for v in rs.integers(0, 2**(n - 1), size=m)]
        blinds = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(m)]
        proof, vcs = jrp.RangeProof.prove_multiple(
            bp, pc, JProofTranscript(LABEL), values, blinds, n)
        out.append((proof.to_bytes(), list(vcs)))
    return tuple(out)


def _jax_batch(wires):
    proofs = [jrp.RangeProof.from_bytes(w) for w, _ in wires]
    return proofs, [JProofTranscript(LABEL) for _ in wires], [v for _, v in wires]


def _port_batch(wires):
    proofs = [RangeProof.from_bytes(w) for w, _ in wires]
    return proofs, [ProofTranscript(LABEL) for _ in wires], [v for _, v in wires]


@pytest.mark.parametrize("m", [1, 2])
def test_prepare_batch_inputs_byte_equal(m):
    wires = _wires(m)
    jp, jt, jv = _jax_batch(wires)
    want = jbvd.prepare_batch_inputs(jp, *_jax_gens(), jt, jv, N, ENTROPY)
    pp, pt, pv = _port_batch(wires)
    got = bvd.prepare_batch_inputs(pp, *_port_gens(), pt, pv, N, ENTROPY)
    for g, w in zip(got[:3], want[:3]):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    assert got[3:] == want[3:]
    assert bvd.sum_bbB(got[1]).tobytes() == jbvd.sum_bbB(want[1]).tobytes()


def test_synthesis_matches_jax_synthesize_lm():
    """At n = 8, m = 2 (the aggregated branch): the jitted JAX synthesis
    takes ~10 s to compile on a CPU even there, and the port's synthesis
    runs the same code for every n and m.  m = 1 and n = 64 are held by
    the end-to-end cases below."""
    n, m = 8, 2
    jp, jt, jv = _jax_batch(_wires(m, n))
    bp, pc = _jax_gens()
    params, bbB_pp, dyn, m_, lg = jbvd.prepare_batch_inputs(
        jp, bp, pc, jt, jv, n, ENTROPY)
    bbB = jbvd.sum_bbB(bbB_pp)
    static = np.asarray(jbvd.static_gens_words(bp, pc, n, m))
    synth = jax.jit(jbvd._synthesize_lm, static_argnums=(1, 2, 3))
    gh_col, dyn_sc = synth(jnp.asarray(params), n, m, lg)
    want = ([limbs_to_int(r) % L for r in np.asarray(gh_col)]
            + [limbs_to_int(r) % L for r in np.asarray(dyn_sc).reshape(-1, 20)])

    _, _, params_t, bbB_t = convert.from_jax_arrays(static, dyn, params, bbB,
                                                    "cpu")
    port_gh, port_dyn = bvd._synthesize_lm(params_t, n, m, lg)
    assert sm.limbs_to_ints(port_gh) + sm.limbs_to_ints(port_dyn) == want
    scalars = bvd.batch_msm_scalars(params_t, bbB_t, n, m, lg)
    assert sm.limbs_to_ints(scalars[:, :2]) == [
        int.from_bytes(bbB[i].tobytes(), "little") for i in range(2)]


def _non_canonical(enc: bytes) -> bytes:
    return (int.from_bytes(enc, "little") + P).to_bytes(32, "little")


@pytest.mark.parametrize("case", ["valid", "t_x", "encoding", "m2"])
def test_batch_verify_agrees_with_jax(case):
    wires = list(_wires(2 if case == "m2" else 1))
    if case == "t_x":
        bad = jrp.RangeProof.from_bytes(wires[1][0])
        bad.t_x = (bad.t_x + 1) % L
        wires[1] = (bad.to_bytes(), wires[1][1])
    elif case == "encoding":
        w = wires[2][0]
        wires[2] = (w[:32] + _non_canonical(w[32:64]) + w[64:], wires[2][1])

    jp, jt, jv = _jax_batch(wires)
    try:
        jrp.batch_verify(jp, *_jax_gens(), jt, jv, N, ENTROPY)
        jax_accepts = True
    except (JProofError, ValueError):   # its host decode raises ValueError
        jax_accepts = False

    pp, pt, pv = _port_batch(wires)
    try:
        batch_verify(pp, *_port_gens(), pt, pv, N, ENTROPY, device="cpu")
        port_accepts = True
    except VerificationError:
        port_accepts = False
    assert port_accepts == jax_accepts == (case in ("valid", "m2"))


def test_encoding_reject_does_not_raise_from_device_half():
    """One bad encoding fails the whole batch through the decode flag."""
    wires = list(_wires(1))
    w = wires[0][0]
    wires[0] = (_non_canonical(w[:32]) + w[32:], wires[0][1])
    pp, pt, pv = _port_batch(wires)
    assert not bvd.batch_verify_device(pp, *_port_gens(), pt, pv, N, ENTROPY,
                                       device="cpu")
