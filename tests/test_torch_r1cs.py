"""The port's R1CS verifier (zkvm_tpu_torch.proofs.r1cs) against the JAX
package's on proofs made by the JAX package's prover: the mega-check job
byte for byte, the verdicts of Verifier.verify on the CPU, and the device
half split_msm_check against the JAX package's host MSM on the same
arrays."""

import functools

import numpy as np
import pytest
import torch

from zkvm_tpu.constants import L
from zkvm_tpu.gadgets import Value as JValue
from zkvm_tpu.gadgets import allocate_value as jallocate_value
from zkvm_tpu.gadgets import cloak as jcloak
from zkvm_tpu.gadgets import range_proof_gadget as jrange_proof_gadget
from zkvm_tpu.kernels.batch_verify_device import static_gens_words as jstatic_gens_words
from zkvm_tpu.native import ScalarVec as JScalarVec
from zkvm_tpu.oracle.ristretto import RistrettoPoint as JPoint
from zkvm_tpu.proofs.engine import Engine
from zkvm_tpu.proofs.errors import ProofError as JProofError
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.r1cs import Prover as JProver
from zkvm_tpu.proofs.r1cs import R1CSProof as JR1CSProof
from zkvm_tpu.proofs.r1cs import Verifier as JVerifier
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch import convert
from zkvm_tpu_torch.constants import P
from zkvm_tpu_torch.gadgets import allocate_value, cloak, range_proof_gadget
from zkvm_tpu_torch.kernels import batch_verify_device as bvd
from zkvm_tpu_torch.kernels import msm
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.proofs.engine import set_engine
from zkvm_tpu_torch.proofs.errors import ProofError, VerificationError
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.r1cs import R1CSProof, Verifier
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

GENS = 64
RANGE_VALUES = [0, 1, 40000, (1 << 16) - 1]
CLOAK_INS = [(3, 11), (4, 11)]
CLOAK_OUTS = [(5, 11), (2, 11)]


@functools.lru_cache(maxsize=None)
def _case(kind: str):
    """(label, commitments, wire bytes) of a proof by the JAX prover: "range"
    is one-phase (four 16-bit range gadgets over committed values),
    "cloak" two-phase (a 2x2 Cloak with 8-bit values)."""
    rs = np.random.default_rng(51)
    label = f"zkvm_tpu_torch r1cs {kind}".encode()
    prover = JProver(JPedersenGens(), JProofTranscript(label))
    commitments = []
    if kind == "range":
        for v in RANGE_VALUES:
            com, var = prover.commit(v, int.from_bytes(rs.bytes(32), "little") % L)
            commitments.append(com)
            jrange_proof_gadget(prover, var, 16, v)
    else:
        ins = [jallocate_value(prover, JValue(q, f)) for q, f in CLOAK_INS]
        outs = [jallocate_value(prover, JValue(q, f)) for q, f in CLOAK_OUTS]
        jcloak(prover, ins, outs, range_bits=8)
    return label, commitments, prover.prove(JBulletproofGens(GENS)).to_bytes()


def _lay(kind, commitments, verifier, cloak_fn, alloc, range_fn):
    if kind == "range":
        for com in commitments:
            range_fn(verifier, verifier.commit(com), 16, None)
    else:
        ins = [alloc(verifier, None) for _ in CLOAK_INS]
        outs = [alloc(verifier, None) for _ in CLOAK_OUTS]
        cloak_fn(verifier, ins, outs, range_bits=8)
    return verifier


def _jax_verifier(kind):
    label, commitments, _ = _case(kind)
    return _lay(kind, commitments, JVerifier(JProofTranscript(label)),
                jcloak, jallocate_value, jrange_proof_gadget)


def _port_verifier(kind):
    label, commitments, _ = _case(kind)
    return _lay(kind, commitments, Verifier(ProofTranscript(label)),
                cloak, allocate_value, range_proof_gadget)


def _tampered(wire: bytes, tamper: str) -> bytes:
    proof = JR1CSProof.from_bytes(wire)
    if tamper == "t_x":
        proof.t_x = (proof.t_x + 1) % L
    elif tamper == "A_I2":       # s + p: a non-canonical encoding
        proof.A_I2 = (int.from_bytes(proof.A_I2, "little") + P).to_bytes(32, "little")
    return proof.to_bytes()


@pytest.mark.parametrize("kind", ["range", "cloak"])
def test_verification_job_is_byte_equal(kind):
    wire = _case(kind)[2]
    jax_verifier, port_verifier = _jax_verifier(kind), _port_verifier(kind)
    want = jax_verifier.verification_job_split_vec(
        JR1CSProof.from_bytes(wire), JBulletproofGens(GENS), JPedersenGens(),
        decompress_dyn=False)
    got = port_verifier.verification_job_split_vec(
        R1CSProof.from_bytes(wire), BulletproofGens(GENS), PedersenGens())
    assert vars(port_verifier.metrics()) == vars(jax_verifier.metrics())
    dyn_s, enc, bb, bs, g_v, h_v, padded_n = got
    assert [int(x) for x in dyn_s] == [int(x) for x in want[0]]
    assert enc == want[1]
    assert (bb, bs, padded_n) == (want[2], want[3], want[6])
    assert g_v.buf == want[4].buf and h_v.buf == want[5].buf
    assert padded_n == 64 and len(g_v) == len(h_v) == padded_n


def _jax_verdict(wire):
    try:
        _jax_verifier("cloak").verify(JR1CSProof.from_bytes(wire), JPedersenGens(),
                                      JBulletproofGens(GENS))
        return True
    except (JProofError, ValueError):
        return False


@pytest.mark.parametrize("tamper", [None, "t_x", "A_I2"])
def test_verify_on_cpu_matches_jax_verdicts(tamper):
    wire = _tampered(_case("cloak")[2], tamper)
    timings = {}
    try:
        _port_verifier("cloak").verify(R1CSProof.from_bytes(wire), PedersenGens(),
                                       BulletproofGens(GENS), device="cpu",
                                       timings=timings)
        accepted = True
        assert timings["route"] == "small" and timings["msm_size"] == 2 + 2 * 64 + 23
    except VerificationError:
        accepted = False
    assert accepted == (tamper is None) == _jax_verdict(wire)


def test_verify_without_device_rides_the_default_engine(monkeypatch):
    """With no device, verify resolves its engine as the range-proof entry
    points do: set_engine's TorchEngine on the CPU, with its MSM
    configuration, reaches split_msm_check, and the verdicts stay."""
    config = msm.MsmConfig(sort=True, gather=True)
    seen = []
    real = bvd.split_msm_check

    def spy(static, enc, static_sc, dyn_sc, wbits, cfg=None):
        seen.append((static.device, cfg))
        return real(static, enc, static_sc, dyn_sc, wbits, cfg)

    monkeypatch.setattr(bvd, "split_msm_check", spy)
    prev = set_engine(TorchEngine("cpu", config=config))
    try:
        verdicts = []
        for tamper in (None, "t_x"):
            try:
                _port_verifier("cloak").verify(
                    R1CSProof.from_bytes(_tampered(_case("cloak")[2], tamper)),
                    PedersenGens(), BulletproofGens(GENS))
                verdicts.append(True)
            except VerificationError:
                verdicts.append(False)
    finally:
        set_engine(prev)
    assert verdicts == [True, False]
    assert seen == [(torch.device("cpu"), config)] * 2


@pytest.mark.parametrize("tamper", [None, "t_x"])
def test_split_msm_check_matches_jax_host_msm(tamper):
    """The JAX package's fused-split arrays (its dynamic part zero-padded to
    256, as its fused_split_check pads it) through
    convert.from_jax_split_inputs and the port's split_msm_check on the CPU,
    against the JAX package's Engine().msm_is_identity on the same job."""
    wire = _tampered(_case("cloak")[2], tamper)
    bp, pc = JBulletproofGens(GENS), JPedersenGens()
    dyn_s, dyn_enc, bb, bs, g_v, h_v, padded_n = _jax_verifier(
        "cloak").verification_job_split_vec(JR1CSProof.from_bytes(wire), bp, pc,
                                            decompress_dyn=False)
    scalars = dyn_s + [bb, bs] + g_v.to_ints() + h_v.to_ints()
    points = ([JPoint.decompress(e) for e in dyn_enc]
              + [pc.B_blinding, pc.B] + bp.G(padded_n, 1) + bp.H(padded_n, 1))
    want = Engine().msm_is_identity(scalars, points)

    D, dpad = len(dyn_s), 256
    static_buf = (bb.to_bytes(32, "little") + bs.to_bytes(32, "little")
                  + g_v.buf + h_v.buf)
    dyn_sc = np.zeros((dpad, 8), np.uint32)
    dyn_sc[:D] = np.frombuffer(JScalarVec.from_ints(dyn_s).buf, np.uint32).reshape(D, 8)
    enc = np.zeros((8, dpad), np.uint32)
    enc[:, :D] = np.frombuffer(b"".join(dyn_enc), np.uint32).reshape(D, 8).T
    args = convert.from_jax_split_inputs(
        np.asarray(jstatic_gens_words(bp, pc, padded_n, 1)), enc,
        np.frombuffer(static_buf, np.uint32).reshape(-1, 8), dyn_sc, device="cpu")
    n = args[0].shape[2] + dpad
    got = bvd.split_msm_check(*args, msm.best_wbits(n))
    assert bool(int(got)) == want == (tamper is None)


def test_verify_raises_on_malformed_proofs():
    wire = _case("cloak")[2]
    with pytest.raises(ProofError):
        R1CSProof.from_bytes(wire[:-1])
    proof = R1CSProof.from_bytes(wire)
    proof.T_3 = bytes(32)                      # the identity encoding
    with pytest.raises(ProofError):
        _port_verifier("cloak").verify(proof, PedersenGens(), BulletproofGens(GENS),
                                       device="cpu")
