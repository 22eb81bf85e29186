"""The port's copies of the pure-Python ground truth (zkvm_tpu_torch.oracle,
.constants, .proofs.generators, .proofs.transcript) against the JAX
package's modules and the pinned cross-stack vectors."""

import json
from pathlib import Path

import numpy as np

import zkvm_tpu.constants as JC
from zkvm_tpu.oracle import field as jfield
from zkvm_tpu.oracle import scalar as jscalar
from zkvm_tpu.oracle.merlin import Transcript as JTranscript
from zkvm_tpu.oracle.ristretto import BASEPOINT as JBASE
from zkvm_tpu.oracle.ristretto import RistrettoPoint as JPoint
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch import constants as C
from zkvm_tpu_torch.oracle import field, scalar
from zkvm_tpu_torch.oracle.merlin import Transcript
from zkvm_tpu_torch.oracle.ristretto import BASEPOINT, RistrettoPoint
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

PINNED = json.loads((Path(__file__).parent / "vectors" / "pinned.json")
                    .read_text())


def test_constants_match():
    for name in ("P", "L", "EDWARDS_D", "EDWARDS_D2", "SQRT_M1",
                 "ONE_MINUS_D_SQ", "D_MINUS_ONE_SQ", "SQRT_AD_MINUS_ONE",
                 "INVSQRT_A_MINUS_D", "BASE_X", "BASE_Y", "BASE_T",
                 "RISTRETTO_BASEPOINT_COMPRESSED", "MERLIN_PROTOCOL_LABEL",
                 "MERLIN_DOMSEP_LABEL", "LABEL_RANGEPROOF", "LABEL_IPP",
                 "GENERATORS_CHAIN_LABEL"):
        assert getattr(C, name) == getattr(JC, name), name


def test_field_and_scalar_match():
    rs = np.random.default_rng(21)
    xs = [int.from_bytes(rs.bytes(32), "little") for _ in range(24)] + [0, 1]
    for u, v in zip(xs, xs[1:] + xs[:1]):
        assert field.sqrt_ratio(u, v) == jfield.sqrt_ratio(u, v)
        assert field.mul(u, v) == jfield.mul(u, v)
        assert scalar.mul(u, v) == jscalar.mul(u, v)
    wide = [rs.bytes(64) for _ in range(8)]
    assert ([scalar.from_bytes_mod_order_wide(b) for b in wide]
            == [jscalar.from_bytes_mod_order_wide(b) for b in wide])
    ls = [x % C.L for x in xs]
    assert scalar.batch_invert(ls) == jscalar.batch_invert(ls)
    assert scalar.sum_of_powers(xs[0], 64) == jscalar.sum_of_powers(xs[0], 64)


def test_ristretto_small_multiples_and_random_points():
    """RFC 9496 §A.1: k·B for k = 0..15 encode as the oracle encodes them,
    and both decoders agree on valid and invalid encodings."""
    p, jp = RistrettoPoint((0, 1, 1, 0)), JPoint((0, 1, 1, 0))
    encs = []
    for _ in range(16):
        assert p.compress() == jp.compress()
        encs.append(p.compress())
        p, jp = p + BASEPOINT, jp + JBASE
    rs = np.random.default_rng(22)
    encs += [RistrettoPoint.from_uniform_bytes(rs.bytes(64)).compress()
             for _ in range(8)]
    encs += [rs.bytes(32) for _ in range(8)] + [(C.P + 2).to_bytes(32, "little")]
    for e in encs:
        try:
            want = JPoint.decompress(e).compress()
        except ValueError:
            want = None
        try:
            got = RistrettoPoint.decompress(e).compress()
        except ValueError:
            got = None
        assert got == want
    u = rs.bytes(64)
    assert (RistrettoPoint.from_uniform_bytes(u).compress()
            == JPoint.from_uniform_bytes(u).compress())


def test_merlin_challenges_match():
    t = Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert (t.challenge_bytes(b"challenge", 32).hex()
            == PINNED["merlin_known_answer"]["hex"])

    a, b = ProofTranscript(b"port"), JProofTranscript(b"port")
    for tr in (a, b):
        tr.rangeproof_domain_sep(64, 1)
        tr.append_scalar(b"t_x", 12345)
        tr.validate_and_append_point(b"A", BASEPOINT.compress())
    assert a.challenge_scalar(b"y") == b.challenge_scalar(b"y")
    for tr in (a, b):
        tr.innerproduct_domain_sep(64)
    assert a.challenge_bytes(b"u", 64) == b.challenge_bytes(b"u", 64)
    ra = a.build_rng().finalize(b"\x00" * 32).random_scalar()
    rb = b.build_rng().finalize(b"\x00" * 32).random_scalar()
    assert ra == rb


def test_generators_match():
    bp, jbp = BulletproofGens(64, 4), JBulletproofGens(64, 4)
    assert ([g.compress() for g in bp.G(64, 4)]
            == [g.compress() for g in jbp.G(64, 4)])
    assert ([h.compress() for h in bp.H(64, 4)]
            == [h.compress() for h in jbp.H(64, 4)])
    pc = PedersenGens()
    assert pc.B_blinding.compress() == JPedersenGens().B_blinding.compress()
    assert pc.B_blinding.compress().hex() == PINNED["pedersen_B_blinding"]
    first = PINNED["bp_gens_first"]
    assert bp.G_vec[0][0].compress().hex() == first["G00"]
    assert bp.H_vec[0][0].compress().hex() == first["H00"]
    assert bp.G_vec[1][0].compress().hex() == first["G10"]
