"""Range-proof proving in the port, held byte for byte against the JAX
package's prover on the same seeded witness RNG, values and blindings.

The range proofs run on an engine over the port's oracle (the base
Engine's plain prover calls and InnerProductProof.create_plain), so that
no MSM twin runs; the device-resident argument (kernels/ipp_device.py)
runs on TorchEngine("cpu"), the kernels' plain versions, at n = 4 with
the R1CS argument's non-unit G factors (u on the upper half), its scalar
limbs held against Python integers at every round, and so does one
TorchEngine.msm_batch over groups of different lengths.
"""

import random

import pytest
import torch

from zkvm_tpu.oracle.merlin import Transcript as JTranscript
from zkvm_tpu.proofs.errors import ProofError as JProofError
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.ipp import InnerProductProof as JInnerProductProof
from zkvm_tpu.proofs.rangeproof import RangeProof as JRangeProof
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.constants import L
from zkvm_tpu_torch.kernels import ipp_device
from zkvm_tpu_torch.kernels import scalarmod as sm
from zkvm_tpu_torch.kernels.combine import horner_fold
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.oracle import edwards
from zkvm_tpu_torch.kernels.words import (points_to_ints, points_words,
                                          to_device, words_to_points)
from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint, compress_batch
from zkvm_tpu_torch.proofs.engine import Engine
from zkvm_tpu_torch.proofs.errors import MPCError, ProofError
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.ipp import InnerProductProof
from zkvm_tpu_torch.proofs.mpc import Dealer, Party
from zkvm_tpu_torch.proofs.rangeproof import RangeProof
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

LABEL = b"port-prove-test"

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)


class OracleEngine(Engine):
    """msm on the port's oracle: Σ k_i P_i by double-and-add."""

    def msm(self, scalars, points):
        if hasattr(scalars, "to_ints"):
            scalars = scalars.to_ints()
        acc = edwards.IDENTITY
        for k, p in zip(scalars, points, strict=True):
            acc = edwards.add(acc, edwards.scalar_mul(int(k) % L, p.ep))
        return RistrettoPoint(acc)


def _jax_rng(seed: bytes):
    return (JTranscript(b"test-witness-rng").build_rng()
            .rekey_with_witness_bytes(b"seed", seed).finalize(b"\x00" * 32))


def _flipped(wire: bytes) -> bytes:
    bad = bytearray(wire)
    bad[4 * 32] ^= 1                          # t_x's low bit
    return bytes(bad)


def test_range_proofs_equal_the_jax_prover_and_verify_in_both():
    eng = OracleEngine()
    bp, pc = BulletproofGens(16, 2), PedersenGens()
    jbp, jpc = JBulletproofGens(16, 2), JPedersenGens()
    r = random.Random(14)
    # the seeded witness RNG runs on the native STROBE and draws the JAX
    # package's scalars
    rng, jrng = fixture.witness_rng(b"rng"), _jax_rng(b"rng")
    assert type(rng.strobe).__name__ == "NativeStrobe128"
    assert ([rng.random_scalar() for _ in range(3)]
            == [jrng.random_scalar() for _ in range(3)])
    for n, values in ((8, [0, r.randrange(1 << 8)]), (16, [(1 << 16) - 1])):
        blindings = [r.randrange(L) for _ in values]
        seed = n.to_bytes(4, "little")
        if len(values) == 1:
            proof, vc = RangeProof.prove_single(
                bp, pc, ProofTranscript(LABEL), values[0], blindings[0], n,
                rng=fixture.witness_rng(seed), engine=eng)
            vcs = [vc]
        else:
            proof, vcs = RangeProof.prove_multiple(
                bp, pc, ProofTranscript(LABEL), values, blindings, n,
                rng=fixture.witness_rng(seed), engine=eng)
        jproof, jvcs = JRangeProof.prove_multiple(
            jbp, jpc, JProofTranscript(LABEL), values, blindings, n,
            rng=_jax_rng(seed))
        wire = proof.to_bytes()
        assert wire == jproof.to_bytes() and vcs == jvcs
        for w, accept in ((wire, True), (_flipped(wire), False)):
            try:
                RangeProof.from_bytes(w).verify_multiple(
                    bp, pc, ProofTranscript(LABEL), vcs, n, engine=eng)
                ok = True
            except ProofError:
                ok = False
            assert ok == accept
            try:
                JRangeProof.from_bytes(w).verify_multiple(
                    jbp, jpc, JProofTranscript(LABEL), vcs, n)
                jok = True
            except JProofError:
                jok = False
            assert jok == accept

    # the dealer names a party whose share does not open its commitments
    dealer = Dealer(bp, pc, ProofTranscript(b"mpc"), 8, 2, engine=eng)
    parties = [Party(bp, pc, v, r.randrange(L), 8, engine=eng)
               for v in (3, 200)]
    ch = dealer.receive_bit_commitments([p.assign_position(j)
                                         for j, p in enumerate(parties)])
    pch = dealer.receive_poly_commitments([p.apply_challenge(ch)
                                           for p in parties])
    shares = [p.apply_poly_challenge(pch) for p in parties]
    shares[1].t_x = (shares[1].t_x + 1) % L
    with pytest.raises(MPCError) as e:
        dealer.receive_shares(shares)
    assert e.value.bad_shares == [1]


def test_device_ipp_equals_the_plain_rounds_and_the_jax_argument():
    n = 4
    a, b, gf, hf = fixture.ipp_inputs(b"ipp-test", n)
    a[0] = a[1] = 0           # zero coefficients: round 1's c_L is zero
    # the R1CS argument's factors: G's (1..1, u..u), H's y^-i times G's
    u = pow(3, 100, L)
    gf = [1] * (n // 2) + [u] * (n // 2)
    hf = [g * h % L for g, h in zip(gf, hf)]
    bp, pc = BulletproofGens(n, 1), PedersenGens()
    G, H, Q = bp.G(n, 1), bp.H(n, 1), pc.B_blinding
    eng = TorchEngine("cpu")
    trace, t_dev = [], ProofTranscript(LABEL)
    dev = ipp_device.create(eng, t_dev, Q, gf, hf, G, H, a, b, trace=trace)
    t_plain = ProofTranscript(LABEL)
    plain = InnerProductProof.create_plain(t_plain, Q, gf, hf, G, H, a, b,
                                           OracleEngine())
    jbp = JBulletproofGens(n, 1)
    jipp = JInnerProductProof.create(JProofTranscript(LABEL),
                                     JPedersenGens().B_blinding, gf, hf,
                                     jbp.G(n, 1), jbp.H(n, 1), a, b)
    assert dev.to_bytes() == plain.to_bytes() == jipp.to_bytes()
    assert (t_dev.challenge_bytes(b"post", 32)
            == t_plain.challenge_bytes(b"post", 32))

    # each round's limbs, within the scalarmod audit's bound, are the
    # reference rounds' integers in original index space
    us = dev._round_challenges(n, ProofTranscript(LABEL))
    a_cur, b_cur, gco, hco, bit = list(a), list(b), list(gf), list(hf), n // 2
    assert len(trace) == len(us) == 2
    for u, limbs in zip(us, trace):
        assert all(int(t.abs().max()) < 1 << 28 for t in limbs)
        got = [sm.limbs_to_ints(t) for t in limbs]
        width = 2 * bit
        up = [bool(j & bit) for j in range(n)]
        c_L = sum(x * y for x, y in zip(a_cur[:bit], b_cur[bit:])) % L
        c_R = sum(x * y for x, y in zip(a_cur[bit:], b_cur[:bit])) % L
        assert got[:4] == [[v[j % width] for j in range(n)]
                           for v in (a_cur, b_cur)] + [gco, hco]
        assert got[4] == ([gco[j] * a_cur[j % width - bit] % L if up[j] else 0
                           for j in range(n)]
                          + [0 if up[j] else hco[j] * b_cur[j % width + bit] % L
                             for j in range(n)] + [c_L])
        assert got[5] == ([0 if up[j] else gco[j] * a_cur[j % width + bit] % L
                           for j in range(n)]
                          + [hco[j] * b_cur[j % width - bit] % L if up[j] else 0
                             for j in range(n)] + [c_R])
        ui = pow(u, L - 2, L)
        a_cur = [(x * u + ui * y) % L for x, y in zip(a_cur[:bit], a_cur[bit:])]
        b_cur = [(x * ui + u * y) % L for x, y in zip(b_cur[:bit], b_cur[bit:])]
        gco = [g * (u if s else ui) % L for g, s in zip(gco, up)]
        hco = [h * (ui if s else u) % L for h, s in zip(hco, up)]
        bit //= 2

    assert trace[0][4][:, -1].abs().sum() == 0

    # K4's twin folds identity totals to a point that encodes as zeros
    ident = words_to_points(to_device(points_words([edwards.IDENTITY] * 2),
                                      "cpu")).reshape(4, 10, 1, 2)
    assert compress_batch(points_to_ints(horner_fold(ident, 1))) == [bytes(32)]

    # msm_batch: groups of different lengths, an all-zero one and an empty
    # one, through one upload, each group's totals and one K4 fold
    rng = random.Random(5)
    groups = [[rng.randrange(L) for _ in range(3)], [0, 0], []]
    pts = [list(G[:3]), [Q, pc.B], []]
    got = eng.msm_batch(groups, pts, ct=True)
    want = [OracleEngine().msm(s, p) for s, p in zip(groups, pts)]
    assert [p.compress() for p in got] == [p.compress() for p in want]
    assert got[1].compress() == got[2].compress() == bytes(32)
