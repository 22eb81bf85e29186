"""Bulletproofs range proofs: proving, wire format and batched
verification.

Upstream counterpart: bulletproofs/src/range_proof/mod.rs —
RangeProof::{prove_single, prove_multiple, verify_multiple, to_bytes,
from_bytes} and the batch seam.  The prover runs the dealer/party MPC
locally (proofs/mpc.py) with every group operation on the engine: one
commit_batch for the value commitments, one msm_batch for the S
commitments and one bit_commit_batch for the A commitments (the JAX
package's grouping), the dealer's sums, one commit_batch for T_1 and T_2,
then the inner-product argument (kernels/ipp_device.py on the card).
The verifier's whole check is ONE multiscalar multiplication; a batch of
proofs combines those checks with random weights into one larger MSM.
When every proof of a batch aggregates the same number m of values,
kernels/batch_verify_device.py synthesizes the scalars on the card;
otherwise, and for one aggregated proof (verify_multiple), the host
assembles the MSM as the JAX package does and an Engine (proofs/engine.py,
kernels/engine.py) checks it on the card.

The host work runs in the port's C++ library (native/): the transcript
replay (strobe.cpp rangeproof_replay), the scalar assembly
(scalarvec.cpp rangeproof_scalar_assembly) and the decode.  The *_plain
methods and batch_verification_job_plain are the pure-Python twins that
the tests and chip_smoke.py hold them against.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

from .. import native
from ..constants import L, LABEL_IPP, LABEL_RANGEPROOF
from ..oracle import scalar
from ..oracle.ristretto import (RistrettoPoint, decompress_many,
                                decompress_many_plain)
from .engine import Engine, resolve_engine
from .errors import FormatError, ProofError, VerificationError
from .generators import BulletproofGens, PedersenGens
from .ipp import InnerProductProof
from .scalarvec import PlainScalarVec, ScalarVec
from .transcript import ProofTranscript
from .util import add_time

IDENTITY_ERROR = "point validation failed: identity"


def delta(n: int, m: int, y: int, z: int) -> int:
    """delta(y,z) = (z - z^2) <1, y^nm> - sum_j z^{j+3} <1, 2^n>
    (upstream range_proof::delta)."""
    sum_y = scalar.sum_of_powers(y, n * m)
    sum_2 = scalar.sum_of_powers(2, n)
    zz = z * z % L
    acc = (z - zz) % L * sum_y % L
    zexp = zz * z % L
    for _ in range(m):
        acc = (acc - zexp * sum_2) % L
        zexp = zexp * z % L
    return acc


@dataclass
class RangeProof:
    A: bytes
    S: bytes
    T_1: bytes
    T_2: bytes
    t_x: int
    t_x_blinding: int
    e_blinding: int
    ipp_proof: InnerProductProof

    @staticmethod
    def prove_multiple(bp_gens: BulletproofGens, pc_gens: PedersenGens,
                       transcript: ProofTranscript, values: list[int],
                       blindings: list[int], n: int, rng=None, device=None,
                       engine: Engine | None = None,
                       timings: dict | None = None
                       ) -> tuple["RangeProof", list[bytes]]:
        """An aggregated proof that each of the m values lies in [0, 2^n)
        (upstream prove_multiple_with_rng); -> (proof, value commitments).
        rng is the witness RNG (a TranscriptRng; None draws from the
        operating system).  The group operations run on `engine`, else a
        TorchEngine on `device`, else the default engine (the card).
        timings, when given, receives commit_v_s, commit_sa_s and
        commit_t_s (the engine calls for V, for S and A, for T_1 and T_2,
        with the dealer's transcript steps between them), commit_s (their
        sum), ipp_create's keys and prove_s, wall seconds."""
        from .mpc import Dealer, Party, PolyCommitment

        t0 = time.perf_counter()
        if len(values) != len(blindings):
            raise ValueError("mismatched values/blindings lengths")
        m = len(values)
        eng = resolve_engine(device, engine)
        dealer = Dealer(bp_gens, pc_gens, transcript, n, m, engine=eng)
        t = time.perf_counter()
        Vs = pc_gens.commit_batch(values, blindings, engine=eng)
        add_time(timings, "commit_v_s", t)
        parties = [Party(bp_gens, pc_gens, v, b, n, rng=rng, engine=eng, V=V)
                   for v, b, V in zip(values, blindings, Vs)]
        groups_s, groups_p, a_jobs = [], [], []
        for j, p in enumerate(parties):
            _sa, pa, ss, ps = p.bit_commitment_parts(j)
            a_jobs.append((p.a_blinding, p.a_L, pc_gens.B_blinding,
                           pa[1:n + 1], pa[n + 1:]))
            groups_s.append(ss)
            groups_p.append(ps)
        t = time.perf_counter()
        outs_s = eng.msm_batch(groups_s, groups_p, ct=True)
        outs_a = eng.bit_commit_batch(a_jobs)
        bit_commitments = [p.finish_bit_commitment(outs_a[j], outs_s[j])
                           for j, p in enumerate(parties)]
        bit_challenge = dealer.receive_bit_commitments(bit_commitments)
        add_time(timings, "commit_sa_s", t)
        openings = [p.poly_commitment_parts(bit_challenge) for p in parties]
        t = time.perf_counter()
        Ts = pc_gens.commit_batch([x for vs, _ in openings for x in vs],
                                  [x for _, bs in openings for x in bs],
                                  engine=eng)
        poly_challenge = dealer.receive_poly_commitments(
            [PolyCommitment(Ts[2 * j], Ts[2 * j + 1]) for j in range(m)])
        add_time(timings, "commit_t_s", t)
        if timings is not None:
            timings["commit_s"] = sum(timings[k] for k in (
                "commit_v_s", "commit_sa_s", "commit_t_s"))
        shares = [p.apply_poly_challenge(poly_challenge) for p in parties]
        proof = dealer.receive_trusted_shares(shares, timings)
        add_time(timings, "prove_s", t0)
        return proof, [bc.V_j for bc in bit_commitments]

    @staticmethod
    def prove_single(bp_gens: BulletproofGens, pc_gens: PedersenGens,
                     transcript: ProofTranscript, v: int, v_blinding: int,
                     n: int, rng=None, device=None,
                     engine: Engine | None = None,
                     timings: dict | None = None
                     ) -> tuple["RangeProof", bytes]:
        proof, commitments = RangeProof.prove_multiple(
            bp_gens, pc_gens, transcript, [v], [v_blinding], n, rng, device,
            engine, timings)
        return proof, commitments[0]

    def dyn_compressed(self, value_commitments: list[bytes]) -> list[bytes]:
        """This proof's dynamic mega-check points, compressed, in MSM
        order: A, S, T1, T2, L..., R..., V..."""
        return (
            [self.A, self.S, self.T_1, self.T_2]
            + list(self.ipp_proof.L_vec) + list(self.ipp_proof.R_vec)
            + list(value_commitments)
        )

    def _check_shape(self, bp_gens: BulletproofGens,
                     value_commitments: list[bytes], n: int) -> int:
        """The structural checks that precede a replay; -> lg(n m)."""
        m = len(value_commitments)
        if n not in (8, 16, 32, 64):
            raise FormatError("invalid bitsize")
        if m == 0 or m & (m - 1):
            raise FormatError("invalid aggregation size")
        if bp_gens.gens_capacity < n or bp_gens.party_capacity < m:
            raise FormatError("invalid generators length")

        lg_nm = (n * m).bit_length() - 1
        for pb in self.dyn_compressed(value_commitments):
            if len(pb) != 32:
                raise ProofError("point validation failed: bad length")
        if (len(self.ipp_proof.L_vec) != lg_nm
                or len(self.ipp_proof.R_vec) != lg_nm or n * m != 1 << lg_nm):
            raise FormatError("inner product proof size mismatch")
        return lg_nm

    def replay_header(self) -> bytes:
        """A, S, T_1, T_2, t_x, t_x_blinding, e_blinding: the wire's first
        224 bytes, which the native replay reads."""
        return (self.A + self.S + self.T_1 + self.T_2
                + scalar.to_bytes(self.t_x)
                + scalar.to_bytes(self.t_x_blinding)
                + scalar.to_bytes(self.e_blinding))

    def _replay_challenges(
        self,
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: ProofTranscript,
        value_commitments: list[bytes],
        n: int,
    ) -> dict:
        """Validate the proof's structure and replay the verification
        transcript in one native call; returns {"y", "z", "x", "w", "c",
        "u"}, the challenges from which the device synthesizes every vector
        scalar.  A zero A, S, T_1, T_2, L or R raises ProofError, as
        validate_and_append_point does."""
        lg = self._check_shape(bp_gens, value_commitments, n)
        rc, raw = native.rangeproof_replay(
            transcript.strobe, LABEL_RANGEPROOF, LABEL_IPP, n,
            len(value_commitments), b"".join(value_commitments),
            self.replay_header(),
            b"".join(lb + rb for lb, rb in zip(self.ipp_proof.L_vec,
                                               self.ipp_proof.R_vec)), lg)
        if rc != 0:
            raise ProofError(IDENTITY_ERROR)
        return challenges_from_blob(raw, lg)

    def _replay_challenges_plain(
        self,
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: ProofTranscript,
        value_commitments: list[bytes],
        n: int,
    ) -> dict:
        """_replay_challenges' twin: the transcript operations one by one."""
        m = len(value_commitments)
        self._check_shape(bp_gens, value_commitments, n)
        transcript.rangeproof_domain_sep(n, m)
        for V in value_commitments:
            transcript.append_point(b"V", V)
        transcript.validate_and_append_point(b"A", self.A)
        transcript.validate_and_append_point(b"S", self.S)
        y = transcript.challenge_scalar(b"y")
        z = transcript.challenge_scalar(b"z")
        transcript.validate_and_append_point(b"T_1", self.T_1)
        transcript.validate_and_append_point(b"T_2", self.T_2)
        x = transcript.challenge_scalar(b"x")
        transcript.append_scalar(b"t_x", self.t_x)
        transcript.append_scalar(b"t_x_blinding", self.t_x_blinding)
        transcript.append_scalar(b"e_blinding", self.e_blinding)
        w = transcript.challenge_scalar(b"w")

        # verifier-local weight combining the t-check and the P-check,
        # drawn from the transcript RNG (upstream: thread rng)
        c = transcript.build_rng().finalize(b"\x00" * 32).random_scalar()

        transcript.innerproduct_domain_sep(n * m)
        u_challenges = []
        for Lb, Rb in zip(self.ipp_proof.L_vec, self.ipp_proof.R_vec):
            transcript.validate_and_append_point(b"L", Lb)
            transcript.validate_and_append_point(b"R", Rb)
            u_challenges.append(transcript.challenge_scalar(b"u"))
        return {"y": y, "z": z, "x": x, "w": w, "c": c, "u": u_challenges}

    def _job_parts(self, bp_gens: BulletproofGens, pc_gens: PedersenGens,
                   transcript: ProofTranscript, value_commitments: list[bytes],
                   n: int, decompressed: list | None = None) -> "_JobParts":
        """Replay the transcript and emit the mega-check MSM's sections, the
        g/h columns as packed ScalarVecs, in the native library
        (rangeproof_scalar_assembly):
            g_i = -z - a s_i,   h_i = z + y^-i (z^2 z_and_2_i - b / s_i).
        Point encodings are decoded on the host (ValueError on an invalid
        one) unless `decompressed` brings them."""
        m = len(value_commitments)
        rep = self._replay_challenges(bp_gens, pc_gens, transcript,
                                      value_commitments, n)
        asm = scalar_assembly(rep["u"], n, m, rep["y"], rep["z"],
                              self.ipp_proof.a, self.ipp_proof.b)
        if decompressed is None:
            decompressed = decompress_many(
                self.dyn_compressed(value_commitments))
        return self._parts(rep, m, *asm, decompressed)

    def _job_parts_plain(self, bp_gens: BulletproofGens,
                         pc_gens: PedersenGens, transcript: ProofTranscript,
                         value_commitments: list[bytes], n: int,
                         decompressed: list | None = None) -> "_JobParts":
        """_job_parts' twin: the Python replay and the PlainScalarVec chain
        (the JAX package's ScalarVec chain, its ground truth)."""
        m = len(value_commitments)
        rep = self._replay_challenges_plain(bp_gens, pc_gens, transcript,
                                            value_commitments, n)
        asm = scalar_assembly_plain(rep["u"], n, m, rep["y"], rep["z"],
                                    self.ipp_proof.a, self.ipp_proof.b)
        if decompressed is None:
            decompressed = decompress_many_plain(
                self.dyn_compressed(value_commitments))
        return self._parts(rep, m, *asm, decompressed)

    def _parts(self, rep: dict, m: int, u_sq, u_inv_sq, g_v, h_v,
               delta_val: int, decompressed: list) -> "_JobParts":
        """The sections shared by _job_parts and its twin."""
        z, x, w, c = rep["z"], rep["x"], rep["w"], rep["c"]
        a, b = self.ipp_proof.a % L, self.ipp_proof.b % L
        zz = z * z % L
        b_s = (w * ((self.t_x - a * b) % L)
               + c * ((delta_val - self.t_x) % L)) % L
        cx = c * x % L
        head = [1, x, cx, cx * x % L] + list(u_sq) + list(u_inv_sq)
        k = len(head)
        return _JobParts(
            head=head, bb_s=(-self.e_blinding - c * self.t_x_blinding) % L,
            b_s=b_s, g_v=g_v, h_v=h_v,
            v_s=[c * zz % L * pow(z, j, L) % L for j in range(m)],
            head_points=decompressed[:k], v_points=decompressed[k:])

    def verification_job(self, bp_gens: BulletproofGens,
                         pc_gens: PedersenGens, transcript: ProofTranscript,
                         value_commitments: list[bytes], n: int
                         ) -> tuple[list[int], list[RistrettoPoint]]:
        """The one-proof mega-check as (scalars, points) that must sum to
        the identity, in the JAX package's order: A, S, T1, T2, L.., R..,
        B_blinding, B, G(n, m), H(n, m), V.."""
        m = len(value_commitments)
        p = self._job_parts(bp_gens, pc_gens, transcript, value_commitments,
                            n)
        scalars = (p.head + [p.bb_s, p.b_s] + p.g_v.to_ints()
                   + p.h_v.to_ints() + p.v_s)
        points = (p.head_points + [pc_gens.B_blinding, pc_gens.B]
                  + bp_gens.G(n, m) + bp_gens.H(n, m) + p.v_points)
        return scalars, points

    def verify_multiple(self, bp_gens: BulletproofGens, pc_gens: PedersenGens,
                        transcript: ProofTranscript,
                        value_commitments: list[bytes], n: int,
                        device=None, engine: Engine | None = None) -> None:
        """One aggregated proof, one MSM (upstream verify_multiple).  The
        MSM runs on `engine`, else a TorchEngine on `device`, else the
        default engine (the card).  Raises VerificationError on reject,
        FormatError/ProofError on malformed input and ValueError on an
        invalid point encoding, as the JAX package does."""
        eng = resolve_engine(device, engine)
        scalars, points = self.verification_job(bp_gens, pc_gens, transcript,
                                                value_commitments, n)
        if not eng.msm_is_identity(scalars, points):
            raise VerificationError("range proof verification failed")

    def verify_single(self, bp_gens: BulletproofGens, pc_gens: PedersenGens,
                      transcript: ProofTranscript, V: bytes, n: int,
                      device=None, engine: Engine | None = None) -> None:
        self.verify_multiple(bp_gens, pc_gens, transcript, [V], n, device,
                             engine)

    def to_bytes(self) -> bytes:
        return (
            self.A + self.S + self.T_1 + self.T_2
            + scalar.to_bytes(self.t_x)
            + scalar.to_bytes(self.t_x_blinding)
            + scalar.to_bytes(self.e_blinding)
            + self.ipp_proof.to_bytes()
        )

    @staticmethod
    def from_bytes(data: bytes) -> "RangeProof":
        if len(data) % 32 != 0 or len(data) < 7 * 32:
            raise FormatError("bad range proof length")
        A, S, T_1, T_2 = (data[i * 32: (i + 1) * 32] for i in range(4))
        t_x = scalar.from_canonical_bytes(data[128:160])
        t_x_blinding = scalar.from_canonical_bytes(data[160:192])
        e_blinding = scalar.from_canonical_bytes(data[192:224])
        ipp = InnerProductProof.from_bytes(data[224:])
        return RangeProof(A, S, T_1, T_2, t_x, t_x_blinding, e_blinding, ipp)


@dataclass
class _JobParts:
    """Sections of one proof's mega-check MSM; the g/h columns stay packed
    ScalarVecs."""
    head: list          # [1, x, cx, cxx] + u_sq + u_inv_sq
    bb_s: int           # B_blinding's scalar
    b_s: int            # B's scalar
    g_v: ScalarVec      # n m entries
    h_v: ScalarVec      # n m entries
    v_s: list           # the value commitments' scalars (m)
    head_points: list   # A, S, T1, T2, L.., R.. (decoded)
    v_points: list      # V.. (decoded)


def scalar_assembly(u: list[int], n: int, m: int, y: int, z: int, a: int,
                    b: int):
    """One proof's (u², u⁻², g, h, delta(y, z)) from its round challenges
    u and y, z, a, b, in one native call (rangeproof_scalar_assembly):
        s_i = Π_j u_j^(±1),   g_i = -z - a s_i,
        h_i = z + y^-i (z^2 z^(i div n) 2^(i mod n) - b / s_i),
    g and h as ScalarVecs.  A zero challenge inverts to zero."""
    lg, nm = len(u), n * m
    raw = native.rangeproof_scalar_assembly(
        b"".join(scalar.to_bytes(v) for v in u), lg, n, m, y, z, a, b)
    ints = [int.from_bytes(raw[32 * i: 32 * i + 32], "little")
            for i in range(2 * lg)]
    return (ints[:lg], ints[lg:],
            ScalarVec(raw[64 * lg: 32 * (2 * lg + nm)], nm),
            ScalarVec(raw[32 * (2 * lg + nm): 32 * (2 * lg + 2 * nm)], nm),
            int.from_bytes(raw[-32:], "little"))


def scalar_assembly_plain(u: list[int], n: int, m: int, y: int, z: int,
                          a: int, b: int):
    """scalar_assembly's pure-Python twin: the JAX package's ScalarVec
    chain (PlainScalarVecs)."""
    y, z, a, b = y % L, z % L, a % L, b % L
    zz = z * z % L
    ipp = InnerProductProof([b""] * len(u), [b""] * len(u), a, b)
    u_sq, u_inv_sq, s_v = ipp.scalars_from_challenges_plain(u)
    exp_y_inv_v = PlainScalarVec.powers(scalar.invert_plain(y), n * m)
    exp_2_v = PlainScalarVec.powers(2, n)
    z_pows = [pow(z, j, L) for j in range(m)]
    z2_v = PlainScalarVec.concat(*(exp_2_v.scale(zj) for zj in z_pows))
    g_v = s_v.axpb(-a, -z)
    h_v = (z2_v.scale(zz).sub(s_v.reverse().scale(b)).mul(exp_y_inv_v)
           .axpb(1, z))
    return u_sq, u_inv_sq, g_v, h_v, delta(n, m, y, z)


def challenges_from_blob(raw: bytes, lg: int) -> dict:
    """The native replay's (5 + lg) 32-byte challenges y, z, x, w, c, u..
    as {"y", "z", "x", "w", "c", "u"}."""
    v = [int.from_bytes(raw[32 * i: 32 * i + 32], "little")
         for i in range(5 + lg)]
    return {"y": v[0], "z": v[1], "x": v[2], "w": v[3], "c": v[4],
            "u": v[5:]}


def batch_weight(entropy: bytes, idx: int, wire: bytes) -> int:
    """The random weight of proof `idx` of a batch (the JAX package's):
    SHA3-512(entropy || idx as u64 || wire) reduced mod ℓ."""
    return scalar.from_bytes_mod_order_wide(hashlib.sha3_512(
        entropy + idx.to_bytes(8, "little") + wire).digest())


def batch_verification_job(proofs: list[RangeProof], bp_gens: BulletproofGens,
                           pc_gens: PedersenGens,
                           transcripts: list[ProofTranscript],
                           value_commitments: list[list[bytes]], n: int,
                           entropy: bytes = b"\x01" * 32
                           ) -> tuple[ScalarVec, list[RistrettoPoint]]:
    """Host half of batched verification for any mix of aggregation sizes
    (the JAX package's batch_verification_job): every proof's mega-check
    times its random weight, in one MSM (scalars, points) that must sum to
    the identity.  The static columns B_blinding, B, G(n, max m), H(n,
    max m) are shared, so the MSM has 2 + 2 n max_m + Σ_p (4 + 2 lg(n m_p)
    + m_p) points.  Every encoding is decoded on the host first, in one
    native call (ValueError on an invalid one); each proof's replay and
    scalars run in the native library."""
    return _batch_job(proofs, bp_gens, pc_gens, transcripts,
                      value_commitments, n, entropy, RangeProof._job_parts,
                      decompress_many, ScalarVec)


def batch_verification_job_plain(proofs, bp_gens, pc_gens, transcripts,
                                 value_commitments, n,
                                 entropy: bytes = b"\x01" * 32):
    """batch_verification_job's pure-Python twin (a PlainScalarVec)."""
    return _batch_job(proofs, bp_gens, pc_gens, transcripts,
                      value_commitments, n, entropy,
                      RangeProof._job_parts_plain, decompress_many_plain,
                      PlainScalarVec)


def _batch_job(proofs, bp_gens, pc_gens, transcripts, value_commitments, n,
               entropy, job_parts, decode, sv_type):
    if not proofs or not (len(proofs) == len(transcripts)
                          == len(value_commitments)):
        raise FormatError("empty batch, or proofs, transcripts and value "
                          "commitments of different counts")
    max_m = max(len(vc) for vc in value_commitments)
    nm_max = n * max_m
    static_points = ([pc_gens.B_blinding, pc_gens.B] + bp_gens.G(n, max_m)
                     + bp_gens.H(n, max_m))
    all_dyn = decode([enc for p, vcs in zip(proofs, value_commitments)
                      for enc in p.dyn_compressed(vcs)])
    # static scalars accumulate as ints (reduced once, at the end)
    static_acc = [0] * (2 + 2 * nm_max)
    dyn_scalars: list[int] = []
    dyn_points: list[RistrettoPoint] = []
    off = 0
    for idx, (proof, transcript, vcs) in enumerate(
            zip(proofs, transcripts, value_commitments)):
        k = len(proof.dyn_compressed(vcs))
        p = job_parts(proof, bp_gens, pc_gens, transcript, vcs, n,
                      decompressed=all_dyn[off: off + k])
        off += k
        wt = batch_weight(entropy, idx, proof.to_bytes())
        dyn_scalars.extend(s * wt % L for s in p.head + p.v_s)
        dyn_points.extend(p.head_points + p.v_points)
        static_acc[0] += wt * p.bb_s
        static_acc[1] += wt * p.b_s
        for i, g in enumerate(p.g_v.to_ints(), 2):
            static_acc[i] += wt * g
        for i, h in enumerate(p.h_v.to_ints(), 2 + nm_max):
            static_acc[i] += wt * h
    return (sv_type.from_ints(static_acc + dyn_scalars),
            static_points + dyn_points)


def batch_verify(
    proofs: list[RangeProof],
    bp_gens: BulletproofGens,
    pc_gens: PedersenGens,
    transcripts: list[ProofTranscript],
    value_commitments: list[list[bytes]],
    n: int,
    entropy: bytes = b"\x01" * 32,
    device=None,
    timings: dict | None = None,
    engine: Engine | None = None,
) -> None:
    """Verify many range proofs in one MSM via a random linear combination.
    Raises VerificationError when the batch is rejected and
    FormatError/ProofError on malformed input.  The MSM runs on `engine`,
    else a TorchEngine on `device` ("cpu" takes the kernels' plain
    PyTorch versions, as the tests do), else the default engine (the
    card).  When every proof aggregates the same m and the engine
    supports_fused_batch_verify, the fused device path decodes the
    encodings on the card (an invalid one rejects the batch); otherwise
    batch_verification_job assembles the MSM on the host (an invalid
    encoding raises ValueError there), as the JAX package does.  timings,
    when given, receives host_s (with the engine's packing), device_s,
    msm_size and wbits."""
    from ..kernels.batch_verify_device import batch_verify_device
    from ..kernels.msm import best_wbits

    eng = resolve_engine(device, engine)
    same_m = all(len(vc) == len(value_commitments[0])
                 for vc in value_commitments)
    if same_m and eng.supports_fused_batch_verify:
        ok = batch_verify_device(proofs, bp_gens, pc_gens, transcripts,
                                 value_commitments, n, entropy, eng.device,
                                 timings, eng.config)
    else:
        t0 = time.perf_counter()
        scalars, points = batch_verification_job(
            proofs, bp_gens, pc_gens, transcripts, value_commitments, n,
            entropy)
        t1 = time.perf_counter()
        split: dict = {}
        ok = eng.msm_is_identity(scalars, points, split)
        if timings is not None:
            pack_s = split.get("pack_s", 0.0)
            timings.update(host_s=t1 - t0 + pack_s,
                           device_s=time.perf_counter() - t1 - pack_s,
                           msm_size=len(points),
                           wbits=getattr(eng, "wbits", None)
                           or best_wbits(len(points)))
    if not ok:
        raise VerificationError("batch range proof verification failed")
