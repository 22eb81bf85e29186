"""R1CS verifier (upstream bulletproofs/src/r1cs/verifier.rs).

Replays the constraint system symbolically (no witness), reproduces the
transcript, and folds the whole verification into ONE MSM == identity,
which kernels/batch_verify_device.py::fused_split_check runs on the card
(`verify`), or an engine over host-decoded points (`verification_job`,
the ZkVM verifier's form).
"""

from __future__ import annotations

import time

from ...constants import L
from ...oracle import scalar
from ...oracle.ristretto import RistrettoPoint, decompress_many
from ..engine import Engine, resolve_engine
from ..errors import R1CSError, VerificationError
from ..generators import BulletproofGens, PedersenGens
from ..scalarvec import PlainScalarVec, ScalarVec
from ..transcript import ProofTranscript
from ..util import next_power_of_two
from .constraint_system import (Metrics, flatten_constraints,
                                flatten_constraints_vec)
from .lc import LinearCombination, Variable, _as_lc
from .proof import R1CSProof


class Verifier:
    """ConstraintSystem implementation without a witness."""

    def __init__(self, transcript: ProofTranscript):
        self.transcript = transcript
        transcript.r1cs_domain_sep()
        self.num_v = 0
        self.V: list[bytes] = []
        self.num_multipliers = 0
        self.constraints: list[LinearCombination] = []
        self.deferred: list = []
        self.pending_multiplier: int | None = None
        self.num_phase1_multipliers: int | None = None
        self._num_phase1_constraints: int | None = None
        self._in_phase2 = False

    def commit(self, V: bytes) -> Variable:
        j = self.num_v
        self.num_v += 1
        self.V.append(V)
        self.transcript.append_point(b"V", V)
        return Variable.committed(j)

    # --------------------------------------------------- ConstraintSystem API
    def multiply(self, left, right):
        left = _as_lc(left)
        right = _as_lc(right)
        i = self.num_multipliers
        self.num_multipliers += 1
        vl = Variable.multiplier_left(i)
        vr = Variable.multiplier_right(i)
        vo = Variable.multiplier_output(i)
        self.constrain(left - vl)
        self.constrain(right - vr)
        return vl, vr, vo

    def allocate(self, assignment=None) -> Variable:
        if self.pending_multiplier is None:
            i = self.num_multipliers
            self.num_multipliers += 1
            self.pending_multiplier = i
            return Variable.multiplier_left(i)
        i = self.pending_multiplier
        self.pending_multiplier = None
        return Variable.multiplier_right(i)

    def allocate_multiplier(self, assignment=None):
        i = self.num_multipliers
        self.num_multipliers += 1
        return (
            Variable.multiplier_left(i),
            Variable.multiplier_right(i),
            Variable.multiplier_output(i),
        )

    def constrain(self, lc):
        # no eager simplify: flatten_constraints merges duplicate terms
        self.constraints.append(_as_lc(lc))

    def specify_randomized_constraints(self, closure):
        self.deferred.append(closure)

    def challenge_scalar(self, label: bytes) -> int:
        if not self._in_phase2:
            raise R1CSError(
                "challenges are only available inside randomized constraints"
            )
        return self.transcript.challenge_scalar(label)

    def metrics(self) -> Metrics:
        p1 = (
            self._num_phase1_constraints
            if self._num_phase1_constraints is not None
            else len(self.constraints)
        )
        return Metrics(
            multipliers=self.num_multipliers,
            constraints=len(self.constraints),
            phase_one_constraints=p1,
            phase_two_constraints=len(self.constraints) - p1,
        )

    # ----------------------------------------------------------------- verify
    def verification_job_split_vec(
        self, proof: R1CSProof, bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
    ):
        """The mega-check MSM's inputs, split into the proof's dynamic terms
        and the scalars over the static columns [B_blinding, B] +
        G(padded_n) + H(padded_n): returns (dyn_scalars, dyn_encodings, bb,
        bs, g_vec, h_vec, padded_n), the G/H scalars as ScalarVecs.  The
        dynamic points stay raw 32-byte encodings, in the order A_I1, A_O1,
        S1, A_I2, A_O2, S2, T_1, T_3..T_6, V.., L.., R..; the device decode
        validates them, so an invalid encoding rejects there.  The flatten,
        the inversions and the ScalarVec arithmetic run in the native
        library."""
        return self._split_vec(proof, bp_gens, plain=False)

    def verification_job_split_vec_plain(
        self, proof: R1CSProof, bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
    ):
        """verification_job_split_vec's pure-Python twin (flatten_constraints,
        PlainScalarVec); the transcript is the verifier's own."""
        return self._split_vec(proof, bp_gens, plain=True)

    def _split_vec(self, proof: R1CSProof, bp_gens: BulletproofGens,
                   plain: bool):
        ts = self.transcript
        ts.append_u64(b"m", self.num_v)

        ts.validate_and_append_point(b"A_I1", proof.A_I1)
        ts.validate_and_append_point(b"A_O1", proof.A_O1)
        ts.validate_and_append_point(b"S1", proof.S1)

        self.num_phase1_multipliers = n1 = self.num_multipliers
        self._num_phase1_constraints = len(self.constraints)
        if not self.deferred:
            ts.r1cs_1phase_domain_sep()
        else:
            ts.r1cs_2phase_domain_sep()
            self._in_phase2 = True
            deferred, self.deferred = self.deferred, []
            for closure in deferred:
                closure(self)
        self.pending_multiplier = None

        # phase-2 commitment points may be the identity: plain append
        ts.append_point(b"A_I2", proof.A_I2)
        ts.append_point(b"A_O2", proof.A_O2)
        ts.append_point(b"S2", proof.S2)

        u = ts.challenge_scalar(b"u")
        y = ts.challenge_scalar(b"y")
        z = ts.challenge_scalar(b"z")

        n = self.num_multipliers
        n2 = n - n1
        padded_n = next_power_of_two(n)
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise R1CSError("invalid generators length")

        if plain:
            wL, wR, wO, wV, wc = flatten_constraints(
                self.constraints, z, n, self.num_v)
            sv_type, invert = PlainScalarVec, scalar.invert_plain
            sv_wL, sv_wR, sv_wO = (PlainScalarVec.from_ints(w + [0] * pad)
                                   for w in (wL, wR, wO))
        else:
            sv_wL, sv_wR, sv_wO, wV, wc = flatten_constraints_vec(
                self.constraints, z, n, self.num_v, pad)
            sv_type, invert = ScalarVec, scalar.invert

        for i in (1, 3, 4, 5, 6):
            ts.validate_and_append_point(
                f"T_{i}".encode(), getattr(proof, f"T_{i}")
            )

        x = ts.challenge_scalar(b"x")
        ts.append_scalar(b"t_x", proof.t_x)
        ts.append_scalar(b"t_x_blinding", proof.t_x_blinding)
        ts.append_scalar(b"e_blinding", proof.e_blinding)
        w = ts.challenge_scalar(b"w")

        # verifier-local weight combining the t-check and P-check
        c = ts.build_rng().finalize(b"\x00" * 32).random_scalar()

        ipp = proof.ipp_proof
        u_sq, u_inv_sq, sv_s = (
            ipp.verification_scalars_vec_plain(padded_n, ts) if plain
            else ipp.verification_scalars_vec(padded_n, ts))
        a, b = proof.ipp_proof.a % L, proof.ipp_proof.b % L

        sv_yinv = sv_type.powers(invert(y), padded_n)
        one_b = (1).to_bytes(32, "little")
        sv_fac = sv_type(
            one_b * n1 + (u % L).to_bytes(32, "little") * (n2 + pad),
            padded_n)
        ones = sv_type(one_b * padded_n, padded_n)

        yneg_wR = sv_yinv.mul(sv_wR)
        delta = sv_type(yneg_wR.buf[: 32 * n], n).inner(
            sv_type(sv_wL.buf[: 32 * n], n))
        # g_i = fac_i · (x·yneg_wR_i − a·s_i)
        g_v = yneg_wR.scale(x).sub(sv_s.scale(a)).mul(sv_fac)
        # h_i = fac_i · (y^{-i}·(x·wL_i + wO_i − b·s_inv_i) − 1)
        h_v = (sv_wL.scale(x).add(sv_wO).sub(sv_s.reverse().scale(b))
               .mul(sv_yinv).sub(ones).mul(sv_fac))
        xx = x * x % L
        basepoint_scalar = (
            w * ((proof.t_x - a * b) % L)
            + c * ((xx * ((wc + delta) % L) - proof.t_x) % L)
        ) % L

        dyn_scalars = (
            [
                x,                      # A_I1
                xx,                     # A_O1
                xx * x % L,             # S1
                u * x % L,              # A_I2
                u * xx % L,             # A_O2
                u * xx % L * x % L,     # S2
                c * x % L,              # T_1
                c * pow(x, 3, L) % L,   # T_3
                c * pow(x, 4, L) % L,   # T_4
                c * pow(x, 5, L) % L,   # T_5
                c * pow(x, 6, L) % L,   # T_6
            ]
            + [c * xx % L * wVj % L for wVj in wV]          # V_j
            + list(u_sq) + list(u_inv_sq)                   # L_vec, R_vec
        )
        dyn_encodings = (list(proof.points()) + list(self.V)
                         + list(proof.ipp_proof.L_vec)
                         + list(proof.ipp_proof.R_vec))
        bb = (-proof.e_blinding - c * proof.t_x_blinding) % L
        return (dyn_scalars, dyn_encodings, bb, basepoint_scalar,
                g_v, h_v, padded_n)

    def verification_job(
        self, proof: R1CSProof, bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
    ) -> tuple[list[int], list[RistrettoPoint]]:
        """The mega-check MSM as (scalars, points) for an engine: the
        dynamic terms, decoded on the host (an invalid encoding raises
        ValueError), then [B_blinding, B] + G(padded_n) + H(padded_n) of
        party 0 (the ZkVM verifier's per-transaction job)."""
        dyn_s, dyn_enc, bb, bs, g_v, h_v, padded_n = \
            self.verification_job_split_vec(proof, bp_gens, pc_gens)
        gens = bp_gens.share(0)
        scalars = dyn_s + [bb, bs] + g_v.to_ints() + h_v.to_ints()
        points = (decompress_many(dyn_enc)
                  + [pc_gens.B_blinding, pc_gens.B]
                  + gens.G(padded_n) + gens.H(padded_n))
        return scalars, points

    def verify(self, proof: R1CSProof, pc_gens: PedersenGens,
               bp_gens: BulletproofGens, device=None,
               timings: dict | None = None,
               engine: Engine | None = None) -> None:
        """Verify `proof` against the constraints laid on this verifier.
        The mega-check runs through the fused split check on `engine`'s
        device and MSM configuration, else on a TorchEngine on `device`
        ("cpu" takes the kernels' plain PyTorch versions, as the tests do),
        else on the default engine (the card), as the range-proof entry
        points resolve theirs.  Raises VerificationError on reject,
        ProofError/R1CSError on malformed input.  timings, when given,
        receives host_s (replay, scalar assembly, packing), device_s
        (upload, device chain, the verdict's fetch), msm_size, wbits and
        route."""
        from ...kernels.batch_verify_device import fused_split_check

        eng = resolve_engine(device, engine)
        if not eng.supports_fused_batch_verify:
            raise TypeError("R1CS verification needs an engine with the "
                            "fused split check (a TorchEngine)")
        t0 = time.perf_counter()
        dyn_s, dyn_enc, bb, bs, g_v, h_v, _ = self.verification_job_split_vec(
            proof, bp_gens, pc_gens)
        static_buf = (bb.to_bytes(32, "little") + bs.to_bytes(32, "little")
                      + g_v.buf + h_v.buf)
        t_job = time.perf_counter()
        ok = fused_split_check(static_buf, dyn_s, b"".join(dyn_enc),
                               bp_gens, pc_gens, eng.device, timings,
                               eng.config)
        if timings is not None:
            timings["host_s"] += t_job - t0
        if not ok:
            raise VerificationError("R1CS proof verification failed")
