"""Bulletproofs range proofs: wire format and batched verification.

Upstream counterpart: bulletproofs/src/range_proof/mod.rs —
RangeProof::{verify_multiple, to_bytes, from_bytes} and the batch seam.
The verifier's whole check is ONE multiscalar multiplication; a batch of
proofs combines those checks with random weights into one larger MSM,
which kernels/batch_verify_device.py runs on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import L
from ..oracle import scalar
from .errors import FormatError, ProofError, VerificationError
from .generators import BulletproofGens, PedersenGens
from .ipp import InnerProductProof
from .transcript import ProofTranscript


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

    def dyn_compressed(self, value_commitments: list[bytes]) -> list[bytes]:
        """This proof's dynamic mega-check points, compressed, in MSM
        order: A, S, T1, T2, L..., R..., V..."""
        return (
            [self.A, self.S, self.T_1, self.T_2]
            + list(self.ipp_proof.L_vec) + list(self.ipp_proof.R_vec)
            + list(value_commitments)
        )

    def _replay_challenges(
        self,
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: ProofTranscript,
        value_commitments: list[bytes],
        n: int,
    ) -> dict:
        """Validate the proof's structure and replay the verification
        transcript; returns {"y", "z", "x", "w", "c", "u"}, the challenges
        from which the device synthesizes every vector scalar."""
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
        if len(self.ipp_proof.L_vec) != lg_nm or n * m != 1 << lg_nm:
            raise FormatError("inner product proof size mismatch")

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


def batch_verify(
    proofs: list[RangeProof],
    bp_gens: BulletproofGens,
    pc_gens: PedersenGens,
    transcripts: list[ProofTranscript],
    value_commitments: list[list[bytes]],
    n: int,
    entropy: bytes = b"\x01" * 32,
    device: str = "cuda",
    timings: dict | None = None,
) -> None:
    """Verify many range proofs in one MSM via a random linear combination.
    Raises VerificationError when the batch is rejected (an invalid point
    encoding rejects the batch too) and FormatError/ProofError on
    malformed input.  Every proof must aggregate the same number m of
    values.  ``device`` is where the MSM runs; "cpu" takes the kernels'
    plain PyTorch versions and is what the tests pass."""
    from ..kernels.batch_verify_device import batch_verify_device

    if not batch_verify_device(proofs, bp_gens, pc_gens, transcripts,
                               value_commitments, n, entropy, device,
                               timings):
        raise VerificationError("batch range proof verification failed")
