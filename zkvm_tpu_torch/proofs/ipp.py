"""The inner-product proof's fields and wire format.

Upstream counterpart: bulletproofs/src/inner_product_proof.rs —
InnerProductProof::{to_bytes, from_bytes, verification_scalars}.  The
verifier never folds: the range-proof and R1CS mega-checks consume the L/R
encodings and the final a, b directly (kernels/batch_verify_device.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import L
from ..oracle import scalar
from .errors import FormatError
from .scalarvec import PlainScalarVec, ScalarVec


@dataclass
class InnerProductProof:
    L_vec: list[bytes]  # compressed round commitments
    R_vec: list[bytes]
    a: int
    b: int

    def verification_scalars_vec(self, n: int, transcript):
        """Replay the round challenges on `transcript` (each L and R is
        checked on the host to be 32 bytes and not the identity encoding)
        and return scalars_from_challenges' (u_sq, u_inv_sq, s)."""
        return self.scalars_from_challenges(
            self._round_challenges(n, transcript))

    def verification_scalars_vec_plain(self, n: int, transcript):
        """verification_scalars_vec's twin (pure-Python scalar arithmetic)."""
        return self.scalars_from_challenges_plain(
            self._round_challenges(n, transcript))

    def _round_challenges(self, n: int, transcript) -> list[int]:
        lg_n = len(self.L_vec)
        if lg_n >= 32:
            raise FormatError("inner product proof too large")
        if n != (1 << lg_n):
            raise FormatError(f"n={n} does not match lg_n={lg_n}")
        transcript.innerproduct_domain_sep(n)
        challenges = []
        for Lb, Rb in zip(self.L_vec, self.R_vec):
            transcript.validate_and_append_point(b"L", Lb)
            transcript.validate_and_append_point(b"R", Rb)
            challenges.append(transcript.challenge_scalar(b"u"))
        return challenges

    def scalars_from_challenges(self, challenges: list[int]):
        """u_j^2, u_j^-2 and the s-vector, s_i = Π_j u_j^(±1) by the bits
        of i, as a packed ScalarVec (upstream verification_scalars), in
        the native library."""
        return self._scalars(challenges, scalar.batch_invert, ScalarVec)

    def scalars_from_challenges_plain(self, challenges: list[int]):
        """scalars_from_challenges' pure-Python twin (a PlainScalarVec)."""
        return self._scalars(challenges, scalar.batch_invert_plain,
                             PlainScalarVec)

    def _scalars(self, challenges, batch_invert, sv_type):
        lg_n = len(self.L_vec)
        challenges_inv = batch_invert(challenges)
        allinv = 1
        for ci in challenges_inv:
            allinv = allinv * ci % L
        u_sq = [u * u % L for u in challenges]
        u_inv_sq = [u * u % L for u in challenges_inv]
        # s[2^j .. 2^(j+1)) = s[0 .. 2^j) * u_sq[lg_n - 1 - j]
        sv = sv_type.from_ints([allinv])
        for j in range(lg_n):
            scaled = sv.scale(u_sq[(lg_n - 1) - j])
            sv = sv_type(sv.buf + scaled.buf, 2 * sv.n)
        return u_sq, u_inv_sq, sv

    def to_bytes(self) -> bytes:
        out = bytearray()
        for Lb, Rb in zip(self.L_vec, self.R_vec):
            out += Lb
            out += Rb
        out += scalar.to_bytes(self.a)
        out += scalar.to_bytes(self.b)
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "InnerProductProof":
        if len(data) % 32 != 0 or len(data) < 64:
            raise FormatError("bad inner product proof length")
        num_elems = len(data) // 32
        lg_n = (num_elems - 2) // 2
        if 2 * lg_n + 2 != num_elems or lg_n >= 32:
            raise FormatError("bad inner product proof structure")
        L_vec, R_vec = [], []
        for i in range(lg_n):
            L_vec.append(data[64 * i: 64 * i + 32])
            R_vec.append(data[64 * i + 32: 64 * i + 64])
        a = scalar.from_canonical_bytes(data[-64:-32])
        b = scalar.from_canonical_bytes(data[-32:])
        return InnerProductProof(L_vec, R_vec, a, b)
