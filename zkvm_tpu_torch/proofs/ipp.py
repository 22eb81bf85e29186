"""The inner-product argument: create, verify and the wire format.

Upstream counterpart: bulletproofs/src/inner_product_proof.rs —
InnerProductProof::{create, verify, to_bytes, from_bytes,
verification_scalars}.  create hands the argument to the engine
(Engine.ipp_create): TorchEngine runs it with the vectors resident on the
card (kernels/ipp_device.py); create_plain is the reference's host rounds,
which fold G and H on the port's oracle, the twin that the base Engine
runs.  The verifier never folds: verify and the range-proof and R1CS
mega-checks consume the L/R encodings and the final a, b directly in one
MSM.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import L
from ..oracle import edwards, scalar
from ..oracle.ristretto import RistrettoPoint, decompress_many
from .engine import resolve_engine
from .errors import FormatError, VerificationError
from .scalarvec import PlainScalarVec, ScalarVec


@dataclass
class InnerProductProof:
    L_vec: list[bytes]  # compressed round commitments
    R_vec: list[bytes]
    a: int
    b: int

    @staticmethod
    def create(transcript, Q: RistrettoPoint, G_factors, H_factors,
               G: list[RistrettoPoint], H: list[RistrettoPoint], a, b,
               device=None, engine=None,
               timings: dict | None = None) -> "InnerProductProof":
        """Prove <a, b> = c for P = <a, G∘G_factors> + <b, H∘H_factors> + c Q
        (n = len(G), a power of two) on the engine (engine=, else a
        TorchEngine on device=, else the default engine, on the card)."""
        return resolve_engine(device, engine).ipp_create(
            transcript, Q, G_factors, H_factors, G, H, a, b, timings=timings)

    @staticmethod
    def create_plain(transcript, Q: RistrettoPoint, G_factors, H_factors,
                     G: list[RistrettoPoint], H: list[RistrettoPoint], a, b,
                     engine) -> "InnerProductProof":
        """The reference's rounds (zkvm_tpu/proofs/ipp.py:92-162): L and R
        by engine.msm, a, b, G and H folded in half, the points on the
        port's oracle (the factors folded in on the first round)."""
        def ints(v):
            return [int(x) % L for x in
                    (v.to_ints() if hasattr(v, "to_ints") else v)]

        def fold_points(s1, s2, P, Q_):
            return [RistrettoPoint(edwards.add(edwards.scalar_mul(x, p.ep),
                                               edwards.scalar_mul(y, q.ep)))
                    for x, y, p, q in zip(s1, s2, P, Q_, strict=True)]

        n = len(G)
        if not (n == len(H) == len(a) == len(b) == len(G_factors)
                == len(H_factors)) or n & (n - 1) or n == 0:
            raise ValueError("the argument takes equal lengths, a power of two")
        transcript.innerproduct_domain_sep(n)
        G, H = list(G), list(H)
        gf, hf = ints(G_factors), ints(H_factors)
        a, b = ints(a), ints(b)
        L_vec: list[bytes] = []
        R_vec: list[bytes] = []
        while n != 1:
            n //= 2
            a_L, a_R, b_L, b_R = a[:n], a[n:], b[:n], b[n:]
            G_L, G_R, H_L, H_R = G[:n], G[n:], H[:n], H[n:]
            gf_L, gf_R, hf_L, hf_R = gf[:n], gf[n:], hf[:n], hf[n:]
            c_L = scalar.inner_product(a_L, b_R)
            c_R = scalar.inner_product(a_R, b_L)
            Lp = engine.msm([x * g % L for x, g in zip(a_L, gf_R)]
                            + [x * h % L for x, h in zip(b_R, hf_L)] + [c_L],
                            G_R + H_L + [Q])
            Rp = engine.msm([x * g % L for x, g in zip(a_R, gf_L)]
                            + [x * h % L for x, h in zip(b_L, hf_R)] + [c_R],
                            G_L + H_R + [Q])
            L_vec.append(Lp.compress())
            R_vec.append(Rp.compress())
            transcript.append_point(b"L", L_vec[-1])
            transcript.append_point(b"R", R_vec[-1])
            u = transcript.challenge_scalar(b"u")
            u_inv = scalar.invert(u)
            a = [(x * u + u_inv * y) % L for x, y in zip(a_L, a_R)]
            b = [(x * u_inv + u * y) % L for x, y in zip(b_L, b_R)]
            G = fold_points([u_inv * g % L for g in gf_L],
                            [u * g % L for g in gf_R], G_L, G_R)
            H = fold_points([u * h % L for h in hf_L],
                            [u_inv * h % L for h in hf_R], H_L, H_R)
            gf = hf = [1] * n
        return InnerProductProof(L_vec, R_vec, a[0], b[0])

    def verify(self, n: int, transcript, G_factors, H_factors,
               P: RistrettoPoint, Q: RistrettoPoint, G: list[RistrettoPoint],
               H: list[RistrettoPoint], device=None, engine=None) -> None:
        """One-MSM verification (upstream InnerProductProof::verify):
        raises VerificationError unless <a s∘G_factors, G> + <b s^-1∘
        H_factors, H> + ab Q - Σ (u_j^2 L_j + u_j^-2 R_j) equals P.  The
        check, with -P in the MSM, is an identity test on the engine."""
        u_sq, u_inv_sq, s = self.verification_scalars_vec(n, transcript)
        s = s.to_ints()
        a, b = self.a, self.b
        g_scalars = [a * si % L * gf % L for si, gf in zip(s, G_factors)]
        h_scalars = [b * si % L * hf % L
                     for si, hf in zip(reversed(s), H_factors)]
        points = decompress_many(list(self.L_vec) + list(self.R_vec))
        if not resolve_engine(device, engine).msm_is_identity(
                [a * b % L] + g_scalars + h_scalars
                + [(-x) % L for x in u_sq + u_inv_sq] + [L - 1],
                [Q] + list(G) + list(H) + points + [P]):
            raise VerificationError("inner product proof verification failed")

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
