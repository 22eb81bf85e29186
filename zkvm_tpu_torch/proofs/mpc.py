"""Aggregated range proving: the dealer's and the parties' state machines.

Upstream counterpart: bulletproofs/src/range_proof/{party.rs, dealer.rs,
messages.rs}; the port's copy of the JAX package's proofs/mpc.py.
RangeProof.prove_multiple runs every party locally.

  Party:  new -> assign_position (BitCommitment) -> apply_challenge
          (PolyCommitment) -> apply_poly_challenge (ProofShare)
  Dealer: new -> receive_bit_commitments (BitChallenge) ->
          receive_poly_commitments (PolyChallenge) ->
          receive_shares / receive_trusted_shares (RangeProof)

Every group operation goes through the engine (a Party's and a Dealer's
engine=, else the default engine, on the card): the commitments, the
dealer's sums of the parties' points, the IPP base w·B, the share audits
(every share's in one call) and the inner-product argument.  The witness
RNG draws in the reference's order: a_blinding, s_blinding, s_L, s_R at
assign_position (bit_commitment_parts), t_1 and t_2 blindings at
apply_challenge (poly_commitment_parts); any other order changes every
proof byte.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..constants import L
from ..oracle import scalar
from ..oracle.merlin import TranscriptRng
from ..oracle.ristretto import RistrettoPoint
from .engine import resolve_engine
from .errors import MPCError
from .generators import BulletproofGens, PedersenGens
from .ipp import InnerProductProof
from .transcript import ProofTranscript
from .util import Poly2, VecPoly1, bit_decompose, powers, vec_mul


@dataclass
class BitCommitment:
    V_j: bytes
    A_j: RistrettoPoint
    S_j: RistrettoPoint


@dataclass
class BitChallenge:
    y: int
    z: int


@dataclass
class PolyCommitment:
    T_1_j: RistrettoPoint
    T_2_j: RistrettoPoint


@dataclass
class PolyChallenge:
    x: int


@dataclass
class ProofShare:
    t_x: int
    t_x_blinding: int
    e_blinding: int
    l_vec: list[int]
    r_vec: list[int]


class Party:
    """One prover of a single n-bit value inside an aggregated proof.  V,
    when given, is its value commitment already made (prove_multiple
    commits every party's value in one engine call)."""

    def __init__(
        self,
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        v: int,
        v_blinding: int,
        n: int,
        rng: TranscriptRng | None = None,
        engine=None,
        V: RistrettoPoint | None = None,
    ):
        if n not in (8, 16, 32, 64):
            raise MPCError("invalid bitsize: n must be one of 8,16,32,64")
        if bp_gens.gens_capacity < n:
            raise MPCError("invalid generators length")
        if not (0 <= v < (1 << n)):
            raise MPCError("value out of range for bitsize")
        self.bp_gens = bp_gens
        self.pc_gens = pc_gens
        self.n = n
        self.v = v
        self.v_blinding = v_blinding % L
        self.engine = resolve_engine(engine=engine)
        self.V = V if V is not None else pc_gens.commit_batch(
            [v], [self.v_blinding], engine=self.engine)[0]
        self._rng = rng

    def _random_scalar(self) -> int:
        if self._rng is not None:
            return self._rng.random_scalar()
        return scalar.from_bytes_mod_order_wide(os.urandom(64))

    def bit_commitment_parts(self, j: int):
        """Take position j and draw the A/S witnesses; -> the A and S MSMs'
        (scalars_A, points_A, scalars_S, points_S), not yet computed."""
        if self.bp_gens.party_capacity <= j:
            raise MPCError("invalid generators length (party capacity)")
        self.j = j
        n = self.n
        gens = self.bp_gens.share(j)
        self.a_blinding = self._random_scalar()
        self.a_L = bit_decompose(self.v, n)
        self.a_R = [(b - 1) % L for b in self.a_L]
        self.s_blinding = self._random_scalar()
        self.s_L = [self._random_scalar() for _ in range(n)]
        self.s_R = [self._random_scalar() for _ in range(n)]
        base = [self.pc_gens.B_blinding] + gens.G(n) + gens.H(n)
        return ([self.a_blinding] + self.a_L + self.a_R, base,
                [self.s_blinding] + self.s_L + self.s_R, base)

    def finish_bit_commitment(self, A: RistrettoPoint,
                              S: RistrettoPoint) -> BitCommitment:
        self.A, self.S = A, S
        return BitCommitment(self.V.compress(), A, S)

    def assign_position(self, j: int) -> BitCommitment:
        _sa, pa, ss, ps = self.bit_commitment_parts(j)
        n = self.n
        A = self.engine.bit_commit_batch([
            (self.a_blinding, self.a_L, self.pc_gens.B_blinding,
             pa[1:n + 1], pa[n + 1:])])[0]
        S = self.engine.msm_secret(ss, ps)
        return self.finish_bit_commitment(A, S)

    def poly_commitment_parts(self, vc: BitChallenge):
        """Form l(X), r(X) and t(X) and draw the t_1, t_2 blindings;
        -> ([t1, t2], [t_1_blinding, t_2_blinding]), the T_1 and T_2
        commitments' openings."""
        n, j = self.n, self.j
        y, z = vc.y % L, vc.z % L
        self.y, self.z = y, z
        offset_y = pow(y, j * n, L)
        offset_z = pow(z, j, L)
        zz = z * z % L
        exp_y = [e * offset_y % L for e in powers(y, n)]
        exp_2 = powers(2, n)
        l0 = [(a - z) % L for a in self.a_L]
        r0 = [(ey * ((ar + z) % L) + zz * offset_z % L * e2) % L
              for ey, ar, e2 in zip(exp_y, self.a_R, exp_2)]
        self.l_poly = VecPoly1(l0, self.s_L)
        self.r_poly = VecPoly1(r0, vec_mul(exp_y, self.s_R))
        self.t_poly: Poly2 = self.l_poly.inner_product(self.r_poly)
        self.t_1_blinding = self._random_scalar()
        self.t_2_blinding = self._random_scalar()
        return ([self.t_poly.t1, self.t_poly.t2],
                [self.t_1_blinding, self.t_2_blinding])

    def apply_challenge(self, vc: BitChallenge) -> PolyCommitment:
        values, blindings = self.poly_commitment_parts(vc)
        return PolyCommitment(*self.pc_gens.commit_batch(
            values, blindings, engine=self.engine))

    def apply_poly_challenge(self, pc: PolyChallenge) -> ProofShare:
        x = pc.x % L
        z, j = self.z, self.j
        zz = z * z % L
        offset_z = pow(z, j, L)
        t_x = self.t_poly.eval(x)
        t_x_blinding = (zz * offset_z % L * self.v_blinding
                        + x * self.t_1_blinding
                        + x * x % L * self.t_2_blinding) % L
        e_blinding = (self.a_blinding + x * self.s_blinding) % L
        return ProofShare(t_x, t_x_blinding, e_blinding,
                          self.l_poly.eval(x), self.r_poly.eval(x))


class Dealer:
    """Aggregates the parties' messages into one proof (upstream
    dealer.rs)."""

    def __init__(
        self,
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: ProofTranscript,
        n: int,
        m: int,
        engine=None,
    ):
        if n not in (8, 16, 32, 64):
            raise MPCError("invalid bitsize")
        if m == 0 or (m & (m - 1)) != 0:
            raise MPCError("invalid aggregation size: m must be a power of 2")
        if bp_gens.gens_capacity < n or bp_gens.party_capacity < m:
            raise MPCError("invalid generators length")
        self.bp_gens = bp_gens
        self.pc_gens = pc_gens
        self.transcript = transcript
        self.n, self.m = n, m
        self.engine = resolve_engine(engine=engine)
        transcript.rangeproof_domain_sep(n, m)

    def _sums(self, *columns) -> list[RistrettoPoint]:
        """The sum of each column of points, one engine call for all."""
        return self.engine.msm_batch([[1] * len(c) for c in columns],
                                     [list(c) for c in columns])

    def receive_bit_commitments(self, bit_commitments: list[BitCommitment]
                                ) -> BitChallenge:
        if len(bit_commitments) != self.m:
            raise MPCError("wrong number of bit commitments")
        self.bit_commitments = bit_commitments
        for bc in bit_commitments:
            self.transcript.append_point(b"V", bc.V_j)
        self.A, self.S = self._sums([bc.A_j for bc in bit_commitments],
                                    [bc.S_j for bc in bit_commitments])
        self.transcript.validate_and_append_point(b"A", self.A.compress())
        self.transcript.validate_and_append_point(b"S", self.S.compress())
        y = self.transcript.challenge_scalar(b"y")
        z = self.transcript.challenge_scalar(b"z")
        self.bit_challenge = BitChallenge(y, z)
        return self.bit_challenge

    def receive_poly_commitments(self, poly_commitments: list[PolyCommitment]
                                 ) -> PolyChallenge:
        if len(poly_commitments) != self.m:
            raise MPCError("wrong number of poly commitments")
        self.poly_commitments = poly_commitments
        self.T_1, self.T_2 = self._sums([pc.T_1_j for pc in poly_commitments],
                                        [pc.T_2_j for pc in poly_commitments])
        self.transcript.validate_and_append_point(b"T_1", self.T_1.compress())
        self.transcript.validate_and_append_point(b"T_2", self.T_2.compress())
        x = self.transcript.challenge_scalar(b"x")
        self.poly_challenge = PolyChallenge(x)
        return self.poly_challenge

    def _assemble(self, proof_shares: list[ProofShare],
                  timings: dict | None = None):
        """Combine the shares and run the inner-product argument."""
        from .rangeproof import RangeProof

        n, m = self.n, self.m
        t_x = sum(ps.t_x for ps in proof_shares) % L
        t_x_blinding = sum(ps.t_x_blinding for ps in proof_shares) % L
        e_blinding = sum(ps.e_blinding for ps in proof_shares) % L
        self.transcript.append_scalar(b"t_x", t_x)
        self.transcript.append_scalar(b"t_x_blinding", t_x_blinding)
        self.transcript.append_scalar(b"e_blinding", e_blinding)
        w = self.transcript.challenge_scalar(b"w")
        Q = self.engine.basepoint_mul(w, ct=False)

        l_vec: list[int] = []
        r_vec: list[int] = []
        for ps in proof_shares:
            l_vec.extend(ps.l_vec)
            r_vec.extend(ps.r_vec)
        ipp = InnerProductProof.create(
            self.transcript, Q, [1] * (n * m),
            powers(scalar.invert(self.bit_challenge.y), n * m),
            self.bp_gens.G(n, m), self.bp_gens.H(n, m), l_vec, r_vec,
            engine=self.engine, timings=timings)
        return RangeProof(
            A=self.A.compress(), S=self.S.compress(),
            T_1=self.T_1.compress(), T_2=self.T_2.compress(),
            t_x=t_x, t_x_blinding=t_x_blinding, e_blinding=e_blinding,
            ipp_proof=ipp)

    def receive_trusted_shares(self, proof_shares: list[ProofShare],
                               timings: dict | None = None):
        """Assemble without auditing the shares (every party is local)."""
        if len(proof_shares) != self.m:
            raise MPCError("wrong number of proof shares")
        return self._assemble(proof_shares, timings)

    def receive_shares(self, proof_shares: list[ProofShare]):
        """Audit every share, naming the parties whose shares fail
        (upstream receive_shares with ProofShareVerifier); every share's
        four sums in one engine call."""
        if len(proof_shares) != self.m:
            raise MPCError("wrong number of proof shares")
        scalars, points = [], []
        for j, ps in enumerate(proof_shares):
            s, p = self._audit_groups(j, ps)
            scalars += s
            points += p
        sums = self.engine.msm_batch(scalars, points)
        bad = [j for j in range(self.m)
               if not (sums[4 * j] == sums[4 * j + 1]
                       and sums[4 * j + 2] == sums[4 * j + 3])]
        if bad:
            raise MPCError("malformed proof shares", bad_shares=bad)
        return self._assemble(proof_shares)

    def _audit_groups(self, j: int, ps: ProofShare):
        """Share j's check against its own commitments (upstream
        audit_share), as four MSM groups (scalars, points), the two sides
        of each of:
          t_x B + t_x_blinding B~ == z^2 z^j V_j + delta_j B + x T_1 + x^2 T_2
          A_j + x S_j == e_blinding B~ + <l + z, G_j> + <y^-i (r - z^2 z^j
                         2^i) - z, H_j>"""
        n = self.n
        y, z = self.bit_challenge.y, self.bit_challenge.z
        x = self.poly_challenge.x
        zz = z * z % L
        offset_z = pow(z, j, L)
        offset_y = pow(y, j * n, L)
        bc = self.bit_commitments[j]
        pc = self.poly_commitments[j]
        V_j = RistrettoPoint.decompress(bc.V_j)
        pcg = self.pc_gens

        sum_y = offset_y * scalar.sum_of_powers(y, n) % L
        sum_2 = scalar.sum_of_powers(2, n)
        delta_j = ((z - zz) % L * sum_y
                   - offset_z * zz % L * z % L * sum_2) % L
        gens = self.bp_gens.share(j)
        y_inv = scalar.invert(y)
        yinv_pows = [pow(y_inv, j * n + i, L) for i in range(n)]
        g_scalars = [(li + z) % L for li in ps.l_vec]
        h_scalars = [(yi * ((ri - zz * offset_z % L * e2) % L) - z) % L
                     for yi, ri, e2 in zip(yinv_pows, ps.r_vec, powers(2, n))]
        return ([[ps.t_x, ps.t_x_blinding],
                 [zz * offset_z % L, delta_j, x, x * x % L],
                 [1, x],
                 [ps.e_blinding] + g_scalars + h_scalars],
                [[pcg.B, pcg.B_blinding],
                 [V_j, pcg.B, pc.T_1_j, pc.T_2_j],
                 [bc.A_j, bc.S_j],
                 [pcg.B_blinding] + gens.G(n) + gens.H(n)])
