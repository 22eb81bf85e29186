"""R1CS prover (upstream bulletproofs/src/r1cs/prover.rs).

Protocol (the JAX package's proofs/r1cs/prover.py):

  phase 1: commit A_I1 = ĩ1·B~ + <a_L1,G> + <a_R1,H>, A_O1, S1
  randomized phase: gadget callbacks draw transcript challenges and may
    allocate more multipliers (phase 2), committed as A_I2, A_O2, S2
  u: phase-separation challenge — verification weights phase-2 commitments
    and generators by u so phases cannot cancel each other
  y, z: flatten constraints into wL,wR,wO,wV,wc with z^{q+1} weights
  l(X) = (a_L + y^-n ∘ wR)·X + a_O·X² + s_L·X³
  r(X) = (wO - y^n) + (y^n ∘ a_R + wL)·X + (y^n ∘ s_R)·X³
  t(X) = <l,r>: t2 carries the statement (t2 = δ + wc + <wV,v>,
    δ = <y^-n ∘ wR, wL>); commit T_1,T_3..T_6
  x: evaluate l,r; t_x, blindings; w: Q = w·B; run the IPP over
    G_factors = (1...1, u...u), H_factors = y^-i * G_factors.

Every group operation runs on the engine (the card's TorchEngine unless
the caller passes another): each V is engine.commit at its `commit`
(appended to the transcript there, so it is one round trip each); each
phase's A_I, A_O and S are one msm_batch; T_1, T_3..T_6 one commit_batch;
Q is basepoint_mul; the argument is engine.ipp_create.  The vector
algebra runs on the native ScalarVec (`polynomials`, `evaluate`), as the
reference's native branch does; `polynomials_plain`, the reference's
VecPoly3 chain, is its twin, which only the tests and chip_smoke.py run.
"""

from __future__ import annotations

import os
import time

from ...constants import L
from ...oracle import scalar
from ..engine import Engine, resolve_engine
from ..errors import R1CSError
from ..generators import BulletproofGens, PedersenGens
from ..scalarvec import ScalarVec
from ..transcript import ProofTranscript
from ..util import Poly6, VecPoly3, add_time, next_power_of_two, powers
from .constraint_system import Metrics, flatten_constraints_vec
from .lc import LinearCombination, Variable, _as_lc
from .proof import R1CSProof

IDENTITY = b"\x00" * 32


def polynomials(a_L, a_R, a_O, s_L, s_R, wL, wR, wO, exp_y, exp_y_inv):
    """The blinded vector polynomials over ScalarVecs of the padded length
    -> ((l1, l2, l3), (r0, r1, r3), t(X) = <l(X), r(X)> as a Poly6), with
    l = l1 X + l2 X² + l3 X³ and r = r0 + r1 X + r3 X³."""
    l1 = exp_y_inv.muladd(wR, a_L)
    l2, l3 = a_O, s_L
    r0 = wO.sub(exp_y)
    r1 = exp_y.muladd(a_R, wL)
    r3 = exp_y.mul(s_R)
    t = Poly6(0, l1.inner(r0), l1.inner(r1) + l2.inner(r0),
              l2.inner(r1) + l3.inner(r0), l1.inner(r3) + l3.inner(r1),
              l2.inner(r3), l3.inner(r3))
    return (l1, l2, l3), (r0, r1, r3), t


def evaluate(l, r, x: int):
    """polynomials' l and r at x, by Horner's rule -> (l(x), r(x))."""
    l1, l2, l3 = l
    r0, r1, r3 = r
    return (l3.scale(x).add(l2).scale(x).add(l1).scale(x),
            r3.scale(pow(x, 3, L)).add(r1.scale(x)).add(r0))


def polynomials_plain(a_L, a_R, a_O, s_L, s_R, wL, wR, wO, exp_y,
                      exp_y_inv):
    """polynomials' twin on lists of ints: the reference's VecPoly3 chain
    -> (l(X), r(X) as VecPoly3s, t(X))."""
    n = len(a_L)
    l1 = [(a_L[i] + exp_y_inv[i] * wR[i]) % L for i in range(n)]
    r0 = [(wO[i] - exp_y[i]) % L for i in range(n)]
    r1 = [(exp_y[i] * a_R[i] + wL[i]) % L for i in range(n)]
    r3 = [exp_y[i] * s_R[i] % L for i in range(n)]
    l_poly = VecPoly3([0] * n, l1, list(a_O), list(s_L))
    r_poly = VecPoly3(r0, r1, [0] * n, r3)
    return l_poly, r_poly, l_poly.special_inner_product(r_poly)


class Prover:
    """ConstraintSystem implementation holding the witness.

    rng is the witness RNG (a TranscriptRng; None draws each blinding from
    os.urandom, one wide scalar each).  engine runs the group operations
    (None: the default engine, the card, made at its first use).  timings,
    when given, receives wall seconds: commit_v_s (every commit),
    commit_phase_s (A_I, A_O, S of both phases), commit_t_s, q_s,
    ipp_create's keys and prove_s (the prove call)."""

    def __init__(
        self,
        pc_gens: PedersenGens,
        transcript: ProofTranscript,
        rng=None,
        engine: Engine | None = None,
        timings: dict | None = None,
    ):
        self.pc_gens = pc_gens
        self.transcript = transcript
        transcript.r1cs_domain_sep()
        self.v: list[int] = []
        self.v_blinding: list[int] = []
        self.a_L: list[int] = []
        self.a_R: list[int] = []
        self.a_O: list[int] = []
        self.constraints: list[LinearCombination] = []
        self.deferred: list = []
        self.pending_multiplier: int | None = None
        self.num_phase1_multipliers: int | None = None  # set at phase switch
        self._num_phase1_constraints: int | None = None
        self._rng = rng
        self._engine = engine
        self._in_phase2 = False
        self.timings = timings

    @property
    def engine(self) -> Engine:
        if self._engine is None:
            self._engine = resolve_engine()
        return self._engine

    # ------------------------------------------------------------ witness io
    def _random_scalar(self) -> int:
        if self._rng is not None:
            return self._rng.random_scalar()
        return scalar.from_bytes_mod_order_wide(os.urandom(64))

    def _random_scalars(self, n: int) -> ScalarVec:
        """n blinding scalars; with a witness RNG one random_scalar each, in
        sequence, as the reference draws them."""
        if self._rng is not None:
            return ScalarVec.from_ints(
                [self._rng.random_scalar() for _ in range(n)])
        return ScalarVec.from_wide_bytes(os.urandom(64 * n), n)

    def commit(self, v: int, v_blinding: int) -> tuple[bytes, Variable]:
        """Commit a high-level value; returns (compressed V, variable)."""
        t = time.perf_counter()
        j = len(self.v)
        self.v.append(v % L)
        self.v_blinding.append(v_blinding % L)
        V = self.engine.commit(v, v_blinding, self.pc_gens.B,
                               self.pc_gens.B_blinding).compress()
        self.transcript.append_point(b"V", V)
        add_time(self.timings, "commit_v_s", t)
        return V, Variable.committed(j)

    # --------------------------------------------------- ConstraintSystem API
    def eval(self, lc) -> int:
        lc = _as_lc(lc)
        acc = 0
        for var, coeff in lc.terms:
            if var.kind == "ml":
                val = self.a_L[var.index]
            elif var.kind == "mr":
                val = self.a_R[var.index]
            elif var.kind == "mo":
                val = self.a_O[var.index]
            elif var.kind == "v":
                val = self.v[var.index]
            else:
                val = 1
            acc = (acc + coeff * val) % L
        return acc

    def multiply(self, left, right) -> tuple[Variable, Variable, Variable]:
        left = _as_lc(left)
        right = _as_lc(right)
        l = self.eval(left)
        r = self.eval(right)
        i = len(self.a_L)
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(l * r % L)
        vl = Variable.multiplier_left(i)
        vr = Variable.multiplier_right(i)
        vo = Variable.multiplier_output(i)
        # bind the LC values to the multiplier wires
        self.constrain(left - vl)
        self.constrain(right - vr)
        return vl, vr, vo

    def allocate(self, assignment: int | None) -> Variable:
        if assignment is None:
            raise R1CSError("prover allocation requires an assignment")
        x = int(assignment) % L
        if self.pending_multiplier is None:
            i = len(self.a_L)
            self.pending_multiplier = i
            self.a_L.append(x)
            self.a_R.append(0)
            self.a_O.append(0)
            return Variable.multiplier_left(i)
        i = self.pending_multiplier
        self.pending_multiplier = None
        self.a_R[i] = x
        self.a_O[i] = self.a_L[i] * x % L
        return Variable.multiplier_right(i)

    def allocate_multiplier(
        self, assignment: tuple[int, int] | None
    ) -> tuple[Variable, Variable, Variable]:
        if assignment is None:
            raise R1CSError("prover allocation requires an assignment")
        l, r = (int(a) % L for a in assignment)
        i = len(self.a_L)
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(l * r % L)
        return (
            Variable.multiplier_left(i),
            Variable.multiplier_right(i),
            Variable.multiplier_output(i),
        )

    def constrain(self, lc):
        # no eager simplify: flatten_constraints merges duplicate terms
        self.constraints.append(_as_lc(lc))

    def specify_randomized_constraints(self, closure):
        """Defer a gadget closure to the randomizing (challenge) phase
        (upstream RandomizedConstraintSystem)."""
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
            multipliers=len(self.a_L),
            constraints=len(self.constraints),
            phase_one_constraints=p1,
            phase_two_constraints=len(self.constraints) - p1,
        )

    # ------------------------------------------------------------------ prove
    def _phase_commitments(self, lo: int, hi: int, G, H, blindings, s_L,
                           s_R) -> list[bytes]:
        """A_I, A_O and S of the multipliers [lo, hi), one msm_batch."""
        t = time.perf_counter()
        i_b, o_b, s_b = blindings
        B_b = self.pc_gens.B_blinding
        G, H = G[lo:hi], H[lo:hi]
        outs = self.engine.msm_batch(
            [[i_b] + self.a_L[lo:hi] + self.a_R[lo:hi],
             [o_b] + self.a_O[lo:hi],
             ScalarVec.concat(ScalarVec.from_ints([s_b]), s_L, s_R)],
            [[B_b] + G + H, [B_b] + G, [B_b] + G + H], ct=True)
        add_time(self.timings, "commit_phase_s", t)
        return [p.compress() for p in outs]

    def prove(self, bp_gens: BulletproofGens) -> R1CSProof:
        t0 = time.perf_counter()
        eng = self.engine
        ts = self.transcript

        ts.append_u64(b"m", len(self.v))

        # --- phase 1 commitments
        n1 = len(self.a_L)
        if bp_gens.gens_capacity < n1:
            raise R1CSError("invalid generators length")
        gens = bp_gens.share(0)

        blindings1 = [self._random_scalar() for _ in range(3)]  # i, o, s
        s_L1 = self._random_scalars(n1)
        s_R1 = self._random_scalars(n1)
        A_I1, A_O1, S1 = self._phase_commitments(
            0, n1, gens.G(n1), gens.H(n1), blindings1, s_L1, s_R1)
        ts.append_point(b"A_I1", A_I1)
        ts.append_point(b"A_O1", A_O1)
        ts.append_point(b"S1", S1)

        # --- randomized phase
        self.num_phase1_multipliers = n1
        self._num_phase1_constraints = len(self.constraints)
        if not self.deferred:
            ts.r1cs_1phase_domain_sep()
        else:
            ts.r1cs_2phase_domain_sep()
            self._in_phase2 = True
            deferred, self.deferred = self.deferred, []
            for closure in deferred:
                closure(self)
        # a half-allocated multiplier keeps its zero right wire
        self.pending_multiplier = None

        # --- phase 2 commitments
        n = len(self.a_L)
        n2 = n - n1
        if bp_gens.gens_capacity < n:
            raise R1CSError("invalid generators length")
        if n2 > 0:
            blindings2 = [self._random_scalar() for _ in range(3)]
            s_L2 = self._random_scalars(n2)
            s_R2 = self._random_scalars(n2)
            A_I2, A_O2, S2 = self._phase_commitments(
                n1, n, gens.G(n), gens.H(n), blindings2, s_L2, s_R2)
        else:
            blindings2 = [0, 0, 0]
            s_L2 = s_R2 = ScalarVec(b"", 0)
            A_I2 = A_O2 = S2 = IDENTITY
        ts.append_point(b"A_I2", A_I2)
        ts.append_point(b"A_O2", A_O2)
        ts.append_point(b"S2", S2)

        u = ts.challenge_scalar(b"u")
        y = ts.challenge_scalar(b"y")
        z = ts.challenge_scalar(b"z")

        # --- flatten constraints & build l/r polynomials
        padded_n = next_power_of_two(n)
        pad = padded_n - n
        wL, wR, wO, wV, _ = flatten_constraints_vec(
            self.constraints, z, n, len(self.v), pad)
        zpad = b"\x00" * (32 * pad)
        a_L, a_R, a_O = (ScalarVec.from_ints(w + [0] * pad)
                         for w in (self.a_L, self.a_R, self.a_O))
        s_L = ScalarVec(s_L1.buf + s_L2.buf + zpad, padded_n)
        s_R = ScalarVec(s_R1.buf + s_R2.buf + zpad, padded_n)
        exp_y_inv = ScalarVec.powers(scalar.invert(y), padded_n)
        l, r, t_poly = polynomials(a_L, a_R, a_O, s_L, s_R, wL, wR, wO,
                                   ScalarVec.powers(y, padded_n), exp_y_inv)

        t = time.perf_counter()
        t_blind = {i: self._random_scalar() for i in (1, 3, 4, 5, 6)}
        T = dict(zip(t_blind, (p.compress() for p in eng.commit_batch(
            [t_poly.t[i] for i in t_blind], list(t_blind.values()),
            self.pc_gens.B, self.pc_gens.B_blinding))))
        add_time(self.timings, "commit_t_s", t)
        for i in (1, 3, 4, 5, 6):
            ts.append_point(f"T_{i}".encode(), T[i])

        x = ts.challenge_scalar(b"x")

        # t2 blinding comes from the committed values: <wV, v_blinding>
        t_2_blinding = scalar.inner_product(wV, self.v_blinding)
        t_x = t_poly.eval(x)
        blinds = [0, t_blind[1], t_2_blinding, t_blind[3], t_blind[4],
                  t_blind[5], t_blind[6]]
        t_x_blinding = sum(b * xx for b, xx in zip(blinds, powers(x, 7))) % L
        i_b, o_b, s_b = ((b1 + u * b2) % L
                         for b1, b2 in zip(blindings1, blindings2))
        e_blinding = (x * i_b + x * x % L * o_b + pow(x, 3, L) * s_b) % L

        ts.append_scalar(b"t_x", t_x)
        ts.append_scalar(b"t_x_blinding", t_x_blinding)
        ts.append_scalar(b"e_blinding", e_blinding)

        w = ts.challenge_scalar(b"w")
        t = time.perf_counter()
        Q = eng.basepoint_mul(w, ct=False)       # w is public
        add_time(self.timings, "q_s", t)

        G_factors = ScalarVec((1).to_bytes(32, "little") * n1
                              + (u % L).to_bytes(32, "little") * (n2 + pad),
                              padded_n)
        H_factors = G_factors.mul(exp_y_inv)
        l_vec, r_vec = evaluate(l, r, x)

        if bp_gens.gens_capacity < padded_n:
            raise R1CSError("invalid generators length (padding)")
        ipp = eng.ipp_create(ts, Q, G_factors, H_factors, gens.G(padded_n),
                             gens.H(padded_n), l_vec, r_vec,
                             timings=self.timings)
        add_time(self.timings, "prove_s", t0)
        return R1CSProof(
            A_I1, A_O1, S1, A_I2, A_O2, S2,
            T[1], T[3], T[4], T[5], T[6],
            t_x, t_x_blinding, e_blinding, ipp,
        )
