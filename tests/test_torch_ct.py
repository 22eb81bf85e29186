"""The constant-time routes for secret scalars: K17 fixed_base_ct and K18
msm_ct (kernels/fixed_base.py, kernels/msm_ct.py), through
TorchEngine("cpu"), whose wrappers run the kernels' plain versions.

Item 1 holds basepoint_mul, commit, commit_batch (K17; one output with
one base and with two, and a batch through fixed_base_ct), msm_secret,
msm_batch(ct=True) and bit_commit_batch (K18, then K4 at w = 4) against
the JAX package's native constant-time functions (ed_fixed_mul,
ed_fixed_commit_batch, ed_msm with ct, ed_bit_commit) and against the
port's oracle, as Ristretto points, on seeded scalars with the edge values
0, 1, ℓ - 1 and scalars below 2^64, and on groups of 0, 1, 2, 3, 17 and 8
points (the slot step, 8, divides only the last) and a 1- and 2-point
msm_secret; then shows that the torch operations the twins dispatch
(recorded with a TorchDispatchMode, each one's name and its tensors'
shapes) are the same sequence for all-zero scalars as for random ones.

Item 2 proves a range proof (n = 8, m = 2) and an R1CS circuit (one
committed value under an 8-bit range gadget) with every call on secret
scalars on TorchEngine("cpu")'s K17 and K18 routes, while msm's window
totals and torch.sort raise: byte for byte the JAX prover's on the same
seeded witness RNG.  The public calls of those proves (the dealer's sums,
the argument) take the JAX package's native MSM, which keeps the test
inside its time budget; they are held to the card's routes elsewhere
(tests/test_torch_prove.py, tests/test_torch_r1cs_prove.py).
"""

import random

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_r1cs_prove import _jax_rng, _lay
from zkvm_tpu import native as jnative
from zkvm_tpu.proofs.generators import BulletproofGens as JBulletproofGens
from zkvm_tpu.proofs.generators import PedersenGens as JPedersenGens
from zkvm_tpu.proofs.r1cs import Prover as JProver
from zkvm_tpu.proofs.rangeproof import RangeProof as JRangeProof
from zkvm_tpu.proofs.transcript import ProofTranscript as JProofTranscript
from zkvm_tpu_torch import fixture
from zkvm_tpu_torch.constants import L
from zkvm_tpu_torch.kernels import engine as engine_mod
from zkvm_tpu_torch.kernels import fixed_base, msm, msm_ct
from zkvm_tpu_torch.kernels import scalarmod as sm
from zkvm_tpu_torch.kernels.engine import TorchEngine
from zkvm_tpu_torch.kernels.words import (points_to_ints, points_words, to_device,
                                          words_to_points)
from zkvm_tpu_torch.oracle import edwards
from zkvm_tpu_torch.oracle.ristretto import BASEPOINT, RistrettoPoint
from zkvm_tpu_torch.proofs.engine import Engine
from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
from zkvm_tpu_torch.proofs.r1cs import Prover
from zkvm_tpu_torch.proofs.rangeproof import RangeProof
from zkvm_tpu_torch.proofs.transcript import ProofTranscript

# the suite runs in several worker processes and these tensors are small:
# intra-op threads would only contend with the other workers
torch.set_num_threads(1)

EDGES = [0, 1, L - 1, (1 << 64) - 1, 12345]


def _enc(ep) -> bytes:
    """An extended point of either package -> its Ristretto encoding."""
    return RistrettoPoint(tuple(int(c) for c in ep)).compress()


def _oracle_msm(scalars, points) -> bytes:
    acc = edwards.IDENTITY
    for k, p in zip(scalars, points, strict=True):
        acc = edwards.add(acc, edwards.scalar_mul(k % L, p.ep))
    return RistrettoPoint(acc).compress()


class _Ops(TorchDispatchMode):
    """Records every dispatched torch operation: its name and the shapes
    of its tensor arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((func, tuple(a.shape for a in args
                                     if isinstance(a, torch.Tensor))))
        return func(*args, **(kwargs or {}))


def test_ct_twins_equal_the_reference_native_and_a_fixed_schedule():
    eng, pc = TorchEngine("cpu"), PedersenGens()
    r = random.Random(16)
    gens = BulletproofGens(17, 1)
    G, H = gens.G(17, 1), gens.H(17, 1)

    # K17: basepoint_mul and commit_batch (one launch over both tables)
    values = EDGES + [r.randrange(L)]
    blindings = [r.randrange(L) for _ in values[:-1]] + [0]
    slot_b, slot_bb = (jnative.ed_fixed_slot(p.ep) for p in
                       (JPedersenGens().B, JPedersenGens().B_blinding))
    got = [p.compress() for p in eng.commit_batch(values, blindings, pc.B,
                                                   pc.B_blinding)]
    assert got == [_enc(ep) for ep in jnative.ed_fixed_commit_batch(
        slot_b, slot_bb, values, blindings)]
    assert got[-1] == (BASEPOINT * values[-1]).compress()
    for k in (0, L - 1, (1 << 64) - 1):
        assert (eng.basepoint_mul(k).compress()
                == _enc(jnative.ed_fixed_mul(slot_b, k, True)))
    assert (eng.basepoint_mul(values[-1], ct=False).compress()
            == got[-1])
    # one output with two bases (an R1CS V), and the batch in one call
    v, b = values[-2], blindings[-2]
    assert (eng.commit(v, b, pc.B, pc.B_blinding).compress() == got[-2]
            == pc.commit(v, b).compress())
    words = eng.scalar_words(values + blindings)
    n = len(values)
    wv, wb = words[:, :n].contiguous(), words[:, n:].contiguous()
    tab_b, tab_bb = eng.fixed_table(pc.B), eng.fixed_table(pc.B_blinding)
    out = fixed_base.fixed_base_ct(tab_b, wv, tab_bb, wb)
    assert [_enc(ep) for ep in points_to_ints(out)] == got

    # K18 then K4: groups of 0, 1, 2, 3, 17 and 8 points (the last a whole
    # number of slot steps), edge scalars in each
    pts = G + H
    groups, points, at = [], [], 0
    for n in (0, 1, 2, 3, 17, 8):
        groups.append([EDGES[(at + i) % len(EDGES)] if i % 2 == 0
                       else r.randrange(L) for i in range(n)])
        points.append(pts[at:at + n])
        at += n
    got = [p.compress() for p in eng.msm_batch(groups, points, ct=True)]
    assert got[0] == bytes(32)
    for g, s, p in zip(got[1:], groups[1:], points[1:]):
        assert g == _enc(jnative.ed_msm(s, [q.ep for q in p], ct=True))
    assert got[1:4] == [_oracle_msm(s, p) for s, p in zip(groups[1:4],
                                                          points[1:4])]
    # a 1- and a 2-point msm_secret
    assert [eng.msm_secret(groups[i], points[i]).compress()
            for i in (1, 2)] == got[1:3]

    # K18: the range proof's A commitment, a_R = a_L - 1
    bits = [r.randrange(2) for _ in range(8)]
    blind = r.randrange(L)
    got = eng.bit_commit_batch([(blind, bits, pc.B_blinding, G[:8], H[:8])])
    assert got[0].compress() == _enc(jnative.ed_bit_commit(
        blind, JPedersenGens().B_blinding.ep, bits, [g.ep for g in G[:8]],
        [h.ep for h in H[:8]]))

    # the kernels' recode is the MSM's signed recode at w = 4
    ks = EDGES + [r.randrange(L) for _ in range(4)]
    words = eng.scalar_words(ks)
    assert torch.equal(fixed_base.radix16_plain(words), sm.signed_digits(
        sm.decode_words_first(words), fixed_base.WBITS))

    # the twins' schedule: the same operations on the same shapes for
    # all-zero scalars as for random ones (K17: one output of one base,
    # two outputs of two; K18: a group of one point and one of two)
    pt = words_to_points(to_device(points_words([G[0].ep, G[1].ep, H[0].ep]),
                                   "cpu"))

    def schedule(k):
        with _Ops() as rec:
            words = eng.scalar_words([k, k, k])
            fixed_base.fixed_base_ct(tab_b, words[:, :1].contiguous())
            fixed_base.fixed_base_ct(tab_b, words[:, :2].contiguous(), tab_bb,
                                     words[:, 1:].contiguous())
            msm_ct.msm_ct(pt, words, [1, 2])
        return rec.ops

    zero = schedule(0)
    assert len(zero) > 10_000
    assert zero == schedule(r.randrange(L))


class _RefEngine(Engine):
    """The JAX package's native MSM as the test's group oracle."""

    def msm(self, scalars, points):
        points = list(points)
        if not points:
            return RistrettoPoint(edwards.IDENTITY)
        ks = scalars.to_ints() if hasattr(scalars, "to_ints") else scalars
        return RistrettoPoint(tuple(jnative.ed_msm(
            [int(k) % L for k in ks], [p.ep for p in points])))


# what no call on secret scalars may reach
BUCKET_ROUTE = ((msm, "window_totals"), (msm, "window_totals_small"),
                (msm, "window_totals_large"), (engine_mod, "window_totals"),
                (torch, "sort"))


def _bucket_route_reached(*args, **kwargs):
    raise AssertionError("a call on secret scalars reached the bucket route "
                         "or torch.sort")


class _CtRoutes(TorchEngine):
    """TorchEngine("cpu") for every call on secret scalars, each with
    BUCKET_ROUTE raising; the public calls on _RefEngine."""

    def __init__(self):
        super().__init__("cpu")
        self.ref = _RefEngine()
        self.secret_calls = []

    def _secret(self, name, *args, **kwargs):
        self.secret_calls.append(name)
        with pytest.MonkeyPatch.context() as mp:
            for owner, attr in BUCKET_ROUTE:
                mp.setattr(owner, attr, _bucket_route_reached)
            return getattr(TorchEngine, name)(self, *args, **kwargs)

    def msm(self, scalars, points):
        return self.ref.msm(scalars, points)

    def msm_batch(self, scalars_groups, points_groups, ct=False):
        if not ct:
            return self.ref.msm_batch(scalars_groups, points_groups)
        return self._secret("msm_batch", scalars_groups, points_groups,
                            ct=True)

    def basepoint_mul(self, scalar, ct=True):
        return self._secret("basepoint_mul", scalar, ct)

    def commit_batch(self, values, blindings, B, B_blinding):
        return self._secret("commit_batch", values, blindings, B, B_blinding)

    def ipp_create(self, *args, **kwargs):
        return self.ref.ipp_create(*args, **kwargs)


def test_small_proves_on_the_ct_routes_equal_the_jax_prover():
    eng, pc, jpc = _CtRoutes(), PedersenGens(), JPedersenGens()
    r = random.Random(17)
    values = [0, 200]
    blindings = [r.randrange(L) for _ in values]
    proof, vcs = RangeProof.prove_multiple(
        BulletproofGens(8, 2), pc, ProofTranscript(b"ct-range"), values,
        blindings, 8, rng=fixture.witness_rng(b"ct"), engine=eng)
    jproof, jvcs = JRangeProof.prove_multiple(
        JBulletproofGens(8, 2), jpc, JProofTranscript(b"ct-range"), values,
        blindings, 8, rng=_jax_rng(b"ct"))
    assert proof.to_bytes() == jproof.to_bytes() and vcs == jvcs
    # V, S (msm_batch), A (bit_commit_batch's msm_batch), T, Q
    assert eng.secret_calls == ["commit_batch", "msm_batch", "msm_batch",
                                "commit_batch", "basepoint_mul"]

    eng.secret_calls.clear()
    prover = Prover(pc, ProofTranscript(b"ct-r1cs"),
                    rng=fixture.witness_rng(b"r1cs"), engine=eng)
    jprover = JProver(jpc, JProofTranscript(b"ct-r1cs"),
                      rng=_jax_rng(b"r1cs"))
    value = (77, r.randrange(L))
    _lay(prover, "range", value)
    _lay(jprover, "range", value, jax=True)
    assert (prover.prove(BulletproofGens(8)).to_bytes()
            == jprover.prove(JBulletproofGens(8)).to_bytes())
    # V (commit), the phase's A_I, A_O and S, T, Q
    assert eng.secret_calls == ["commit_batch", "msm_batch",
                                "commit_batch", "basepoint_mul"]
