"""The inner-product argument's CREATE with its vectors resident on the
device.

Counterpart of the JAX package's kernels/ipp_device.py (_ipp_round,
device_ipp_create), itself a redesign of upstream
inner_product_proof.rs InnerProductProof::create, which folds G and H in
half every round (a double-scalar multiplication a point).  Here no point
is ever folded:

  * G ++ H ++ Q stay on the device in their original index order, as the
    port's point limbs (4, 10, 2n + 1), converted once.  A folded point
    G^(k)[j] is a combination of original points, so each round's L and R
    are MSMs over the original points with coefficients in original index
    space: coef_i = gcoef_i · a-value · mask_i, where gcoef_i = G_factors_i
    · Π_r u_r^(±1) gathers the fold challenges (the verifier's s-vector).
    Half of each round's 2n + 1 coefficients are zero by the mask.
  * a, b and the accumulated G and H coefficients live as mod-ℓ limbs
    (10, n) int64 (kernels/scalarmod.py) in replicated form: after the
    round that folds bit k, a[i] == a[i ^ 2^k], and the current vector of
    length n_k is a[0 .. n_k).  One round step serves every round.
  * A round: fold with the previous challenge, build the masked L and R
    coefficients, recode them (scalarmod.signed_digits, which reduces to
    the canonical scalar first), run msm.window_totals for both, fold both
    with one K4 horner_fold launch and fetch the two points.  The host
    compresses them (native), appends them to the transcript, draws u,
    inverts it (native) and uploads u and u^-1.
  * The last fold (the round with no L or R) runs on the host.

The reference computes the round's scalar step with XLA, not Pallas, so
here it is plain torch ops on the device; the MSMs and the fold run the
port's kernels (K5s and K3 up to 2,048 points, K2 and K3 above, K4).
The port has no ipp_device_min_n: the JAX engine's 4,096 threshold
weighs a ~24 ms TPU round trip, which does not hold on the card.

Proof bytes equal InnerProductProof.create_plain's on the same transcript
(tests/test_torch_prove.py, chip_smoke.py's prove phase).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..constants import L
from ..oracle import scalar
from ..oracle.ristretto import compress_batch
from ..proofs.ipp import InnerProductProof
from ..proofs.util import add_time
from . import scalarmod as sm
from .combine import horner_fold
from .engine import _point_words
from .msm import best_wbits, window_totals
from .words import points_to_ints, to_device, words_to_points


def _ints(v) -> list[int]:
    return [int(x) % L for x in (v.to_ints() if hasattr(v, "to_ints") else v)]


def fold(state, u, fold_bit: int, iota):
    """Fold (a, b, gcoef, hcoef) with the challenge u = (10, 2) limbs of
    [u, u^-1] across index bit fold_bit: a' = a_lo u + a_hi u^-1, b' = b_lo
    u^-1 + b_hi u (replicated over the bit), and each original index's G
    coefficient times u where the bit is set (G_R) and u^-1 where it is
    clear, H's the other way round.  One mul_lm and one add_lm over the
    six products side by side."""
    a, b, gcoef, hcoef = state
    n = iota.shape[0]
    u, u_inv = u[:, :1].expand(-1, n), u[:, 1:].expand(-1, n)
    lo = iota - (iota & fold_bit)
    hi = iota | fold_bit
    upper = (iota & fold_bit) != 0
    prods = sm.mul_lm(
        torch.cat([a[:, lo], b[:, lo], a[:, hi], b[:, hi], gcoef, hcoef], 1),
        torch.cat([u, u_inv, u_inv, u, torch.where(upper, u, u_inv),
                   torch.where(upper, u_inv, u)], 1))
    ab = sm.add_lm(prods[:, :2 * n], prods[:, 2 * n:4 * n])
    return ab[:, :n], ab[:, n:], prods[:, 4 * n:5 * n], prods[:, 5 * n:]


def coefficients(state, bit: int, iota):
    """This round's L and R scalars over G ++ H ++ Q, (10, 2n + 1) each:
    L = <a_L, G_R> + <b_R, H_L> + c_L Q, R = <a_R, G_L> + <b_L, H_R> + c_R Q,
    with c_L = <a_L, b_R>, c_R = <a_R, b_L> over the current halves.  One
    mul_lm over the six products side by side."""
    a, b, gcoef, hcoef = state
    n = iota.shape[0]
    lo = iota - (iota & bit)
    hi = iota | bit
    upper = (iota & bit) != 0
    a_hi, b_hi = a[:, hi], b[:, hi]
    g_alo, h_bhi, g_ahi, h_blo, c_l, c_r = sm.mul_lm(
        torch.cat([gcoef, hcoef, gcoef, hcoef, a, a_hi], 1),
        torch.cat([a[:, lo], b_hi, a_hi, b[:, lo], b_hi, b], 1)
    ).split(n, 1)
    zero = torch.zeros_like(a)
    c = sm.accumulate_lm(torch.where(iota < bit, torch.stack([c_l, c_r], 1),
                                     zero.unsqueeze(1)), 2)
    return (torch.cat([torch.where(upper, g_alo, zero),
                       torch.where(upper, zero, h_bhi), c[:, :1]], 1),
            torch.cat([torch.where(upper, zero, g_ahi),
                       torch.where(upper, h_blo, zero), c[:, 1:]], 1))


def _event(timings, dev):
    """A recorded CUDA event when timing on a card, else None."""
    if timings is None or dev.type != "cuda":
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def create(engine, transcript, Q, G_factors, H_factors, G, H, a, b,
           timings: dict | None = None, trace: list | None = None
           ) -> InnerProductProof:
    """InnerProductProof.create on engine.device (a TorchEngine's device,
    window width and MSM configuration): the same arguments, transcript
    operations and proof bytes.  timings, when given, receives the rounds
    and, summed over them, ipp_scalar_ms (the scalar step) and ipp_msm_ms
    (recode, MSMs and K4), device time between CUDA events on a card, and
    wall seconds: ipp_round_s, split into ipp_issue_s (the host issuing the
    round's device work), ipp_wait_s (until that work ends; on a card the
    round synchronises here when timed), ipp_fetch_s (points_to_ints) and
    ipp_host_s (compress, transcript, invert, upload); and ipp_s.  trace, when given, receives each
    round's (a, b, gcoef, hcoef, coef_L, coef_R) limbs."""
    t_all = time.perf_counter()
    n = len(G)
    if not (n == len(H) == len(a) == len(b) == len(G_factors)
            == len(H_factors)) or n & (n - 1) or n == 0:
        raise ValueError("the argument takes equal lengths, a power of two")
    transcript.innerproduct_domain_sep(n)
    if n == 1:
        return InnerProductProof([], [], _ints(a)[0], _ints(b)[0])
    dev = engine.device
    words = np.stack([_point_words(p) for p in list(G) + list(H) + [Q]])
    points = words_to_points(to_device(
        np.ascontiguousarray(words.transpose(1, 2, 0)), dev))
    state = tuple(sm.ints_to_limbs(_ints(v), dev)
                  for v in (a, b, G_factors, H_factors))
    iota = torch.arange(n, device=dev)
    wbits = engine.wbits or best_wbits(2 * n + 1)

    L_vec, R_vec = [], []
    u = None
    fold_bit, bit = 0, n // 2
    while bit >= 1:
        t_round = time.perf_counter()
        e0 = _event(timings, dev)
        if fold_bit:
            state = fold(state, u, fold_bit, iota)
        coefs = coefficients(state, bit, iota)
        e1 = _event(timings, dev)
        digits = sm.signed_digits(torch.cat(coefs, 1), wbits)
        totals = torch.stack([window_totals(points, d, wbits, engine.config)
                              for d in digits.split(2 * n + 1)], 2)
        folded = horner_fold(totals.contiguous(), wbits)
        e2 = _event(timings, dev)
        t_wait = time.perf_counter()
        if e2 is not None:
            e2.synchronize()
        t_fetch = time.perf_counter()
        if trace is not None:
            trace.append(state + coefs)
        Lp, Rp = points_to_ints(folded)                 # the round's fetch
        t_host = time.perf_counter()
        Lb, Rb = compress_batch([Lp, Rp])
        L_vec.append(Lb)
        R_vec.append(Rb)
        transcript.append_point(b"L", Lb)
        transcript.append_point(b"R", Rb)
        x = transcript.challenge_scalar(b"u")
        u = sm.ints_to_limbs([x, scalar.invert(x)], dev)
        fold_bit, bit = bit, bit // 2
        if timings is not None:
            for key, t0, t1 in (("ipp_issue_s", t_round, t_wait),
                                ("ipp_wait_s", t_wait, t_fetch),
                                ("ipp_fetch_s", t_fetch, t_host)):
                timings[key] = timings.get(key, 0.0) + t1 - t0
            add_time(timings, "ipp_host_s", t_host)
            add_time(timings, "ipp_round_s", t_round)
            timings["rounds"] = timings.get("rounds", 0) + 1
            if e0 is not None:
                timings["ipp_scalar_ms"] = (timings.get("ipp_scalar_ms", 0.0)
                                            + e0.elapsed_time(e1))
                timings["ipp_msm_ms"] = (timings.get("ipp_msm_ms", 0.0)
                                         + e1.elapsed_time(e2))

    # the last fold, on the host
    a0, a1, b0, b1 = sm.limbs_to_ints(torch.cat([state[0][:, :2],
                                                 state[1][:, :2]], 1))
    x, x_inv = sm.limbs_to_ints(u)
    add_time(timings, "ipp_s", t_all)
    return InnerProductProof(L_vec, R_vec, (a0 * x + x_inv * a1) % L,
                             (b0 * x_inv + x * b1) % L)
