"""Batched range-proof verification and the R1CS split mega-check on the
card.

Counterpart of the JAX package's kernels/batch_verify_device.py.  The host
half (prepare_batch_inputs) replays every proof's transcript in one call
of the native library (strobe.cpp rangeproof_replay_batch), hashes the
per-proof weights and assembles the compact params of the whole batch in
another (scalarvec.cpp fused_params_assembly: one batched inversion, the
per-proof products); prepare_batch_inputs_plain is its pure-Python twin.
The device half (batch_msm_check) is one chain on the card:

  synthesis    _synthesize_lm: every MSM scalar from the packed challenges
               (mod-ℓ tensor ops, kernels/scalarmod.py)
  recode       signed radix-2^w digits
  decode       K1 ristretto_decode of the proofs' raw point encodings
  MSM          window_totals: sort, K2 bucket_accumulate, K3 bucket_fold
  combine      K4 horner_check: Horner fold and identity test

and the verdict is (every encoding decoded) AND (the MSM is the identity).
Point order: [B_blinding, B] + G(n, m) + H(n, m) + per proof A, S, T1, T2,
L.., R.., V..; the scalar rows match.

The R1CS verifier (proofs/r1cs/verifier.py) computes every scalar on the
host; its device half (split_msm_check) is decode, recode, window_totals
and K4 over the same resident generator columns.
"""

from __future__ import annotations

import functools
import hashlib
import time
import weakref

import numpy as np
import torch

from .. import native
from ..constants import L, LABEL_IPP, LABEL_RANGEPROOF
from ..oracle import scalar
from ..proofs.errors import FormatError, ProofError
from ..proofs.rangeproof import IDENTITY_ERROR, batch_weight
from ..proofs.rangeproof import delta as delta_fn
from . import scalarmod as sm
from .combine import horner_check
from .decompress import ristretto_decode
from .msm import MsmConfig, best_wbits, route, window_totals
from .words import (encoding_words, points_words, scalar_words, to_device,
                    words_to_ints, words_to_points)

# COMPACT param layout, (nb, 9 + lg, 8) u32 — identical to the JAX
# package's:  [0] wt  [1] z  [2] y_inv  [3] allinv  [4] a  [5] b  [6] x
#             [7] cx (c·x)  [8] czz (c·z²)  [9..9+lg) u_sq
N_COMPACT = 9


@functools.lru_cache(maxsize=None)
def _limb_constants(n: int, nm: int, device: torch.device):
    """(1 as (10, 1, 1) limbs, the concat_z_and_2 column: (10, nm, 1) limbs
    of 2^(i mod n)) on `device`, uploaded once (an upload syncs)."""
    one = sm.ints_to_limbs([1], device).view(sm.NL, 1, 1)
    pow2 = sm.ints_to_limbs([1 << (i % n) for i in range(nm)], device)
    return one, pow2.unsqueeze(-1)


def _synthesize_lm(params_words: torch.Tensor, n: int, m: int, lg: int):
    """Compact params (nb, 9 + lg, 8) int32 words -> (static column scalars
    (10, 2nm), per-proof dyn scalars (10, nb * k)), k = 4 + 2 lg + m, all
    congruent mod ℓ.  The batch of proofs rides the last axis."""
    nm = n * m
    nb = params_words.shape[0]
    dev = params_words.device
    w = params_words.permute(1, 2, 0)                      # (C, 8, nb)
    wt, z, y_inv, allinv, a_s, b_s, x, cx, czz = (
        sm.decode_words_first(w[i]) for i in range(N_COMPACT))
    u_sq = [sm.decode_words_first(w[N_COMPACT + j]) for j in range(lg)]

    wz = sm.mul_lm(wt, z)
    wz_neg = sm.neg_lm(wz)
    wzz = sm.mul_lm(wz, z)
    wa_neg = sm.neg_lm(sm.mul_lm(wt, a_s))
    wb_neg = sm.neg_lm(sm.mul_lm(wt, b_s))
    wt_x = sm.mul_lm(wt, x)
    wt_cx = sm.mul_lm(wt, cx)
    wt_cxx = sm.mul_lm(wt_cx, x)
    wczz = sm.mul_lm(wt, czz)
    # u_j^-2 = allinv² · Π_{k≠j} u_k² from prefix and suffix products
    allinv2 = sm.mul_lm(allinv, allinv)
    pre, suf = [None] * lg, [None] * lg
    acc = allinv2
    for j in range(lg):
        pre[j] = acc
        acc = sm.mul_lm(acc, u_sq[j])
    acc = None
    for j in range(lg - 1, -1, -1):
        suf[j] = acc
        acc = u_sq[j] if acc is None else sm.mul_lm(acc, u_sq[j])
    u_inv_sq = [pre[j] if suf[j] is None else sm.mul_lm(pre[j], suf[j])
                for j in range(lg)]

    one, pow2 = _limb_constants(n, nm, dev)

    def pow_expand(base, count):
        """Π_j base[j]^{bit_j(i)} for i < count, as a doubling tree."""
        acc = one.expand(sm.NL, 1, nb)
        size = 1
        for b in base:
            if size >= count:
                break
            acc = torch.cat([acc, sm.mul_lm(acc, b[:, None, :])], dim=1)
            size *= 2
        return acc[:, :count]                              # (10, count, nb)

    # s_i = allinv · Π_j u_sq[lg-1-j]^{bit_j(i)}, and 1/s_i = s_{nm-1-i}
    s = sm.mul_lm(pow_expand([u_sq[lg - 1 - j] for j in range(lg)], nm),
                  allinv[:, None, :])
    s_inv = s.flip(1)
    y2 = [y_inv]
    for _ in range(max(0, lg - 1)):
        y2.append(sm.mul_lm(y2[-1], y2[-1]))
    yp = pow_expand(y2, nm)
    if m > 1:
        z2k = [z]
        for _ in range(max(0, m.bit_length() - 2)):
            z2k.append(sm.mul_lm(z2k[-1], z2k[-1]))
        zpow = pow_expand(z2k, m)                          # (10, m, nb)
    else:
        zpow = one.expand(sm.NL, 1, nb)

    # g_i = -wt·z - wt·a·s_i
    g = wz_neg[:, None, :] + sm.mul_lm(wa_neg[:, None, :], s)
    # h_i = wt·z + y^-i·(wt·z²·z^(i div n)·2^(i mod n) - wt·b·s_inv_i)
    a_col = torch.repeat_interleave(sm.mul_lm(wzz[:, None, :], zpow), n, dim=1)
    t1 = sm.mul_lm(a_col, pow2)
    t2 = sm.mul_lm(wb_neg[:, None, :], s_inv)
    h = wz[:, None, :] + sm.mul_lm(yp, sm.add_lm(t1, t2))
    gh_col = torch.cat([sm.accumulate_lm(g, 2), sm.accumulate_lm(h, 2)], dim=1)

    # dyn head scalars in MSM order A, S, T1, T2, L.., R.., V..
    wt_b = wt[:, None, :]
    head = ([wt_b, wt_x[:, None, :], wt_cx[:, None, :], wt_cxx[:, None, :]]
            + [sm.mul_lm(wt_b, u[:, None, :]) for u in u_sq]
            + [sm.mul_lm(wt_b, u[:, None, :]) for u in u_inv_sq]
            + [sm.mul_lm(wczz[:, None, :], zpow)])
    dyn = torch.cat(head, dim=1)                           # (10, k, nb)
    return gh_col, dyn.permute(0, 2, 1).reshape(sm.NL, -1)


def batch_msm_scalars(params_words, bbB_words, n: int, m: int, lg: int):
    """All MSM scalars, (10, 2 + 2nm + nb·k) limbs in point order."""
    gh_col, dyn = _synthesize_lm(params_words, n, m, lg)
    return torch.cat([sm.decode_words_last(bbB_words), gh_col, dyn], dim=1)


def batch_msm_check(static_words: torch.Tensor, dyn_words: torch.Tensor,
                    params_words: torch.Tensor, bbB_words: torch.Tensor,
                    n: int, m: int, lg: int, wbits: int,
                    config: MsmConfig | None = None) -> torch.Tensor:
    """The device half: static_words (4, 8, 2 + 2nm) resident generator
    words, dyn_words (8, nb·k) raw encodings, params_words (nb, 9 + lg, 8),
    bbB_words (2, 8) (all int32 bit patterns, on one device) -> int32 scalar
    tensor, 1 iff the batch accepts.  config picks the bucket pipeline's
    stages (msm.MsmConfig; None reads the environment)."""
    digits = sm.signed_digits(
        batch_msm_scalars(params_words, bbB_words, n, m, lg), wbits)
    dyn_pts, ok = ristretto_decode(dyn_words)
    points = torch.cat([words_to_points(static_words), dyn_pts], dim=2)
    totals = window_totals(points, digits, wbits, config)
    ident = horner_check(totals.unsqueeze(2).contiguous(), wbits)[0]
    return ok.min() & ident


def split_msm_check(static_words: torch.Tensor, dyn_enc_words: torch.Tensor,
                    static_scalar_words: torch.Tensor,
                    dyn_scalar_words: torch.Tensor, wbits: int,
                    config: MsmConfig | None = None) -> torch.Tensor:
    """A split mega-check on one device: static_words (4, 8, S) resident
    point words, dyn_enc_words (8, D) raw encodings, static_scalar_words
    (S, 8) and dyn_scalar_words (D, 8) 32-byte scalars below 2^256 (all
    int32 bit patterns) -> int32 scalar tensor, 1 iff every encoding
    decodes (K1's flag) and Σ s_i P_i is the identity.  The counterpart of
    the JAX package's txbatch_msm_check; config as batch_msm_check's."""
    scalars = torch.cat([sm.decode_words_last(static_scalar_words),
                         sm.decode_words_last(dyn_scalar_words)], dim=1)
    digits = sm.signed_digits(scalars, wbits)
    dyn_pts, ok = ristretto_decode(dyn_enc_words)
    points = torch.cat([words_to_points(static_words), dyn_pts], dim=2)
    totals = window_totals(points, digits, wbits, config)
    ident = horner_check(totals.unsqueeze(2).contiguous(), wbits)[0]
    return ok.min() & ident


def fused_split_check(static_buf: bytes, dyn_s, dyn_enc_blob: bytes,
                      bp_gens, pc_gens, device="cuda",
                      timings: dict | None = None,
                      config: MsmConfig | None = None) -> bool:
    """One split mega-check on `device`: the static scalars arrive as
    packed 32-byte bytes over the resident [B_blinding, B] + G(maxpad) +
    H(maxpad) columns, the dynamic points as raw 32-byte encodings
    (decoded and validated by K1), the dynamic scalars as ints.  True iff
    it accepts.

    The JAX package pads the dynamic part to a multiple of 1,024 (256 at
    least) and fixes wbits = 13, so that XLA compiles are shared and its
    13-bit recoder applies; the port needs neither, so the MSM has exactly
    n = S + D points and best_wbits(n) picks the width.  timings, when
    given, receives host_s (packing), device_s (upload, device chain, the
    verdict's fetch), msm_size, wbits and route; config as
    batch_msm_check's."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    S = len(static_buf) // 32
    maxpad = (S - 2) // 2
    if len(static_buf) != 32 * S or S != 2 + 2 * maxpad:
        raise FormatError("static scalars must cover [B_blinding, B] + G + H")
    D = len(dyn_s)
    if len(dyn_enc_blob) != 32 * D:
        raise FormatError("one 32-byte encoding per dynamic scalar")
    static = static_gens_words(bp_gens, pc_gens, maxpad, 1, dev)
    static_sc = np.frombuffer(static_buf, np.uint32).reshape(S, 8)
    dyn_sc = scalar_words([int(x) % L for x in dyn_s])
    enc = np.frombuffer(dyn_enc_blob, np.uint32).reshape(D, 8).T
    n = S + D
    wbits = best_wbits(n)
    t_host = time.perf_counter()
    flag = split_msm_check(static, to_device(enc, dev),
                           to_device(static_sc, dev), to_device(dyn_sc, dev),
                           wbits, config)
    verdict = bool(flag.item())
    if timings is not None:
        timings.update(host_s=t_host - t0,
                       device_s=time.perf_counter() - t_host, msm_size=n,
                       wbits=wbits, route=route(n))
    return verdict


# ------------------------------------------------------- static gens cache
_static_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def static_gens_words(bp_gens, pc_gens, n: int, m: int, device) -> torch.Tensor:
    """Device-resident (4, 8, 2 + 2nm) words of [B_blinding, B] + G(n, m) +
    H(n, m), made once per generator set, shape and device."""
    per_gens = _static_cache.setdefault(bp_gens, {})
    key = (n, m, pc_gens.B.compress(), pc_gens.B_blinding.compress(),
           str(torch.device(device)))
    cached = per_gens.get(key)
    if cached is None:
        pts = ([pc_gens.B_blinding, pc_gens.B]
               + bp_gens.G(n, m) + bp_gens.H(n, m))
        cached = to_device(points_words([p.ep for p in pts]), device)
        per_gens[key] = cached
    return cached


# --------------------------------------------------------------- host half
def pack_verification_params_compact(jobs: list[dict]) -> np.ndarray:
    """Per-proof compact params -> (nb, 9 + lg, 8) uint32."""
    lg = len(jobs[0]["u_sq"])
    blob = bytearray()
    for j in jobs:
        for v in ([j["wt"], j["z"], j["y_inv"], j["allinv"], j["a"], j["b"],
                   j["x"], j["cx"], j["czz"]] + list(j["u_sq"])):
            blob += int(v).to_bytes(32, "little")
    return np.frombuffer(bytes(blob), np.uint32).reshape(
        len(jobs), N_COMPACT + lg, 8)


def dyn_words(proofs, value_commitments) -> np.ndarray:
    """Every proof's dynamic points as raw encodings, (8, nb·k) uint32."""
    encs = []
    for proof, vcs in zip(proofs, value_commitments):
        encs.extend(proof.dyn_compressed(vcs))
    return encoding_words(encs)


def _batch_shape(proofs, transcripts, value_commitments, n: int):
    """-> (nb, m, lg) of a fused batch, whose proofs share one m."""
    nb = len(proofs)
    if not nb or nb != len(transcripts) or nb != len(value_commitments):
        raise FormatError("empty batch, or proofs, transcripts and value "
                          "commitments of different counts")
    m = len(value_commitments[0])
    if any(len(vc) != m for vc in value_commitments):
        raise FormatError("batched proofs must share one aggregation size")
    return nb, m, (n * m).bit_length() - 1


def prepare_batch_inputs(proofs, bp_gens, pc_gens, transcripts,
                         value_commitments, n: int,
                         entropy: bytes = b"\x01" * 32,
                         timings: dict | None = None):
    """Host half, in the native library: one transcript replay of the whole
    batch, the per-proof weight hashes, one params assembly.  Returns
    (params (nb, 9 + lg, 8) uint32, bbB_per_proof (nb, 2, 8) uint32 — each
    proof's weighted B_blinding and B scalars, dyn words (8, nb·k) uint32,
    m, lg).  Raises FormatError / ProofError on malformed proofs, the
    first in proof order, as the proof-by-proof twin does.  timings, when
    given, receives replay_s, weights_s, params_s and words_s."""
    t0 = time.perf_counter()
    nb, m, lg = _batch_shape(proofs, transcripts, value_commitments, n)
    # every proof's structure before one replay of the proofs ahead of the
    # first malformed one: an identity point among those raises first
    bad = None
    for i, (proof, vcs) in enumerate(zip(proofs, value_commitments)):
        try:
            proof._check_shape(bp_gens, vcs, n)
        except ProofError as e:
            bad = (i, e)
            break
    k = nb if bad is None else bad[0]
    wires = [p.to_bytes() for p in proofs]
    rcs, blobs = native.rangeproof_replay_batch(
        [t.strobe for t in transcripts[:k]], LABEL_RANGEPROOF, LABEL_IPP, n,
        m, b"".join(v for vcs in value_commitments[:k] for v in vcs),
        b"".join(wires[:k]), 224 + 64 * lg + 64, lg)
    if any(rcs):
        raise ProofError(IDENTITY_ERROR)
    if bad is not None:
        raise bad[1]
    t1 = time.perf_counter()
    digests = b"".join(
        hashlib.sha3_512(entropy + i.to_bytes(8, "little") + w).digest()
        for i, w in enumerate(wires))
    t2 = time.perf_counter()
    prf = b"".join(scalar.to_bytes(v) for p in proofs
                   for v in (p.t_x, p.t_x_blinding, p.e_blinding,
                             p.ipp_proof.a, p.ipp_proof.b))
    params, bbB_per_proof = native.fused_params_assembly(
        b"".join(blobs), prf, digests, nb, lg, n, m)
    t3 = time.perf_counter()
    dyn = dyn_words(proofs, value_commitments)
    if timings is not None:
        timings.update(replay_s=t1 - t0, weights_s=t2 - t1,
                       params_s=t3 - t2, words_s=time.perf_counter() - t3)
    return params, bbB_per_proof, dyn, m, lg


def prepare_batch_inputs_plain(proofs, bp_gens, pc_gens, transcripts,
                               value_commitments, n: int,
                               entropy: bytes = b"\x01" * 32):
    """prepare_batch_inputs' pure-Python twin: proof-by-proof replays, one
    batched inversion, the per-proof params in Python ints."""
    nb, m, lg = _batch_shape(proofs, transcripts, value_commitments, n)
    replays = [p._replay_challenges_plain(bp_gens, pc_gens, t, vcs, n)
               for p, t, vcs in zip(proofs, transcripts, value_commitments)]
    params, bbB_per_proof = params_plain(proofs, replays, n, m, lg, entropy)
    return params, bbB_per_proof, dyn_words(proofs, value_commitments), m, lg


def params_plain(proofs, replays: list[dict], n: int, m: int, lg: int,
                 entropy: bytes):
    """fused_params_assembly's pure-Python twin: each proof's replayed
    challenges ({"y", "z", "x", "w", "c", "u"}) and scalars -> (params
    (nb, 9 + lg, 8), bbB_per_proof (nb, 2, 8)), uint32."""
    nb = len(proofs)
    # one inversion pass for y, every u, and y - 1 (delta's geometric sum)
    all_u = [u for r in replays for u in r["u"]]
    ys = [r["y"] for r in replays]
    ym1 = [(r["y"] - 1) % L or 1 for r in replays]
    inv = scalar.batch_invert_plain(ys + all_u + ym1)
    y_invs = inv[:nb]
    u_invs = [inv[nb + i * lg: nb + (i + 1) * lg] for i in range(nb)]
    ym1_invs = inv[nb + nb * lg:]

    jobs, bbB_rows = [], []
    for i, (proof, r) in enumerate(zip(proofs, replays)):
        y, z, x, w, c, u = r["y"], r["z"], r["x"], r["w"], r["c"], r["u"]
        a, b = proof.ipp_proof.a % L, proof.ipp_proof.b % L
        wt = batch_weight(entropy, i, proof.to_bytes())
        zz = z * z % L
        allinv = 1
        for ui in u_invs[i]:
            allinv = allinv * ui % L
        if y == 1:
            dv = delta_fn(n, m, y, z)
        else:
            y_nm = y
            for _ in range(lg):
                y_nm = y_nm * y_nm % L
            sum_y = (y_nm - 1) * ym1_invs[i] % L
            acc = (z - zz) % L * sum_y % L
            zexp = zz * z % L
            for _ in range(m):
                acc = (acc - zexp * ((1 << n) - 1)) % L
                zexp = zexp * z % L
            dv = acc
        b_s = (w * ((proof.t_x - a * b) % L) + c * ((dv - proof.t_x) % L)) % L
        bb_s = (-proof.e_blinding - c * proof.t_x_blinding) % L
        bbB_rows.append(int(wt * bb_s % L).to_bytes(32, "little")
                        + int(wt * b_s % L).to_bytes(32, "little"))
        jobs.append({
            "wt": wt, "z": z, "y_inv": y_invs[i], "allinv": allinv,
            "a": a, "b": b, "x": x, "cx": c * x % L, "czz": c * zz % L,
            "u_sq": [ui * ui % L for ui in u],
        })
    params = pack_verification_params_compact(jobs)
    bbB_per_proof = np.frombuffer(b"".join(bbB_rows), np.uint32).reshape(
        nb, 2, 8)
    return params, bbB_per_proof


def sum_bbB(bbB_pp: np.ndarray) -> np.ndarray:
    """Per-proof (nb, 2, 8) B_blinding/B scalar rows -> their sums mod ℓ,
    (2, 8) uint32."""
    rows = words_to_ints(bbB_pp)
    bb = sum(rows[0::2]) % L
    b = sum(rows[1::2]) % L
    return np.frombuffer(bb.to_bytes(32, "little") + b.to_bytes(32, "little"),
                         np.uint32).reshape(2, 8).copy()


def require_device(device) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no CUDA
    device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but none is available")
    return dev


class _Prepared:
    """One batch's host half, uploaded: the device tensors (params, dyn
    words, bbB), the upload's event (None unless it ran on a stream of its
    own), m, lg and the host half's seconds."""

    __slots__ = ("tensors", "event", "m", "lg", "host_s")

    def __init__(self, tensors, event, m, lg, host_s):
        self.tensors, self.event = tensors, event
        self.m, self.lg, self.host_s = m, lg, host_s


def _prepare(batch, bp_gens, pc_gens, n: int, entropy: bytes,
             dev: torch.device, copy_stream=None,
             timings: dict | None = None) -> _Prepared:
    """batch_verify_device's host half: prepare_batch_inputs (its stages
    into timings) and sum_bbB, then the upload through pinned memory, on
    copy_stream with an event recorded after it when one is given, else on
    the current stream.  Launches no kernel, and touches no cache of the
    calling thread (static_gens_words), so the pipeline's worker runs it."""
    t0 = time.perf_counter()
    proofs, transcripts, vcs = batch
    params, bbB_pp, dyn, m, lg = prepare_batch_inputs(
        proofs, bp_gens, pc_gens, transcripts, vcs, n, entropy, timings)
    with torch.cuda.stream(copy_stream):
        tensors = [to_device(a, dev) for a in (params, dyn, sum_bbB(bbB_pp))]
    event = None
    if copy_stream is not None:
        event = torch.cuda.Event()
        event.record(copy_stream)
    return _Prepared(tensors, event, m, lg, time.perf_counter() - t0)


def _launch(prep: _Prepared, bp_gens, pc_gens, n: int, dev: torch.device,
            config: MsmConfig | None, timings: dict | None = None
            ) -> torch.Tensor:
    """batch_verify_device's device half, on the calling thread: wait for
    the batch's upload event (if any), then batch_msm_check on the current
    stream; -> the verdict tensor, not fetched.  timings, when given,
    receives msm_size and wbits."""
    params, dyn, bbB = prep.tensors
    if prep.event is not None:
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(prep.event)
        for t in prep.tensors:          # made on the copy stream, read here
            t.record_stream(stream)
    static = static_gens_words(bp_gens, pc_gens, n, prep.m, dev)
    total = static.shape[2] + dyn.shape[1]
    wbits = best_wbits(total)
    if timings is not None:
        timings.update(msm_size=total, wbits=wbits)
    return batch_msm_check(static, dyn, params, bbB, n, prep.m, prep.lg,
                           wbits, config)


def batch_verify_device(proofs, bp_gens, pc_gens, transcripts,
                        value_commitments, n: int,
                        entropy: bytes = b"\x01" * 32, device="cuda",
                        timings: dict | None = None,
                        config: MsmConfig | None = None) -> bool:
    """Batched verification through the device half; True iff the batch
    accepts.  Every proof must aggregate the same number m of values.  An
    invalid point encoding makes it False; malformed proofs raise
    FormatError/ProofError.  timings, when given, receives host_s
    (prepare_batch_inputs' stages, also given, and the upload's staging),
    device_s (the device chain and the verdict's fetch), msm_size and
    wbits."""
    dev = require_device(device)
    prep = _prepare((proofs, transcripts, value_commitments), bp_gens,
                    pc_gens, n, entropy, dev, timings=timings)
    t_host = time.perf_counter()
    verdict = bool(_launch(prep, bp_gens, pc_gens, n, dev, config,
                           timings).item())
    if timings is not None:
        timings.update(host_s=prep.host_s,
                       device_s=time.perf_counter() - t_host)
    return verdict


# ------------------------------------------------------ the serving pipeline
def batch_verify_device_pipelined(batches, bp_gens, pc_gens, n: int,
                                  entropies=None, device=None, engine=None,
                                  timings: dict | None = None,
                                  config: MsmConfig | None = None
                                  ) -> list[bool]:
    """The serving path: a stream of batches, each verified as
    batch_verify_device verifies it (its _prepare and _launch), with the
    host half of batch k + 1 overlapped against batch k on the card.  On
    the H100 it is not yet faster than a loop over batch_verify_device
    (PERF.md §6): both halves run Python, and the GIL serialises them; it
    is where a device half that issues without Python (ROADMAP A4, a CUDA
    graph) can show the overlap.

    batches: (proofs, transcripts, value_commitments) tuples, each batch of
    one aggregation size; entropies: one weight entropy a batch (default a
    counter, as the reference's).  A worker thread runs each batch's host
    half and uploads it on a stream of its own from pinned buffers; the
    calling thread takes batch k, hands the worker batch k + 1, waits for
    batch k's upload event, issues its device half on its current stream
    and fetches the verdict.  Only the calling thread launches kernels and
    reads static_gens_words' cache.  An invalid encoding makes that batch
    False; a malformed proof raises at its batch's turn.  The engine
    resolves as the verifiers' (`engine`, else a TorchEngine on `device`,
    else the card) and must be one with supports_fused_batch_verify;
    config None takes the engine's.  timings, when given, receives
    total_s, batches, and per batch lists host_s (the worker's host half
    and upload), device_s (issue to fetched verdict) and wall_s (between
    verdicts)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..proofs.engine import resolve_engine
    eng = resolve_engine(device, engine)
    if not eng.supports_fused_batch_verify:
        raise ValueError("the pipelined path needs an engine on a device "
                         "(supports_fused_batch_verify)")
    dev = eng.device
    config = eng.config if config is None else config
    if entropies is None:
        entropies = [bytes([k % 255 + 1]) * 32 for k in range(len(batches))]
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    results, host_s, device_s, wall_s = [], [], [], []
    t0 = t_last = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        def submit(k):
            return ex.submit(_prepare, batches[k], bp_gens, pc_gens, n,
                             entropies[k], dev, copy_stream)
        fut = submit(0) if batches else None
        for k in range(len(batches)):
            prep = fut.result()
            if k + 1 < len(batches):
                fut = submit(k + 1)
            t = time.perf_counter()
            flag = _launch(prep, bp_gens, pc_gens, n, dev, config)
            results.append(bool(flag.item()))
            now = time.perf_counter()
            host_s.append(prep.host_s)
            device_s.append(now - t)
            wall_s.append(now - t_last)
            t_last = now
    if timings is not None:
        timings.update(total_s=time.perf_counter() - t0,
                       batches=len(batches), host_s=host_s,
                       device_s=device_s, wall_s=wall_s)
    return results
