"""Batched range-proof verification and the R1CS split mega-check on the
card.

Counterpart of the JAX package's kernels/batch_verify_device.py.  The host
half (prepare_batch_inputs) replays every proof's transcript, batch-inverts
the challenges, hashes the per-proof weights and packs ~20 canonical
scalars per proof.  The device half (batch_msm_check) is one chain on the
card:

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

import time
import weakref

import numpy as np
import torch

from ..constants import L
from ..oracle import scalar
from ..proofs.errors import FormatError
from ..proofs.rangeproof import batch_weight
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


def _pow2_limbs(n: int, nm: int, device) -> torch.Tensor:
    """(10, nm, 1) limbs of 2^(i mod n), the concat_z_and_2 column."""
    return sm.ints_to_limbs([1 << (i % n) for i in range(nm)],
                            device).unsqueeze(-1)


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

    one = sm.ints_to_limbs([1], dev).view(sm.NL, 1, 1)

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
    t1 = sm.mul_lm(a_col, _pow2_limbs(n, nm, dev))
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


def prepare_batch_inputs(proofs, bp_gens, pc_gens, transcripts,
                         value_commitments, n: int,
                         entropy: bytes = b"\x01" * 32):
    """Host half: transcript replays, one batched inversion, per-proof
    weights and params.  Returns (params (nb, 9 + lg, 8) uint32,
    bbB_per_proof (nb, 2, 8) uint32 — each proof's weighted B_blinding and
    B scalars, dyn words (8, nb·k) uint32, m, lg).  Raises FormatError /
    ProofError on malformed proofs."""
    nb = len(proofs)
    if not nb or nb != len(transcripts) or nb != len(value_commitments):
        raise FormatError("empty batch, or proofs, transcripts and value "
                          "commitments of different counts")
    m = len(value_commitments[0])
    if any(len(vc) != m for vc in value_commitments):
        raise FormatError("batched proofs must share one aggregation size")
    lg = (n * m).bit_length() - 1

    replays = [p._replay_challenges(bp_gens, pc_gens, t, vcs, n)
               for p, t, vcs in zip(proofs, transcripts, value_commitments)]
    # one inversion pass for y, every u, and y - 1 (delta's geometric sum)
    all_u = [u for r in replays for u in r["u"]]
    ys = [r["y"] for r in replays]
    ym1 = [(r["y"] - 1) % L or 1 for r in replays]
    inv = scalar.batch_invert(ys + all_u + ym1)
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
    return params, bbB_per_proof, dyn_words(proofs, value_commitments), m, lg


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


def batch_verify_device(proofs, bp_gens, pc_gens, transcripts,
                        value_commitments, n: int,
                        entropy: bytes = b"\x01" * 32, device="cuda",
                        timings: dict | None = None,
                        config: MsmConfig | None = None) -> bool:
    """Batched verification through the device half; True iff the batch
    accepts.  Every proof must aggregate the same number m of values.  An
    invalid point encoding makes it False; malformed proofs raise
    FormatError/ProofError.  timings, when given, receives host_s,
    device_s (upload, device chain and the verdict's fetch), msm_size and
    wbits."""
    dev = require_device(device)
    t_start = time.perf_counter()
    params, bbB_pp, dyn, m, lg = prepare_batch_inputs(
        proofs, bp_gens, pc_gens, transcripts, value_commitments, n, entropy)
    bbB = sum_bbB(bbB_pp)
    static = static_gens_words(bp_gens, pc_gens, n, m, dev)
    total = static.shape[2] + dyn.shape[1]
    wbits = best_wbits(total)
    t_host = time.perf_counter()
    flag = batch_msm_check(static, to_device(dyn, dev), to_device(params, dev),
                           to_device(bbB, dev), n, m, lg, wbits, config)
    verdict = bool(flag.item())
    t_dev = time.perf_counter()
    if timings is not None:
        timings.update(host_s=t_host - t_start, device_s=t_dev - t_host,
                       msm_size=total, wbits=wbits)
    return verdict
