"""Pippenger window totals: K2 bucket_accumulate and K3 bucket_fold.

Counterpart of the JAX package's pallas_msm.window_totals.  One pipeline
for every n (any n works; callers that pad use identity points with zero
digits, which join no bucket):

  1. per window, sort packed (|digit|, sign, index) keys (torch.sort — the
     JAX package sorts with XLA outside any Pallas kernel too);
  2. run offsets of each bucket in the sorted keys (torch.searchsorted);
  3. K2 (csrc/bucket_accumulate.cu): every bucket's signed point sum;
  4. K3 (csrc/bucket_fold.cu): each window's Σ_b b · B_b.

Windows are signed radix-2^w digits with |digit| <= 2^(w-1), so a window
has nb = 2^(w-1) buckets holding magnitudes 1..nb.  The packed key needs
that bound: a larger digit would spill into the index bits.
"""

from __future__ import annotations

import math

import torch

from . import _build
from . import field as F
from .scalarmod import num_windows

FOLD_LANES = 128      # K3 threads per window (the block size)

# Cost model for choosing wbits on an H100 (132 SMs); the unit is one
# point add on one thread.  K2 runs one thread per (window, bucket); at
# ~512 resident threads per SM a launch of nw * nb threads takes
# ceil(nw * nb / 67,584) waves, and a warp waits for the longest run among
# its 32 buckets, about λ + 2.5 sqrt(λ) adds for Poisson runs of mean
# λ = n / nb.  The top windows are not uniform: scalars are canonical and
# below 2^252 (but for a 2^-127 share), so window j holds only
# b_j = 252 - w j of its w bits, its digits fall in about 2^b_j buckets
# and its longest run is about n / 2^b_j — and a window holding no bits
# receives the carry out of a full window below, putting half the points
# in bucket 1.  That run is one thread's serial work: on an H100 SXM at
# 700 W, window_totals over 17,538 points took 1.5 ms at w = 11 against
# 66 ms at w = 12, where the top window is such a carry window.  K3 then
# walks 2R adds per thread, plus a scan and a tree of log2(lanes) adds
# each and log2(R) doublings.  From 13, the JAX package's width at these
# sizes, the model moves to 11 for every batch size up to 2^18 points.
_SMS = 132
_RESIDENT_THREADS = 512
_SCALAR_BITS = 252


def fold_lanes(nb: int) -> int:
    return min(FOLD_LANES, nb)


def msm_cost(n: int, wbits: int) -> float:
    nb = 1 << (wbits - 1)
    nw = num_windows(wbits)
    lam = n / nb
    waves = math.ceil(nw * nb / (_SMS * _RESIDENT_THREADS))
    k2 = waves * (lam + 2.5 * math.sqrt(lam) + 1)
    for j in range(nw):
        bits = min(wbits, max(0, _SCALAR_BITS - wbits * j))
        if 0 < bits < wbits:
            k2 = max(k2, n / 2 ** bits)
        elif bits == 0 and _SCALAR_BITS - wbits * (j - 1) >= wbits:
            k2 = max(k2, n / 2)
    lanes = fold_lanes(nb)
    r = nb // lanes
    k3 = 2 * r + 2 * math.log2(lanes) + math.log2(r)
    return k2 + k3


def best_wbits(n: int) -> int:
    return min(range(8, 17), key=lambda w: (msm_cost(n, w), w))


# ------------------------------------------------------------------ K2
def bucket_accumulate_plain(keys, offsets, points, nb: int, shift: int):
    """Plain twin of K2: the same adds in the same order, vectorized over
    buckets (one step per position in the runs)."""
    nw, n = keys.shape
    starts = offsets[:, :-1].reshape(-1)
    lens = offsets[:, 1:].reshape(-1) - starts
    rows = torch.arange(nw, device=keys.device).repeat_interleave(nb)
    pts = F.unpack_points(points)
    acc = list(F.identity_like(torch.zeros((F.NL, nw * nb), dtype=torch.int64,
                                           device=keys.device)))
    for r in range(int(lens.max()) if lens.numel() else 0):
        sel = (lens > r).nonzero().squeeze(1)
        key = keys[rows[sel], starts[sel] + r]
        idx = key & ((1 << shift) - 1)
        neg = ((key >> shift) & 1) == 1
        X, Y, Z, T = (c[:, idx] for c in pts)
        p = (F.select(neg, F.neg(X), X), Y, Z, F.select(neg, F.neg(T), T))
        if r > 0:
            p = F.point_add(tuple(c[:, sel] for c in acc), p)
        for c, v in zip(acc, p):
            c[:, sel] = v
    return F.pack_points(acc)


def bucket_accumulate(keys, offsets, points, nb: int, shift: int):
    """Sorted keys (nw, n) int64, offsets (nw, nb + 1) int64, points
    (4, 10, n) int32 -> bucket sums (4, 10, nw * nb) int32."""
    if keys.device.type == "cpu":
        return bucket_accumulate_plain(keys, offsets, points, nb, shift)
    nw, n = keys.shape
    _build.check_cuda(keys, torch.int64, (nw, n), "bucket_accumulate keys")
    _build.check_cuda(offsets, torch.int64, (nw, nb + 1),
                      "bucket_accumulate offsets")
    _build.check_cuda(points, torch.int32, (4, F.NL, n),
                      "bucket_accumulate points")
    out = torch.empty((4, F.NL, nw * nb), dtype=torch.int32,
                      device=keys.device)
    _build.launch("bucket_accumulate", keys, offsets, points, out, n, nw, nb,
                  shift)
    bucket_accumulate.launches += 1
    return out


bucket_accumulate.launches = 0


# ------------------------------------------------------------------ K3
def bucket_fold_plain(buckets, nw: int, nb: int):
    """Plain twin of K3, the same adds in the same order."""
    lanes = fold_lanes(nb)
    R = nb // lanes
    B = [c.view(F.NL, nw, lanes, R) for c in F.unpack_points(buckets)]
    T = F.identity_like(torch.zeros((F.NL, nw, lanes), dtype=torch.int64,
                                    device=buckets.device))
    W = T
    for r in range(R - 1, -1, -1):
        T = F.point_add(T, tuple(c[..., r] for c in B))
        W = F.point_add(W, T)
    off = 1
    while off < lanes:                  # suffix scan over the lanes
        head = F.point_add(tuple(c[..., :lanes - off] for c in T),
                           tuple(c[..., off:] for c in T))
        T = tuple(torch.cat([h, c[..., lanes - off:]], dim=-1)
                  for h, c in zip(head, T))
        off *= 2
    ident = F.identity_like(T[0][..., 0])
    T = tuple(torch.cat([i.unsqueeze(-1), c[..., 1:]], dim=-1)
              for i, c in zip(ident, T))
    half = lanes // 2
    while half >= 1:                    # tree sums over the lanes
        T = F.point_add(tuple(c[..., :half] for c in T),
                        tuple(c[..., half:2 * half] for c in T))
        W = F.point_add(tuple(c[..., :half] for c in W),
                        tuple(c[..., half:2 * half] for c in W))
        half //= 2
    acc = tuple(c[..., 0] for c in T)
    for _ in range(R.bit_length() - 1):
        acc = F.point_double(acc)
    return F.pack_points(F.point_add(tuple(c[..., 0] for c in W), acc))


def bucket_fold(buckets, nw: int, nb: int):
    """Bucket sums (4, 10, nw * nb) int32 -> window totals (4, 10, nw)."""
    if buckets.device.type == "cpu":
        return bucket_fold_plain(buckets, nw, nb)
    _build.check_cuda(buckets, torch.int32, (4, F.NL, nw * nb),
                      "bucket_fold buckets")
    lanes = fold_lanes(nb)
    out = torch.empty((4, F.NL, nw), dtype=torch.int32, device=buckets.device)
    _build.launch("bucket_fold", buckets, out, nw, nb, lanes,
                  (nb // lanes).bit_length() - 1)
    bucket_fold.launches += 1
    return out


bucket_fold.launches = 0


# ------------------------------------------------------------ the pipeline
def sort_keys(digits: torch.Tensor, nb: int):
    """(n, nw) int32 signed digits -> (sorted keys (nw, n) int64, run offsets
    (nw, nb + 1) int64, index bits).  Zero digits sort first and belong to
    no bucket."""
    n, nw = digits.shape
    shift = max(n - 1, 1).bit_length()
    d = digits.T.to(torch.int64)
    keys = ((d.abs() << (shift + 1)) | ((d < 0).to(torch.int64) << shift)
            | torch.arange(n, device=digits.device))
    keys = torch.sort(keys, dim=1).values.contiguous()
    bounds = (torch.arange(1, nb + 2, device=digits.device) << (shift + 1))
    offsets = torch.searchsorted(keys, bounds.expand(nw, nb + 1).contiguous())
    return keys, offsets, shift


def window_totals(points: torch.Tensor, digits: torch.Tensor, wbits: int):
    """points (4, 10, n) int32, digits (n, nw) int32 signed radix-2^wbits
    with |digit| <= 2^(wbits-1) -> window totals (4, 10, nw) int32, where
    total_w = Σ_i digit[i, w] · P_i."""
    nb = 1 << (wbits - 1)
    keys, offsets, shift = sort_keys(digits, nb)
    buckets = bucket_accumulate(keys, offsets, points, nb, shift)
    return bucket_fold(buckets, digits.shape[1], nb)
