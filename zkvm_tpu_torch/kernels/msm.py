"""Pippenger window totals, by one of two routes.

Counterpart of the JAX package's pallas_msm.window_totals, and dispatched
as it is: MSMs of 2,048 points or fewer (those whose padded_msm_size
there is under the 4,096-point tile of its sequential pipeline) take the
small route, larger ones the bucket pipeline.  Both start from one sort:

  1. per window, sort packed (|digit|, sign, index) keys (torch.sort by
     default, as the JAX package sorts with XLA by default; K9 under the
     sort configuration below), and find the run offsets of each bucket
     (torch.searchsorted).

window_totals_large, the bucket pipeline:
  2. K2 (csrc/bucket_accumulate.cu), or K11 or K12 (below): every bucket's
     signed point sum;
  3. K3 (csrc/bucket_fold.cu): each window's Σ_b b · B_b.

window_totals_small, the associative-scan route (JAX _bucket_totals):
  2. gather and sign the points in sorted order (torch ops);
  3. an inclusive segmented scan over each window's sorted runs:
     ceil(log2 R) launches of K5 (kernels/pointwise.seg_combine), R the
     longest bucket run of any window;
  4. each bucket takes the scan's value at the end of its run;
  5. a suffix scan over the buckets and a tree over the suffix sums,
     2 log2(nb) launches of K6 (kernels/pointwise.point_add).

The bucket pipeline's stages follow an MsmConfig, as the JAX package's
_bucket_totals_seq follows its environment switches (pallas_msm.py
:707-720, :1025-1032, :1059-1065); the small route ignores it:
  * default: torch.sort; K2 gathers each point's limbs itself;
  * sort (ZKVM_MSM_SORT=pallas): K9 (kernels/sort.py) sorts the keys;
  * gather (ZKVM_MSM_GATHER=pallas): the points are frozen to canonical
    words, K10 (kernels/gather.py) gathers them into sorted order, one
    row per point, and K11 (csrc/bucket_accumulate_words.cu) decodes and
    signs them while it sums the buckets;
  * affine (ZKVM_MSM_AFFINE=1, only when gather is off): the points are
    normalized to affine words by one batch inversion (to_affine_words),
    K10 gathers those 16-word rows and K12
    (csrc/bucket_accumulate_affine.cu) sums the buckets with mixed adds.
The JAX package caps its word gather at n <= 2^18 and its Pallas sort at
2^18 keys for the TPU's VMEM; the port runs the configured kernel at
every n.

Any n works on either route (callers that pad use identity points with
zero digits, which join no bucket).  Windows are signed radix-2^w digits
with |digit| <= 2^(w-1), so a window has nb = 2^(w-1) buckets holding
magnitudes 1..nb.  The packed key needs that bound: a larger digit would
spill into the index bits.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch

from ..constants import EDWARDS_D2
from . import _build
from . import field as F
from .gather import gather_words
from .pointwise import point_add, seg_combine
from .scalarmod import num_windows
from .sort import radix_sort
from .words import field_words_to_limbs, limbs_to_field_words, points_to_words

FOLD_LANES = 128      # K3 threads per window (the block size)
SMALL_MSM_MAX = 2048  # the largest MSM on the small route

# Cost model for choosing wbits on an H100 (132 SMs); the unit is one
# point add on one thread, and at ~512 resident threads per SM a launch of
# t threads takes ceil(t / 67,584) waves.
#
# The large route: K2 runs one thread per (window, bucket), and a warp
# waits for the longest run among its 32 buckets, about λ + 2.5 sqrt(λ)
# adds for Poisson runs of mean λ = n / nb.  The top windows are not
# uniform: scalars are canonical and below 2^252 (but for a 2^-127
# share), so window j holds only b_j = 252 - w j of its w bits, its digits
# fall in about 2^b_j buckets and its longest run is about n / 2^b_j — and
# a window holding no bits receives the carry out of a full window below,
# putting half the points in bucket 1.  That run is one thread's serial
# work: on an H100 SXM at 700 W, window_totals over 17,538 points took
# 1.5 ms at w = 11 against 66 ms at w = 12, where the top window is such a
# carry window.  K3 then walks 2R adds per thread, plus a scan and a tree
# of log2(lanes) adds each and log2(R) doublings.  From 13, the JAX
# package's width at these sizes, the model moves to 11 for every batch
# size up to 2^18 points.
#
# The small route: at most ceil(log2 n) scan launches of nw * n threads
# (the scan stops at the longest bucket run), then 2 log2(nb) fold
# launches of at most nw * nb threads, each launch one add deep.  Digit
# skew costs nothing here.  Every launch is at least one wave, so the
# narrowest window the search allows (8) wins at every small n; the JAX
# package's 13 would fold 4,096 buckets per window.
_SMS = 132
_RESIDENT_THREADS = 512
_SCALAR_BITS = 252


def fold_lanes(nb: int) -> int:
    return min(FOLD_LANES, nb)


def route(n: int) -> str:
    """"small" for MSMs of n <= SMALL_MSM_MAX points, else "large"."""
    return "small" if n <= SMALL_MSM_MAX else "large"


def _waves(threads: int) -> int:
    return max(1, math.ceil(threads / (_SMS * _RESIDENT_THREADS)))


def msm_cost(n: int, wbits: int) -> float:
    nb = 1 << (wbits - 1)
    nw = num_windows(wbits)
    if route(n) == "small":
        return (math.ceil(math.log2(max(n, 2))) * _waves(nw * n)
                + 2 * (wbits - 1) * _waves(nw * nb))
    lam = n / nb
    k2 = _waves(nw * nb) * (lam + 2.5 * math.sqrt(lam) + 1)
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


@dataclass(frozen=True)
class MsmConfig:
    """The bucket pipeline's stages (module note).  MsmConfig() is the
    default: torch.sort and K2 over limbs."""
    sort: bool = False      # K9 radix sort instead of torch.sort
    gather: bool = False    # K10 word rows + K11
    affine: bool = False    # K10 affine rows + K12; gather takes precedence

    @staticmethod
    def from_env() -> "MsmConfig":
        """The JAX package's switches, read now, with its names, values and
        precedence: ZKVM_MSM_SORT=pallas, ZKVM_MSM_GATHER=pallas, and
        ZKVM_MSM_AFFINE=1 only when the word gather is off."""
        gather = os.environ.get("ZKVM_MSM_GATHER", "") == "pallas"
        return MsmConfig(
            sort=os.environ.get("ZKVM_MSM_SORT", "") == "pallas",
            gather=gather,
            affine=not gather and os.environ.get("ZKVM_MSM_AFFINE", "") == "1")


# ------------------------------------------------------------ K2, K11, K12
def _bucket_walk(keys, offsets, nb: int, shift: int, load, first, add):
    """The bucket-sum twins' shared loop, vectorized over buckets with one
    step per position in the runs, the kernels' adds in their order:
    load(window, position, point index, negate) gives the point at a
    sorted position, first(p) a run's starting value, add(acc, p) the
    next sum; an empty bucket stays the identity."""
    nw, n = keys.shape
    starts = offsets[:, :-1].reshape(-1)
    lens = offsets[:, 1:].reshape(-1) - starts
    rows = torch.arange(nw, device=keys.device).repeat_interleave(nb)
    acc = list(F.identity_like(torch.zeros((F.NL, nw * nb), dtype=torch.int64,
                                           device=keys.device)))
    for r in range(int(lens.max()) if lens.numel() else 0):
        sel = (lens > r).nonzero().squeeze(1)
        w, pos = rows[sel], starts[sel] + r
        key = keys[w, pos]
        p = load(w, pos, key & ((1 << shift) - 1), ((key >> shift) & 1) == 1)
        p = first(p) if r == 0 else add(tuple(c[:, sel] for c in acc), p)
        for c, v in zip(acc, p):
            c[:, sel] = v
    return F.pack_points(acc)


def _signed(neg, p):
    """(X, Y, Z, T) with X and T negated where neg."""
    X, Y, Z, T = p
    return F.select(neg, F.neg(X), X), Y, Z, F.select(neg, F.neg(T), T)


def bucket_accumulate_plain(keys, offsets, points, nb: int, shift: int):
    """Plain twin of K2: the same adds in the same order."""
    pts = F.unpack_points(points)
    return _bucket_walk(
        keys, offsets, nb, shift,
        lambda w, pos, idx, neg: _signed(neg, tuple(c[:, idx] for c in pts)),
        lambda p: p, F.point_add)


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


def _row_coord(rows, w, pos, c: int):
    """Limbs of coordinate c of the gathered rows at (w, pos), (10, k)."""
    return field_words_to_limbs(rows[w, pos, 8 * c: 8 * c + 8].T)


def bucket_accumulate_words_plain(keys, offsets, rows, nb: int, shift: int):
    """Plain twin of K11: K2's adds on points decoded from word rows."""
    return _bucket_walk(
        keys, offsets, nb, shift,
        lambda w, pos, idx, neg: _signed(
            neg, tuple(_row_coord(rows, w, pos, c) for c in range(4))),
        lambda p: p, F.point_add)


def _affine_load(rows, w, pos, neg):
    """(x, y, xy) of the affine rows at (w, pos), x and xy negated where
    neg (K12's load)."""
    x, y = _row_coord(rows, w, pos, 0), _row_coord(rows, w, pos, 1)
    xy = F.mul(x, y)
    return F.select(neg, F.neg(x), x), y, F.select(neg, F.neg(xy), xy)


def madd_affine(acc, p):
    """acc + (x, y, 1, xy) by add-2008-hwcd-3 with Z2 = 1 (K12's add, the
    JAX package's _seq_scan_awords_kernel formula)."""
    X1, Y1, Z1, T1 = acc
    x, y, xy = p
    A = F.mul(F.sub(Y1, X1), F.sub(y, x))
    B = F.mul(F.add(Y1, X1), F.add(y, x))
    C = F.mul(F.mul(T1, F.const(EDWARDS_D2, T1)), xy)
    D = F.add(Z1, Z1)
    E, Fv, G, H = F.sub(B, A), F.sub(D, C), F.add(D, C), F.add(B, A)
    return F.mul(E, Fv), F.mul(G, H), F.mul(Fv, G), F.mul(E, H)


def bucket_accumulate_affine_plain(keys, offsets, rows, nb: int, shift: int):
    """Plain twin of K12: the same mixed adds in the same order."""
    return _bucket_walk(
        keys, offsets, nb, shift,
        lambda w, pos, idx, neg: _affine_load(rows, w, pos, neg),
        lambda p: (p[0], p[1], F.identity_like(p[0])[2], p[2]), madd_affine)


def _launch_rows_kernel(fn, name, keys, offsets, rows, nb, shift, words):
    nw, n = keys.shape
    _build.check_cuda(keys, torch.int64, (nw, n), f"{name} keys")
    _build.check_cuda(offsets, torch.int64, (nw, nb + 1), f"{name} offsets")
    _build.check_cuda(rows, torch.int32, (nw, n, words), f"{name} rows")
    out = torch.empty((4, F.NL, nw * nb), dtype=torch.int32,
                      device=keys.device)
    _build.launch(name, keys, offsets, rows, out, n, nw, nb, shift)
    fn.launches += 1
    return out


def bucket_accumulate_words(keys, offsets, rows, nb: int, shift: int):
    """As bucket_accumulate, from rows (nw, n, 32) int32: each window's
    canonical point words in sorted order (K10's output)."""
    if keys.device.type == "cpu":
        return bucket_accumulate_words_plain(keys, offsets, rows, nb, shift)
    return _launch_rows_kernel(bucket_accumulate_words,
                               "bucket_accumulate_words", keys, offsets, rows,
                               nb, shift, 32)


bucket_accumulate_words.launches = 0


def bucket_accumulate_affine(keys, offsets, rows, nb: int, shift: int):
    """As bucket_accumulate, from rows (nw, n, 16) int32: each window's
    affine (x, y) words in sorted order.  Equal to K2's sums as points."""
    if keys.device.type == "cpu":
        return bucket_accumulate_affine_plain(keys, offsets, rows, nb, shift)
    return _launch_rows_kernel(bucket_accumulate_affine,
                               "bucket_accumulate_affine", keys, offsets,
                               rows, nb, shift, 16)


bucket_accumulate_affine.launches = 0


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
def pack_keys(digits: torch.Tensor):
    """(n, nw) int32 signed digits -> (keys (nw, n) int64, index bits
    `shift`): key = |digit| << (shift + 1) | sign << shift | index.  The
    index is ascending along each row, so a stable sort by the (|digit|,
    sign) bits alone (K9, sort_keys) orders the keys as a full sort does."""
    n = digits.shape[0]
    shift = max(n - 1, 1).bit_length()
    d = digits.T.to(torch.int64)
    keys = ((d.abs() << (shift + 1)) | ((d < 0).to(torch.int64) << shift)
            | torch.arange(n, device=digits.device))
    return keys.contiguous(), shift


def sort_keys(digits: torch.Tensor, nb: int, radix: bool = False):
    """(n, nw) int32 signed digits -> (sorted keys (nw, n) int64, run offsets
    (nw, nb + 1) int64, index bits).  Zero digits sort first and belong to
    no bucket.  radix sorts with K9 instead of torch.sort, by the bits
    above the index only: |digit| <= nb takes nb.bit_length() bits, over
    the sign bit.  The result is the same tensor (pack_keys)."""
    nw = digits.shape[1]
    keys, shift = pack_keys(digits)
    keys = (radix_sort(keys, shift, shift + 1 + nb.bit_length()) if radix
            else torch.sort(keys, dim=1).values.contiguous())
    bounds = (torch.arange(1, nb + 2, device=digits.device) << (shift + 1))
    offsets = torch.searchsorted(keys, bounds.expand(nw, nb + 1).contiguous())
    return keys, offsets, shift


def point_rows(points: torch.Tensor) -> torch.Tensor:
    """(4, 10, n) int32 limbs -> (n, 32) int32 canonical words, one row of
    X, Y, Z, T per point (the JAX package's encode_words_lm(normalize_lm))."""
    n = points.shape[2]
    return points_to_words(points).permute(2, 0, 1).reshape(n, 32).contiguous()


def to_affine_words(points: torch.Tensor) -> torch.Tensor:
    """(4, 10, n) int32 limbs, Z nonzero -> (n, 16) int32 canonical words of
    the affine x = X/Z, y = Y/Z, one row per point (the JAX package's
    pallas_msm.to_affine_words, which returns (16, n) planes): one batch
    inversion, about 6n multiplications, in torch ops."""
    X, Y, Z, _ = F.unpack_points(points)
    zinv = F.batch_invert(Z)
    return torch.cat([limbs_to_field_words(F.mul(X, zinv)),
                      limbs_to_field_words(F.mul(Y, zinv))]).T.contiguous()


def window_totals_large(points: torch.Tensor, digits: torch.Tensor,
                        wbits: int, config: MsmConfig | None = None
                        ) -> torch.Tensor:
    """The bucket pipeline: sort, bucket sums by K2, K11 or K12, K3 (shapes
    as window_totals).  config None reads MsmConfig.from_env()."""
    config = MsmConfig.from_env() if config is None else config
    nb = 1 << (wbits - 1)
    keys, offsets, shift = sort_keys(digits, nb, config.sort)
    if config.gather:
        rows = gather_words(point_rows(points), keys & ((1 << shift) - 1))
        buckets = bucket_accumulate_words(keys, offsets, rows, nb, shift)
    elif config.affine:
        rows = gather_words(to_affine_words(points), keys & ((1 << shift) - 1))
        buckets = bucket_accumulate_affine(keys, offsets, rows, nb, shift)
    else:
        buckets = bucket_accumulate(keys, offsets, points, nb, shift)
    return bucket_fold(buckets, digits.shape[1], nb)


def _flat(pts: torch.Tensor) -> torch.Tensor:
    """(4, 10, ...) -> contiguous (4, 10, B), the kernels' layout."""
    return pts.reshape(4, F.NL, -1).contiguous()


def sorted_runs(points: torch.Tensor, digits: torch.Tensor, wbits: int):
    """The small route's scan input: (each window's points in sorted
    order, negated where the digit is negative, (4, 10, nw, n) int32;
    run-start flags (nw, n) int32, 1 where the digit's magnitude changes;
    the bucket run offsets (nw, nb + 1) of sort_keys)."""
    n, nw = digits.shape
    keys, offsets, shift = sort_keys(digits, 1 << (wbits - 1))
    pts = points[:, :, keys & ((1 << shift) - 1)]
    neg = ((keys >> shift) & 1) == 1
    for c in (0, 3):                                        # X and T
        v = pts[c].to(torch.int64)
        pts[c] = F.select(neg, F.neg(v), v).to(torch.int32)
    mag = keys >> (shift + 1)
    flags = torch.ones((nw, n), dtype=torch.int32, device=digits.device)
    flags[:, 1:] = (mag[:, 1:] != mag[:, :-1]).to(torch.int32)
    return pts, flags, offsets


def window_totals_small(points: torch.Tensor, digits: torch.Tensor,
                        wbits: int) -> torch.Tensor:
    """The associative-scan route: the same totals as the JAX package's
    pallas_msm._bucket_totals, from a Hillis-Steele segmented scan (K5)
    and a suffix-sum fold (K6); shapes as window_totals."""
    if points.device.type != "cpu":
        _build.check_cuda(points, torch.int32, (4, F.NL, None),
                          "window_totals_small points")
    n, nw = digits.shape
    nb = 1 << (wbits - 1)
    pts, flags, offsets = sorted_runs(points, digits, wbits)

    # inclusive scan of each run (x_i <- x_(i-d) (+) x_i for i >= d); after
    # the step with offset d every run of up to 2d points is summed, so the
    # scan stops at the longest bucket run (the zero digits' run is unread)
    longest = int((offsets[:, 1:] - offsets[:, :-1]).max())
    d = 1
    while d < longest:
        out = seg_combine(_flat(pts[..., :n - d]), _flat(pts[..., d:]),
                          flags[:, d:].reshape(-1).contiguous())
        pts = torch.cat([pts[..., :d], out.view(4, F.NL, nw, n - d)], dim=-1)
        flags = torch.cat([flags[:, :d], flags[:, d:] | flags[:, :n - d]],
                          dim=1)
        d *= 2

    # bucket b (magnitude b + 1) is the scan's value at the end of its run
    ends = offsets[:, 1:]
    last = (ends - 1).clamp(min=0).expand(4, F.NL, nw, nb)
    ident = torch.zeros((4, F.NL, 1, 1), dtype=torch.int32,
                        device=digits.device)
    ident[1, 0] = ident[2, 0] = 1
    sums = torch.where(ends > offsets[:, :-1], pts.gather(3, last), ident)

    # Σ_b (b + 1) · B_b = Σ_b S_b over the suffix sums S_b = Σ_(j >= b) B_j
    d = 1
    while d < nb:
        head = point_add(_flat(sums[..., :nb - d]), _flat(sums[..., d:]))
        sums = torch.cat([head.view(4, F.NL, nw, nb - d), sums[..., nb - d:]],
                         dim=-1)
        d *= 2
    m = nb
    while m > 1:
        m //= 2
        sums = point_add(_flat(sums[..., :m]), _flat(sums[..., m:2 * m])
                         ).view(4, F.NL, nw, m)
    return sums[..., 0].contiguous()


def window_totals(points: torch.Tensor, digits: torch.Tensor, wbits: int,
                  config: MsmConfig | None = None):
    """points (4, 10, n) int32, digits (n, nw) int32 signed radix-2^wbits
    with |digit| <= 2^(wbits-1) -> window totals (4, 10, nw) int32, where
    total_w = Σ_i digit[i, w] · P_i.  MSMs of n <= SMALL_MSM_MAX points take
    the small route, larger ones the bucket pipeline with `config`."""
    if route(digits.shape[0]) == "small":
        return window_totals_small(points, digits, wbits)
    return window_totals_large(points, digits, wbits, config)
