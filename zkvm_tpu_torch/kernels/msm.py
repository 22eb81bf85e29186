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
  2. K2 (csrc/bucket_accumulate.cu), or K11 or K12 (entries of the same
     source): every bucket's signed point sum.  K2 is load-balanced: a
     group of four lanes (one point coordinate each, csrc/lanes.cuh) adds
     a fixed chunk of ACCUMULATE_CHUNK sorted records, writes the runs
     that start and end inside it, and passes the pieces of runs that
     cross its edges on as a shorter sorted keyed sequence, which the same
     kernel reduces again (accumulate_levels: 6 levels at 17,538 points).
     Its records are points in cached form.  K2 makes them once per point
     and gathers them by index; K11 and K12 run the same levels with
     another first-level loader, which decodes a gathered row and forms
     its cached form as it reads it.  Their work does not depend on how
     the digits fall: equal digits cost what random ones do;
  3. K3 (csrc/bucket_fold.cu): each window's Σ_b b · B_b: blocks of up
     to FOLD_GROUPS four-lane groups over runs of at most FOLD_GROUPS ·
     FOLD_RUN buckets (nb / 256 blocks a window), then one block per
     window over its blocks' sums (fold_shape); one launch where a window
     is one block (nb <= 256).
The twins (bucket_accumulate_plain and its words and affine versions,
bucket_fold_plain) run the kernels' additions in the kernels' association,
vectorized, so that the card's results equal theirs bit for bit; the
three bucket-sum twins share one level loop (_accumulate_plain) and differ
in their loaders, as the kernels do.  K11's and K12's sums equal K2's as
points (other limbs: the same points decoded from canonical words).

window_totals_small, the small route (JAX _bucket_totals: an
associative_scan over seg_combine_lm, the buckets read at the run ends, a
suffix scan and a tree of point_add_lm), in two launches after the sort:
  2. K5s (csrc/small_scan.cu): every bucket sum, a cluster of
     SMALL_CLUSTER blocks per window (both shapes compile-time constants
     of the kernel).  Each of the window's SMALL_CLUSTER
     * SMALL_GROUPS groups of four lanes adds a chunk of consecutive sorted
     records (gathered and signed by the kernel) and writes the runs that
     end inside it; the pieces of runs that cross chunk edges meet in a
     segmented scan of the chunks' tails in the cluster's shared memory,
     whose depth the cluster finds on the card from its own window's runs;
  3. K3 (bucket_fold): each window's Σ_b b · B_b, one block of 32 groups
     of four buckets per window at nb = 128, one launch.
small_scan_plain runs K5s's additions in its association, vectorized.
The elementwise K5 and K6 (kernels/pointwise.py) stay as entry points.

The bucket pipeline's stages follow an MsmConfig, as the JAX package's
_bucket_totals_seq follows its environment switches (pallas_msm.py
:707-720, :1025-1032, :1059-1065); the small route ignores it:
  * default: torch.sort; K2 gathers each point's limbs itself;
  * sort (ZKVM_MSM_SORT=pallas): K9 (kernels/sort.py) sorts the keys;
  * gather (ZKVM_MSM_GATHER=pallas): the points are frozen to canonical
    words, K10 (kernels/gather.py) gathers them into sorted order, one
    row per point, and K11 decodes and signs them while it sums the
    buckets;
  * affine (ZKVM_MSM_AFFINE=1, only when gather is off): the points are
    normalized to affine words by one batch inversion (to_affine_words),
    K10 gathers those 16-word rows and K12 sums the buckets, each affine
    point read into cached form (y - x, y + x, 2d x y, 2).
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

import os
from dataclasses import dataclass

import torch

from ..constants import EDWARDS_D2
from . import _build
from . import field as F
from .combine import add_cached, cached
from .gather import gather_words
from .sort import radix_sort
from .words import field_words_to_limbs, limbs_to_field_words, points_to_words

# K2 records per worker (a group of four lanes) on its first level and on
# the later ones: the kernel's kChunk and kChunk1, which it is compiled
# with (K11 and K12 run the same levels).  These four size the scratch of
# K2, K11, K12 and K3; each C entry refuses a scratch shorter than its own
# constants need, and tests/test_torch_scratch_contract.py holds them
# equal to the .cu sources'.
ACCUMULATE_CHUNK = 32
ACCUMULATE_CHUNK1 = 8
FOLD_RUN = 8           # K3 buckets per group in its first pass
FOLD_GROUPS = 32       # K3 groups of four lanes per block
SMALL_MSM_MAX = 2048  # the largest MSM on the small route
# K5s's groups of four lanes a block and blocks (a thread-block cluster) per
# window: copies of small_scan.cu's kGroups and kCluster, which the twin
# follows
SMALL_GROUPS = 32
SMALL_CLUSTER = 4

# Choosing wbits on an H100.  The large route takes its width from a
# table: 11 up to 387,493 points.  chip_smoke.py's width sweep prints
# window_totals by width around 11 (the minimum and median of several
# timings) on the default configuration at 4,096, 17,538 and 69,762
# points; K2 and K3 do work there that does not depend on how the digits
# fall, and the widths 9 to 13 lie within a few per cent of each other.
# K11 and K12 run K2's levels too, so no configuration gives a bucket one
# thread any more: at 12 or 14 the top window holds no scalar bits and
# receives the carry out of the window below, putting half the points in
# bucket 1, which the one-thread-per-bucket accumulators of the first
# designs walked in a row (over 17,538 points window_totals took 1.5 ms
# at w = 11 against 66 ms at w = 12 with such an accumulator, on an H100
# SXM at 700 W); chip_smoke.py times K11 and K12 at w = 12 beside 11.
# Above 387,493 points the table keeps the choices of the first design's
# cost model (15, then 16 from 4,716,319 points), which are not measured
# on the card.
#
# The small route takes w = 8 (SMALL_WBITS): chip_smoke.py sweeps K5s + K3
# over w = 6 to 10 at 1,055, 1,282 and 2,048 points (PERF.md section 5).
SMALL_WBITS = 8
_LARGE_WIDTHS = ((387_493, 11), (4_716_318, 15))   # (up to n points, wbits)
_LARGE_WIDTH_ABOVE = 16


def route(n: int) -> str:
    """"small" for MSMs of n <= SMALL_MSM_MAX points, else "large"."""
    return "small" if n <= SMALL_MSM_MAX else "large"


def best_wbits(n: int) -> int:
    if route(n) == "small":
        return SMALL_WBITS
    return next((w for top, w in _LARGE_WIDTHS if n <= top),
                _LARGE_WIDTH_ABOVE)


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
def _signed(neg, p):
    """(X, Y, Z, T) with X and T negated where neg."""
    X, Y, Z, T = p
    return F.select(neg, F.neg(X), X), Y, Z, F.select(neg, F.neg(T), T)


def _signed_cached(neg, c):
    """-P's cached form where neg, from P's: (Y + X, Y - X, -2d T, 2 Z)."""
    return (F.select(neg, c[1], c[0]), F.select(neg, c[0], c[1]),
            F.select(neg, F.neg(c[2]), c[2]), c[3])


def _lane_add(p, q):
    """p + q as the lane-parallel kernels add (csrc/lanes.cuh lane_add_pt):
    q's cached form, then the cached addition."""
    return add_cached(p, cached(q))


def accumulate_levels(n: int, chunk: int = ACCUMULATE_CHUNK,
                      chunk1: int = ACCUMULATE_CHUNK1) -> list[int]:
    """K2's record counts per window, level by level: n sorted keys, then
    2 ceil(N / C) pieces after a level of N > C records, C = chunk on the
    first level and chunk1 after it (both at least 4, so that N falls)."""
    sizes = [n]
    while sizes[-1] > (chunk if len(sizes) == 1 else chunk1):
        c = chunk if len(sizes) == 1 else chunk1
        sizes.append(2 * -(-sizes[-1] // c))
    return sizes


def _level_scratch(nw: int, n: int, chunk: int, chunk1: int) -> int:
    """int32 words of the levels' scratch (K11's and K12's whole scratch):
    two buffers of 41 nw N (keys, then points) for levels 1 and 2, the
    later levels reusing them in turn."""
    sizes = accumulate_levels(n, chunk, chunk1) + [0, 0]
    return 41 * nw * (sizes[1] + sizes[2])


def _accumulate_scratch(nw: int, n: int, chunk: int, chunk1: int) -> int:
    """int32 words of K2's scratch: the points' cached forms (40 n), then
    the levels' buffers."""
    return 40 * n + _level_scratch(nw, n, chunk, chunk1)


def _limb_records(keys, points, shift: int):
    """K2's first-level loader: load(rows, rc) gives the cached forms of the
    points at sorted positions (rows, rc), -P's where the sign bit is set,
    gathered by index from every point's cached form, made once."""
    cpts = cached(F.unpack_points(points))

    def load(rows, rc):
        key = keys[rows, rc]
        return _signed_cached(((key >> shift) & 1) == 1,
                              tuple(x[:, key & ((1 << shift) - 1)]
                                    for x in cpts))
    return load


def _word_records(keys, rows_in, shift: int):
    """K11's: the points decoded from the gathered word rows (nw, n, 32)
    at (rows, rc), then their cached forms, signed."""
    def load(rows, rc):
        words = rows_in[rows, rc].permute(2, 0, 1)
        p = tuple(field_words_to_limbs(words[8 * c: 8 * c + 8])
                  for c in range(4))
        return _signed_cached(((keys[rows, rc] >> shift) & 1) == 1,
                              cached(p))
    return load


def _affine_records(keys, rows_in, shift: int):
    """K12's: the affine points (x, y) decoded from the gathered rows
    (nw, n, 16) at (rows, rc), in cached form (y - x, y + x, 2d (x y), 2),
    signed."""
    def load(rows, rc):
        words = rows_in[rows, rc].permute(2, 0, 1)
        x, y = field_words_to_limbs(words[:8]), field_words_to_limbs(words[8:])
        two = torch.zeros_like(x)
        two[0] = 2
        return _signed_cached(
            ((keys[rows, rc] >> shift) & 1) == 1,
            (F.sub(y, x), F.add(y, x),
             F.mul(F.mul(x, y), F.const(EDWARDS_D2, x)), two))
    return load


def _accumulate_plain(keys, nb: int, shift: int, load, chunk: int,
                      chunk1: int):
    """The bucket-sum kernels' levels (csrc/bucket_accumulate.cu),
    vectorized over every (window, chunk) worker, with the kernels'
    additions in their association; load is the first level's loader
    (_limb_records, _word_records, _affine_records).  A bucket no run
    reaches keeps the identity, as the kernels write it from offsets."""
    nw, n = keys.shape
    dev = keys.device
    out = [c.clone() for c in F.identity_like(
        torch.zeros((F.NL, nw * nb), dtype=torch.int64, device=dev))]
    rows = torch.arange(nw, device=dev).unsqueeze(1)
    rkey = keys >> (shift + 1)                    # the records' buckets
    N = n
    while True:
        K = -(-N // chunk)
        Nn = 2 * K if N > chunk else 0
        s = torch.arange(K, device=dev) * chunk
        e = (s + chunk).clamp(max=N)
        prev = torch.where(s > 0, rkey[:, (s - 1).clamp(min=0)], -1)
        nxt = torch.where(e < N, rkey[:, e.clamp(max=N - 1)], -1)
        ident = F.identity_like(torch.zeros((F.NL, nw, K), dtype=torch.int64,
                                            device=dev))
        c_ident = cached(ident)
        acc = first = ident
        before = torch.full((nw, K), -1, device=dev)
        run_start = s.expand(nw, K)
        lo = torch.zeros((nw, K), dtype=torch.int64, device=dev)
        hi = lo.clone()
        through = torch.zeros((nw, K), dtype=torch.bool, device=dev)
        for i in range(chunk):
            r = s + i
            valid = (r < e).expand(nw, K)
            rc = r.clamp(max=N - 1)
            kr = torch.where(valid, rkey[:, rc], -1)
            kn = torch.where(valid & (r + 1 < e), rkey[:, (r + 1).clamp(
                max=N - 1)], -1)
            real = kr > 0
            q = tuple(F.select(real, x, i_)
                      for x, i_ in zip(load(rows, rc), c_ident))
            restart = (kr != before) if i else torch.ones_like(valid)
            acc = add_cached(tuple(F.select(restart, i_, a)
                                   for i_, a in zip(ident, acc)), q)
            run_start = torch.where(restart, r, run_start)
            ends = real & ((r == e - 1) | (kn != kr))
            into = ends & (run_start == s) & (kr == prev)
            on = ends & (r == e - 1) & (kr == nxt)
            w_d, c_d = (ends & ~into & ~on).nonzero(as_tuple=True)
            for o, a in zip(out, acc):
                o[:, w_d * nb + kr[w_d, c_d] - 1] = a[:, w_d, c_d]
            first = tuple(F.select(into, a, f) for a, f in zip(acc, first))
            lo = torch.where(into, kr, lo)
            hi = torch.where(on, kr, hi)
            through = torch.where(on, into, through)
            before = kr
        if not Nn:
            return F.pack_points(out)
        c_first, c_last = cached(first), cached(acc)
        c_last = tuple(F.select(through, i_, x)
                       for i_, x in zip(c_ident, c_last))
        level_pts = tuple(torch.stack([a, b], dim=3).reshape(F.NL, nw, Nn)
                          for a, b in zip(c_first, c_last))
        rkey = torch.stack([lo, hi], dim=2).reshape(nw, Nn)

        def load(rows, rc, level_pts=level_pts):
            return tuple(x[:, rows, rc] for x in level_pts)
        N = Nn
        chunk = chunk1


def bucket_accumulate_plain(keys, offsets, points, nb: int, shift: int,
                            chunk: int = ACCUMULATE_CHUNK,
                            chunk1: int = ACCUMULATE_CHUNK1):
    """Plain twin of K2: the levels over the points' cached forms, gathered
    by index.  offsets are not read (nor by the other twins)."""
    return _accumulate_plain(keys, nb, shift,
                             _limb_records(keys, points, shift), chunk,
                             chunk1)


def bucket_accumulate_words_plain(keys, offsets, rows, nb: int, shift: int):
    """Plain twin of K11: K2's levels over points decoded from word rows."""
    return _accumulate_plain(keys, nb, shift, _word_records(keys, rows, shift),
                             ACCUMULATE_CHUNK, ACCUMULATE_CHUNK1)


def bucket_accumulate_affine_plain(keys, offsets, rows, nb: int, shift: int):
    """Plain twin of K12: K2's levels over affine points in cached form."""
    return _accumulate_plain(keys, nb, shift,
                             _affine_records(keys, rows, shift),
                             ACCUMULATE_CHUNK, ACCUMULATE_CHUNK1)


def _launch_accumulate(fn, name, keys, offsets, records, shape, scratch_len,
                       nb, shift):
    """One C call of a bucket-sum kernel (K2, K11 or K12) on CUDA tensors:
    records (K2's points or K10's rows) of `shape`, a scratch of
    scratch_len int32.  Counts on fn.launches."""
    nw, n = keys.shape
    _build.check_cuda(keys, torch.int64, (nw, n), f"{name} keys")
    _build.check_cuda(offsets, torch.int64, (nw, nb + 1), f"{name} offsets")
    _build.check_cuda(records, torch.int32, shape, f"{name} records")
    out = torch.empty((4, F.NL, nw * nb), dtype=torch.int32,
                      device=keys.device)
    scratch = torch.empty((scratch_len,), dtype=torch.int32,
                          device=keys.device)
    _build.launch(name, keys, offsets, records, out, scratch, scratch.numel(),
                  n, nw, nb, shift)
    fn.launches += 1
    return out


def bucket_accumulate(keys, offsets, points, nb: int, shift: int):
    """Sorted keys (nw, n) int64, offsets (nw, nb + 1) int64, points
    (4, 10, n) int32 -> bucket sums (4, 10, nw * nb) int32.  One call
    launches 1 + len(accumulate_levels(n)) kernels."""
    if keys.device.type == "cpu":
        return bucket_accumulate_plain(keys, offsets, points, nb, shift)
    nw, n = keys.shape
    return _launch_accumulate(
        bucket_accumulate, "bucket_accumulate", keys, offsets, points,
        (4, F.NL, n), _accumulate_scratch(nw, n, ACCUMULATE_CHUNK,
                                          ACCUMULATE_CHUNK1), nb, shift)


bucket_accumulate.launches = 0


def bucket_accumulate_words(keys, offsets, rows, nb: int, shift: int):
    """As bucket_accumulate, from rows (nw, n, 32) int32: each window's
    canonical point words in sorted order (K10's output).  One call
    launches len(accumulate_levels(n)) kernels."""
    if keys.device.type == "cpu":
        return bucket_accumulate_words_plain(keys, offsets, rows, nb, shift)
    nw, n = keys.shape
    return _launch_accumulate(
        bucket_accumulate_words, "bucket_accumulate_words", keys, offsets,
        rows, (nw, n, 32), _level_scratch(nw, n, ACCUMULATE_CHUNK,
                                          ACCUMULATE_CHUNK1), nb, shift)


bucket_accumulate_words.launches = 0


def bucket_accumulate_affine(keys, offsets, rows, nb: int, shift: int):
    """As bucket_accumulate, from rows (nw, n, 16) int32: each window's
    affine (x, y) words in sorted order.  Equal to K2's sums as points.
    One call launches len(accumulate_levels(n)) kernels."""
    if keys.device.type == "cpu":
        return bucket_accumulate_affine_plain(keys, offsets, rows, nb, shift)
    nw, n = keys.shape
    return _launch_accumulate(
        bucket_accumulate_affine, "bucket_accumulate_affine", keys, offsets,
        rows, (nw, n, 16), _level_scratch(nw, n, ACCUMULATE_CHUNK,
                                          ACCUMULATE_CHUNK1), nb, shift)


bucket_accumulate_affine.launches = 0


# ------------------------------------------------------------------ K3
def fold_shape(nb: int) -> tuple[int, int, int, int]:
    """K3's layout for nb buckets: (G groups of R = nb / FOLD_GROUPS
    (within 1 to FOLD_RUN) buckets per block, nblk blocks per window, G2
    groups of R2 blocks in the window pass, which runs only where nblk >
    1)."""
    R = min(FOLD_RUN, max(1, nb // FOLD_GROUPS))
    G = min(FOLD_GROUPS, nb // R)
    nblk = nb // (G * R)
    G2 = min(FOLD_GROUPS, nblk)
    return G, nblk, G2, nblk // G2


def _fold_scratch(nw: int, nb: int) -> int:
    """int32 words of K3's scratch `part`, (2, 4, 10, nw nblk): each
    first-pass block's T and W; none where nblk = 1."""
    nblk = fold_shape(nb)[1]
    return 2 * 4 * F.NL * nw * nblk if nblk > 1 else 0


def _block_combine(T, V, W, log2_r: int):
    """K3's block_combine over the groups on the last axis: (Σ_g T_g,
    Σ_g V_g + R Σ_(g>=1) SufT_g, Σ_g W_g), W None for none."""
    G = T[0].shape[-1]
    off = 1
    while off < G:                      # suffix scan over the groups
        head = _lane_add(tuple(c[..., :G - off] for c in T),
                         tuple(c[..., off:] for c in T))
        T = tuple(torch.cat([h, c[..., G - off:]], dim=-1)
                  for h, c in zip(head, T))
        off *= 2
    tsum = tuple(c[..., 0] for c in T)
    ident = F.identity_like(T[0][..., :1])
    U = tuple(torch.cat([i, c[..., 1:]], dim=-1) for i, c in zip(ident, T))
    half = G // 2
    while half >= 1:                    # tree sums over the groups
        U, V = (_lane_add(tuple(c[..., :half] for c in X),
                          tuple(c[..., half:2 * half] for c in X))
                for X in (U, V))
        if W is not None:
            W = _lane_add(tuple(c[..., :half] for c in W),
                          tuple(c[..., half:2 * half] for c in W))
        half //= 2
    u = tuple(c[..., 0] for c in U)
    for _ in range(log2_r):
        u = F.point_double(u)
    vout = _lane_add(tuple(c[..., 0] for c in V), u)
    return tsum, vout, None if W is None else tuple(c[..., 0] for c in W)


def bucket_fold_plain(buckets, nw: int, nb: int):
    """Plain twin of K3 (csrc/bucket_fold.cu): its two passes with the same
    additions in the same association, vectorized over windows, blocks and
    groups; nblk = 1 ends with the first."""
    G, nblk, G2, R2 = fold_shape(nb)
    R = nb // (G * nblk)
    B = [c.view(F.NL, nw, nblk, G, R) for c in F.unpack_points(buckets)]
    T = V = tuple(c[..., R - 1] for c in B)
    for r in range(R - 2, -1, -1):
        T = _lane_add(T, tuple(c[..., r] for c in B))
        V = _lane_add(V, T)
    tk, wk, _ = _block_combine(T, V, None, R.bit_length() - 1)
    if nblk == 1:
        return F.pack_points(tuple(c[..., 0] for c in wk))
    tk, wk = ([c.reshape(F.NL, nw, G2, R2) for c in X] for X in (tk, wk))
    T = V = W = F.identity_like(torch.zeros((F.NL, nw, G2),
                                            dtype=torch.int64,
                                            device=buckets.device))
    for r in range(R2 - 1, -1, -1):
        V = _lane_add(V, T)
        T = _lane_add(T, tuple(c[..., r] for c in tk))
        W = _lane_add(W, tuple(c[..., r] for c in wk))
    _, v, w = _block_combine(T, V, W, R2.bit_length() - 1)
    for _ in range((G * R).bit_length() - 1):
        v = F.point_double(v)
    return F.pack_points(_lane_add(w, v))


def bucket_fold(buckets, nw: int, nb: int):
    """Bucket sums (4, 10, nw * nb) int32 -> window totals (4, 10, nw).
    One call launches two kernels, one where nb <= 256; nb a power of two
    from 1 to 2^16 on the card."""
    if buckets.device.type == "cpu":
        return bucket_fold_plain(buckets, nw, nb)
    _build.check_cuda(buckets, torch.int32, (4, F.NL, nw * nb),
                      "bucket_fold buckets")
    part = torch.empty((_fold_scratch(nw, nb),), dtype=torch.int32,
                       device=buckets.device)
    out = torch.empty((4, F.NL, nw), dtype=torch.int32, device=buckets.device)
    _build.launch("bucket_fold", buckets, part, part.numel(), out, nw, nb)
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


# ------------------------------------------------------- the small route
def small_scan_plain(keys, points, nb: int, shift: int):
    """Plain twin of K5s (csrc/small_scan.cu): its chunks, its segmented
    scan of the chunks' tails and its heads, vectorized over every (window,
    group), with the kernel's additions in its association.  The kernel
    stops the scan once no chunk waits for a carry; the steps after that
    change no value, so the twin runs them all."""
    nw, n = keys.shape
    dev = keys.device
    out = [c.clone() for c in F.identity_like(
        torch.zeros((F.NL, nw * nb), dtype=torch.int64, device=dev))]
    if n == 0:
        return F.pack_points(out)
    G = SMALL_CLUSTER * SMALL_GROUPS        # chunks a window
    C = max(1, -(-n // G))                  # records a chunk
    pts = F.unpack_points(points)
    mag = keys >> (shift + 1)
    ident = F.identity_like(torch.zeros((F.NL, nw, G), dtype=torch.int64,
                                        device=dev))
    s = torch.arange(G, device=dev) * C
    e = (s + C).clamp(max=n)

    def at(t, r, ok):
        """t's columns at positions r (G,), -1 where not ok: (nw, G)."""
        return torch.where(ok, t[:, r.clamp(0, n - 1)], -1)

    def store(mask, keys_, val):
        w, g = mask.nonzero(as_tuple=True)
        for o, v in zip(out, val):
            o[:, w * nb + keys_[w, g] - 1] = v[:, w, g]

    before = at(mag, s - 1, (s > 0) & (s < n))
    acc = head = ident
    started = (s >= n).expand(nw, G)
    in_run = torch.ones((nw, G), dtype=torch.bool, device=dev)
    has_head = torch.zeros_like(in_run)
    head_key = torch.zeros((nw, G), dtype=torch.int64, device=dev)
    for i in range(C):                      # 1. each group's chunk, in order
        r = s + i
        valid = (r < e).expand(nw, G)
        kr = at(mag, r, r < e)
        kn = at(mag, r + 1, (r < e) & (r + 1 < n))
        key = keys[:, r.clamp(max=n - 1)]
        p = _signed(((key >> shift) & 1) == 1,
                    tuple(c[:, key & ((1 << shift) - 1)] for c in pts))
        q = cached(tuple(F.select(valid, a, b) for a, b in zip(p, ident)))
        restart = kr != before
        total = add_cached(tuple(F.select(restart, a, b)
                                 for a, b in zip(ident, acc)), q)
        acc = tuple(F.select(valid, a, b) for a, b in zip(total, acc))
        started = started | (valid & restart)
        in_run = in_run & ~(valid & restart)
        ends = valid & (kr > 0) & (kn != kr)
        store(ends & ~in_run, kr, acc)
        head = tuple(F.select(ends & in_run, a, h) for a, h in zip(acc, head))
        head_key = torch.where(ends & in_run, kr, head_key)
        has_head = has_head | (ends & in_run)
        before = kr

    X, f = acc, started                     # 2. the chunks' segmented scan
    g = torch.arange(G, device=dev)
    d = 1
    while d < G:
        src = torch.where(g >= d, g - d, g)
        total = _lane_add(tuple(c[..., src] for c in X), X)
        X = tuple(F.select((g >= d) & ~f, a, b) for a, b in zip(total, X))
        f = f | ((g >= d) & f[:, src])
        d *= 2
    carry = tuple(c[..., (g - 1).clamp(min=0)] for c in X)   # 3. heads
    store(has_head, head_key, _lane_add(carry, head))
    return F.pack_points(out)


def small_scan(keys, points, nb: int, shift: int):
    """Sorted keys (nw, n) int64 (pack_keys), points (4, 10, n) int32 ->
    bucket sums (4, 10, nw * nb) int32, bucket b of window w (magnitude
    b + 1) at w * nb + b, the identity where empty.  One launch of nw
    clusters of SMALL_CLUSTER blocks of SMALL_GROUPS groups of four
    lanes."""
    if keys.device.type == "cpu":
        return small_scan_plain(keys, points, nb, shift)
    nw, n = keys.shape
    _build.check_cuda(keys, torch.int64, (nw, n), "small_scan keys")
    _build.check_cuda(points, torch.int32, (4, F.NL, n), "small_scan points")
    out = torch.empty((4, F.NL, nw * nb), dtype=torch.int32,
                      device=keys.device)
    _build.launch("small_scan", keys, points, out, n, nw, nb, shift)
    small_scan.launches += 1
    return out


small_scan.launches = 0


def window_totals_small(points: torch.Tensor, digits: torch.Tensor,
                        wbits: int) -> torch.Tensor:
    """The small route: the same totals as the JAX package's
    pallas_msm._bucket_totals from K5s's bucket sums and K3's fold, two
    launches after the sort at w <= 9 (nb <= 256) and no read back to the
    host; shapes as window_totals."""
    nb = 1 << (wbits - 1)
    keys, shift = pack_keys(digits)
    keys = torch.sort(keys, dim=1).values.contiguous()
    return bucket_fold(small_scan(keys, points, nb, shift), digits.shape[1],
                       nb)


def window_totals(points: torch.Tensor, digits: torch.Tensor, wbits: int,
                  config: MsmConfig | None = None):
    """points (4, 10, n) int32, digits (n, nw) int32 signed radix-2^wbits
    with |digit| <= 2^(wbits-1) -> window totals (4, 10, nw) int32, where
    total_w = Σ_i digit[i, w] · P_i.  MSMs of n <= SMALL_MSM_MAX points take
    the small route, larger ones the bucket pipeline with `config`."""
    if route(digits.shape[0]) == "small":
        return window_totals_small(points, digits, wbits)
    return window_totals_large(points, digits, wbits, config)
