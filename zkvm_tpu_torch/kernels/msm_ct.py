"""K18 msm_ct: constant-time multiscalar multiplication on the card.

Replaces the reference's native constant-time Straus MSM (ed_msm with
ct = 1, zkvm_tpu/native/edwards255.cpp:287) and its range-proof A
commitment (ed_bit_commit, :413-460): the prover's MSMs over secret
scalars.  The CUDA kernel is csrc/msm_ct.cu, a fixed-window ladder with
full-table selects and no sort: per point a table of 1·P .. 8·P in
cached form, 64 signed radix-16 digits a scalar (recoded on the card
from its canonical words), per group and window the sum of each point's
masked pick, in chunks of up to CHUNK points (one block each, tables in
shared memory; a chunk runs its count rounded up to SLOT_STEP slots) and
then a fixed tree of FANIN rows a segment over the chunks.  Its output is
every group's 64 window totals, which K4 (combine.horner_fold at w = 4)
folds.

plan() lays the chunks and the tree from the groups' sizes alone, which
are public; nothing of the schedule reads a digit.  The wrapper keeps each
plan's segment table on the device by its tuple of sizes (device_plan),
so a repeated shape makes no plan and no upload.  msm_ct_plain runs the
kernel's field operations in the kernel's order (torch.where in place of
its masked moves; a chunk's slots past its count pick the identity), so
the card's limbs equal the twin's bit for bit, and its dispatched
operations are the same for any scalars.  The wrapper takes the twin only
for CPU tensors; on a CUDA tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build
from . import field as F
from .combine import add_cached, cached
from .fixed_base import (ENTRIES, WINDOWS, add_cached_lazy, radix16_plain,
                         select_cached)

# copies of csrc/msm_ct.cu's kChunk (points a chunk, one table a group of
# four lanes) and kSlotStep (a chunk runs its count rounded up to a
# multiple of it), and the tree's rows a segment, which plan() sets
CHUNK = 32
SLOT_STEP = 8
FANIN = 16

# (device, sizes) -> (segment table on the device, level rows as a ctypes
# array, the levels); emptied when it holds _PLANS_MAX
_PLANS: dict = {}
_PLANS_MAX = 256
_PLANS_LOCK = threading.Lock()


def plan(sizes) -> list[tuple[np.ndarray, np.ndarray]]:
    """Groups of `sizes` points (each > 0, concatenated in order) -> the
    levels of the schedule, [(start, count)] int32 arrays: level 0 the
    chunks (start a point index), each later level the tree's segments
    over the rows of the level before, until one row a group."""
    starts, counts, rows = [], [], []
    at = 0
    for n in sizes:
        k = -(-n // CHUNK)
        starts += [at + CHUNK * c for c in range(k)]
        counts += [min(CHUNK, n - CHUNK * c) for c in range(k)]
        rows.append(k)
        at += n
    levels = [(np.array(starts, np.int32), np.array(counts, np.int32))]
    while any(k > 1 for k in rows):
        starts, counts, nxt, at = [], [], [], 0
        for k in rows:
            m = -(-k // FANIN)
            starts += [at + FANIN * c for c in range(m)]
            counts += [min(FANIN, k - FANIN * c) for c in range(m)]
            nxt.append(m)
            at += k
        levels.append((np.array(starts, np.int32), np.array(counts, np.int32)))
        rows = nxt
    return levels


def scratch_len(levels) -> int:
    """int32 elements of the rows below the last level."""
    return sum(len(s) * WINDOWS * 4 * F.NL for s, _ in levels[:-1])


def slots(count):
    """A chunk's slots: its count rounded up to SLOT_STEP."""
    return -(-count // SLOT_STEP) * SLOT_STEP


def device_plan(sizes: tuple, device):
    """(segment table, level rows, levels) of plan(sizes) as the C entry
    takes them, made and uploaded at the first call with these sizes on
    `device`, then kept."""
    key = (str(device), sizes)
    with _PLANS_LOCK:
        got = _PLANS.get(key)
        if got is None:
            levels = plan(sizes)
            segs = torch.from_numpy(np.concatenate(
                [a for lv in levels for a in lv])).to(device)
            rows = (ctypes.c_int64 * len(levels))(*(len(s) for s, _ in levels))
            if len(_PLANS) >= _PLANS_MAX:
                _PLANS.clear()
            got = _PLANS[key] = (segs, rows, levels)
    return got


def point_tables_plain(pts) -> torch.Tensor:
    """Four (10, n) int64 coordinates -> (4, 10, n, 8) int64, the cached
    forms of 1·P .. 8·P, as the chunk kernel builds them."""
    cp = cached(pts)
    mine, entries = pts, [cp]
    for _ in range(1, ENTRIES):
        mine = add_cached_lazy(mine, cp)
        entries.append(cached(mine))
    return torch.stack([torch.stack(e) for e in entries], dim=-1)


def msm_ct_plain(points: torch.Tensor, words: torch.Tensor,
                 sizes) -> torch.Tensor:
    """As csrc/msm_ct.cu: (4, 10, N) int32 points, (8, N) int32 words of
    canonical scalars, groups of `sizes` -> (4, 10, G, 64) int32 window
    totals."""
    digits = radix16_plain(words)
    levels = plan(sizes)
    dev = points.device
    start, count = (torch.from_numpy(a).to(dev, torch.int64)
                    for a in levels[0])
    runs = slots(count)                                  # (chunks,)
    slot = torch.arange(int(runs.max()), device=dev)
    live = slot < count[:, None]                         # (chunks, slots)
    idx = start[:, None] + torch.minimum(slot, count[:, None] - 1)
    tabs = point_tables_plain(F.unpack_points(points))[:, :, idx]
    # (4, 10, chunks, slots, 8)
    dg = torch.where(live[..., None], digits[idx].to(torch.int64), 0)
    acc = F.identity_like(torch.zeros(
        (F.NL, idx.shape[0], WINDOWS), dtype=torch.int64, device=dev))
    for s in range(slot.shape[0]):
        nxt = add_cached_lazy(acc, select_cached(tabs[:, :, :, s:s + 1],
                                                 dg[:, s, :]))
        take = s < runs
        acc = tuple(torch.where(take[None, :, None], a, b)
                    for a, b in zip(nxt, acc))
    for lv in levels[1:]:
        start, count = (torch.from_numpy(a).to(dev, torch.int64) for a in lv)
        rows = acc
        acc = tuple(c[:, start] for c in rows)
        for k in range(1, int(count.max())):
            q = tuple(c[:, start + torch.clamp(count - 1, max=k)]
                      for c in rows)
            nxt = add_cached(acc, cached(q))
            take = k < count
            acc = tuple(torch.where(take[None, :, None], a, b)
                        for a, b in zip(nxt, acc))
    return F.pack_points(acc)


def msm_ct(points: torch.Tensor, words: torch.Tensor,
           sizes) -> torch.Tensor:
    """The window totals of Σ_i s_i·P_i for each group of `sizes`
    (consecutive columns of points (4, 10, N) int32 and of the canonical
    scalars' little-endian words (8, N) int32) -> (4, 10, G, 64) int32 in
    radix 16, constant-time in the scalars.  The kernel's int32 scratch
    holds scratch_len(plan(sizes)) elements; it refuses a shorter one."""
    sizes = [int(n) for n in sizes]
    if not sizes or min(sizes) <= 0 or sum(sizes) != points.shape[2]:
        raise ValueError("msm_ct: groups of one point or more, covering "
                         "every point")
    if points.device.type == "cpu":
        return msm_ct_plain(points, words, sizes)
    N = points.shape[2]
    _build.check_cuda(points, torch.int32, (4, F.NL, N), "msm_ct points")
    _build.check_cuda(words, torch.int32, (8, N), "msm_ct scalar words")
    segs, rows, levels = device_plan(tuple(sizes), points.device)
    scratch = torch.empty((max(scratch_len(levels), 1),),
                          dtype=torch.int32, device=points.device)
    out = torch.empty((4, F.NL, len(sizes), WINDOWS), dtype=torch.int32,
                      device=points.device)
    _build.launch("msm_ct", points, words, segs, ctypes.addressof(rows),
                  len(levels), scratch, scratch.numel(), out, N)
    _build.count(msm_ct)
    return out


msm_ct.launches = 0
