"""K17 fixed_base_ct: constant-time fixed-base multiplication on the card.

Replaces the reference's native fixed-base tables (zkvm_tpu/native/
edwards255.cpp:462-514: ed_fixed_init, ed_fixed_mul,
ed_fixed_commit_batch), which keep basepoint_mul, commit and commit_batch
constant-time in the secret scalar.  The CUDA kernels are
csrc/fixed_base.cu: a set-up entry (table) that builds a base's radix-16
table on the card, and the batch entry (fixed_base_ct) that computes
v_i·P + b_i·Q, or v_i·P alone, with SPLIT = 64 groups of four lanes an
output, each adding the masked picks of its one window (the window's row
read whole and picked by mask, csrc/ct_select.cuh; the digits recoded from
the canonical scalars' words on the card), then a fixed tree of six levels
over the 64 partial sums.

The plain twins (table_plain, fixed_base_plain, select_cached,
add_cached_lazy, radix16_plain) run the kernels' field operations in the
kernels' order, with torch.where in place of the masked moves, so the
card's limbs equal theirs bit for bit; their dispatched operations do not depend on the
scalars either.  A wrapper takes its twin only for CPU tensors; on a CUDA
tensor it launches or raises.
"""

from __future__ import annotations

import torch

from . import _build
from . import field as F
from .combine import add_cached, cached

WINDOWS = 64      # signed radix-16 digits a scalar (scalarmod at w = 4)
ENTRIES = 8       # (k + 1)·16^w·P, k = 0..7
WBITS = 4
SPLIT = 64        # groups an output (csrc/fixed_base.cu kSplit)


def cached_identity(like: torch.Tensor):
    """The identity's cached form (Y - X, Y + X, 2d T, 2 Z) = (1, 1, 0, 2),
    four limb tensors shaped like `like`."""
    zero = torch.zeros_like(like)
    one, two = zero.clone(), zero.clone()
    one[0], two[0] = 1, 2
    return one, one.clone(), zero, two


def radix16_plain(words: torch.Tensor) -> torch.Tensor:
    """(8, n) int32 words of canonical scalars -> (n, 64) int32 signed
    radix-16 digits, least significant first, as ct_select.cuh's
    radix16_next makes them (the reference's to_radix_16): nibble plus
    carry v, carry (v + 8) >> 4, digit v - 16 carry."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    carry = torch.zeros_like(w[0])
    out = []
    for i in range(WINDOWS):
        v = ((w[i // 8] >> (4 * (i % 8))) & 15) + carry
        carry = (v + 8) >> 4
        out.append(v - (carry << 4))
    return torch.stack(out, dim=-1).to(torch.int32)


def select_cached(row: torch.Tensor, digits: torch.Tensor):
    """ct_select.cuh's lane_select_signed: row (4, 10, ..., 8) int64, the
    cached coordinates of entry k = (k + 1)·P, digits (...) in [-8, 8] ->
    the cached form of digit·P, four (10, ...) tensors: every entry picked
    by mask, then negated by mask, (Y + X, Y - X, -2d T, 2 Z), -2d T limb
    by limb with no carry pass."""
    sign, mag = digits < 0, digits.abs()
    r = torch.stack(cached_identity(torch.zeros(
        (F.NL,) + digits.shape, dtype=torch.int64, device=digits.device)))
    for k in range(ENTRIES):
        r = torch.where(mag == k + 1, row[..., k], r)
    flipped = torch.stack((r[1], r[0], -r[2], r[3]))
    return tuple(torch.where(sign, flipped, r).unbind(0))


def add_cached_lazy(p, q):
    """lanes.cuh's lane_add_lazy: combine.add_cached with its sums and
    differences left uncarried, each within fe_mul's input bound."""
    X1, Y1, Z1, T1 = p
    A = F.mul(Y1 - X1, q[0])
    B = F.mul(Y1 + X1, q[1])
    C = F.mul(T1, q[2])
    D = F.mul(Z1, q[3])
    E, Fv, G, H = B - A, D - C, D + C, B + A
    return F.mul(E, Fv), F.mul(G, H), F.mul(Fv, G), F.mul(E, H)


def table_plain(point: torch.Tensor) -> torch.Tensor:
    """(4, 10, 1) int32 point -> (64, 8, 4, 10) int32: entry k of window w
    the cached form of (k + 1)·16^w·P, as fixed_base_table_kernel builds
    it (p + k·p by cached additions, then four doublings to the next
    window's p).  The doubling chain comes first here and the windows'
    entries after it, all windows at once: the same operations on the same
    values."""
    p = F.unpack_points(point)
    ps = []
    for _ in range(WINDOWS):
        ps.append(p)
        for _ in range(4):
            p = F.point_double(p)
    p = tuple(torch.cat([q[c] for q in ps], dim=1) for c in range(4))
    cp = cached(p)
    mine, entries = p, [cp]
    for _ in range(1, ENTRIES):
        mine = add_cached(mine, cp)
        entries.append(cached(mine))
    # entries[k][c]: (10, 64) -> (64, 8, 4, 10)
    return torch.stack([torch.stack(e) for e in entries]).permute(
        3, 0, 1, 2).to(torch.int32).contiguous()


def _rows(table: torch.Tensor) -> torch.Tensor:
    """(64, 8, 4, 10) int32 -> (4, 10, 64, 8) int64 coordinates."""
    return table.permute(2, 3, 0, 1).to(torch.int64)


def fixed_base_plain(tab_p: torch.Tensor, words_p: torch.Tensor,
                     tab_q: torch.Tensor | None = None,
                     words_q: torch.Tensor | None = None) -> torch.Tensor:
    """As fixed_base_kernel: group w of an output, from the identity, adds
    the select of P's row w by v's digit w, then Q's by b's; then the 64
    partial sums pairwise, part[2p] + part[2p + 1], until one is left ->
    (4, 10, n) int32.  Every group and every output at once: one or two
    selects and additions, then six tree levels."""
    n = words_p.shape[1]
    acc = F.identity_like(torch.zeros((F.NL, n, SPLIT), dtype=torch.int64,
                                      device=words_p.device))
    bases = [(_rows(tab_p), radix16_plain(words_p))]
    if tab_q is not None:
        bases.append((_rows(tab_q), radix16_plain(words_q)))
    for rows, d in bases:
        acc = add_cached_lazy(acc, select_cached(rows[:, :, None], d))
    while acc[0].shape[-1] > 1:
        acc = add_cached_lazy(tuple(c[..., 0::2] for c in acc),
                              cached(tuple(c[..., 1::2] for c in acc)))
    return F.pack_points(tuple(c[..., 0] for c in acc))


def table(point: torch.Tensor) -> torch.Tensor:
    """(4, 10, 1) int32 base -> its (64, 8, 4, 10) int32 radix-16 table,
    built on the point's device (the set-up entry of csrc/fixed_base.cu)."""
    if point.device.type == "cpu":
        return table_plain(point)
    _build.check_cuda(point, torch.int32, (4, F.NL, 1), "fixed_base point")
    out = torch.empty((WINDOWS, ENTRIES, 4, F.NL), dtype=torch.int32,
                      device=point.device)
    _build.launch("fixed_base_table", point, out)
    return out


def fixed_base_ct(tab_p: torch.Tensor, words_p: torch.Tensor,
                  tab_q: torch.Tensor | None = None,
                  words_q: torch.Tensor | None = None) -> torch.Tensor:
    """v_i·P + b_i·Q (or v_i·P without Q) for canonical scalars v (words_p)
    and b (words_q), (8, n) int32 little-endian words each, over the
    tables of P and Q -> (4, 10, n) int32 points, one launch,
    constant-time in the scalars."""
    if (tab_q is None) != (words_q is None):
        raise ValueError("fixed_base_ct: Q's table and scalars go together")
    if words_p.device.type == "cpu":
        return fixed_base_plain(tab_p, words_p, tab_q, words_q)
    shape = (WINDOWS, ENTRIES, 4, F.NL)
    _build.check_cuda(tab_p, torch.int32, shape, "fixed_base P table")
    _build.check_cuda(words_p, torch.int32, (8, None), "fixed_base v words")
    n = words_p.shape[1]
    if tab_q is not None:
        _build.check_cuda(tab_q, torch.int32, shape, "fixed_base Q table")
        _build.check_cuda(words_q, torch.int32, (8, n), "fixed_base b words")
    out = torch.empty((4, F.NL, n), dtype=torch.int32,
                      device=words_p.device)
    two = tab_q is not None
    _build.launch("fixed_base", tab_p, tab_q if two else tab_p, words_p,
                  words_q if two else words_p, out, n, 2 if two else 1)
    _build.count(fixed_base_ct)
    return out


fixed_base_ct.launches = 0
