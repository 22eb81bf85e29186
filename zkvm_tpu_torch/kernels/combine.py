"""K4 horner_check: window combine and Ristretto identity test.

Replaces the JAX package's pallas_msm.py::_horner_kernel (horner_fold_device,
which returns the folded point) and the identity test of
_combine_check_core.  The CUDA kernel is csrc/horner_check.cu; it writes
both the folded point (horner_fold) and the verdict (horner_check).
horner_fold_plain is the same chain in PyTorch ops, with the kernel's
formulas: F.point_double, and an addition of each window total in cached
form (Y - X, Y + X, 2d T, 2 Z), which the kernel computes for every
window before the chain.
"""

from __future__ import annotations

import torch

from ..constants import EDWARDS_D2
from . import _build
from . import field as F


def cached(p):
    """(X, Y, Z, T) -> (Y - X, Y + X, 2d T, 2 Z), the addend's half of
    add-2008-hwcd-3 (a = -1, k = 2d)."""
    X, Y, Z, T = p
    return (F.sub(Y, X), F.add(Y, X), F.mul(T, F.const(EDWARDS_D2, T)),
            F.add(Z, Z))


def add_cached(p, q):
    """p + q for q in cached form: the same point as F.point_add(p, q), in
    the kernel's operations (C = T1 (2d T2) where point_add takes
    (T1 2d) T2)."""
    X1, Y1, Z1, T1 = p
    A, B, C, D = F.mul_many((F.sub(Y1, X1), F.add(Y1, X1), T1, Z1), q)
    E, Fv, G, H = F.sub(B, A), F.sub(D, C), F.add(D, C), F.add(B, A)
    return F.mul_many((E, G, Fv, E), (Fv, H, G, H))


def horner_fold_plain(totals: torch.Tensor, wbits: int):
    """(4, 10, C, nw) window totals -> the combined points, a tuple of four
    (10, C) int64 limb tensors: acc = T_{nw-1}; per lower window wbits
    doublings, then acc += T_w."""
    tot = F.unpack_points(totals)
    nw = totals.shape[-1]
    q = cached(tot)
    acc = tuple(c[..., nw - 1] for c in tot)
    for w in range(nw - 2, -1, -1):
        for _ in range(wbits):
            acc = F.point_double(acc)
        acc = add_cached(acc, tuple(c[..., w] for c in q))
    return acc


def horner_check_plain(totals: torch.Tensor, wbits: int) -> torch.Tensor:
    acc = horner_fold_plain(totals, wbits)
    return (F.is_zero(acc[0]) | F.is_zero(acc[1])).to(torch.int32)


def _launch(totals: torch.Tensor, wbits: int):
    """K4 on a CUDA tensor -> (folded points (4, 10, C) int32, verdicts
    (C,) int32).  Counts on horner_check.launches, whichever wrapper asks."""
    _build.check_cuda(totals, torch.int32, (4, F.NL, None, None),
                      "horner_check totals")
    nchecks, nw = totals.shape[2], totals.shape[3]
    folded = torch.empty((4, F.NL, nchecks), dtype=torch.int32,
                         device=totals.device)
    out = torch.empty((nchecks,), dtype=torch.int32, device=totals.device)
    _build.launch("horner_check", totals, folded, out, nchecks, nw, wbits)
    _build.count(horner_check)
    return folded, out


def horner_fold(totals: torch.Tensor, wbits: int) -> torch.Tensor:
    """(4, 10, C, nw) int32 window totals -> (4, 10, C) int32 carried limbs
    of Σ_w 2^(w · wbits) T_w (the JAX package's horner_fold_device)."""
    if totals.device.type == "cpu":
        return F.pack_points(horner_fold_plain(totals, wbits))
    return _launch(totals, wbits)[0]


def horner_check(totals: torch.Tensor, wbits: int) -> torch.Tensor:
    """(4, 10, C, nw) int32 window totals -> (C,) int32: 1 iff
    Σ_w 2^(w · wbits) T_w is the Ristretto identity (canonical X or Y zero)."""
    if totals.device.type == "cpu":
        return horner_check_plain(totals, wbits)
    return _launch(totals, wbits)[1]


horner_check.launches = 0
