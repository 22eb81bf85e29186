"""K4 horner_check: window combine and Ristretto identity test.

Replaces the JAX package's pallas_msm.py::_horner_kernel and the identity
test of _combine_check_core.  The CUDA kernel is csrc/horner_check.cu;
horner_check_plain is the same chain in PyTorch ops.
"""

from __future__ import annotations

import torch

from . import _build
from . import field as F


def horner_fold_plain(totals: torch.Tensor, wbits: int):
    """(4, 10, C, nw) window totals -> the combined points, a tuple of four
    (10, C) int64 limb tensors: acc = T_{nw-1}; per lower window wbits
    doublings, then acc += T_w."""
    tot = F.unpack_points(totals)
    nw = totals.shape[-1]
    acc = tuple(c[..., nw - 1] for c in tot)
    for w in range(nw - 2, -1, -1):
        for _ in range(wbits):
            acc = F.point_double(acc)
        acc = F.point_add(acc, tuple(c[..., w] for c in tot))
    return acc


def horner_check_plain(totals: torch.Tensor, wbits: int) -> torch.Tensor:
    acc = horner_fold_plain(totals, wbits)
    return (F.is_zero(acc[0]) | F.is_zero(acc[1])).to(torch.int32)


def horner_check(totals: torch.Tensor, wbits: int) -> torch.Tensor:
    """(4, 10, C, nw) int32 window totals -> (C,) int32: 1 iff
    Σ_w 2^(w · wbits) T_w is the Ristretto identity (canonical X or Y zero)."""
    if totals.device.type == "cpu":
        return horner_check_plain(totals, wbits)
    _build.check_cuda(totals, torch.int32, (4, F.NL, None, None),
                      "horner_check totals")
    nchecks, nw = totals.shape[2], totals.shape[3]
    out = torch.empty((nchecks,), dtype=torch.int32, device=totals.device)
    _build.launch("horner_check", totals, out, nchecks, nw, wbits)
    horner_check.launches += 1
    return out


horner_check.launches = 0
