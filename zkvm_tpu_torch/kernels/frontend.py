"""The MSM frontend on canonical words.

Counterparts of the JAX package's pallas_msm.pack_words,
window_totals_from_words and combine_window_totals: the host packs 128
bytes of canonical words per point and 32 per scalar, the card decodes
them to limbs and signed digits and runs window_totals, and the host
combines the window totals (or K4 does, kernels/combine.py).  The port
takes n points exactly: the JAX package's padding to a power of two or a
multiple of its 4,096-point tile keeps its XLA compiles shared, which
PyTorch does not need.
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle import edwards
from . import scalarmod as sm
from .msm import MsmConfig, window_totals
from .words import point_words, points_to_ints, words_to_points


def pack_words(points, scalars) -> tuple[np.ndarray, np.ndarray]:
    """Points (each a (4, 8) uint32 word array or an extended point) and
    scalars (ints below 2^256, or a ScalarVec, whose buffer is used as it
    is) -> (point words (4, 8, n), scalar words (8, n)), uint32."""
    n = len(points)
    pw = np.empty((n, 4, 8), np.uint32)
    for i, ep in enumerate(points):
        pw[i] = ep if isinstance(ep, np.ndarray) else point_words(ep)
    if hasattr(scalars, "buf"):
        blob = scalars.buf
    else:
        blob = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    if len(blob) != 32 * n:
        raise ValueError("one scalar per point")
    sw = np.frombuffer(blob, np.uint32).reshape(n, 8)
    return (np.ascontiguousarray(pw.transpose(1, 2, 0)),
            np.ascontiguousarray(sw.T))


def window_totals_from_words(point_words: torch.Tensor,
                             scalar_words: torch.Tensor, wbits: int,
                             config: MsmConfig | None = None) -> torch.Tensor:
    """point_words (4, 8, n) and scalar_words (8, n), int32 bit patterns of
    u32 words on one device -> window totals (4, 10, nw) int32."""
    points = words_to_points(point_words)
    digits = sm.signed_digits(sm.decode_words_first(scalar_words), wbits)
    return window_totals(points, digits, wbits, config)


def combine_window_totals(totals: torch.Tensor, wbits: int):
    """Window totals (4, 10, nw) -> the extended point Σ_w 2^(w wbits) T_w,
    by Horner's rule on the host with the oracle's exact doubling chain."""
    pts = points_to_ints(totals)
    acc = pts[-1]
    for w in range(len(pts) - 2, -1, -1):
        for _ in range(wbits):
            acc = edwards.double(acc)
        acc = edwards.add(acc, pts[w])
    return acc
