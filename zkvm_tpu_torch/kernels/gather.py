"""K10 gather_words: the per-window permutation gather of point word rows.

Replaces both block shapes of the JAX package's pallas_msm.py::
gather_rows_words (ZKVM_MSM_GATHER=pallas there; MsmConfig.gather or
.affine here, kernels/msm.py).  The CUDA kernel is csrc/gather_words.cu;
gather_words_plain is the same gather as torch indexing.

Layout (a port choice): src is (n, S) int32, one row of S canonical u32
words per point (S = 32 for X, Y, Z, T; 16 for affine x, y), and the
output (nw, n, S) keeps one row per gathered point, so a bucket's run is
contiguous for K11/K12.  The JAX kernel takes (S, n) word planes and
writes (nw, S, n).
"""

from __future__ import annotations

import torch

from . import _build


def gather_words_plain(src: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return src[perm]


def gather_words(src: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """src (n, S) int32 rows, S a multiple of 4, perm (nw, n) int64 indices
    into the rows -> (nw, n, S) int32 with out[w, j] = src[perm[w, j]]."""
    if src.device.type == "cpu":
        return gather_words_plain(src, perm)
    _build.check_cuda(src, torch.int32, (None, None), "gather_words src")
    S = src.shape[1]
    if S % 4:
        raise ValueError(f"gather_words src: rows of {S} words are not whole "
                         "16-byte quads")
    _build.check_cuda(perm, torch.int64, (None, None), "gather_words perm")
    out = torch.empty(perm.shape + (S,), dtype=torch.int32, device=src.device)
    _build.launch("gather_words", src, perm, out, perm.numel(), S // 4)
    _build.count(gather_words)
    return out


gather_words.launches = 0
