"""K9 bitonic_sort: ascending per-row sort of the MSM's packed keys.

Replaces the JAX package's pallas_msm.py::_bitonic_kernel (sort_rows_device),
the stage that ZKVM_MSM_SORT=pallas selects there and MsmConfig.sort here
(kernels/msm.py).  The CUDA kernel is csrc/bitonic_sort.cu;
bitonic_sort_plain is the same network in PyTorch ops.  Rows pad to the
next power of two with INT64_MAX, which sorts to the tail and is sliced
off, as sort_rows_device pads with INT32_MAX.  The MSM's keys are unique
(their low bits are the point index), so any correct sort gives the same
tensor as torch.sort.
"""

from __future__ import annotations

import torch

from . import _build

INT64_MAX = (1 << 63) - 1


def _padded(keys: torch.Tensor) -> torch.Tensor:
    """keys in the first n columns of (R, 2^ceil(log2 n)), INT64_MAX after."""
    R, n = keys.shape
    buf = torch.full((R, 1 << max(n - 1, 1).bit_length()), INT64_MAX,
                     dtype=torch.int64, device=keys.device)
    buf[:, :n] = keys
    return buf


def bitonic_sort_plain(keys: torch.Tensor) -> torch.Tensor:
    """The kernel's network in torch ops: every (size, stride) stage is one
    vectorized compare-exchange of the pairs (i, i + stride), ascending
    where (i & size) == 0."""
    R, n = keys.shape
    x = _padded(keys)
    npad = x.shape[1]
    size = 2
    while size <= npad:
        stride = size // 2
        while stride >= 1:
            v = x.view(R, npad // (2 * stride), 2, stride)
            lo, hi = v[:, :, 0], v[:, :, 1]
            first = torch.arange(npad // (2 * stride), device=x.device) * (
                2 * stride)
            asc = ((first & size) == 0).view(1, -1, 1)
            mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
            x = torch.stack([torch.where(asc, mn, mx), torch.where(asc, mx, mn)],
                            dim=2).view(R, npad)
            stride //= 2
        size *= 2
    return x[:, :n].contiguous()


def bitonic_sort(keys: torch.Tensor) -> torch.Tensor:
    """(R, n) int64 -> each row sorted ascending, (R, n) int64."""
    if keys.device.type == "cpu":
        return bitonic_sort_plain(keys)
    _build.check_cuda(keys, torch.int64, (None, None), "bitonic_sort keys")
    R, n = keys.shape
    buf = _padded(keys)
    _build.launch("bitonic_sort", buf, R, buf.shape[1])
    bitonic_sort.launches += 1
    return buf[:, :n].contiguous()


bitonic_sort.launches = 0
