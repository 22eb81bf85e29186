"""K9 radix_sort: stable per-row sort of the MSM's packed keys by a range
of their bits.

Replaces the JAX package's pallas_msm.py::_bitonic_kernel (sort_rows_device),
the stage that ZKVM_MSM_SORT=pallas selects there and MsmConfig.sort here
(kernels/msm.py).  The CUDA kernel is csrc/radix_sort.cu, a least-
significant-digit radix sort in passes of at most 8 bits; radix_sort_plain
is the same passes in PyTorch ops.  Rows of any length are sorted as
they are; nothing pads them to a power of two.

With lo_bit = 0 and hi_bit = 63 it is a full sort of nonnegative int64
keys, as sort_rows_device is of its int32 keys.  The MSM passes only the
(|digit|, sign) field of its keys (msm.sort_keys): their low bits are the
point index, already ascending along each row, so the stable sort of the
field alone gives the same tensor as torch.sort of the whole keys.
"""

from __future__ import annotations

import torch

from . import _build

TILE = 2048           # keys of a row per block of the histogram and scatter
PASS_BITS = 8         # the most bits a pass sorts by


def passes(lo_bit: int, hi_bit: int) -> list[tuple[int, int]]:
    """(shift, bits) of each pass, lowest first: the bits [lo_bit, hi_bit)
    split into ceil(n / 8) passes of equal width (the last may be
    narrower), as csrc/radix_sort.cu splits them."""
    bits = hi_bit - lo_bit
    if bits <= 0:
        return []
    k = -(-bits // PASS_BITS)
    per = -(-bits // k)
    return [(lo_bit + p * per, min(per, bits - p * per)) for p in range(k)]


def radix_sort_plain(keys: torch.Tensor, lo_bit: int = 0,
                     hi_bit: int = 63) -> torch.Tensor:
    """The kernel's passes in torch ops: per pass, the digit's stable
    argsort along each row, then the keys in that order."""
    x = keys.clone()
    for shift, bits in passes(lo_bit, hi_bit):
        digit = (x >> shift) & ((1 << bits) - 1)
        x = x.gather(1, torch.argsort(digit, dim=1, stable=True))
    return x


def radix_sort(keys: torch.Tensor, lo_bit: int = 0,
               hi_bit: int = 63) -> torch.Tensor:
    """(R, n) nonnegative int64 -> each row sorted ascending and stably by
    bits [lo_bit, hi_bit) of its keys, (R, n) int64; keys is not written."""
    if not 0 <= lo_bit <= hi_bit <= 63:
        raise ValueError(f"radix_sort: bits [{lo_bit}, {hi_bit}) not within "
                         "[0, 63)")
    if keys.device.type == "cpu":
        return radix_sort_plain(keys, lo_bit, hi_bit)
    _build.check_cuda(keys, torch.int64, (None, None), "radix_sort keys")
    R, n = keys.shape
    if R > 65535:
        raise ValueError(f"radix_sort: {R} rows, at most 65,535")
    out = torch.empty_like(keys)
    tmp = torch.empty_like(keys)
    tiles = -(-n // TILE)
    hist = torch.empty((R, 1 << PASS_BITS, max(tiles, 1)), dtype=torch.int32,
                       device=keys.device)
    _build.launch("radix_sort", keys, out, tmp, hist, R, n, TILE, lo_bit,
                  hi_bit)
    _build.count(radix_sort)
    return out


radix_sort.launches = 0
