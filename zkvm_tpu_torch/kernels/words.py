"""The canonical boundary shared with the JAX package, and conversions to
the port's limb form.

Boundary formats (identical to the JAX package's):
  * 32-byte little-endian scalars and field elements, as 8 u32 words;
  * point words: (4, 8) u32 = canonical X, Y, Z, T of an extended point
    (the JAX package's pallas_msm.point_words);
  * raw 32-byte Ristretto encodings, as (8, n) u32 word columns.

Torch has no general uint32 arithmetic, so word tensors are int32 holding
the u32 bit patterns; numpy arrays stay uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import NL, OFFS, W, freeze

_MASK32 = (1 << 32) - 1


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & _MASK32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def bits_to_limbs(words: torch.Tensor, offs, widths) -> torch.Tensor:
    """(8, ...) u32 words -> (len(offs), ...) int64 limbs of bits
    [offs[i], offs[i] + widths[i]) of the little-endian 256-bit value."""
    w = _u32(words)
    w = torch.cat([w, torch.zeros_like(w[:1])])
    out = []
    for o, b in zip(offs, widths):
        k, s = o >> 5, o & 31
        v = w[k] >> s
        if s + b > 32:
            v = v | (w[k + 1] << (32 - s))
        out.append(v & ((1 << b) - 1))
    return torch.stack(out)


def limbs_to_bits(limbs: torch.Tensor, offs, widths) -> torch.Tensor:
    """Canonical nonnegative limbs -> (8, ...) int32 u32 bit patterns."""
    words = []
    for k in range(8):
        lo, hi = 32 * k, 32 * k + 32
        acc = torch.zeros_like(limbs[0])
        for i, (o, b) in enumerate(zip(offs, widths)):
            if o + b <= lo or o >= hi:
                continue
            acc = acc | ((limbs[i] << (o - lo)) if o >= lo
                         else (limbs[i] >> (lo - o)))
        words.append(_to_i32(acc & _MASK32))
    return torch.stack(words)


def field_words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(8, ...) field words -> (10, ...) int64 limbs (bit 255 is dropped,
    as ref10's fe_frombytes does)."""
    return bits_to_limbs(words, OFFS, W)


def limbs_to_field_words(h: torch.Tensor) -> torch.Tensor:
    """(10, ...) limbs -> (8, ...) canonical words of h mod p."""
    return limbs_to_bits(freeze(h), OFFS, W)


def words_to_points(words: torch.Tensor) -> torch.Tensor:
    """(4, 8, n) point words -> (4, 10, n) int32 limbs."""
    return torch.stack([field_words_to_limbs(c) for c in words.unbind(0)]
                       ).to(torch.int32)


def points_to_words(pts: torch.Tensor) -> torch.Tensor:
    """(4, 10, ...) int32 limbs -> (4, 8, ...) canonical point words."""
    return torch.stack([limbs_to_field_words(c.to(torch.int64))
                        for c in pts.unbind(0)])


# ---------------------------------------------------------------- host side
def point_words(ep) -> np.ndarray:
    """(4, 8) uint32 canonical words of one extended point (X, Y, Z, T)."""
    blob = b"".join(int(c).to_bytes(32, "little") for c in ep)
    return np.frombuffer(blob, np.uint32).reshape(4, 8)


def points_words(eps) -> np.ndarray:
    """Extended points -> (4, 8, n) uint32."""
    return np.ascontiguousarray(
        np.stack([point_words(ep) for ep in eps]).transpose(1, 2, 0))


def encoding_words(encodings: list[bytes]) -> np.ndarray:
    """Raw 32-byte encodings -> (8, n) uint32 word columns."""
    return np.ascontiguousarray(
        np.frombuffer(b"".join(encodings), np.uint32)
        .reshape(len(encodings), 8).T)


def scalar_words(xs: list[int]) -> np.ndarray:
    """Ints in [0, 2^256) -> (n, 8) uint32 little-endian words."""
    blob = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(blob, np.uint32).reshape(len(xs), 8).copy()


def words_to_ints(words: np.ndarray) -> list[int]:
    """(..., 8) uint32 -> ints (row-wise)."""
    rows = np.ascontiguousarray(words, np.uint32).reshape(-1, 8)
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with the same bits on `device`."""
    a = np.ascontiguousarray(arr, np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def points_to_ints(pts: torch.Tensor) -> list[tuple[int, int, int, int]]:
    """(4, 10, n) limbs -> list of extended points as ints mod p."""
    words = points_to_words(pts).cpu().numpy().view(np.uint32)  # (4, 8, n)
    cols = [words_to_ints(np.ascontiguousarray(words[c].T)) for c in range(4)]
    return list(zip(*cols))

