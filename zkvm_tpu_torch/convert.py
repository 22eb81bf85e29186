"""Carries the device inputs of the JAX package's batch_msm_check,
txbatch_msm_check and window_totals_from_words across, and its 13-bit
field limbs (from_jax_limbs13).

Both packages keep the same canonical word layouts at this boundary, so
conversion is a reinterpretation of the uint32 words as int32 tensors on
the chosen device.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.field import OFFS, W, freeze
from .kernels.words import bits_to_limbs, to_device


def from_jax_arrays(static_words, dyn_words, params_words, bbB_words,
                    device="cuda"):
    """The JAX package's batch_msm_check arguments as numpy arrays —
    static_words (4, 8, 2 + 2nm), dyn_words (8, D) raw encodings,
    params_words (nb, 9 + lg, 8), bbB_words (2, 8), all uint32 — -> the
    port's batch_msm_check tensors on `device`, in the same order."""
    return tuple(to_device(np.asarray(a, np.uint32), device)
                 for a in (static_words, dyn_words, params_words, bbB_words))


def from_jax_split_inputs(static_words, dyn_enc_words, static_sc_words,
                          dyn_sc_words, device="cuda"):
    """The JAX package's txbatch_msm_check arguments as numpy arrays —
    static_words (4, 8, S) point words, dyn_enc_words (8, D) raw
    encodings, static_sc_words (S, 8) and dyn_sc_words (D, 8) scalars, all
    uint32 — -> the port's split_msm_check tensors on `device`, in the same
    order.  The JAX package's zero padding of the dynamic part (identity
    encodings with zero scalars) may stay: it changes no verdict."""
    return tuple(to_device(np.asarray(a, np.uint32), device)
                 for a in (static_words, dyn_enc_words, static_sc_words,
                           dyn_sc_words))


def from_jax_msm_words(point_words, scalar_words, device="cuda"):
    """The JAX package's pallas_msm.pack_words output as numpy arrays —
    point_words (4, 8, n) and scalar_words (8, n), uint32 — -> the port's
    frontend.window_totals_from_words tensors on `device`.  Its padding
    (identity points with zero scalars) may stay: it changes no sum."""
    return tuple(to_device(np.asarray(a, np.uint32), device)
                 for a in (point_words, scalar_words))


def from_jax_limbs13(limbs, device="cuda"):
    """The JAX package's field limbs as a numpy array — (20, ...) limbs of
    13 bits, limb k weighing 2^(13 k), values up to 2^260 (above p) — ->
    the port's (10, ...) int32 canonical limbs of each value mod p on
    `device`.  The 260 bits are packed into words, bits 0-254 split into
    the port's limbs, and bits 255-259 fold into limb 0 as 19 times their
    value (2^255 = 19 mod p) before the canonical reduction."""
    x = np.asarray(limbs)
    if x.shape[0] != 20 or ((x < 0) | (x >= 1 << 13)).any():
        raise ValueError("expected 20 limbs of 13 bits each")
    x = x.astype(np.uint64)
    words = np.zeros((9,) + x.shape[1:], np.uint64)
    for k in range(20):
        w, s = divmod(13 * k, 32)
        v = x[k] << np.uint64(s)
        words[w] |= v & np.uint64(0xFFFFFFFF)
        words[w + 1] |= v >> np.uint64(32)
    top = (words[7] >> np.uint64(31)) | (words[8] << np.uint64(1))
    low = torch.from_numpy(words[:8].astype(np.uint32).view(np.int32))
    h = bits_to_limbs(low, OFFS, W)
    h[0] += 19 * torch.from_numpy(top.astype(np.int64))
    return freeze(h).to(device=device, dtype=torch.int32)
