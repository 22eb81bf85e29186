"""Carries the device inputs of the JAX package's batch_msm_check,
txbatch_msm_check and window_totals_from_words across.

Both packages keep the same canonical word layouts at this boundary, so
conversion is a reinterpretation of the uint32 words as int32 tensors on
the chosen device.
"""

from __future__ import annotations

import numpy as np

from .kernels.words import to_device


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
