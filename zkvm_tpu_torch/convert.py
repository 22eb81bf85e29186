"""Carries the device inputs of the JAX package's batch_msm_check across.

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
