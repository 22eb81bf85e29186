"""TorchEngine: the port's device implementation of the Engine seam
(proofs/engine.py).

Counterpart of the JAX package's kernels/engine.py::JaxEngine for the
verifier's two calls, msm and msm_is_identity.  Protocol code stays host
Python over RistrettoPoints; the engine packs their canonical words
(cached on each point, so static generators convert once) and the
scalars, and runs frontend.window_totals_from_words on its device.  msm
combines the window totals on the host; msm_is_identity runs K4 on the
card and fetches one int.

Every MSM goes to the device: the JAX engine keeps MSMs under 2,048 points
on the host because a TPU round trip costs ~24 ms there, which does not
hold on the card, and msm.window_totals has its own route for n <= 2,048.
"""

from __future__ import annotations

import time

import torch

from ..constants import L
from ..oracle import edwards
from ..oracle.ristretto import RistrettoPoint
from ..proofs.engine import Engine
from .batch_verify_device import require_device
from .combine import horner_check
from .frontend import combine_window_totals, pack_words, window_totals_from_words
from .msm import MsmConfig, best_wbits
from .words import point_words, to_device


def _point_words(p: RistrettoPoint):
    """(4, 8) uint32 canonical words of one point, cached on the object."""
    cached = getattr(p, "_words", None)
    if cached is None:
        cached = point_words(p.ep)
        p._words = cached
    return cached


class TorchEngine(Engine):
    """MSMs on `device` ("cuda" unless the caller asks for "cpu", where the
    kernels' plain versions run).  wbits None picks msm.best_wbits per
    size; config None reads the JAX package's switches at each call
    (msm.MsmConfig.from_env)."""

    supports_fused_batch_verify = True

    def __init__(self, device="cuda", wbits: int | None = None,
                 config: MsmConfig | None = None):
        self.device = require_device(device)
        self.wbits = wbits
        self.config = config

    @staticmethod
    def pack(scalars, points):
        """-> (point words (4, 8, n), scalar words (8, n)) uint32 on the
        host, the point words cached on each point."""
        if not hasattr(scalars, "buf"):          # a ScalarVec stays packed
            scalars = [int(s) % L for s in scalars]
        return pack_words([_point_words(p) for p in points], scalars)

    def totals_from_words(self, pw, sw) -> tuple[torch.Tensor, int]:
        """pack's words -> (window totals (4, 10, nw) on the device,
        wbits)."""
        wbits = self.wbits or best_wbits(pw.shape[2])
        return window_totals_from_words(to_device(pw, self.device),
                                        to_device(sw, self.device), wbits,
                                        self.config), wbits

    def window_totals(self, scalars, points) -> tuple[torch.Tensor, int]:
        return self.totals_from_words(*self.pack(scalars, points))

    def msm(self, scalars, points) -> RistrettoPoint:
        points = list(points)
        if not points:
            return RistrettoPoint(edwards.IDENTITY)
        totals, wbits = self.window_totals(scalars, points)
        return RistrettoPoint(combine_window_totals(totals, wbits))

    def msm_is_identity(self, scalars, points,
                        timings: dict | None = None) -> bool:
        points = list(points)
        if not points:
            return True
        t0 = time.perf_counter()
        words = self.pack(scalars, points)
        if timings is not None:
            timings["pack_s"] = time.perf_counter() - t0
        totals, wbits = self.totals_from_words(*words)
        return bool(horner_check(totals.unsqueeze(2).contiguous(), wbits)
                    .item())
