"""Checkpoint and resume for long-running MSMs (SURVEY.md §5.4).

Counterpart of the JAX package's parallel/checkpoint.py.  The window loop
runs on the host; each window's total (one point) is computed on the
device, saved at once in an .npz checkpoint (written beside it, then
renamed over it), and a restarted run resumes at the first missing
window.  Deterministic re-execution of a window doubles as fault
isolation (SURVEY.md §5.3).  The saved totals are the port's canonical
point words ((4, 8) u32), not limbs.  The windows combine on the device:
K4 horner_fold over the stacked totals, where the reference runs Horner's
rule on its host, since no group operation of the port runs on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..kernels.combine import horner_fold
from ..kernels.msm import window_totals
from ..kernels.words import (points_to_ints, points_to_words, to_device,
                             words_to_points)
from ..oracle.ristretto import RistrettoPoint


class CheckpointedMSM:
    """An MSM run window by window from the host, each window's total
    checkpointed on disk at `path` (an .npz)."""

    def __init__(self, path: str, wbits: int):
        self.path = path
        self.wbits = wbits

    def _load(self) -> dict[int, np.ndarray]:
        if not os.path.exists(self.path):
            return {}
        with np.load(self.path) as data:
            return {int(k.split("_")[1]): data[k] for k in data.files
                    if k.startswith("win_")}

    def _save(self, done: dict[int, np.ndarray]):
        tmp = self.path + ".tmp.npz"
        np.savez(tmp, **{f"win_{w}": v for w, v in done.items()})
        os.replace(tmp, self.path)

    def run(self, points: torch.Tensor, digits: torch.Tensor
            ) -> RistrettoPoint:
        """Σ_i P_i · s_i for points (4, 10, n) int32 limbs and digits
        (n, nw) int32 signed radix-2^wbits digits on one device, resuming
        from any checkpointed windows; the checkpoint is removed after
        success."""
        done = self._load()
        nw = digits.shape[1]
        for w in range(nw):
            if w in done:
                continue
            total = window_totals(points, digits[:, w:w + 1].contiguous(),
                                  self.wbits)
            done[w] = points_to_words(total)[:, :, 0].cpu().numpy().view(
                np.uint32)
            self._save(done)
        words = np.stack([done[w] for w in range(nw)], axis=-1)  # (4, 8, nw)
        totals = words_to_points(to_device(words, points.device))
        folded = horner_fold(totals.unsqueeze(2).contiguous(), self.wbits)
        self.cleanup()
        return RistrettoPoint(points_to_ints(folded)[0])

    def cleanup(self):
        if os.path.exists(self.path):
            os.remove(self.path)
