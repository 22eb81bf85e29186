"""TorchEngine: the port's device implementation of the Engine seam
(proofs/engine.py).

Counterpart of the JAX package's kernels/engine.py::JaxEngine.  Protocol
code stays host Python over RistrettoPoints; the engine packs their
canonical words (cached on each point, so static generators convert once)
and the scalars, and runs frontend.window_totals_from_words on its device.
The verifier's calls: msm combines the window totals on the host;
msm_is_identity runs K4 on the card and fetches one int.  The prover's
calls: msm_batch uploads every group's words at once, runs each group's
window totals with no host sync between groups, folds the groups of each
window width with one K4 horner_fold launch and fetches the points once;
basepoint_mul, commit, commit_batch and bit_commit_batch (the base
class's definitions) ride it, msm_secret is msm (the base class's
definition), and ipp_create runs the device-resident inner-product
argument (kernels/ipp_device.py).

Every MSM goes to the device: the JAX engine keeps MSMs under 2,048 points
on the host because a TPU round trip costs ~24 ms there, which does not
hold on the card, and msm.window_totals has its own route for n <= 2,048.
The prover's MSMs too, where the JAX engine keeps secret MSMs under 4,096
points on its constant-time host path: the card's MSM sorts by digit, so
its memory traffic depends on the secret scalars (README, "Proving").
"""

from __future__ import annotations

import itertools
import time

import torch

from ..constants import L
from ..oracle import edwards
from ..oracle.ristretto import RistrettoPoint
from ..proofs.engine import Engine
from . import scalarmod as sm
from .batch_verify_device import require_device
from .combine import horner_check, horner_fold
from .frontend import combine_window_totals, pack_words, window_totals_from_words
from .msm import MsmConfig, best_wbits, window_totals
from .words import point_words, points_to_ints, to_device, words_to_points


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

    # ------------------------------------------------------ the prover's
    def msm_batch(self, scalars_groups, points_groups,
                  ct: bool = False) -> list[RistrettoPoint]:
        """Independent MSMs on the device, one fetch for all of them: one
        upload and decode for every group; then for each window width
        among the groups (each group takes its own best width, or the
        engine's), one recode, each group's window totals and one K4
        launch.  The route does not depend on ct: secret scalars take the
        same variable-time pipeline."""
        groups = [(s.to_ints() if hasattr(s, "to_ints") else s, list(p))
                  for s, p in zip(scalars_groups, points_groups,
                                  strict=True)]
        if any(len(s) != len(p) for s, p in groups):
            raise ValueError("one scalar per point")
        out = [RistrettoPoint(edwards.IDENTITY) for _ in groups]
        width = {i: self.wbits or best_wbits(len(p))
                 for i, (_, p) in enumerate(groups) if p}
        if not width:
            return out
        order = sorted(width, key=width.get)      # one width's groups adjacent
        pw, sw = self.pack([x for i in order for x in groups[i][0]],
                           [p for i in order for p in groups[i][1]])
        points = words_to_points(to_device(pw, self.device))
        scalars = sm.decode_words_first(to_device(sw, self.device))
        folded, off = [], 0
        for wbits, members in itertools.groupby(order, key=width.get):
            sizes = [len(groups[i][1]) for i in members]
            digits = sm.signed_digits(scalars[:, off:off + sum(sizes)], wbits)
            totals, at = [], 0
            for n in sizes:
                totals.append(window_totals(
                    points[:, :, off + at:off + at + n].contiguous(),
                    digits[at:at + n], wbits, self.config))
                at += n
            folded.append(horner_fold(torch.stack(totals, 2).contiguous(),
                                      wbits))
            off += at
        for i, ep in zip(order, points_to_ints(torch.cat(folded, 2))):
            out[i] = RistrettoPoint(ep)
        return out

    def ipp_create(self, transcript, Q, G_factors, H_factors, G, H, a, b,
                   timings: dict | None = None):
        from .ipp_device import create
        return create(self, transcript, Q, G_factors, H_factors, G, H, a, b,
                      timings=timings)
