"""TorchEngine: the port's device implementation of the Engine seam
(proofs/engine.py).

Counterpart of the JAX package's kernels/engine.py::JaxEngine.  Protocol
code stays host Python over RistrettoPoints; the engine packs their
canonical words (cached on each point, so static generators convert once)
and the scalars, and runs them on its device.
The verifier's calls: msm combines the window totals on the host;
msm_is_identity runs K4 on the card and fetches one int, split for the
serving pipeline into msm_start (pack, upload, window totals; no host
sync) and msm_finish_is_identity (K4 and the fetch).  The prover's
calls, one fetch each:
  * public scalars, msm_batch(ct=False): every group's words uploaded at
    once, each group's window totals with no host sync between groups,
    the groups of each window width folded by one K4 horner_fold launch;
  * secret scalars, constant-time on the card, as the reference keeps
    them on its host (zkvm_tpu/proofs/engine.py:36-97):
    - basepoint_mul (either ct, as the reference uses its table for
      both), commit and commit_batch: K17 fixed_base_ct
      (kernels/fixed_base.py) over radix-16 tables of the bases, built on
      the card at a base's first use and kept resident, keyed by its
      canonical words;
    - msm_secret, msm_batch(ct=True) and bit_commit_batch (the base
      class's definition over msm_batch): K18 msm_ct (kernels/msm_ct.py),
      every group's 64 window totals in one launch, then one K4 fold at
      w = 4.
    Neither reaches msm.window_totals, its sort or the bucket kernels;
  * ipp_create runs the device-resident inner-product argument
    (kernels/ipp_device.py).

Every MSM goes to the device: the JAX engine keeps MSMs under 2,048 points
on the host because a TPU round trip costs ~24 ms there, which does not
hold on the card, and msm.window_totals has its own route for n <= 2,048.
The secret MSMs too, where the JAX engine keeps those under 4,096 points
on its constant-time native path.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

from ..constants import L
from ..oracle import edwards
from ..oracle.ristretto import BASEPOINT, RistrettoPoint
from ..proofs.engine import Engine
from . import fixed_base as fb
from . import scalarmod as sm
from .batch_verify_device import require_device
from .combine import horner_check, horner_fold
from .frontend import combine_window_totals, pack_words, window_totals_from_words
from .msm import MsmConfig, best_wbits, window_totals
from .msm_ct import msm_ct
from .words import (point_words, points_to_ints, scalar_words, to_device,
                    words_to_points)

# K17's resident tables, (device, the base's canonical words) -> (64, 8, 4,
# 10) int32, shared by every engine on a device; the lock guards the dict
# and each build (distributed_prove's hosts call their engines from
# threads)
_TABLES: dict[tuple[str, bytes], torch.Tensor] = {}
_TABLES_LOCK = threading.Lock()


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
        return self.msm_finish_is_identity(
            self.msm_start(scalars, points, timings))

    # ------------------------------------------------ the serving pipeline
    def msm_start(self, scalars, points, timings: dict | None = None):
        """msm_is_identity's launch half: pack the words on the host, then
        totals_from_words (an upload through pinned memory and the window
        totals), with no host sync, so the host can prepare the next check
        while the card runs this one.  -> a handle for msm_finish_is_identity, (totals,
        wbits), or None for no points.  timings as msm_is_identity's."""
        points = list(points)
        if not points:
            return None
        t0 = time.perf_counter()
        words = self.pack(scalars, points)
        if timings is not None:
            timings["pack_s"] = time.perf_counter() - t0
        return self.totals_from_words(*words)

    def msm_finish_is_identity(self, handle) -> bool:
        """K4 on msm_start's window totals, then the verdict's one fetch."""
        if handle is None:
            return True
        totals, wbits = handle
        return bool(horner_check(totals.unsqueeze(2).contiguous(), wbits)
                    .item())

    # ------------------------------------------------------ the prover's
    @staticmethod
    def _groups(scalars_groups, points_groups):
        groups = [(s.to_ints() if hasattr(s, "to_ints") else s, list(p))
                  for s, p in zip(scalars_groups, points_groups,
                                  strict=True)]
        if any(len(s) != len(p) for s, p in groups):
            raise ValueError("one scalar per point")
        return groups

    def msm_batch(self, scalars_groups, points_groups,
                  ct: bool = False) -> list[RistrettoPoint]:
        """Independent MSMs on the device, one fetch for all of them.
        Public scalars (ct False): one upload and decode for every group;
        then for each window width among the groups (each group takes its
        own best width, or the engine's), one recode, each group's window
        totals and one K4 launch.  Secret scalars (ct True): one upload, a
        radix-16 recode, one K18 launch for every group and one K4 launch
        at w = 4, constant-time in the scalars."""
        groups = self._groups(scalars_groups, points_groups)
        if ct:
            return self._msm_batch_ct(groups)
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

    def _msm_batch_ct(self, groups) -> list[RistrettoPoint]:
        out = [RistrettoPoint(edwards.IDENTITY) for _ in groups]
        live = [i for i, (_, p) in enumerate(groups) if p]
        if not live:
            return out
        pw, sw = self.pack([x for i in live for x in groups[i][0]],
                           [p for i in live for p in groups[i][1]])
        points = words_to_points(to_device(pw, self.device))
        totals = msm_ct(points, to_device(sw, self.device),
                        [len(groups[i][1]) for i in live])
        for i, ep in zip(live, points_to_ints(horner_fold(totals, fb.WBITS))):
            out[i] = RistrettoPoint(ep)
        return out

    def msm_secret(self, scalars, points) -> RistrettoPoint:
        """An MSM over secret scalars: K18, then K4 (msm_batch, ct)."""
        return self.msm_batch([scalars], [points], ct=True)[0]

    def fixed_table(self, base: RistrettoPoint) -> torch.Tensor:
        """K17's radix-16 table of `base` on the device, built at its first
        use there and kept (fixed_base.table)."""
        words = _point_words(base)
        key = (str(self.device), words.tobytes())
        with _TABLES_LOCK:
            tab = _TABLES.get(key)
            if tab is None:
                point = words_to_points(to_device(words[:, :, None],
                                                  self.device))
                tab = _TABLES[key] = fb.table(point.contiguous())
        return tab

    def scalar_words(self, scalars) -> torch.Tensor:
        """Scalars (ints) -> (8, n) int32 words of their canonical values
        on the device, one upload (K17 and K18 recode them)."""
        return to_device(scalar_words([int(s) % L for s in scalars]).T,
                         self.device)

    def basepoint_mul(self, scalar: int, ct: bool = True) -> RistrettoPoint:
        """scalar·B by K17 over B's table, whether the scalar is secret or
        not (the reference's table serves both), one fetch."""
        out = fb.fixed_base_ct(self.fixed_table(BASEPOINT),
                               self.scalar_words([scalar]))
        return RistrettoPoint(points_to_ints(out)[0])

    def commit_batch(self, values, blindings, B: RistrettoPoint,
                     B_blinding: RistrettoPoint) -> list[RistrettoPoint]:
        """[v_i·B + b_i·B_blinding]: one K17 launch over both bases'
        tables, one fetch."""
        values, blindings = list(values), list(blindings)
        if len(values) != len(blindings):
            raise ValueError("one blinding per value")
        if not values:
            return []
        n = len(values)
        words = self.scalar_words(values + blindings)
        out = fb.fixed_base_ct(self.fixed_table(B), words[:, :n].contiguous(),
                               self.fixed_table(B_blinding),
                               words[:, n:].contiguous())
        return [RistrettoPoint(ep) for ep in points_to_ints(out)]

    def ipp_create(self, transcript, Q, G_factors, H_factors, G, H, a, b,
                   timings: dict | None = None):
        from .ipp_device import create
        return create(self, transcript, Q, G_factors, H_factors, G, H, a, b,
                      timings=timings)
