"""Multi-rank batched proof verification (BASELINE config 2/4).

Counterpart of the JAX package's parallel/batch_verify.py.  Proofs are
replayed on the host into verification jobs: (scalars, points) MSMs that
must sum to the identity.  Jobs are padded to a common size, stacked into
group arrays, and dispatched to the mesh: groups shard over dp, each
group's MSM over tp (sharded_msm.sharded_grouped_msm).  The identity test
is K4's on the card: the Ristretto identity coset, X = 0 or Y = 0 (the
Edwards sum may carry small torsion from decompressed coset
representatives), where the reference fetches the points and tests them
on the host.
"""

from __future__ import annotations

import torch

from ..constants import L
from ..kernels import scalarmod as sm
from ..kernels.msm import best_wbits
from ..kernels.words import points_words, to_device, words_to_points
from ..proofs.errors import VerificationError
from .mesh import Mesh
from .sharded_msm import identity_points, pad_points, sharded_grouped_msm


def padded_size(nmax: int) -> int:
    """The common job size: the next power of two, 16 at least (the
    reference's), so that it splits over any power-of-two tp."""
    size = 16
    while size < nmax:
        size *= 2
    return size


def jobs_to_arrays(jobs, wbits: int, device="cuda"):
    """jobs: (scalars, points) pairs, RistrettoPoints and ints -> (points
    (g, 4, 10, size) int32 limbs, digits (g, size, nw) int32 signed
    radix-2^wbits) on `device`, every job padded with identity points and
    zero digits to padded_size of the largest."""
    dev = torch.device(device)
    size = padded_size(max(len(s) for s, _ in jobs))
    pts, dgs = [], []
    for scalars, points in jobs:
        p = words_to_points(to_device(points_words([q.ep for q in points]),
                                      dev))
        d = sm.signed_digits(sm.ints_to_limbs([int(s) % L for s in scalars],
                                              dev), wbits)
        pad = size - d.shape[0]
        pts.append(pad_points(p, pad))
        dgs.append(torch.cat([d, d.new_zeros((pad, d.shape[1]))]))
    return torch.stack(pts), torch.stack(dgs)


def pad_groups(points: torch.Tensor, digits: torch.Tensor, dp: int):
    """Pad the group axis to a multiple of dp with trivial (identity) jobs;
    -> (points, digits, the group count before padding)."""
    g = digits.shape[0]
    pad = -g % dp
    if pad:
        ident = identity_points((pad, points.shape[-1]), points.device)
        points = torch.cat([points, ident.permute(2, 0, 1, 3)])
        digits = torch.cat([digits, digits.new_zeros((pad,)
                                                     + digits.shape[1:])])
    return points, digits, g


def sharded_batch_verify_jobs(mesh: Mesh, jobs, wbits: int | None = None
                              ) -> None:
    """Verify every job's MSM == identity on the mesh; raises
    VerificationError naming the first failing group, as the reference's
    does.  wbits None takes best_wbits of a rank's share of a group."""
    if not jobs:
        return
    if wbits is None:
        size = padded_size(max(len(s) for s, _ in jobs))
        wbits = best_wbits(-(-size // mesh.shape["tp"]))
    points, digits = jobs_to_arrays(jobs, wbits, mesh.device)
    points, digits, g = pad_groups(points, digits, mesh.shape["dp"])
    ok = sharded_grouped_msm(mesh, points, digits, wbits)[:g].cpu()
    for i, v in enumerate(ok.tolist()):
        if not v:
            raise VerificationError(f"batched verification failed (group {i})")
