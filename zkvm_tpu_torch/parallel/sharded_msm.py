"""Sharded Pippenger MSM over the process mesh.

Counterpart of the JAX package's parallel/sharded_msm.py.  An MSM is a sum
over disjoint point sets, so the mesh partitions the points: each rank
runs msm.window_totals on its contiguous share, the ranks' (4, 10, nw)
window totals (a few KB) are all-gathered, and every rank folds the stack
in log-depth Edwards additions, so that the result is the same on every
rank.  The fold is K6's tree entry point_tree_fold (kernels/pointwise.py),
the port of the reference's _point_add_kernel formula that its sharded
paths trace (pallas_msm._add_formula): one launch folds the whole stack as
it lies, its identity pad rows made in the kernel, so any rank count works
(the reference's pipeline path asserts a power of two; its fused path
pads).

The reference's sharded_msm_fn (its batch-major jnp MSM) and
sharded_msm_pallas (its limb-major pipeline) are one function here: the
port has one window-totals pipeline.
"""

from __future__ import annotations

import torch

from ..oracle.ristretto import RistrettoPoint
from ..kernels import field as F
from ..kernels.combine import horner_check, horner_fold
from ..kernels.msm import window_totals
from ..kernels.pointwise import identity_points, point_tree_fold
from ..kernels.words import points_to_ints
from .mesh import Mesh


def tree_fold(stack: torch.Tensor) -> torch.Tensor:
    """(R, 4, 10, B) points -> (4, 10, B), their sum over R: K6's tree
    entry (pointwise.point_tree_fold) on a CUDA stack, its twin on a CPU
    one.  The stack padded with identities to a power of two, then row i
    plus row i + h at each level, the reference's association; one launch,
    none at R = 1."""
    return point_tree_fold(stack)


def combine_gathered(mesh: Mesh, totals: torch.Tensor,
                     axis: str | None = None) -> torch.Tensor:
    """Every rank's (4, 10, B) window totals (B = nw, or groups x nw)
    along `axis` ("tp", "dp" or None for the whole mesh), all-gathered and
    summed by tree_fold (K6's tree entry): the same (4, 10, B) on every
    rank of the axis."""
    return tree_fold(mesh.all_gather(totals, axis))


def pad_points(points: torch.Tensor, pad: int) -> torch.Tensor:
    """(..., 4, 10, n) points with `pad` identity points appended."""
    ident = identity_points((pad,), points.device)
    return torch.cat([points, ident.expand(points.shape[:-1] + (pad,))],
                     dim=-1)


def share(points: torch.Tensor, digits: torch.Tensor, parts: int,
          index: int):
    """Part `index` of `parts` contiguous shares of points (..., 4, 10, n)
    and digits (..., n, nw), each of ceil(n / parts) points, the last
    padded with identity points and zero digits (which join no
    bucket)."""
    n = digits.shape[-2]
    per = -(-n // parts)
    lo, hi = min(index * per, n), min((index + 1) * per, n)
    pts, dg = points[..., lo:hi], digits[..., lo:hi, :]
    if hi - lo < per:
        pad = per - (hi - lo)
        pts = pad_points(pts, pad)
        dg = torch.cat([dg, dg.new_zeros(dg.shape[:-2] + (pad, dg.shape[-1]))],
                       dim=-2)
    return pts.contiguous(), dg.contiguous()


def sharded_msm(mesh: Mesh, points: torch.Tensor, digits: torch.Tensor,
                wbits: int) -> RistrettoPoint:
    """Σ_i P_i · s_i over the whole mesh: points (4, 10, n) int32 limbs and
    digits (n, nw) int32 signed radix-2^wbits digits of the scalars, the
    same on every rank.  Each rank runs window_totals on its share on
    mesh.device, combine_gathered sums the totals over the mesh, K4
    horner_fold applies Horner's rule, and one point is fetched: the same
    on every rank."""
    pts, dg = share(points, digits, mesh.size, mesh.rank)
    local = window_totals(pts.to(mesh.device), dg.to(mesh.device), wbits)
    total = combine_gathered(mesh, local)
    folded = horner_fold(total.unsqueeze(2).contiguous(), wbits)
    return RistrettoPoint(points_to_ints(folded)[0])


def sharded_grouped_msm(mesh: Mesh, points: torch.Tensor,
                        digits: torch.Tensor, wbits: int) -> torch.Tensor:
    """g independent MSMs, each tested for the Ristretto identity: points
    (g, 4, 10, n) and digits (g, n, nw) signed radix-2^wbits, g a multiple
    of the mesh's dp (batch_verify.pad_groups), the same on every rank.
    Groups split over dp and each group's points over tp: a rank runs
    window_totals on its share of each of its groups, combine_gathered
    sums its groups' totals over its tp row (one gather), one K4
    horner_check tests its groups, and the verdicts are all-gathered over
    dp.  -> (g,) int32 verdicts on mesh.device, 1 where the group's sum is
    the identity, the same on every rank."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    g = digits.shape[0]
    if g % dp:
        raise ValueError(f"{g} groups do not split over dp = {dp}")
    per = g // dp
    mine = slice(mesh.index["dp"] * per, (mesh.index["dp"] + 1) * per)
    pts, dg = share(points[mine], digits[mine], tp, mesh.index["tp"])
    pts, dg = pts.to(mesh.device), dg.to(mesh.device)
    totals = torch.stack([window_totals(pts[i], dg[i], wbits)
                          for i in range(per)], dim=2)   # (4, 10, per, nw)
    nw = totals.shape[3]
    totals = combine_gathered(mesh, totals.reshape(4, F.NL, per * nw), "tp")
    verdicts = horner_check(totals.reshape(4, F.NL, per, nw), wbits)
    return mesh.all_gather(verdicts, "dp").reshape(g)
