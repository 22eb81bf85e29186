"""Elementwise point and field kernels over csrc/field25519.cuh.

  K5 seg_combine (csrc/seg_combine.cu): out = flag ? q : p + q, one step of
     a segmented scan: the counterpart of pallas_msm.py::seg_combine_lm
     (its _seg_combine_kernel).
  K6 point_add (csrc/point_add.cu): out = p + q, the counterpart of
     pallas_field.point_add (its _point_add_kernel) and of
     pallas_msm.py::point_add_lm (_add_kernel).  Its tree entry
     point_tree_fold sums an (R, 4, 10, B) stack over R in one launch: the
     multi-device paths' fold of the ranks' window totals
     (parallel/sharded_msm.py tree_fold).
     The small-MSM route (kernels/msm.py window_totals_small) runs on K5s
     and K3; K5 and point_add are entry points.
  K7 mul (csrc/fe_mul.cu) and K8 add (csrc/fe_add.cu): batched GF(p)
     multiply and add with one carry pass, the counterparts of the JAX
     package's pallas_field.mul and .add entry points.  No verify path
     calls them.

K5 and K6 hold a point in a group of four lanes, one coordinate a lane,
and add with lanes.cuh's lane_add_pt (q's cached form, then the addition:
three products deep, so a launch of a few thousand points is bound by one
such addition, and the tree by log2 R of them); K7 and K8 run one thread
per element.  Any batch size B works (the JAX entry points take multiples
of 512 lanes).  Points are (4, 10, B) int32, field elements (10, B) int32,
in kernels/field.py's limb form.  Each *_plain function is the kernel's
PyTorch twin, limb for limb: the CPU path and the kernel's yardstick on
the card.  The point twins add as the kernels do, in cached form
(combine.add_cached), whose products differ in association from
F.point_add's but not mod p.
"""

from __future__ import annotations

import torch

from . import _build
from . import field as F
from .combine import add_cached, cached

# csrc/point_add.cu kTreeMaxRows: point_tree_fold's rows after padding
TREE_MAX_ROWS = 64


def _check_points(t: torch.Tensor, B, what: str) -> None:
    _build.check_cuda(t, torch.int32, (4, F.NL, B), what)


def _check_fe(t: torch.Tensor, B, what: str) -> None:
    _build.check_cuda(t, torch.int32, (F.NL, B), what)


# ------------------------------------------------------------------ K5
def seg_combine_plain(p, q, flags):
    """As the kernel: every element's p + q, then q where the flag is set."""
    return torch.where(flags != 0, q, point_add_plain(p, q))


def seg_combine(p: torch.Tensor, q: torch.Tensor,
                flags: torch.Tensor) -> torch.Tensor:
    """p, q (4, 10, B) int32 points, flags (B,) int32 -> (4, 10, B):
    out[i] = q[i] where flags[i] != 0, else p[i] + q[i]."""
    if p.device.type == "cpu":
        return seg_combine_plain(p, q, flags)
    _check_points(p, None, "seg_combine p")
    B = p.shape[2]
    _check_points(q, B, "seg_combine q")
    _build.check_cuda(flags, torch.int32, (B,), "seg_combine flags")
    out = torch.empty_like(p)
    _build.launch("seg_combine", p, q, flags, out, B)
    _build.count(seg_combine)
    return out


seg_combine.launches = 0


# ------------------------------------------------------------------ K6
def point_add_plain(p, q):
    """As the kernel: p + q with q in cached form (combine.add_cached)."""
    q = cached(F.unpack_points(q))
    return F.pack_points(add_cached(F.unpack_points(p), q))


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p, q (4, 10, B) int32 points -> p + q, (4, 10, B) int32."""
    if p.device.type == "cpu":
        return point_add_plain(p, q)
    _check_points(p, None, "point_add p")
    B = p.shape[2]
    _check_points(q, B, "point_add q")
    out = torch.empty_like(p)
    _build.launch("point_add", p, q, out, B)
    _build.count(point_add)
    return out


point_add.launches = 0


def identity_points(shape: tuple, device) -> torch.Tensor:
    """(4, 10, *shape) int32 identity points (0, 1, 1, 0)."""
    out = torch.zeros((4, F.NL) + tuple(shape), dtype=torch.int32,
                      device=device)
    out[1:3, 0] = 1
    return out


def point_tree_fold_plain(stack):
    """As the kernel: the rows padded with identities to a power of two,
    then row i + row i + h for every i < h, h halving down to 1."""
    R, B = stack.shape[0], stack.shape[3]
    size = 1 << (R - 1).bit_length()
    rows = stack.permute(1, 2, 0, 3)                     # (4, 10, R, B)
    if size != R:
        rows = torch.cat([rows, identity_points((size - R, B), stack.device)],
                         dim=2)
    while rows.shape[2] > 1:
        h = rows.shape[2] // 2
        rows = point_add_plain(rows[:, :, :h], rows[:, :, h:])
    return rows[:, :, 0].contiguous()


def point_tree_fold(stack: torch.Tensor) -> torch.Tensor:
    """(R, 4, 10, B) int32 points, R <= TREE_MAX_ROWS, -> (4, 10, B) int32,
    their sum over R in the reference's tree (point_tree_fold_plain), in
    one launch.  R = 1 launches nothing: row 0 is the sum."""
    R = stack.shape[0]
    if not 1 <= R <= TREE_MAX_ROWS:
        raise ValueError(f"point_tree_fold: {R} rows, not 1 to "
                         f"{TREE_MAX_ROWS}")
    if stack.device.type == "cpu":
        return point_tree_fold_plain(stack)
    _build.check_cuda(stack, torch.int32, (None, 4, F.NL, None),
                      "point_tree_fold stack")
    if R == 1:
        return stack[0]
    B = stack.shape[3]
    out = torch.empty((4, F.NL, B), dtype=torch.int32, device=stack.device)
    _build.launch("point_tree_fold", stack, out, R, B)
    _build.count(point_tree_fold)
    return out


point_tree_fold.launches = 0


# ------------------------------------------------------------------ K7
def mul_plain(a, b):
    return F.mul(a.to(torch.int64), b.to(torch.int64)).to(torch.int32)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (10, B) int32 limbs within 1.65 * 2^W_i (carried limbs are) ->
    a * b, (10, B) int32 carried limbs."""
    if a.device.type == "cpu":
        return mul_plain(a, b)
    _check_fe(a, None, "mul a")
    B = a.shape[1]
    _check_fe(b, B, "mul b")
    out = torch.empty_like(a)
    _build.launch("fe_mul", a, b, out, B)
    _build.count(mul)
    return out


mul.launches = 0


# ------------------------------------------------------------------ K8
def add_plain(a, b):
    return F.add(a.to(torch.int64), b.to(torch.int64)).to(torch.int32)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (10, B) int32 carried limbs -> a + b after one carry pass,
    (10, B) int32 carried limbs."""
    if a.device.type == "cpu":
        return add_plain(a, b)
    _check_fe(a, None, "add a")
    B = a.shape[1]
    _check_fe(b, B, "add b")
    out = torch.empty_like(a)
    _build.launch("fe_add", a, b, out, B)
    _build.count(add)
    return out


add.launches = 0
