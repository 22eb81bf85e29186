"""Elementwise point and field kernels over csrc/field25519.cuh.

  K5 seg_combine (csrc/seg_combine.cu): out = flag ? q : p + q, one step of
     a segmented scan: the counterpart of pallas_msm.py::seg_combine_lm
     (its _seg_combine_kernel).
  K6 point_add (csrc/point_add.cu): out = p + q, the counterpart of
     pallas_field.point_add (its _point_add_kernel) and of
     pallas_msm.py::point_add_lm (_add_kernel).
     The small-MSM route (kernels/msm.py window_totals_small) runs on K5s
     and K3; K5 and K6 are entry points.
  K7 mul (csrc/fe_mul.cu) and K8 add (csrc/fe_add.cu): batched GF(p)
     multiply and add with one carry pass, the counterparts of the JAX
     package's pallas_field.mul and .add entry points.  No verify path
     calls them.

One thread per element, so any batch size B works (the JAX entry points
take multiples of 512 lanes).  Points are (4, 10, B) int32, field elements
(10, B) int32, in kernels/field.py's limb form.  Each *_plain function is
the kernel's PyTorch twin, limb for limb: the CPU path and the kernel's
yardstick on the card.
"""

from __future__ import annotations

import torch

from . import _build
from . import field as F


def _check_points(t: torch.Tensor, B, what: str) -> None:
    _build.check_cuda(t, torch.int32, (4, F.NL, B), what)


def _check_fe(t: torch.Tensor, B, what: str) -> None:
    _build.check_cuda(t, torch.int32, (F.NL, B), what)


# ------------------------------------------------------------------ K5
def seg_combine_plain(p, q, flags):
    """As the kernel: the elements whose flag is clear get p + q, the
    others keep q."""
    clear = (flags == 0).nonzero().squeeze(1)
    out = q.clone()
    out[:, :, clear] = point_add_plain(p[:, :, clear], q[:, :, clear])
    return out


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
    return F.pack_points(F.point_add(F.unpack_points(p), F.unpack_points(q)))


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
