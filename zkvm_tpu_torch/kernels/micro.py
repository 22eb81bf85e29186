"""K13-K16: the field and point micro-kernels (csrc/field_micro.cu).

  K13 micro_mul: a <- a b, `depth` times, one thread or a group of five
     lanes per element (the counterpart of bench/pallas_micro.py's
     _pallas_binop with the pad, roll and chain kernels);
  K14 micro_parts: a multiplication split into its parts, "raw" (one
     wrapping int32 multiply a limb), "prod" (fe_mul's 100 products into
     ten int64 columns, no carry), "carry" (a + b, then 8 carry passes)
     and "chain" (fe_mul; at depth 1 the whole multiplication), each
     `depth` times (_pallas_binop_planes with the planes kernels);
  K15 micro_add_chain: q <- p + q, `depth` times, one thread per point
     (_make_add_chain_planes);
  K16 micro_add_chain_lanes: the same chain in the four-lane form, p in
     cached form once (_make_add_chain).

No verify path calls them: they time the field and point code that every
other kernel shares.  Field elements are (10, B) int32 limbs, points
(4, 10, B) int32, in kernels/field.py's form, within mul's precondition
(carried or canonical limbs are).  Each *_plain function is its kernel's
PyTorch twin, limb for limb: the CPU path and the kernel's yardstick on
the card.
"""

from __future__ import annotations

import torch

from . import _build
from . import combine
from . import field as F

MUL_FORMS = ("thread", "lanes")
PARTS = ("raw", "prod", "carry", "chain")

_MASK = torch.tensor([(1 << w) - 1 for w in F.W], dtype=torch.int64)


def _check_depth(depth: int) -> None:
    if depth < 1:
        raise ValueError(f"depth must be at least 1, got {depth}")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of its low 32 bits, kept as int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _fe_pair(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    _build.check_cuda(a, torch.int32, (F.NL, None), f"{what} a")
    B = a.shape[1]
    _build.check_cuda(b, torch.int32, (F.NL, B), f"{what} b")
    return B


def _point_pair(p: torch.Tensor, q: torch.Tensor, what: str) -> int:
    _build.check_cuda(p, torch.int32, (4, F.NL, None), f"{what} p")
    B = p.shape[2]
    _build.check_cuda(q, torch.int32, (4, F.NL, B), f"{what} q")
    return B


# ------------------------------------------------------------------ K13
def micro_mul_plain(a, b, depth=1):
    x, y = a.to(torch.int64), b.to(torch.int64)
    for _ in range(depth):
        x = F.mul(x, y)
    return x.to(torch.int32)


def micro_mul(a: torch.Tensor, b: torch.Tensor, depth: int = 1,
              form: str = "thread") -> torch.Tensor:
    """a, b (10, B) int32 limbs -> a b^depth, (10, B) int32 carried limbs,
    in one of MUL_FORMS (the same limbs in either)."""
    _check_depth(depth)
    if form not in MUL_FORMS:
        raise ValueError(f"form must be one of {MUL_FORMS}, got {form!r}")
    if a.device.type == "cpu":
        return micro_mul_plain(a, b, depth)
    B = _fe_pair(a, b, "micro_mul")
    out = torch.empty_like(a)
    _build.launch("micro_mul", a, b, out, B, depth, MUL_FORMS.index(form))
    _build.count(micro_mul)
    return out


micro_mul.launches = 0


# ------------------------------------------------------------------ K14
def micro_parts_plain(a, b, variant="chain", depth=1):
    x, y = a.to(torch.int64), b.to(torch.int64)
    if variant == "raw":
        for _ in range(depth):
            x = _wrap32(x * y)
        return x.to(torch.int32)
    if variant == "prod":
        mask = _MASK.to(x.device).view(F.NL, 1)
        for _ in range(depth):
            h = F.mul_columns(x, y)
            x = h & mask
        return h
    if variant == "carry":
        h = x + y
        for _ in range(8 * depth):
            h = F.carry_pass(h)
        return h.to(torch.int32)
    return micro_mul_plain(a, b, depth)


def micro_parts(a: torch.Tensor, b: torch.Tensor, variant: str = "chain",
                depth: int = 1) -> torch.Tensor:
    """a, b (10, B) int32 limbs -> one of PARTS, `depth` times: "raw"
    (10, B) int32, x <- x b wrapping, limb by limb; "prod" (10, B) int64,
    the columns of f b with f <- the columns cut to the limb widths (at
    depth 1 the columns of a b); "carry" (10, B) int32, a + b after 8 depth
    carry passes; "chain" (10, B) int32, a b^depth."""
    _check_depth(depth)
    if variant not in PARTS:
        raise ValueError(f"variant must be one of {PARTS}, got {variant!r}")
    if a.device.type == "cpu":
        return micro_parts_plain(a, b, variant, depth)
    B = _fe_pair(a, b, "micro_parts")
    out = torch.empty((F.NL, B), device=a.device,
                      dtype=torch.int64 if variant == "prod" else torch.int32)
    _build.launch("micro_parts", a, b, out, B, depth, PARTS.index(variant))
    _build.count(micro_parts)
    return out


micro_parts.launches = 0


# ------------------------------------------------------------------ K15
def micro_add_chain_plain(p, q, depth=1):
    a, r = F.unpack_points(p), F.unpack_points(q)
    for _ in range(depth):
        r = F.point_add(a, r)
    return F.pack_points(r)


def micro_add_chain(p: torch.Tensor, q: torch.Tensor,
                    depth: int = 1) -> torch.Tensor:
    """p, q (4, 10, B) int32 -> q <- p + q `depth` times (add-2008-hwcd-3),
    (4, 10, B) int32 carried limbs."""
    _check_depth(depth)
    if p.device.type == "cpu":
        return micro_add_chain_plain(p, q, depth)
    B = _point_pair(p, q, "micro_add_chain")
    out = torch.empty_like(p)
    _build.launch("micro_add_chain", p, q, out, B, depth)
    _build.count(micro_add_chain)
    return out


micro_add_chain.launches = 0


# ------------------------------------------------------------------ K16
def micro_add_chain_lanes_plain(p, q, depth=1):
    c, r = combine.cached(F.unpack_points(p)), F.unpack_points(q)
    for _ in range(depth):
        r = combine.add_cached(r, c)
    return F.pack_points(r)


def micro_add_chain_lanes(p: torch.Tensor, q: torch.Tensor,
                          depth: int = 1) -> torch.Tensor:
    """As micro_add_chain, in the four-lane form: q <- q + p with p in
    cached form (the same coordinates mod p, other limbs)."""
    _check_depth(depth)
    if p.device.type == "cpu":
        return micro_add_chain_lanes_plain(p, q, depth)
    B = _point_pair(p, q, "micro_add_chain_lanes")
    out = torch.empty_like(p)
    _build.launch("micro_add_chain_lanes", p, q, out, B, depth)
    _build.count(micro_add_chain_lanes)
    return out


micro_add_chain_lanes.launches = 0
