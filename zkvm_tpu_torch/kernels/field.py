"""GF(2^255 - 19) and Edwards point arithmetic as plain PyTorch ops.

Representation (the CUDA kernels use the same one, csrc/field25519.cuh):
ten signed limbs in radix 2^25.5 — limb i carries bits [OFFS[i],
OFFS[i] + W[i]) with widths 26, 25, 26, 25, ... (the ref10 form).  Tensors
here are int64 with the limb axis FIRST, (10, ...); between kernels limbs
are stored as int32, points as (4, 10, n) int32 = X, Y, Z, T.  Only
32x32 -> 64-bit products are needed, so the first CUDA kernels are simple.

Overflow audit (int64 columns, int32 storage):
  * "carried" limbs satisfy |h_i| <= 0.52 * 2^W[i]: every op below ends in
    carry passes that guarantee it (see carry()).
  * mul/sqr take inputs with |f_i|, |g_i| <= 1.65 * 2^W[i] (ref10's
    precondition).  The worst column is h_0 = f0 g0 + 19 * (4 even*even
    + 5 doubled odd*odd terms) <= 1.65^2 * 2^52 * (1 + 19 * 6.5)
    = 2^60.4 < 2^63.  The CUDA kernel's 19*g_j in int32 is
    <= 19 * 1.65 * 2^26 = 2^30.97 < 2^31.
  * add/sub/neg of carried values stay below 2^(W+1) before their one
    carry pass; a pass on |h_i| < 2^(W[i]+2) moves at most 4 (x19 into
    limb 0) across a boundary, so results are carried again.
  * mul's two carry passes: from |h| < 2^61 the first leaves |h_0| <
    2^25 + 19 * 2^37, the second |h_i| <= 2^(W[i]-1) + 2^16.3 (limb 0) or
    + 2^15.3 — carried.
debug_assert_limb_bounds checks the precondition on a tensor.
"""

from __future__ import annotations

import torch

from ..constants import EDWARDS_D2, P

W = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)
OFFS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
NL = 10

_W_COL = torch.tensor(W, dtype=torch.int64)
_HALF = torch.tensor([1 << (w - 1) for w in W], dtype=torch.int64)
# the factor of g_j when f_i has an odd i: f_i g_j lands in column
# (i + j) mod 10 one bit high when both limbs are odd (x19 on wrap)
_ODD = torch.tensor([2 if i % 2 else 1 for i in range(NL)], dtype=torch.int64)


# module constants on each device they were used on: the upload of a host
# tensor waits for it (a host sync), so each is made once per device, and
# the device halves issue no copy (chip_smoke.py checks that no launch half
# syncs before its fetch)
_ON_DEVICE: dict = {}


def on_device(t: torch.Tensor, device: torch.device, key=None) -> torch.Tensor:
    """The constant t on `device`: t itself on the CPU, else its copy there,
    uploaded at its first use and kept under `key` (t's identity unless
    given; t must then live as long as the module)."""
    if device.type == "cpu":
        return t
    key = (id(t) if key is None else key, device)
    out = _ON_DEVICE.get(key)
    if out is None:
        out = _ON_DEVICE[key] = t.to(device)
    return out


def _col(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(10,) table -> (10, 1, ...) broadcastable against `like`."""
    return on_device(t, like.device).view((NL,) + (1,) * (like.dim() - 1))


def carry_pass(h: torch.Tensor) -> torch.Tensor:
    """One parallel rounding carry pass: c_i = round(h_i / 2^W[i]) moves to
    limb i+1 (limb 9's carry wraps into limb 0 times 19)."""
    w = _col(_W_COL, h)
    c = (h + _col(_HALF, h)) >> w
    h = h - (c << w)
    return h + torch.cat([19 * c[-1:], c[:-1]])


def carry(h: torch.Tensor) -> torch.Tensor:
    return carry_pass(carry_pass(h))


# the rows of [19 g, g, 19 g', g'] (g' = g with its odd limbs doubled)
# that limb i of f takes, one a column k: g_(k-i), from g' where i is odd,
# 19 times where k - i wraps.  Row i is the ten consecutive rows from
# _MUL_FROM[i].
_MUL_FROM = tuple((2 * NL if i % 2 else 0) + NL - i for i in range(NL))


def mul_columns(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """mul's ten int64 columns before its carry passes (the CUDA header's
    fe_mul_cols): column k = Σ_i f_i g_(k-i) (× 19 where k - i wraps, × 2
    where i and k - i are both odd), accumulated over i from slices of
    [19 g, g] and the same with g's odd limbs doubled.  The sums are exact
    int64 (the audit above bounds every partial sum), so the order of the
    terms does not change a limb."""
    f, g = torch.broadcast_tensors(f, g)
    go = g * _col(_ODD, g)
    ext = torch.cat([19 * g, g, 19 * go, go])
    out = f[0] * ext[_MUL_FROM[0]:_MUL_FROM[0] + NL]
    for i in range(1, NL):
        out.addcmul_(f[i], ext[_MUL_FROM[i]:_MUL_FROM[i] + NL])
    return out


def mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return carry(mul_columns(f, g))


def sqr(f: torch.Tensor) -> torch.Tensor:
    return mul(f, f)


def mul_many(fs, gs) -> tuple:
    """(mul(f, g) for f, g in zip(fs, gs)) in one call over the operands
    stacked on a batch axis: mul is elementwise in its batch axes, so each
    product has the limbs it has alone, for a few tensor operations in
    place of one set a product (the twins' CPU time)."""
    ops = torch.broadcast_tensors(*fs, *gs)
    k = len(fs)
    return mul(torch.stack(ops[:k], dim=1),
               torch.stack(ops[k:], dim=1)).unbind(1)


def add(f, g):
    return carry_pass(f + g)


def sub(f, g):
    return carry_pass(f - g)


def neg(f):
    return carry_pass(-f)


def freeze(h: torch.Tensor) -> torch.Tensor:
    """Carried limbs -> the canonical limbs of h mod p (ref10 fe_tobytes):
    q = floor(h / p) is found from the top carry, h - q*p is rippled."""
    h = carry(h)
    q = (19 * h[9] + (1 << 24)) >> 25
    for i in range(NL):
        q = (h[i] + q) >> W[i]
    limbs = list(h.unbind(0))
    limbs[0] = limbs[0] + 19 * q
    for i in range(NL - 1):
        c = limbs[i] >> W[i]
        limbs[i + 1] = limbs[i + 1] + c
        limbs[i] = limbs[i] - (c << W[i])
    limbs[9] = limbs[9] - ((limbs[9] >> 25) << 25)
    return torch.stack(limbs)


def is_zero(h: torch.Tensor) -> torch.Tensor:
    return (freeze(h) == 0).all(0)


def is_negative(h: torch.Tensor) -> torch.Tensor:
    """RFC 9496 "negative": the canonical representative is odd."""
    return (freeze(h)[0] & 1) == 1


def invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p - 2) = 1/z (0 for z = 0), by ref10's fe_invert chain: 254
    squarings and 11 multiplications."""
    def sq_n(x, k):
        for _ in range(k):
            x = sqr(x)
        return x

    z2 = sqr(z)
    z9 = mul(sq_n(z2, 2), z)
    z11 = mul(z9, z2)
    z_5_0 = mul(sqr(z11), z9)                  # z^(2^5 - 1)
    z_10_0 = mul(sq_n(z_5_0, 5), z_5_0)
    z_20_0 = mul(sq_n(z_10_0, 10), z_10_0)
    z_40_0 = mul(sq_n(z_20_0, 20), z_20_0)
    z_50_0 = mul(sq_n(z_40_0, 10), z_10_0)
    z_100_0 = mul(sq_n(z_50_0, 50), z_50_0)
    z_200_0 = mul(sq_n(z_100_0, 100), z_100_0)
    z_250_0 = mul(sq_n(z_200_0, 50), z_50_0)
    return mul(sq_n(z_250_0, 5), z11)          # z^(2^255 - 21)


def _prefix_products(z: torch.Tensor) -> torch.Tensor:
    """Inclusive products along the last axis, Hillis-Steele: after the
    step with offset d every position holds the product of its last 2d
    factors; ceil(log2 n) steps."""
    n = z.shape[-1]
    d = 1
    while d < n:
        z = torch.cat([z[..., :d], mul(z[..., :n - d], z[..., d:])], dim=-1)
        d *= 2
    return z


def batch_invert(z: torch.Tensor) -> torch.Tensor:
    """(10, n) carried limbs, none zero mod p -> their inverses, by the
    Montgomery trick (the JAX package's pallas_msm.batch_zinv_lm): prefix
    and suffix products, one inversion of the whole product, then
    1/z_i = prefix_(i-1) suffix_(i+1) / Π z."""
    pre = _prefix_products(z)
    suf = _prefix_products(z.flip(-1)).flip(-1)
    tinv = invert(pre[..., -1:])
    one = const(1, z[..., :1])
    pre_ex = torch.cat([one.expand_as(z[..., :1]), pre[..., :-1]], dim=-1)
    suf_ex = torch.cat([suf[..., 1:], one.expand_as(z[..., :1])], dim=-1)
    return mul(mul(pre_ex, suf_ex), tinv)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask ? a : b per element (mask broadcasts over the limb axis)."""
    return torch.where(mask.unsqueeze(0), a, b)


def const(x: int, like: torch.Tensor) -> torch.Tensor:
    """Canonical limbs of the constant x, shaped (10, 1, ...) to broadcast."""
    x %= P
    limbs = on_device(torch.tensor(int_to_limbs(x), dtype=torch.int64),
                      like.device, ("const", x))
    return limbs.view((NL,) + (1,) * (like.dim() - 1))


def int_to_limbs(x: int) -> list[int]:
    """Canonical ints < 2^255 -> ten nonnegative limbs."""
    return [(x >> o) & ((1 << w) - 1) for o, w in zip(OFFS, W)]


def limbs_to_int(limbs) -> int:
    """Ten (possibly signed, uncarried) limbs -> int mod p."""
    return sum(int(v) << o for v, o in zip(limbs, OFFS)) % P


def ints_to_fe(xs: list[int], device="cpu") -> torch.Tensor:
    """List of field ints -> (10, n) int64 canonical limbs."""
    return torch.tensor([int_to_limbs(x % P) for x in xs],
                        dtype=torch.int64, device=device).T.contiguous()


def fe_to_ints(h: torch.Tensor) -> list[int]:
    """(10, n) limbs -> list of ints mod p."""
    cols = h.to("cpu", torch.int64).T.tolist()
    return [limbs_to_int(c) for c in cols]


def debug_assert_limb_bounds(h: torch.Tensor, k: float = 1.65) -> None:
    """Raise if any limb exceeds k * 2^W[i] in magnitude (mul's precondition
    at k = 1.65)."""
    lim = torch.tensor([int(k * (1 << w)) for w in W], dtype=torch.int64,
                       device=h.device).view((NL,) + (1,) * (h.dim() - 1))
    if bool((h.abs() > lim).any()):
        raise AssertionError("field limbs out of bounds")


# ------------------------------------------------------------ Edwards points
# Points are 4-tuples (X, Y, Z, T) of (10, ...) int64 limb tensors with
# x = X/Z, y = Y/Z, T = XY/Z; the identity is (0, 1, 1, 0).

def point_add(p, q):
    """Unified extended addition add-2008-hwcd-3 (a = -1, k = 2d): 9 mul."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A, B, Td, D = mul_many(
        (sub(Y1, X1), add(Y1, X1), T1, Z1),
        (sub(Y2, X2), add(Y2, X2), const(EDWARDS_D2, T1), add(Z2, Z2)))
    C = mul(Td, T2)
    E = sub(B, A)
    F = sub(D, C)
    G = add(D, C)
    H = add(B, A)
    return mul_many((E, G, F, E), (F, H, G, H))


def point_double(p):
    """dbl-2008-hwcd with a = -1: 4 sqr + 4 mul."""
    X, Y, Z, _ = p
    XY = add(X, Y)
    A, B, Zz, S = mul_many((X, Y, Z, XY), (X, Y, Z, XY))
    C = add(Zz, Zz)
    E = sub(sub(S, A), B)
    G = sub(B, A)
    F = sub(G, C)
    H = sub(neg(A), B)
    return mul_many((E, G, F, E), (F, H, G, H))


def identity_like(x: torch.Tensor):
    """Identity point with the batch shape of the limb tensor x."""
    zero = torch.zeros_like(x)
    one = zero.clone()
    one[0] = 1
    return zero, one, one.clone(), zero.clone()


def unpack_points(pts: torch.Tensor):
    """(4, 10, ...) int32 -> tuple of four (10, ...) int64."""
    return tuple(c.to(torch.int64) for c in pts.unbind(0))


def pack_points(p) -> torch.Tensor:
    """Tuple of four carried (10, ...) int64 -> (4, 10, ...) int32."""
    return torch.stack(p).to(torch.int32)
