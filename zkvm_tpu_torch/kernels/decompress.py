"""K1 ristretto_decode: Ristretto255 DECODE of raw 32-byte encodings.

Replaces the JAX package's pallas_decompress.py::_decompress_kernel.  The
CUDA kernel is csrc/decompress.cu (a group of five lanes per encoding,
each product split over the group by output column; bound by operations,
see its note).  ristretto_decode_plain below is the same computation in
PyTorch ops: the CPU path and the kernel's yardstick on the card.

Semantics (RFC 9496 §4.3.1, as the JAX kernel): s = 0 decodes to the
identity and is valid; a non-canonical s, a negative s, a non-square, a
negative t or y = 0 gives ok = 0 and the identity point.  Zero-padded
encodings decode to the identity.
"""

from __future__ import annotations

import torch

from ..constants import EDWARDS_D, SQRT_M1
from . import _build
from . import field as F
from .words import field_words_to_limbs


def _pow2k(a, k):
    for _ in range(k):
        a = F.sqr(a)
    return a


def _pow_p58(a):
    """a^((p-5)/8) = a^(2^252 - 3)."""
    m = F.mul
    z2 = F.sqr(a)
    z9 = m(a, _pow2k(z2, 2))
    z11 = m(z2, z9)
    z_5_0 = m(z9, F.sqr(z11))
    z_10_0 = m(_pow2k(z_5_0, 5), z_5_0)
    z_20_0 = m(_pow2k(z_10_0, 10), z_10_0)
    z_40_0 = m(_pow2k(z_20_0, 20), z_20_0)
    z_50_0 = m(_pow2k(z_40_0, 10), z_10_0)
    z_100_0 = m(_pow2k(z_50_0, 50), z_50_0)
    z_200_0 = m(_pow2k(z_100_0, 100), z_100_0)
    z_250_0 = m(_pow2k(z_200_0, 50), z_50_0)
    return m(_pow2k(z_250_0, 2), a)


def _eq(a, b):
    return F.is_zero(F.sub(a, b))


def ristretto_decode_plain(words: torch.Tensor):
    """(8, n) int32 encoding words -> ((4, 10, n) int32 points, (n,) int32 ok)."""
    s = field_words_to_limbs(words)
    # canonical: bit 255 (the int32 sign bit of word 7) clear and s < p
    s_canonical = (F.freeze(s) == s).all(0) & (words[7] >= 0)
    s_nonneg = (s[0] & 1) == 0

    one = F.const(1, s).expand_as(s)
    sqrt_m1 = F.const(SQRT_M1, s)
    ss = F.sqr(s)
    u1 = F.sub(one, ss)
    u2 = F.add(one, ss)
    u2_sqr = F.sqr(u2)
    v = F.sub(F.neg(F.mul(F.const(EDWARDS_D, s), F.sqr(u1))), u2_sqr)

    a = F.mul(v, u2_sqr)
    a3 = F.mul(F.sqr(a), a)
    a7 = F.mul(F.sqr(a3), a)
    r = F.mul(a3, _pow_p58(a7))
    check = F.mul(a, F.sqr(r))
    correct = _eq(check, one)
    flipped = _eq(check, F.neg(one))
    flipped_i = _eq(check, F.neg(sqrt_m1.expand_as(s)))
    r = F.select(flipped | flipped_i, F.mul(r, sqrt_m1), r)
    r = F.select(F.is_negative(r), F.neg(r), r)
    was_square = correct | flipped

    den_x = F.mul(r, u2)
    den_y = F.mul(F.mul(r, den_x), v)
    x = F.mul(F.add(s, s), den_x)
    x = F.select(F.is_negative(x), F.neg(x), x)
    y = F.mul(u1, den_y)
    t = F.mul(x, y)

    ok = (was_square & ~F.is_negative(t) & ~F.is_zero(y)
          & s_canonical & s_nonneg)
    zero = torch.zeros_like(s)
    pts = F.pack_points((F.select(ok, x, zero), F.select(ok, y, one), one,
                         F.select(ok, t, zero)))
    return pts, ok.to(torch.int32)


def ristretto_decode(words: torch.Tensor):
    """(8, n) int32 encoding words -> ((4, 10, n) int32 points, (n,) int32
    ok).  CPU tensors take the plain version; CUDA tensors launch K1."""
    if words.device.type == "cpu":
        return ristretto_decode_plain(words)
    _build.check_cuda(words, torch.int32, (8, None), "ristretto_decode words")
    n = words.shape[1]
    pts = torch.empty((4, F.NL, n), dtype=torch.int32, device=words.device)
    ok = torch.empty((n,), dtype=torch.int32, device=words.device)
    _build.launch("decompress", words, pts, ok, n)
    _build.count(ristretto_decode)
    return pts, ok


ristretto_decode.launches = 0
