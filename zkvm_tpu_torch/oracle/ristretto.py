"""Ristretto255: the prime-order group over the Curve25519 cofactor-8 curve.

Upstream counterpart: curve25519-dalek src/ristretto.rs; wire behavior per RFC 9496
(ENCODE §4.3.1, DECODE §4.3.2, MAP/one-way map §4.3.4).  The ``RistrettoPoint``
class here is the protocol-layer point type of the port; the device path
packs batches of them into canonical words (kernels/words.py).

ENCODE and DECODE run in the port's C++ host library
(native/ristretto255.cpp), one call for a batch; _compress_py,
_decompress_py and decompress_many_plain are their pure-Python twins.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..constants import (
    P, L, SQRT_M1, EDWARDS_D, ONE_MINUS_D_SQ, D_MINUS_ONE_SQ,
    SQRT_AD_MINUS_ONE, INVSQRT_A_MINUS_D,
)
from . import edwards, field


class RistrettoPoint:
    """An element of the Ristretto255 group, internally an Edwards point.
    `_words` caches the point's canonical words for the device engine
    (kernels/engine.py)."""

    __slots__ = ("ep", "_words")

    def __init__(self, ep: edwards.Point):
        self.ep = ep

    # -- group ops ---------------------------------------------------------
    def __add__(self, other: "RistrettoPoint") -> "RistrettoPoint":
        return RistrettoPoint(edwards.add(self.ep, other.ep))

    def __sub__(self, other: "RistrettoPoint") -> "RistrettoPoint":
        return RistrettoPoint(edwards.sub(self.ep, other.ep))

    def __neg__(self) -> "RistrettoPoint":
        return RistrettoPoint(edwards.neg(self.ep))

    def __mul__(self, k: int) -> "RistrettoPoint":
        return RistrettoPoint(edwards.scalar_mul(int(k) % L, self.ep))

    __rmul__ = __mul__

    def double(self) -> "RistrettoPoint":
        return RistrettoPoint(edwards.double(self.ep))

    def __eq__(self, other) -> bool:
        """Ristretto equality: X1 Y2 == Y1 X2  or  X1 X2 == Y1 Y2
        (curve25519-dalek ristretto.rs ct_eq) — E[4] cosets compare equal."""
        if not isinstance(other, RistrettoPoint):
            return NotImplemented
        X1, Y1, _, _ = self.ep
        X2, Y2, _, _ = other.ep
        return (X1 * Y2 - Y1 * X2) % P == 0 or (X1 * X2 - Y1 * Y2) % P == 0

    def __hash__(self):
        return hash(self.compress())

    def is_identity(self) -> bool:
        return self == IDENTITY

    # -- encoding ----------------------------------------------------------
    def compress(self) -> bytes:
        """RFC 9496 ENCODE (upstream RistrettoPoint::compress), native."""
        return compress_batch([self.ep])[0]

    def _compress_py(self) -> bytes:
        """compress's pure-Python twin."""
        X, Y, Z, T = self.ep
        u1 = (Z + Y) * (Z - Y) % P
        u2 = X * Y % P
        _, invsqrt = field.invsqrt(u1 * u2 % P * u2 % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * T % P
        ix0 = X * SQRT_M1 % P
        iy0 = Y * SQRT_M1 % P
        enchanted_denominator = den1 * INVSQRT_A_MINUS_D % P
        rotate = field.is_negative(T * z_inv % P)
        if rotate:
            x, y, den_inv = iy0, ix0, enchanted_denominator
        else:
            x, y, den_inv = X, Y, den2
        if field.is_negative(x * z_inv % P):
            y = (-y) % P
        s = field.ct_abs(den_inv * ((Z - y) % P) % P)
        return field.to_bytes(s)

    @staticmethod
    def decompress(b: bytes) -> "RistrettoPoint":
        """RFC 9496 DECODE (upstream CompressedRistretto::decompress),
        native.  Raises ValueError on invalid encodings."""
        return decompress_many([b])[0]

    @staticmethod
    def _decompress_py(b: bytes) -> "RistrettoPoint":
        """decompress's pure-Python twin."""
        if len(b) != 32:
            raise ValueError("ristretto encoding must be 32 bytes")
        s = field.from_bytes_strict(b)
        if field.is_negative(s):
            raise ValueError("ristretto encoding: s is negative")
        ss = s * s % P
        u1 = (1 - ss) % P
        u2 = (1 + ss) % P
        u2_sqr = u2 * u2 % P
        v = ((-EDWARDS_D * u1 % P * u1) - u2_sqr) % P
        was_square, invsqrt = field.invsqrt(v * u2_sqr % P)
        den_x = invsqrt * u2 % P
        den_y = invsqrt * den_x % P * v % P
        x = field.ct_abs(2 * s * den_x % P)
        y = u1 * den_y % P
        t = x * y % P
        if (not was_square) or field.is_negative(t) or y == 0:
            raise ValueError("invalid ristretto encoding")
        return RistrettoPoint((x, y, 1, t))

    # -- hash-to-group -----------------------------------------------------
    @staticmethod
    def from_uniform_bytes(b: bytes) -> "RistrettoPoint":
        """RFC 9496 one-way map on 64 uniform bytes = MAP(t1) + MAP(t2)
        (upstream RistrettoPoint::from_uniform_bytes)."""
        assert len(b) == 64
        r1 = field.from_bytes(b[:32])
        r2 = field.from_bytes(b[32:])
        return RistrettoPoint(
            edwards.add(_elligator_map(r1), _elligator_map(r2))
        )

    @staticmethod
    def hash_from_bytes_sha3_512(data: bytes) -> "RistrettoPoint":
        """RistrettoPoint::hash_from_bytes::<Sha3_512> — used by PedersenGens
        to derive B_blinding from the compressed basepoint
        (bulletproofs/src/generators.rs)."""
        import hashlib
        return RistrettoPoint.from_uniform_bytes(hashlib.sha3_512(data).digest())

    def __repr__(self):
        return f"RistrettoPoint({self.compress().hex()})"


def decompress_many(encodings: list[bytes]) -> list[RistrettoPoint]:
    """DECODE every encoding in one native call; raises ValueError on the
    first invalid one.  Each point keeps its canonical words (the native
    coordinates are the engine's upload form, kernels/engine.py)."""
    n = len(encodings)
    for b in encodings:
        if len(b) != 32:
            raise ValueError("ristretto encoding must be 32 bytes")
    if n == 0:
        return []
    coords, ok = native.decompress_batch_raw(b"".join(encodings), n)
    words = np.frombuffer(coords, np.uint32).reshape(n, 4, 8)
    out = []
    for i in range(n):
        if not ok[i]:
            raise ValueError(f"invalid ristretto encoding at index {i}")
        o = coords[128 * i: 128 * (i + 1)]
        p = RistrettoPoint(tuple(int.from_bytes(o[32 * k: 32 * k + 32],
                                                "little") for k in range(4)))
        p._words = words[i]
        out.append(p)
    return out


def decompress_many_plain(encodings: list[bytes]) -> list[RistrettoPoint]:
    """decompress_many's pure-Python twin."""
    return [RistrettoPoint._decompress_py(b) for b in encodings]


def compress_batch(eps: list[edwards.Point]) -> list[bytes]:
    """ENCODE extended points in one native call."""
    n = len(eps)
    if n == 0:
        return []
    raw = native.compress_batch_raw(
        b"".join((c % P).to_bytes(32, "little") for ep in eps for c in ep), n)
    return [raw[32 * i: 32 * (i + 1)] for i in range(n)]


def _elligator_map(t: int) -> edwards.Point:
    """RFC 9496 §4.3.4 MAP: field element -> curve point."""
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = ((-1 - r * EDWARDS_D) % P) * ((r + EDWARDS_D) % P) % P
    was_square, s = field.sqrt_ratio(u, v)
    s_prime = (-field.ct_abs(s * t % P)) % P
    if not was_square:
        s = s_prime
        c = r
    else:
        c = (-1) % P
    N = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s * v % P
    w1 = N * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return (w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


IDENTITY = RistrettoPoint(edwards.IDENTITY)
BASEPOINT = RistrettoPoint(edwards.BASEPOINT)

