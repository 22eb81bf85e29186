"""GF(2^255 - 19) reference arithmetic on Python ints.

Upstream counterpart: curve25519-dalek src/field.rs + backend/serial/{u32,u64}/field.rs
(FieldElement2625 / FieldElement51).  Here a field element is simply an int in [0, p).

The only nontrivial routine is ``sqrt_ratio`` (sqrt_ratio_i upstream), which underpins
Ristretto compress/decompress and the Elligator map; its sign conventions follow
RFC 9496: the returned root is always "nonnegative" (even).
"""

from ..constants import P, SQRT_M1

__all__ = [
    "add", "sub", "neg", "mul", "sqr", "invert", "batch_invert",
    "pow_p58", "sqrt_ratio", "invsqrt", "is_negative", "ct_abs",
    "to_bytes", "from_bytes", "from_bytes_strict",
]


def add(a: int, b: int) -> int:
    return (a + b) % P


def sub(a: int, b: int) -> int:
    return (a - b) % P


def neg(a: int) -> int:
    return (-a) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def sqr(a: int) -> int:
    return (a * a) % P


def invert(a: int) -> int:
    """Fermat inversion a^(p-2); invert(0) = 0 as upstream."""
    return pow(a, P - 2, P)


def batch_invert(xs: list[int]) -> list[int]:
    """Montgomery-trick batch inversion (upstream: FieldElement::batch_invert /
    Scalar::batch_invert pattern).  Zero entries invert to zero."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * (x if x != 0 else 1) % P
    inv = pow(prefix[n], P - 2, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        x = xs[i]
        if x == 0:
            out[i] = 0
        else:
            out[i] = inv * prefix[i] % P
            inv = inv * x % P
    return out


def pow_p58(a: int) -> int:
    """a^((p-5)/8), the exponentiation at the heart of sqrt_ratio."""
    return pow(a, (P - 5) // 8, P)


def is_negative(a: int) -> bool:
    """RFC 9496 "negative" = odd canonical representative."""
    return (a % P) & 1 == 1


def ct_abs(a: int) -> int:
    a %= P
    return P - a if a & 1 else a


def sqrt_ratio(u: int, v: int) -> tuple[bool, int]:
    """Compute sqrt(u/v) if it exists (upstream FieldElement::sqrt_ratio_i).

    Returns (was_square, r) where r is the nonnegative root of u/v when
    was_square, else the nonnegative root of SQRT_M1*(u/v).
    sqrt_ratio(0, 0) = (True, 0); sqrt_ratio(u, 0) = (False, 0) for u != 0.
    """
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow_p58(u * v7 % P) % P
    check = v * r % P * r % P

    correct_sign = check == u
    flipped_sign = check == (P - u) % P
    flipped_sign_i = check == (P - u) * SQRT_M1 % P

    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P

    was_square = correct_sign or flipped_sign
    return was_square, ct_abs(r)


def invsqrt(a: int) -> tuple[bool, int]:
    """1/sqrt(a): sqrt_ratio(1, a)."""
    return sqrt_ratio(1, a)


def to_bytes(a: int) -> bytes:
    return (a % P).to_bytes(32, "little")


def from_bytes(b: bytes) -> int:
    """Mask the top bit and reduce — upstream FieldElement::from_bytes semantics."""
    assert len(b) == 32
    return (int.from_bytes(b, "little") & ((1 << 255) - 1)) % P


def from_bytes_strict(b: bytes) -> int:
    """Reject non-canonical encodings (needed by Ristretto decompress)."""
    assert len(b) == 32
    x = int.from_bytes(b, "little")
    if x >= P:
        raise ValueError("non-canonical field element encoding")
    return x
