"""Scalars mod ℓ = 2^252 + 27742...493, the Ristretto255 group order.

Upstream counterpart: curve25519-dalek src/scalar.rs.  Inversion runs in
the port's C++ host library (native/scalarvec.cpp, Montgomery's trick);
invert_plain and batch_invert_plain are its pure-Python twins.
"""

import ctypes

from .. import native
from ..constants import L

__all__ = [
    "add", "sub", "neg", "mul", "invert", "batch_invert", "invert_plain",
    "batch_invert_plain",
    "from_bytes_mod_order", "from_bytes_mod_order_wide", "from_canonical_bytes",
    "to_bytes", "sum_of_powers", "inner_product",
]


def add(a: int, b: int) -> int:
    return (a + b) % L


def sub(a: int, b: int) -> int:
    return (a - b) % L


def neg(a: int) -> int:
    return (-a) % L


def mul(a: int, b: int) -> int:
    return (a * b) % L


def invert(a: int) -> int:
    """a^-1 mod ℓ (zero -> zero), in the native library."""
    return batch_invert([a])[0]


def batch_invert(xs: list[int]) -> list[int]:
    """Montgomery-trick batch inversion mod ℓ (upstream Scalar::batch_invert)
    in the native library.  Zero entries invert to zero."""
    n = len(xs)
    buf = b"".join((int(x) % L).to_bytes(32, "little") for x in xs)
    out = ctypes.create_string_buffer(max(32 * n, 1))
    native.lib().scl_batch_invert(buf, n, out)
    raw = out.raw
    return [int.from_bytes(raw[32 * i: 32 * i + 32], "little")
            for i in range(n)]


def invert_plain(a: int) -> int:
    """invert's pure-Python twin."""
    return pow(a, L - 2, L)


def batch_invert_plain(xs: list[int]) -> list[int]:
    """batch_invert's pure-Python twin.  Zero entries invert to zero."""
    xs = [int(x) % L for x in xs]
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * (x if x != 0 else 1) % L
    inv = pow(prefix[n], L - 2, L)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        x = xs[i]
        if x == 0:
            out[i] = 0
        else:
            out[i] = inv * prefix[i] % L
            inv = inv * x % L
    return out


def from_bytes_mod_order(b: bytes) -> int:
    assert len(b) == 32
    return int.from_bytes(b, "little") % L


def from_bytes_mod_order_wide(b: bytes) -> int:
    """Reduce 64 uniform bytes mod ℓ (upstream Scalar::from_bytes_mod_order_wide)."""
    assert len(b) == 64
    return int.from_bytes(b, "little") % L


def from_canonical_bytes(b: bytes) -> int:
    assert len(b) == 32
    x = int.from_bytes(b, "little")
    if x >= L:
        raise ValueError("non-canonical scalar encoding")
    return x


def to_bytes(a: int) -> bytes:
    return (a % L).to_bytes(32, "little")


def sum_of_powers(x: int, n: int) -> int:
    """1 + x + ... + x^{n-1} mod ℓ (upstream util::sum_of_powers)."""
    acc, cur = 0, 1
    for _ in range(n):
        acc = (acc + cur) % L
        cur = cur * x % L
    return acc


def inner_product(a: list[int], b: list[int]) -> int:
    """<a, b> mod ℓ (upstream util::inner_product)."""
    assert len(a) == len(b)
    return sum(x * y for x, y in zip(a, b)) % L
