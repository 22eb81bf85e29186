"""Scalars mod ℓ = 2^252 + 27742...493, the Ristretto255 group order.

Upstream counterpart: curve25519-dalek src/scalar.rs.  Pure Python: the
port carries no native host module yet.
"""

from ..constants import L

__all__ = [
    "add", "sub", "neg", "mul", "invert", "batch_invert",
    "from_bytes_mod_order", "from_bytes_mod_order_wide", "from_canonical_bytes",
    "to_bytes", "sum_of_powers",
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
    return pow(a, L - 2, L)


def batch_invert(xs: list[int]) -> list[int]:
    """Montgomery-trick batch inversion mod ℓ (upstream Scalar::batch_invert).
    Zero entries invert to zero."""
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

