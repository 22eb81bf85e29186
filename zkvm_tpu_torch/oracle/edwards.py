"""Twisted Edwards curve (-x² + y² = 1 + d x²y²) in extended coordinates.

Upstream counterpart: curve25519-dalek src/edwards.rs + src/backend/serial/curve_models
(ExtendedPoint / CompletedPoint / Niels points).  Formulas are the unified
add-2008-hwcd-3 (a = -1, k = 2d) and dbl-2008-hwcd, both branch-free — the same
formulas the CUDA kernels implement over limb arrays (kernels/csrc/field25519.cuh).

A point is the tuple (X, Y, Z, T) of ints with x = X/Z, y = Y/Z, T = XY/Z.
"""

from ..constants import P, EDWARDS_D2, BASE_X, BASE_Y, BASE_T

Point = tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)
BASEPOINT: Point = (BASE_X, BASE_Y, 1, BASE_T)


def add(p: Point, q: Point) -> Point:
    """Unified extended addition (add-2008-hwcd-3): 8M + 1 k-mult, complete on
    the prime-order (Ristretto) subgroup, valid for doubling and identity."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * EDWARDS_D2 % P * T2 % P
    D = 2 * Z1 * Z2 % P
    E = (B - A) % P
    F = (D - C) % P
    G = (D + C) % P
    H = (B + A) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def double(p: Point) -> Point:
    """dbl-2008-hwcd with a = -1: 4M + 4S."""
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    D = (-A) % P
    E = ((X1 + Y1) * (X1 + Y1) - A - B) % P
    G = (D + B) % P
    F = (G - C) % P
    H = (D - B) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def neg(p: Point) -> Point:
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def sub(p: Point, q: Point) -> Point:
    return add(p, neg(q))


def scalar_mul(k: int, p: Point) -> Point:
    """Variable-base scalar multiplication, fixed 4-bit windows
    (oracle stand-in for upstream radix-16 / NAF paths)."""
    k = int(k)
    if k == 0:
        return IDENTITY
    # Precompute 0..15 multiples.
    table = [IDENTITY, p]
    for i in range(2, 16):
        table.append(add(table[i - 1], p))
    digits = []
    while k:
        digits.append(k & 15)
        k >>= 4
    acc = table[digits[-1]]
    for d in reversed(digits[:-1]):
        acc = double(double(double(double(acc))))
        acc = add(acc, table[d])
    return acc
