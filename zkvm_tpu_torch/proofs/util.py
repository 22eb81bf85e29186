"""Small helpers of the proof layer (upstream bulletproofs/src/util.rs):
the range prover's vector and polynomial arithmetic mod ℓ on Python ints
(VecPoly1, Poly2), bit decomposition, and a timing helper.  VecPoly3 and
Poly6 belong to the R1CS prover, which the port does not have yet."""

import time

from ..constants import L
from ..oracle.scalar import inner_product


def vec_add(a: list[int], b: list[int]) -> list[int]:
    return [(x + y) % L for x, y in zip(a, b, strict=True)]


def vec_sub(a: list[int], b: list[int]) -> list[int]:
    return [(x - y) % L for x, y in zip(a, b, strict=True)]


def vec_mul(a: list[int], b: list[int]) -> list[int]:
    """Hadamard product."""
    return [x * y % L for x, y in zip(a, b, strict=True)]


def vec_scale(a: list[int], c: int) -> list[int]:
    return [x * c % L for x in a]


def powers(x: int, n: int) -> list[int]:
    """[1, x, ..., x^(n-1)] mod ℓ."""
    out, cur = [], 1
    for _ in range(n):
        out.append(cur)
        cur = cur * x % L
    return out


class VecPoly1:
    """l(X) = v0 + v1·X with vector coefficients (upstream VecPoly1)."""

    def __init__(self, v0: list[int], v1: list[int]):
        self.v0, self.v1 = v0, v1

    def inner_product(self, other: "VecPoly1") -> "Poly2":
        """<l(X), r(X)> by the Karatsuba trick (upstream
        VecPoly1::inner_product)."""
        t0 = inner_product(self.v0, other.v0)
        t2 = inner_product(self.v1, other.v1)
        l0_plus_l1 = vec_add(self.v0, self.v1)
        r0_plus_r1 = vec_add(other.v0, other.v1)
        t1 = (inner_product(l0_plus_l1, r0_plus_r1) - t0 - t2) % L
        return Poly2(t0, t1, t2)

    def eval(self, x: int) -> list[int]:
        return [(a + b * x) % L for a, b in zip(self.v0, self.v1)]


class Poly2:
    """t(X) = t0 + t1·X + t2·X² (upstream Poly2)."""

    def __init__(self, t0: int, t1: int, t2: int):
        self.t0, self.t1, self.t2 = t0 % L, t1 % L, t2 % L

    def eval(self, x: int) -> int:
        return (self.t0 + x * (self.t1 + x * self.t2)) % L


def bit_decompose(v: int, n: int) -> list[int]:
    """a_L bits of v, little-endian, length n."""
    return [(v >> i) & 1 for i in range(n)]


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def add_time(timings: dict | None, key: str, since: float) -> None:
    """timings[key] += the seconds since `since` (no-op without timings)."""
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - since
