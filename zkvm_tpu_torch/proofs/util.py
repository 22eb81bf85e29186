"""Small helpers of the proof layer (upstream bulletproofs/src/util.rs):
the provers' vector and polynomial arithmetic mod ℓ on Python ints
(VecPoly1 and Poly2 for the range prover, VecPoly3 and Poly6 for the R1CS
prover, whose VecPoly3 chain is the twin of its ScalarVec chain), bit
decomposition, and a timing helper."""

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


class VecPoly3:
    """Degree-3 vector polynomial (upstream VecPoly3, used by the R1CS
    prover)."""

    def __init__(self, v0, v1, v2, v3):
        self.v = [v0, v1, v2, v3]

    @classmethod
    def zero(cls, n: int) -> "VecPoly3":
        return cls(*[[0] * n for _ in range(4)])

    def special_inner_product(self, rhs: "VecPoly3") -> "Poly6":
        """<l(X), r(X)> with the R1CS structure: self.v[0] == 0 and
        rhs.v[2] == 0 (l = l1 X + l2 X² + l3 X³;  r = r0 + r1 X + r3 X³).
        Upstream VecPoly3::special_inner_product."""
        l = self.v
        r = rhs.v
        t1 = inner_product(l[1], r[0])
        t2 = (inner_product(l[1], r[1]) + inner_product(l[2], r[0])) % L
        t3 = (inner_product(l[2], r[1]) + inner_product(l[3], r[0])) % L
        t4 = (inner_product(l[1], r[3]) + inner_product(l[3], r[1])) % L
        t5 = inner_product(l[2], r[3])
        t6 = inner_product(l[3], r[3])
        return Poly6(0, t1, t2, t3, t4, t5, t6)

    def eval(self, x: int) -> list[int]:
        n = len(self.v[0])
        out = []
        for i in range(n):
            acc = 0
            for coeff in reversed(self.v):
                acc = (acc * x + coeff[i]) % L
            out.append(acc)
        return out


class Poly6:
    """t(X) = sum t_i X^i, degree 6 (upstream Poly6)."""

    def __init__(self, *ts):
        if len(ts) != 7:
            raise ValueError("Poly6 takes seven coefficients")
        self.t = [t % L for t in ts]

    def eval(self, x: int) -> int:
        acc = 0
        for coeff in reversed(self.t):
            acc = (acc * x + coeff) % L
        return acc


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
