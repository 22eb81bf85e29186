"""Vectors of scalars mod ℓ, packed as 32-byte little-endian canonical
encodings.

Counterpart of the JAX package's native.ScalarVec, whose C++ module the
port does not carry: a pure-Python copy of the operations the R1CS
verifier and the range-proof mega-check use.  The packed buffer is the
same byte for byte, so it goes to the device as u32 words unchanged
(kernels/batch_verify_device.py, kernels/frontend.py).
Operations are elementwise and return new vectors.
"""

from __future__ import annotations

from ..constants import L


class ScalarVec:
    __slots__ = ("buf", "n")

    def __init__(self, buf: bytes, n: int):
        if len(buf) != 32 * n:
            raise ValueError("a ScalarVec buffer holds 32 bytes per scalar")
        self.buf = buf
        self.n = n

    @staticmethod
    def from_ints(xs) -> "ScalarVec":
        xs = [int(x) % L for x in xs]
        return ScalarVec(b"".join(x.to_bytes(32, "little") for x in xs),
                         len(xs))

    def to_ints(self) -> list[int]:
        b = self.buf
        return [int.from_bytes(b[32 * i: 32 * i + 32], "little")
                for i in range(self.n)]

    def __len__(self) -> int:
        return self.n

    def reverse(self) -> "ScalarVec":
        b = self.buf
        return ScalarVec(b"".join(b[32 * i: 32 * i + 32]
                                  for i in range(self.n - 1, -1, -1)), self.n)

    def _zip(self, other: "ScalarVec", op) -> "ScalarVec":
        if self.n != other.n:
            raise ValueError("ScalarVec lengths differ")
        return ScalarVec.from_ints(op(a, b) for a, b in
                                   zip(self.to_ints(), other.to_ints()))

    def mul(self, other: "ScalarVec") -> "ScalarVec":
        return self._zip(other, lambda a, b: a * b)

    def add(self, other: "ScalarVec") -> "ScalarVec":
        return self._zip(other, lambda a, b: a + b)

    def sub(self, other: "ScalarVec") -> "ScalarVec":
        return self._zip(other, lambda a, b: a - b)

    def scale(self, k: int) -> "ScalarVec":
        k = int(k) % L
        return ScalarVec.from_ints(a * k for a in self.to_ints())

    def axpb(self, x: int, b: int) -> "ScalarVec":
        """self[i] * x + b."""
        x, b = int(x) % L, int(b) % L
        return ScalarVec.from_ints(a * x + b for a in self.to_ints())

    @staticmethod
    def concat(*vecs: "ScalarVec") -> "ScalarVec":
        return ScalarVec(b"".join(v.buf for v in vecs), sum(v.n for v in vecs))

    def inner(self, other: "ScalarVec") -> int:
        if self.n != other.n:
            raise ValueError("ScalarVec lengths differ")
        return sum(a * b for a, b in zip(self.to_ints(),
                                         other.to_ints())) % L

    @staticmethod
    def powers(x: int, n: int) -> "ScalarVec":
        """[1, x, x^2, ..., x^(n-1)]."""
        x = int(x) % L
        out, acc = [], 1
        for _ in range(n):
            out.append(acc)
            acc = acc * x % L
        return ScalarVec.from_ints(out)
