"""Vectors of scalars mod ℓ, packed as 32-byte little-endian canonical
encodings.

Counterpart of the JAX package's native.ScalarVec.  ScalarVec runs every
operation in the port's C++ host library (native/scalarvec.cpp's scl_*
entries); PlainScalarVec is its pure-Python twin, which the tests and
chip_smoke.py hold it against.  The packed buffer is the same byte for
byte in both, so it goes to the device as u32 words unchanged
(kernels/batch_verify_device.py, kernels/frontend.py).  Operations are
elementwise and return new vectors; every buffer holds canonical scalars
(below ℓ), as the library requires.
"""

from __future__ import annotations

import ctypes

from .. import native
from ..constants import L


def _le(x: int) -> bytes:
    return (int(x) % L).to_bytes(32, "little")


class _Packed:
    """The packed layout shared by ScalarVec and its twin."""

    __slots__ = ("buf", "n")

    def __init__(self, buf: bytes, n: int):
        if len(buf) != 32 * n:
            raise ValueError("a ScalarVec buffer holds 32 bytes per scalar")
        self.buf = buf
        self.n = n

    @classmethod
    def from_ints(cls, xs):
        xs = [int(x) % L for x in xs]
        return cls(b"".join(x.to_bytes(32, "little") for x in xs), len(xs))

    def to_ints(self) -> list[int]:
        b = self.buf
        return [int.from_bytes(b[32 * i: 32 * i + 32], "little")
                for i in range(self.n)]

    def __len__(self) -> int:
        return self.n

    def reverse(self):
        b = self.buf
        return type(self)(b"".join(b[32 * i: 32 * i + 32]
                                   for i in range(self.n - 1, -1, -1)),
                          self.n)

    @classmethod
    def concat(cls, *vecs):
        return cls(b"".join(v.buf for v in vecs), sum(v.n for v in vecs))

    def _same_length(self, *others):
        if any(o.n != self.n for o in others):
            raise ValueError("ScalarVec lengths differ")


class ScalarVec(_Packed):
    """A vector of scalars mod ℓ whose operations run in the native
    library."""

    __slots__ = ()

    def _out(self, fn, *args) -> "ScalarVec":
        out = ctypes.create_string_buffer(max(32 * self.n, 1))
        fn(*args, out)
        return ScalarVec(out.raw[:32 * self.n], self.n)

    def _scalar(self, fn, *args) -> int:
        out = ctypes.create_string_buffer(32)
        fn(*args, out)
        return int.from_bytes(out.raw, "little")

    def mul(self, other: "ScalarVec") -> "ScalarVec":
        self._same_length(other)
        return self._out(native.lib().scl_mul, self.buf, other.buf, self.n)

    def add(self, other: "ScalarVec") -> "ScalarVec":
        self._same_length(other)
        return self._out(native.lib().scl_add, self.buf, other.buf, self.n)

    def sub(self, other: "ScalarVec") -> "ScalarVec":
        self._same_length(other)
        return self._out(native.lib().scl_sub, self.buf, other.buf, self.n)

    def scale(self, k: int) -> "ScalarVec":
        return self._out(native.lib().scl_mul_scalar, self.buf, _le(k),
                         self.n)

    def axpb(self, x: int, b: int) -> "ScalarVec":
        """self[i] * x + b."""
        return self._out(native.lib().scl_axpb, self.buf, _le(x), _le(b),
                         self.n)

    def muladd(self, other: "ScalarVec", addend: "ScalarVec") -> "ScalarVec":
        """self[i] * other[i] + addend[i]."""
        self._same_length(other, addend)
        return self._out(native.lib().scl_muladd, self.buf, other.buf,
                         addend.buf, self.n)

    def neg(self) -> "ScalarVec":
        return self._out(native.lib().scl_neg, self.buf, self.n)

    def batch_invert(self) -> "ScalarVec":
        """Elementwise inverse, zero -> zero (Montgomery's trick)."""
        return self._out(native.lib().scl_batch_invert, self.buf, self.n)

    def sum(self) -> int:
        return self._scalar(native.lib().scl_sum, self.buf, self.n)

    def inner(self, other: "ScalarVec") -> int:
        self._same_length(other)
        return self._scalar(native.lib().scl_inner, self.buf, other.buf,
                            self.n)

    @staticmethod
    def powers(x: int, n: int) -> "ScalarVec":
        """[1, x, x^2, ..., x^(n-1)]."""
        out = ctypes.create_string_buffer(max(32 * n, 1))
        native.lib().scl_powers(_le(x), n, out)
        return ScalarVec(out.raw[:32 * n], n)

    @staticmethod
    def from_wide_bytes(blob: bytes, n: int) -> "ScalarVec":
        """n 64-byte blocks, each reduced mod ℓ (from_bytes_mod_order_wide)."""
        if len(blob) != 64 * n:
            raise ValueError("from_wide_bytes takes 64 bytes per scalar")
        out = ctypes.create_string_buffer(max(32 * n, 1))
        native.lib().scl_from_wide(blob, n, out)
        return ScalarVec(out.raw[:32 * n], n)


class PlainScalarVec(_Packed):
    """ScalarVec's pure-Python twin: the same operations on Python ints."""

    __slots__ = ()

    def _zip(self, op, *others) -> "PlainScalarVec":
        self._same_length(*others)
        cols = [self.to_ints()] + [o.to_ints() for o in others]
        return PlainScalarVec.from_ints(op(*t) for t in zip(*cols))

    def mul(self, other):
        return self._zip(lambda a, b: a * b, other)

    def add(self, other):
        return self._zip(lambda a, b: a + b, other)

    def sub(self, other):
        return self._zip(lambda a, b: a - b, other)

    def scale(self, k: int):
        k = int(k) % L
        return PlainScalarVec.from_ints(a * k for a in self.to_ints())

    def axpb(self, x: int, b: int):
        """self[i] * x + b."""
        x, b = int(x) % L, int(b) % L
        return PlainScalarVec.from_ints(a * x + b for a in self.to_ints())

    def muladd(self, other, addend):
        """self[i] * other[i] + addend[i]."""
        return self._zip(lambda a, b, c: a * b + c, other, addend)

    def neg(self):
        return PlainScalarVec.from_ints(-a for a in self.to_ints())

    def batch_invert(self):
        """Elementwise inverse, zero -> zero."""
        from ..oracle.scalar import batch_invert_plain
        return PlainScalarVec.from_ints(batch_invert_plain(self.to_ints()))

    def sum(self) -> int:
        return sum(self.to_ints()) % L

    def inner(self, other) -> int:
        self._same_length(other)
        return sum(a * b for a, b in zip(self.to_ints(),
                                         other.to_ints())) % L

    @staticmethod
    def powers(x: int, n: int):
        """[1, x, x^2, ..., x^(n-1)]."""
        x = int(x) % L
        out, acc = [], 1
        for _ in range(n):
            out.append(acc)
            acc = acc * x % L
        return PlainScalarVec.from_ints(out)

    @staticmethod
    def from_wide_bytes(blob: bytes, n: int):
        """n 64-byte blocks, each reduced mod ℓ."""
        if len(blob) != 64 * n:
            raise ValueError("from_wide_bytes takes 64 bytes per scalar")
        return PlainScalarVec.from_ints(
            int.from_bytes(blob[64 * i: 64 * i + 64], "little")
            for i in range(n))
