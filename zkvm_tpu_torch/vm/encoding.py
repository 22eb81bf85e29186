"""Byte-level wire encoding: little-endian reader/writer.

Upstream counterpart: slingshot/zkvm/src/encoding.rs — SliceReader with typed
LE reads, length-prefixed byte strings, and Encodable writers.
"""

from __future__ import annotations

from .errors import FormatError


class Reader:
    """Consuming LE byte reader (upstream SliceReader)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def done(self) -> bool:
        return self.pos == len(self.data)

    def read_bytes(self, n: int) -> bytes:
        if self.remaining() < n:
            raise FormatError("unexpected end of data")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def read_u8(self) -> int:
        return self.read_bytes(1)[0]

    def read_u32(self) -> int:
        return int.from_bytes(self.read_bytes(4), "little")

    def read_u64(self) -> int:
        return int.from_bytes(self.read_bytes(8), "little")

    def read_u8x32(self) -> bytes:
        return self.read_bytes(32)

    def read_prefixed_bytes(self) -> bytes:
        n = self.read_u32()
        return self.read_bytes(n)


class Writer:
    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def write_bytes(self, b: bytes):
        self.buf += b

    def write_u8(self, v: int):
        self.buf += bytes([v & 0xFF])

    def write_u32(self, v: int):
        self.buf += int(v).to_bytes(4, "little")

    def write_u64(self, v: int):
        self.buf += int(v).to_bytes(8, "little")

    def write_prefixed_bytes(self, b: bytes):
        self.write_u32(len(b))
        self.write_bytes(b)

    def to_bytes(self) -> bytes:
        return bytes(self.buf)
