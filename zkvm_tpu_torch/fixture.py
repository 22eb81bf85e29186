"""The committed range-proof fixture: real proofs the port can read on a
machine without the JAX package (tests/test_torch_fixture.py makes it).

File layout (little-endian): magic b"ZKRP0001", u32 n, u32 m, u32 count,
u32 label length, the transcript label, then per proof its m value
commitments (32 bytes each) and its wire bytes (224 + 64 lg(nm) + 64).
"""

from __future__ import annotations

import struct
from pathlib import Path

FIXTURE = Path(__file__).resolve().parent / "data" / "rangeproofs_n64_m1.bin"
MAGIC = b"ZKRP0001"


def wire_len(n: int, m: int) -> int:
    return 224 + 64 * ((n * m).bit_length() - 1) + 64


def dump(path, label: bytes, n: int, m: int, records) -> None:
    """records: [(wire bytes, [value commitments])]."""
    blob = bytearray(MAGIC + struct.pack("<IIII", n, m, len(records),
                                         len(label)) + label)
    for wire, vcs in records:
        if len(wire) != wire_len(n, m) or len(vcs) != m:
            raise ValueError("record does not match n and m")
        blob += b"".join(vcs) + wire
    Path(path).write_bytes(bytes(blob))


def load(path=FIXTURE):
    """-> (label, n, m, [(wire bytes, [value commitments])])."""
    data = Path(path).read_bytes()
    if data[:8] != MAGIC:
        raise ValueError("not a range-proof fixture")
    n, m, count, llen = struct.unpack_from("<IIII", data, 8)
    off = 24
    label = data[off: off + llen]
    off += llen
    size = 32 * m + wire_len(n, m)
    if len(data) != off + count * size:
        raise ValueError("truncated range-proof fixture")
    records = []
    for i in range(count):
        rec = data[off + i * size: off + (i + 1) * size]
        records.append((rec[32 * m:], [rec[32 * j: 32 * j + 32]
                                       for j in range(m)]))
    return label, n, m, records
