"""The committed proof fixtures: real proofs the port can read on a machine
without the JAX package (tests/test_torch_fixture.py and
tests/test_torch_r1cs_fixture.py make them with the JAX package's prover).

Range proofs (little-endian): magic b"ZKRP0001", u32 n, u32 m, u32 count,
u32 label length, the transcript label, then per proof its m value
commitments (32 bytes each) and its wire bytes (224 + 64 lg(nm) + 64).
Range proofs of mixed aggregation sizes: magic b"ZKRPM001", u32 n, u32
count, u32 label length, the label, then per proof u32 m, its m value
commitments and its wire bytes.

R1CS proofs (little-endian): magic b"ZKR1CS01", u32 label length, the
label, u32 circuit-name length, the name, u32 generator capacity (the
proof's padded multiplier count), u32 parameter count, the u32
parameters, u32 commitment count, the commitments (32 bytes each), then
the proof's wire bytes to the end.  Circuits: "cloak" with parameters
(inputs, outputs, range bits) over allocated values, and "range" with
(bits,), one range gadget per committed value.

ZkVM transactions (little-endian; tests/test_torch_tx_fixture.py makes
them): magic b"ZKTX0001", u32 generator capacity, u32 count, then per
transaction a u8 kind tag (an index into TX_KINDS), u32 wire length, the
wire bytes (Tx.to_bytes()) and the 32-byte txid the JAX package's
verifier computed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"
FIXTURE = DATA / "rangeproofs_n64_m1.bin"
FIXTURE_MIXED = DATA / "rangeproofs_n64_mixed.bin"
R1CS_CLOAK = DATA / "r1cs_cloak4x4_64.bin"
R1CS_RANGE = DATA / "r1cs_range512x64.bin"
MAGIC = b"ZKRP0001"
MIXED_MAGIC = b"ZKRPM001"
R1CS_MAGIC = b"ZKR1CS01"
TXS_BLOCK = DATA / "txs_block256.bin"
TX_MAGIC = b"ZKTX0001"
TX_KINDS = ("issue", "payment", "call", "signid", "signtag", "unblind",
            "borrow_retire", "fee")


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


def dump_mixed(path, label: bytes, n: int, records) -> None:
    """records: [(wire bytes, [value commitments])], any m each."""
    blob = bytearray(MIXED_MAGIC + struct.pack("<III", n, len(records),
                                               len(label)) + label)
    for wire, vcs in records:
        m = len(vcs)
        if m == 0 or len(wire) != wire_len(n, m):
            raise ValueError("record does not match n and its m")
        blob += struct.pack("<I", m) + b"".join(vcs) + wire
    Path(path).write_bytes(bytes(blob))


def load_mixed(path=FIXTURE_MIXED):
    """-> (label, n, [(wire bytes, [value commitments])]), m = len(vcs)."""
    data = Path(path).read_bytes()
    if data[:8] != MIXED_MAGIC:
        raise ValueError("not a mixed range-proof fixture")
    n, count, llen = struct.unpack_from("<III", data, 8)
    off = 20
    label = data[off: off + llen]
    off += llen
    records = []
    for _ in range(count):
        if off + 4 > len(data):
            raise ValueError("truncated mixed range-proof fixture")
        (m,) = struct.unpack_from("<I", data, off)
        off += 4
        size = 32 * m + wire_len(n, m)
        rec = data[off: off + size]
        if m == 0 or len(rec) != size:
            raise ValueError("truncated mixed range-proof fixture")
        off += size
        records.append((rec[32 * m:], [rec[32 * j: 32 * j + 32]
                                       for j in range(m)]))
    if off != len(data):
        raise ValueError("trailing bytes in a mixed range-proof fixture")
    return label, n, records


# ------------------------------------------------------------------- R1CS
@dataclass
class R1CSFixture:
    label: bytes
    circuit: str
    gens_capacity: int
    params: tuple[int, ...]
    commitments: list[bytes]
    wire: bytes


def dump_r1cs(path, fx: R1CSFixture) -> None:
    name = fx.circuit.encode()
    blob = (R1CS_MAGIC + struct.pack("<I", len(fx.label)) + fx.label
            + struct.pack("<I", len(name)) + name
            + struct.pack("<II", fx.gens_capacity, len(fx.params))
            + struct.pack(f"<{len(fx.params)}I", *fx.params)
            + struct.pack("<I", len(fx.commitments))
            + b"".join(fx.commitments) + fx.wire)
    Path(path).write_bytes(blob)


def load_r1cs(path) -> R1CSFixture:
    data = Path(path).read_bytes()
    if data[:8] != R1CS_MAGIC:
        raise ValueError("not an R1CS fixture")
    off = 8

    def take(size: int) -> bytes:
        nonlocal off
        if off + size > len(data):
            raise ValueError("truncated R1CS fixture")
        off += size
        return data[off - size: off]

    def u32() -> int:
        return struct.unpack("<I", take(4))[0]

    label = take(u32())
    circuit = take(u32()).decode()
    gens_capacity = u32()
    params = tuple(u32() for _ in range(u32()))
    commitments = [take(32) for _ in range(u32())]
    return R1CSFixture(label, circuit, gens_capacity, params, commitments,
                       data[off:])


def r1cs_verifier(fx: R1CSFixture):
    """A Verifier with the fixture's circuit laid on it, ready for verify."""
    from .gadgets import allocate_value, cloak, range_proof_gadget
    from .proofs.r1cs import Verifier
    from .proofs.transcript import ProofTranscript

    verifier = Verifier(ProofTranscript(fx.label))
    if fx.circuit == "cloak":
        k_in, k_out, bits = fx.params
        ins = [allocate_value(verifier, None) for _ in range(k_in)]
        outs = [allocate_value(verifier, None) for _ in range(k_out)]
        cloak(verifier, ins, outs, range_bits=bits)
    elif fx.circuit == "range":
        (bits,) = fx.params
        for com in fx.commitments:
            range_proof_gadget(verifier, verifier.commit(com), bits, None)
    else:
        raise ValueError(f"unknown circuit {fx.circuit!r}")
    return verifier


# ------------------------------------------------------------------- ZkVM
@dataclass
class TxRecord:
    kind: str
    wire: bytes
    txid: bytes


def dump_txs(path, gens_capacity: int, records: list[TxRecord]) -> None:
    blob = bytearray(TX_MAGIC + struct.pack("<II", gens_capacity,
                                            len(records)))
    for rec in records:
        if len(rec.txid) != 32:
            raise ValueError("a txid is 32 bytes")
        blob += struct.pack("<BI", TX_KINDS.index(rec.kind), len(rec.wire))
        blob += rec.wire + rec.txid
    Path(path).write_bytes(bytes(blob))


def load_txs(path=TXS_BLOCK) -> tuple[int, list[TxRecord]]:
    """-> (generator capacity, records in file order)."""
    data = Path(path).read_bytes()
    if data[:8] != TX_MAGIC:
        raise ValueError("not a transaction fixture")
    gens_capacity, count = struct.unpack_from("<II", data, 8)
    off = 16
    records = []
    for _ in range(count):
        if off + 5 > len(data):
            raise ValueError("truncated transaction fixture")
        tag, size = struct.unpack_from("<BI", data, off)
        off += 5
        if tag >= len(TX_KINDS) or off + size + 32 > len(data):
            raise ValueError("bad record in a transaction fixture")
        records.append(TxRecord(TX_KINDS[tag], data[off: off + size],
                                data[off + size: off + size + 32]))
        off += size + 32
    if off != len(data):
        raise ValueError("trailing bytes in a transaction fixture")
    return gens_capacity, records


def tampered_tx(wire: bytes, part: str) -> bytes:
    """A transaction's wire bytes with bit 0 flipped in its proof's t_x
    (part "proof"; the scalar stays canonical, so the proof parses and
    its R1CS check rejects) or in its signature's s ("signature"; an
    unsigned transaction's all-zero signature becomes a stray one)."""
    from .vm.tx import Tx
    tx = Tx.from_bytes(wire)
    if part == "proof":
        proof = bytearray(tx.proof)
        proof[11 * 32] ^= 1                 # after the 11 points: t_x
        tx.proof = bytes(proof)
    elif part == "signature":
        sig = bytearray(tx.signature)
        sig[0] ^= 1
        tx.signature = bytes(sig)
    else:
        raise ValueError(f"unknown part {part!r}")
    return tx.to_bytes()
