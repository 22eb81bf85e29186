"""Transactions, the tx log, and TxID.

Upstream counterpart: slingshot/zkvm/src/tx.rs (SURVEY.md §2.6):
Tx {header {version, mintime_ms, maxtime_ms}, program, signature, proof};
TxEntry::{Header, Issue, Retire, Input, Output, Fee, Data}; TxID = Merkle
root of encoded entries under the ZkVM.txid label.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import LABEL_ZKVM_TXID
from ..crypto.merkle import MerkleTree
from .encoding import Reader, Writer
from .errors import FormatError, TimeBoundsInvalid


@dataclass(frozen=True)
class TxHeader:
    version: int = 1
    mintime_ms: int = 0
    maxtime_ms: int = 2**63 - 1

    def validate(self):
        if self.mintime_ms > self.maxtime_ms:
            raise TimeBoundsInvalid("mintime exceeds maxtime")

    def encode(self, w: Writer):
        w.write_u64(self.version)
        w.write_u64(self.mintime_ms)
        w.write_u64(self.maxtime_ms)

    @staticmethod
    def parse(r: Reader) -> "TxHeader":
        return TxHeader(r.read_u64(), r.read_u64(), r.read_u64())


@dataclass
class TxEntry:
    """One tx log entry; `payload` content depends on kind."""
    kind: str  # header|issue|retire|input|output|fee|data
    payload: bytes

    _KINDS = {"header": 0, "issue": 1, "retire": 2, "input": 3,
              "output": 4, "fee": 5, "data": 6}

    def encode(self) -> bytes:
        w = Writer()
        w.write_u8(self._KINDS[self.kind])
        w.write_prefixed_bytes(self.payload)
        return w.to_bytes()

    @staticmethod
    def header(h: TxHeader) -> "TxEntry":
        w = Writer()
        h.encode(w)
        return TxEntry("header", w.to_bytes())

    @staticmethod
    def issue(qty_point: bytes, flv_point: bytes) -> "TxEntry":
        return TxEntry("issue", qty_point + flv_point)

    @staticmethod
    def retire(qty_point: bytes, flv_point: bytes) -> "TxEntry":
        return TxEntry("retire", qty_point + flv_point)

    @staticmethod
    def input_(contract_id: bytes) -> "TxEntry":
        return TxEntry("input", contract_id)

    @staticmethod
    def output(serialized_contract: bytes) -> "TxEntry":
        return TxEntry("output", serialized_contract)

    @staticmethod
    def fee(amount: int) -> "TxEntry":
        w = Writer()
        w.write_u64(amount)
        return TxEntry("fee", w.to_bytes())

    @staticmethod
    def data(data: bytes) -> "TxEntry":
        return TxEntry("data", data)


def tx_id(log: list[TxEntry]) -> bytes:
    """TxID = Merkle root over encoded log entries (upstream TxID)."""
    return MerkleTree.root_of(LABEL_ZKVM_TXID, [e.encode() for e in log])


@dataclass
class Tx:
    header: TxHeader
    program: bytes
    signature: bytes      # 64 bytes (musig over txid)
    proof: bytes          # serialized R1CSProof

    def to_bytes(self) -> bytes:
        w = Writer()
        self.header.encode(w)
        w.write_prefixed_bytes(self.program)
        if len(self.signature) != 64:
            raise FormatError("signature must be 64 bytes")
        w.write_bytes(self.signature)
        w.write_prefixed_bytes(self.proof)
        return w.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "Tx":
        r = Reader(data)
        header = TxHeader.parse(r)
        program = r.read_prefixed_bytes()
        signature = r.read_bytes(64)
        proof = r.read_prefixed_bytes()
        if not r.done():
            raise FormatError("trailing bytes in tx")
        return Tx(header, program, signature, proof)

    def witness_hash(self) -> bytes:
        """Hash of the full tx including witness data (upstream WitnessHash)."""
        from ..oracle.merlin import Transcript
        t = Transcript(LABEL_ZKVM_TXID)
        t.append_message(b"witness", self.to_bytes())
        return t.challenge_bytes(b"wtxid", 32)


@dataclass
class VerifiedTx:
    header: TxHeader
    id: bytes
    log: list[TxEntry]
    fee: int

    @property
    def outputs(self) -> list[bytes]:
        return [e.payload for e in self.log if e.kind == "output"]

    @property
    def inputs(self) -> list[bytes]:
        return [e.payload for e in self.log if e.kind == "input"]
