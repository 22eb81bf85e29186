"""Blocks and block headers.

The port's copy of the JAX package's chain/block.py over the port's
encoding, transactions and Merkle tree: the same ids and wire bytes.

Upstream counterpart: slingshot/blockchain/src/block.rs — BlockHeader
{version, height, prev, timestamp_ms, txroot, utxoroot, ext}, BlockID via
Merlin hashing, Block = header + txs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto.merkle import MerkleTree
from ..oracle.merlin import Transcript
from ..vm.encoding import Reader, Writer
from ..vm.tx import Tx

_LABEL = b"ZkVM.block"


@dataclass
class BlockHeader:
    version: int
    height: int
    prev: bytes           # 32-byte previous block id
    timestamp_ms: int
    txroot: bytes         # merkle root of witness tx hashes
    utxoroot: bytes       # utreexo state hash
    ext: bytes = b""

    def encode(self, w: Writer):
        w.write_u64(self.version)
        w.write_u64(self.height)
        w.write_bytes(self.prev)
        w.write_u64(self.timestamp_ms)
        w.write_bytes(self.txroot)
        w.write_bytes(self.utxoroot)
        w.write_prefixed_bytes(self.ext)

    @staticmethod
    def parse(r: Reader) -> "BlockHeader":
        return BlockHeader(
            version=r.read_u64(), height=r.read_u64(), prev=r.read_u8x32(),
            timestamp_ms=r.read_u64(), txroot=r.read_u8x32(),
            utxoroot=r.read_u8x32(), ext=r.read_prefixed_bytes(),
        )

    @staticmethod
    def make_initial(timestamp_ms: int, utxoroot: bytes) -> "BlockHeader":
        return BlockHeader(
            version=1, height=1, prev=b"\x00" * 32,
            timestamp_ms=timestamp_ms,
            txroot=MerkleTree.root_of(_LABEL, []),
            utxoroot=utxoroot,
        )


def block_id(header: BlockHeader) -> bytes:
    w = Writer()
    header.encode(w)
    t = Transcript(_LABEL)
    t.append_message(b"header", w.to_bytes())
    return t.challenge_bytes(b"id", 32)


def txroot(txs: list[Tx]) -> bytes:
    return MerkleTree.root_of(_LABEL, [tx.witness_hash() for tx in txs])


@dataclass
class Block:
    """Full block: header + txs + the utreexo proofs for every tx input,
    keyed by contract id (upstream slingshot BlockTx carries its
    `Vec<utreexo::Proof>` inline for exactly this reason: a syncing peer
    must be able to re-apply the block against the pre-state forest
    without any out-of-band proof source)."""
    header: BlockHeader
    txs: list[Tx] = field(default_factory=list)
    utxo_proofs: dict[bytes, "UtreexoProof"] = field(default_factory=dict)

    def id(self) -> bytes:
        return block_id(self.header)

    def encode(self, w: Writer):
        self.header.encode(w)
        w.write_u32(len(self.txs))
        for tx in self.txs:
            w.write_prefixed_bytes(tx.to_bytes())
        w.write_u32(len(self.utxo_proofs))
        for cid in sorted(self.utxo_proofs):
            w.write_bytes(cid)
            w.write_prefixed_bytes(self.utxo_proofs[cid].serialize())

    def to_bytes(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.to_bytes()

    @staticmethod
    def parse(r: Reader) -> "Block":
        from .utreexo import UtreexoProof
        header = BlockHeader.parse(r)
        txs = [Tx.from_bytes(r.read_prefixed_bytes())
               for _ in range(r.read_u32())]
        proofs = {}
        for _ in range(r.read_u32()):
            cid = r.read_u8x32()
            proofs[cid] = UtreexoProof.deserialize(r.read_prefixed_bytes())
        return Block(header, txs, proofs)

    @staticmethod
    def from_bytes(data: bytes) -> "Block":
        r = Reader(data)
        b = Block.parse(r)
        if not r.done():
            from ..vm.errors import FormatError
            raise FormatError("trailing bytes in block")
        return b
