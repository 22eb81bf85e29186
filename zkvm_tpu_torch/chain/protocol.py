"""Block relay / sync protocol messages.

The port's copy of the JAX package's chain/protocol.py: the same wire
bytes, so a port node and a JAX node sync with each other.

Upstream counterpart: slingshot/blockchain/src/protocol.rs — typed messages
for header announcement, inventory exchange, compact (short-id) block relay,
and tx/block requests.  Transport-agnostic: messages serialize to bytes; a
node wires them to any peer layer (the upstream "cybershake" p2p encryption
layer is out of scope per SURVEY.md §2.8).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..vm.encoding import Reader, Writer
from ..vm.errors import FormatError
from .block import Block, BlockHeader, block_id
from .shortid import ShortIDNonce


@dataclass
class GetInventory:
    """Ask a peer for its current tip + mempool short ids."""
    version: int = 1
    shortid_nonce: int = 0

    TAG = 1

    def encode(self, w: Writer):
        w.write_u8(self.TAG)
        w.write_u64(self.version)
        w.write_u64(self.shortid_nonce)


@dataclass
class Inventory:
    """Peer's tip header + mempool short ids under the requested nonce."""
    tip: BlockHeader
    shortid_nonce: int
    mempool_short_ids: list[bytes] = field(default_factory=list)

    TAG = 2

    def encode(self, w: Writer):
        w.write_u8(self.TAG)
        self.tip.encode(w)
        w.write_u64(self.shortid_nonce)
        w.write_u32(len(self.mempool_short_ids))
        for sid in self.mempool_short_ids:
            if len(sid) != 6:
                raise FormatError("short id must be 6 bytes")
            w.write_bytes(sid)


@dataclass
class GetBlocks:
    """Request full blocks after a known header."""
    after: bytes  # block id

    TAG = 3

    def encode(self, w: Writer):
        w.write_u8(self.TAG)
        w.write_bytes(self.after)


@dataclass
class Blocks:
    """Full blocks (txs + embedded utxo proofs), oldest first — the reply
    a syncing peer applies directly (upstream protocol.rs Blocks)."""
    blocks: list[Block]

    TAG = 4

    def encode(self, w: Writer):
        w.write_u8(self.TAG)
        w.write_u32(len(self.blocks))
        for b in self.blocks:
            w.write_prefixed_bytes(b.to_bytes())


@dataclass
class GetMempoolTxs:
    """Request full txs for unknown short ids."""
    shortid_nonce: int
    missing: list[bytes]

    TAG = 5

    def encode(self, w: Writer):
        w.write_u8(self.TAG)
        w.write_u64(self.shortid_nonce)
        w.write_u32(len(self.missing))
        for sid in self.missing:
            w.write_bytes(sid)


@dataclass
class MempoolTxs:
    txs: list[bytes]  # serialized txs

    TAG = 6

    def encode(self, w: Writer):
        w.write_u8(self.TAG)
        w.write_u32(len(self.txs))
        for t in self.txs:
            w.write_prefixed_bytes(t)


def encode_message(msg) -> bytes:
    w = Writer()
    msg.encode(w)
    return w.to_bytes()


def parse_message(data: bytes):
    r = Reader(data)
    tag = r.read_u8()
    if tag == GetInventory.TAG:
        return GetInventory(r.read_u64(), r.read_u64())
    if tag == Inventory.TAG:
        tip = BlockHeader.parse(r)
        nonce = r.read_u64()
        n = r.read_u32()
        sids = [r.read_bytes(6) for _ in range(n)]
        return Inventory(tip, nonce, sids)
    if tag == GetBlocks.TAG:
        return GetBlocks(r.read_u8x32())
    if tag == Blocks.TAG:
        n = r.read_u32()
        return Blocks([Block.from_bytes(r.read_prefixed_bytes())
                       for _ in range(n)])
    if tag == GetMempoolTxs.TAG:
        nonce = r.read_u64()
        n = r.read_u32()
        return GetMempoolTxs(nonce, [r.read_bytes(6) for _ in range(n)])
    if tag == MempoolTxs.TAG:
        n = r.read_u32()
        return MempoolTxs([r.read_prefixed_bytes() for _ in range(n)])
    raise FormatError(f"unknown message tag {tag}")


def inventory_for(tip: BlockHeader, mempool_tx_hashes: list[bytes],
                  seed: bytes, nonce: int) -> Inventory:
    """Build an Inventory response with short ids keyed by (seed, nonce)."""
    sid = ShortIDNonce(seed, nonce)
    return Inventory(
        tip, nonce, [sid.short_id(h) for h in mempool_tx_hashes]
    )
