"""A minimal full node: state machine + mempool + block store + sync loop.

The port's copy of the JAX package's chain/node.py.  A Node resolves its
engine once (`engine`, else a TorchEngine on `device`, else the card) and
hands it to its mempool and to every make_block / apply_block, so each
transaction it admits, mines or receives is verified on the card.  Its
snapshot (serialize / deserialize) and its wire messages are the
reference's bytes: a JAX node and a port node sync with each other and read
each other's snapshots.

Upstream counterpart: slingshot/blockchain/src/protocol.rs (the Node trait's
message handlers) — header/inventory exchange, full-block catch-up, and
BIP152-style short-id mempool relay.  Transport-agnostic: `handle_message`
consumes one encoded message and returns encoded replies; any peer layer
(sockets, queues, tests) shuttles the bytes.

The node keeps a `UtxoIndex`: the utreexo proof for every live contract id,
re-based through each block's Catchup.  That is what lets it build blocks
(make_block needs proofs for every spent input) and serve wallets; upstream
nodes do the same with `utreexo::Catchup::update_proof` per block.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..proofs.engine import Engine, resolve_engine
from ..proofs.generators import BulletproofGens
from ..vm.contract import contract_id, parse_contract
from ..vm.encoding import Reader, Writer
from ..vm.tx import Tx
from .block import Block, BlockHeader, block_id
from .mempool import Mempool, MempoolError
from .protocol import (
    Blocks, GetBlocks, GetInventory, GetMempoolTxs, Inventory, MempoolTxs,
    encode_message, inventory_for, parse_message,
)
from .shortid import ShortIDNonce
from .state import BlockchainError, BlockchainState
from .utreexo import Catchup, UtreexoProof


class NodeError(Exception):
    pass


@dataclass
class UtxoIndex:
    """Live contract id -> current utreexo proof, re-based every block."""
    proofs: dict[bytes, UtreexoProof] = field(default_factory=dict)

    def apply(self, catchup: Catchup, spent: set[bytes],
              created: list[bytes]):
        for cid in spent:
            self.proofs.pop(cid, None)
        self.proofs = {
            cid: catchup.update_proof(cid, p)
            for cid, p in self.proofs.items()
        }
        for cid in created:
            self.proofs[cid] = catchup.proof_for_new_item(cid)


class Node:
    """One peer.  Drive with `handle_message(bytes) -> [bytes]` or the
    direct methods (submit_tx / make_block / receive_block)."""

    def __init__(self, state: BlockchainState, bp_gens: BulletproofGens,
                 shortid_nonce: int = 1, max_blocks_per_reply: int = 100,
                 device=None, engine: Engine | None = None):
        self.state = state
        self.bp_gens = bp_gens
        self.engine = resolve_engine(device, engine)
        self.mempool = Mempool(bp_gens, engine=self.engine)
        self.utxos = UtxoIndex()
        self.blocks: dict[int, Block] = {}   # height -> block (sync store)
        self.shortid_nonce = shortid_nonce
        self.max_blocks_per_reply = max_blocks_per_reply

    # ------------------------------------------------------------- helpers
    @property
    def tip(self) -> BlockHeader:
        return self.state.tip

    def submit_tx(self, tx: Tx):
        return self.mempool.append(tx)

    def _apply(self, block: Block, new_state: BlockchainState,
               catchup: Catchup, verified):
        spent = {cid for v in verified for cid in v.inputs}
        created = [
            contract_id(parse_contract(ob))
            for v in verified for ob in v.outputs
        ]
        self.state = new_state
        self.blocks[block.header.height] = block
        self.utxos.apply(catchup, spent, created)
        self.mempool.update_after_block(spent, {v.id for v in verified})
        return catchup

    def make_block(self, timestamp_ms: int | None = None) -> Block:
        """Assemble the next block from the mempool (feerate order)."""
        txs = self.mempool.ordered_txs()
        block, new_state, catchup, verified = self.state.make_block(
            txs, dict(self.utxos.proofs), self.bp_gens, timestamp_ms,
            engine=self.engine
        )
        self._apply(block, new_state, catchup, verified)
        return block

    def receive_block(self, block: Block) -> Catchup:
        """Validate + apply a block received from a peer (embedded proofs)."""
        new_state, catchup, verified = self.state.apply_block(
            block, None, self.bp_gens, engine=self.engine
        )
        return self._apply(block, new_state, catchup, verified)

    # -------------------------------------------------------- persistence
    def serialize(self) -> bytes:
        """Durable node snapshot: chain state + block store + utxo-proof
        index (the mempool is intentionally volatile, as upstream).

        Trust model: a snapshot is the node's OWN local storage.  The
        utxoroot<->forest binding and per-proof verification catch
        state/index corruption; plain header fields (prev, timestamps)
        are trusted, exactly as upstream's persisted BlockchainState."""
        w = Writer()
        w.write_prefixed_bytes(self.state.serialize())
        heights = sorted(self.blocks)
        w.write_u32(len(heights))
        for h in heights:
            w.write_u64(h)
            w.write_prefixed_bytes(self.blocks[h].to_bytes())
        w.write_u32(len(self.utxos.proofs))
        for cid in sorted(self.utxos.proofs):
            w.write_bytes(cid)
            w.write_prefixed_bytes(self.utxos.proofs[cid].serialize())
        return w.to_bytes()

    @staticmethod
    def deserialize(data: bytes, bp_gens: BulletproofGens, device=None,
                    engine: Engine | None = None) -> "Node":
        """A node from a snapshot (this package's or the JAX package's), on
        the engine resolved as the constructor's."""
        r = Reader(data)
        state = BlockchainState.deserialize(r.read_prefixed_bytes())
        node = Node(state, bp_gens, device=device, engine=engine)
        for _ in range(r.read_u32()):
            h = r.read_u64()
            node.blocks[h] = Block.from_bytes(r.read_prefixed_bytes())
        for _ in range(r.read_u32()):
            cid = r.read_u8x32()
            p = UtreexoProof.deserialize(r.read_prefixed_bytes())
            node.state.utreexo.verify(cid, p)  # reject stale snapshots
            node.utxos.proofs[cid] = p
        if not r.done():
            raise NodeError("trailing bytes in node snapshot")
        return node

    # ------------------------------------------------------- message loop
    def start_sync(self) -> bytes:
        """Opening message to a fresh peer."""
        return encode_message(
            GetInventory(version=1, shortid_nonce=self.shortid_nonce)
        )

    def handle_message(self, data: bytes) -> list[bytes]:
        """Consume one wire message, mutate local state, return replies."""
        msg = parse_message(data)
        out: list = []

        if isinstance(msg, GetInventory):
            out.append(inventory_for(
                self.tip, list(self.mempool.entries),
                block_id(self.tip), msg.shortid_nonce,
            ))

        elif isinstance(msg, Inventory):
            if msg.tip.height > self.tip.height:
                out.append(GetBlocks(after=block_id(self.tip)))
            # request mempool txs we don't know under the peer's nonce
            sid = ShortIDNonce(block_id(msg.tip), msg.shortid_nonce)
            known = {sid.short_id(txid) for txid in self.mempool.entries}
            missing = [s for s in msg.mempool_short_ids if s not in known]
            if missing and msg.tip.height <= self.tip.height:
                out.append(GetMempoolTxs(msg.shortid_nonce, missing))

        elif isinstance(msg, GetBlocks):
            heights = sorted(self.blocks)
            start = None
            for h in heights:
                if self.blocks[h].header.prev == msg.after:
                    start = h
                    break
            if start is None and msg.after == block_id(self.tip):
                out.append(Blocks([]))       # peer is already at our tip
            elif start is None:
                raise NodeError("unknown sync point")
            else:
                run = [
                    self.blocks[h]
                    for h in range(start,
                                   start + self.max_blocks_per_reply)
                    if h in self.blocks
                ]
                out.append(Blocks(run))

        elif isinstance(msg, Blocks):
            for b in msg.blocks:
                self.receive_block(b)
            if msg.blocks:
                # there may be more: re-ask from the new tip
                out.append(GetBlocks(after=block_id(self.tip)))

        elif isinstance(msg, GetMempoolTxs):
            sid = ShortIDNonce(block_id(self.tip), msg.shortid_nonce)
            want = set(msg.missing)
            txs = [
                e.tx.to_bytes() for txid, e in self.mempool.entries.items()
                if sid.short_id(txid) in want
            ]
            out.append(MempoolTxs(txs))

        elif isinstance(msg, MempoolTxs):
            for raw in msg.txs:
                try:
                    self.submit_tx(Tx.from_bytes(raw))
                except (MempoolError, BlockchainError):
                    pass  # stale/conflicting relay is not an error

        else:
            raise NodeError(f"unhandled message {type(msg).__name__}")
        return [encode_message(m) for m in out]


def sync(requester: Node, responder: Node, max_rounds: int = 32) -> int:
    """Pump messages between two nodes until the requester stops asking.
    Returns the number of message round-trips.  Every hop re-encodes and
    re-parses, so the wire format is exercised end to end."""
    pending = [requester.start_sync()]
    rounds = 0
    while pending and rounds < max_rounds:
        rounds += 1
        replies: list[bytes] = []
        for m in pending:
            replies.extend(responder.handle_message(m))
        pending = []
        for m in replies:
            pending.extend(requester.handle_message(m))
    if pending:
        raise NodeError("sync did not converge")
    return rounds
