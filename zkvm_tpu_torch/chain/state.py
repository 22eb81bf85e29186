"""Blockchain state machine.

The port's copy of the JAX package's chain/state.py.  make_block and
apply_block verify each transaction with the port's verify_tx on one
engine, resolved once a call (`engine`, else a TorchEngine on `device`,
else the card), one transaction after another as the reference does.

Upstream counterpart: slingshot/blockchain/src/state.rs (SURVEY.md §3.4):
BlockchainState {tip, utreexo}; make_block verifies txs and assembles a
block; apply_block re-verifies, checks utxo inclusion proofs, deletes spent
contracts and inserts new ones.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..proofs.engine import Engine, resolve_engine
from ..proofs.generators import BulletproofGens
from ..vm.contract import contract_id, parse_contract
from ..vm.encoding import Reader, Writer
from ..vm.tx import Tx, VerifiedTx
from ..vm.verifier import verify_tx
from .block import Block, BlockHeader, block_id, txroot
from .utreexo import Catchup, Utreexo, UtreexoProof


class BlockchainError(Exception):
    pass


@dataclass
class BlockchainState:
    tip: BlockHeader
    utreexo: Utreexo

    @staticmethod
    def make_initial(timestamp_ms: int = 0) -> "BlockchainState":
        u = Utreexo()
        return BlockchainState(
            tip=BlockHeader.make_initial(timestamp_ms, u.state_hash()),
            utreexo=u,
        )

    def serialize(self) -> bytes:
        """Durable node state for restart (tip header + utreexo forest) —
        upstream slingshot/blockchain state.rs's checkpoint payload."""
        w = Writer()
        self.tip.encode(w)
        w.write_prefixed_bytes(self.utreexo.serialize())
        return w.to_bytes()

    @staticmethod
    def deserialize(data: bytes) -> "BlockchainState":
        r = Reader(data)
        tip = BlockHeader.parse(r)
        utreexo = Utreexo.deserialize(r.read_prefixed_bytes())
        if not r.done():
            raise BlockchainError("trailing bytes in blockchain state")
        if tip.utxoroot != utreexo.state_hash():
            raise BlockchainError("utxoroot does not match restored forest")
        return BlockchainState(tip=tip, utreexo=utreexo)

    def make_block(
        self,
        txs: list[Tx],
        utxo_proofs: dict[bytes, UtreexoProof],
        bp_gens: BulletproofGens,
        timestamp_ms: int | None = None,
        device=None,
        engine: Engine | None = None,
    ) -> tuple[Block, "BlockchainState", Catchup, list[VerifiedTx]]:
        """Verify txs on the engine, apply them, and assemble the next
        block."""
        timestamp_ms = (
            self.tip.timestamp_ms + 1 if timestamp_ms is None else timestamp_ms
        )
        new_state, catchup, verified = self._apply_txs(
            txs, utxo_proofs, bp_gens, timestamp_ms,
            resolve_engine(device, engine)
        )
        header = BlockHeader(
            version=self.tip.version,
            height=self.tip.height + 1,
            prev=block_id(self.tip),
            timestamp_ms=timestamp_ms,
            txroot=txroot(txs),
            utxoroot=new_state.utreexo.state_hash(),
        )
        new_state.tip = header
        # embed the spent-input proofs so peers can re-apply from the wire
        used = {
            cid: utxo_proofs[cid]
            for v in verified for cid in v.inputs
        }
        return Block(header, txs, used), new_state, catchup, verified

    def apply_block(
        self,
        block: Block,
        utxo_proofs: dict[bytes, UtreexoProof] | None = None,
        bp_gens: BulletproofGens | None = None,
        device=None,
        engine: Engine | None = None,
    ) -> tuple["BlockchainState", Catchup, list[VerifiedTx]]:
        """Validate and apply a received block, its transactions verified on
        the engine.  utxo_proofs=None uses the proofs embedded in the block
        (the sync path)."""
        if utxo_proofs is None:
            utxo_proofs = block.utxo_proofs
        if bp_gens is None:
            raise BlockchainError("bp_gens required")
        if block.header.prev != block_id(self.tip):
            raise BlockchainError("block does not extend the tip")
        if block.header.height != self.tip.height + 1:
            raise BlockchainError("bad block height")
        if block.header.timestamp_ms <= self.tip.timestamp_ms:
            raise BlockchainError("timestamp must advance")
        if block.header.txroot != txroot(block.txs):
            raise BlockchainError("txroot mismatch")
        new_state, catchup, verified = self._apply_txs(
            block.txs, utxo_proofs, bp_gens, block.header.timestamp_ms,
            resolve_engine(device, engine)
        )
        if block.header.utxoroot != new_state.utreexo.state_hash():
            raise BlockchainError("utxoroot mismatch")
        new_state.tip = block.header
        return new_state, catchup, verified

    def _apply_txs(self, txs, utxo_proofs, bp_gens, timestamp_ms,
                   engine: Engine):
        deletions: list[tuple[bytes, UtreexoProof]] = []
        insertions: list[bytes] = []
        verified: list[VerifiedTx] = []
        for tx in txs:
            if not (tx.header.mintime_ms <= timestamp_ms <= tx.header.maxtime_ms):
                raise BlockchainError("tx time bounds violated")
            vtx = verify_tx(tx, bp_gens, engine=engine)
            verified.append(vtx)
            for cid in vtx.inputs:
                if cid not in utxo_proofs:
                    raise BlockchainError("missing utxo proof for input")
                deletions.append((cid, utxo_proofs[cid]))
            for contract_bytes in vtx.outputs:
                insertions.append(contract_id(parse_contract(contract_bytes)))
        new_utreexo = self.utreexo.copy()
        catchup = new_utreexo.update(deletions, insertions)
        return (
            BlockchainState(tip=self.tip, utreexo=new_utreexo),
            catchup,
            verified,
        )
