"""Mempool: pending txs ordered by feerate with eviction.

The port's copy of the JAX package's chain/mempool.py: each appended
transaction is verified by the port's verify_tx on the mempool's engine,
resolved once at construction (`engine`, else a TorchEngine on `device`,
else the card).  Eviction keeps the reference's exact Fraction ordering.

Upstream counterpart: slingshot/blockchain/src/mempool.rs — tracks unconfirmed
txs, orders by fee/size, evicts the lowest-feerate tx when full, and drops
txs whose inputs were spent by an applied block.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

from ..proofs.engine import Engine, resolve_engine
from ..proofs.generators import BulletproofGens
from ..vm.fees import FeeRate
from ..vm.tx import Tx, VerifiedTx
from ..vm.verifier import verify_tx


class MempoolError(Exception):
    pass


@dataclass
class _Entry:
    tx: Tx
    verified: VerifiedTx
    feerate: FeeRate


class Mempool:
    def __init__(self, bp_gens: BulletproofGens, max_size: int = 10_000,
                 device=None, engine: Engine | None = None):
        self.bp_gens = bp_gens
        self.max_size = max_size
        self.engine = resolve_engine(device, engine)
        self.entries: dict[bytes, _Entry] = {}  # txid -> entry

    def __len__(self):
        return len(self.entries)

    def append(self, tx: Tx) -> VerifiedTx:
        verified = verify_tx(tx, self.bp_gens, engine=self.engine)
        if verified.id in self.entries:
            raise MempoolError("duplicate tx")
        # reject double-spends within the pool
        pool_inputs = {
            cid for e in self.entries.values() for cid in e.verified.inputs
        }
        for cid in verified.inputs:
            if cid in pool_inputs:
                raise MempoolError("input already spent in mempool")
        feerate = FeeRate(verified.fee, len(tx.to_bytes()))
        entry = _Entry(tx, verified, feerate)
        if len(self.entries) >= self.max_size:
            # lowest-feerate victim via exact cross-product ordering
            # (fee1/size1 < fee2/size2 <=> fee1*size2 < fee2*size1)
            worst_id = min(
                self.entries, key=lambda k: Fraction(
                    self.entries[k].feerate.fee,
                    max(self.entries[k].feerate.size, 1),
                )
            )
            worst = self.entries[worst_id]
            if not worst.feerate.less_than(feerate):
                raise MempoolError("mempool full and feerate too low")
            del self.entries[worst_id]
        self.entries[verified.id] = entry
        return verified

    def ordered_txs(self) -> list[Tx]:
        """Highest feerate first (block template order)."""
        return [
            e.tx for e in sorted(
                self.entries.values(),
                key=lambda e: Fraction(e.feerate.fee, max(e.feerate.size, 1)),
                reverse=True,
            )
        ]

    def update_after_block(self, spent_inputs: set[bytes],
                           included_txids: set[bytes] = frozenset()):
        """Drop txs included in a newly applied block and txs that now
        conflict with it.  Eviction by included txid matters for input-less
        txs (pure issuances): they never conflict on inputs, so without it
        a mined issuance would re-enter every subsequent block template."""
        stale = [
            txid for txid, e in self.entries.items()
            if txid in included_txids
            or any(cid in spent_inputs for cid in e.verified.inputs)
            or txid in spent_inputs
        ]
        for txid in stale:
            del self.entries[txid]
