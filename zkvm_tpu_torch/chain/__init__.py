"""L6: blockchain state machine, utreexo accumulator, mempool, node.

The port's copy of the JAX package's chain/, with the same exports and
wire bytes; every transaction check and every group operation of the
encrypted channel runs on the port's engine, the card unless the caller
asks for the CPU.

Upstream counterpart: slingshot/blockchain (SURVEY.md §2.7) — block/state
round trips, the hash-based dynamic UTXO accumulator with catchup proofs,
and the fee-ordered mempool with compact short ids.
"""

from .utreexo import Utreexo, UtreexoProof, Catchup  # noqa: F401
from .block import Block, BlockHeader, block_id  # noqa: F401
from .state import BlockchainState  # noqa: F401
from .mempool import Mempool  # noqa: F401
