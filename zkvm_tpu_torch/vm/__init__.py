"""L5: the ZkVM transaction machine.

Upstream counterpart: slingshot/zkvm (SURVEY.md §2.6) — a stack VM whose
single interpreter serves both prover and verifier, emitting R1CS constraints
and deferred point operations; taproot predicates, contracts, the tx log and
TxID, fees, and the byte-level wire encoding.  The prover's side
builds and signs transactions (build_tx), the verifier's checks them
(verify_tx).
"""

from .errors import VMError  # noqa: F401
from .tx import Tx, TxHeader, TxEntry, VerifiedTx, tx_id  # noqa: F401
from .ops import Instruction, encode_program, parse_program  # noqa: F401
from .verifier import verify_tx, precompute_tx  # noqa: F401
from .prover import build_tx  # noqa: F401
