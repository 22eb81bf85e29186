"""L5: the ZkVM transaction machine, the verifier's side.

Upstream counterpart: slingshot/zkvm (SURVEY.md §2.6) — a stack VM whose
single interpreter serves both prover and verifier, emitting R1CS constraints
and deferred point operations; taproot predicates, contracts, the tx log and
TxID, fees, and the byte-level wire encoding.  The port verifies: the
prover's driver is not ported yet.
"""

from .errors import VMError  # noqa: F401
from .tx import Tx, TxHeader, TxEntry, VerifiedTx, tx_id  # noqa: F401
from .ops import Instruction, encode_program, parse_program  # noqa: F401
from .verifier import verify_tx, precompute_tx  # noqa: F401
