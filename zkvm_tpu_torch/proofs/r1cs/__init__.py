"""Two-phase R1CS constraint-system proofs over committed values: the
verifier side (upstream bulletproofs/src/r1cs/*, the interstellar
`yoloproofs` feature).  One gadget definition serves prover and verifier;
the port carries only the verifier."""

from ..errors import R1CSError  # noqa: F401
from .lc import ONE, LinearCombination, Variable  # noqa: F401
from .proof import R1CSProof  # noqa: F401
from .verifier import Verifier  # noqa: F401
