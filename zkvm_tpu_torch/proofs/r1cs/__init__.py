"""Two-phase R1CS constraint-system proofs over committed values (upstream
bulletproofs/src/r1cs/*, the interstellar `yoloproofs` feature): the
prover and the verifier.  One gadget definition serves both."""

from ..errors import R1CSError  # noqa: F401
from .lc import ONE, LinearCombination, Variable  # noqa: F401
from .proof import R1CSProof  # noqa: F401
from .prover import Prover  # noqa: F401
from .verifier import Verifier  # noqa: F401
