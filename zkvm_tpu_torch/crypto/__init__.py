"""L2, the verifier's half: Schnorr signatures, MuSig key aggregation and
Merkle trees.

Upstream counterparts (SURVEY.md §2.3): slingshot/{starsig, musig, merkle}
— Schnorr over Ristretto with Merlin transcripts (single and batch
verification), n-of-n MuSig key aggregation, and Merlin-hashed binary
Merkle trees.
"""

from .merkle import MerkleTree, Path  # noqa: F401
from .musig import Multikey, MusigError  # noqa: F401
from .starsig import Signature, VerificationKey, verify, verify_batch  # noqa: F401
