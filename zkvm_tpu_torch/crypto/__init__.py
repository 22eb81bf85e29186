"""L2: Schnorr signatures, MuSig multisignatures and Merkle trees.

Upstream counterparts (SURVEY.md §2.3): slingshot/{starsig, musig, merkle}
— Schnorr over Ristretto with Merlin transcripts (signing, single and
batch verification), n-of-n MuSig key aggregation and 3-round signing, and
Merlin-hashed binary Merkle trees.
"""

from .merkle import MerkleTree, Path  # noqa: F401
from .musig import (Multikey, MusigError, Party, aggregate_shares,  # noqa: F401
                    sign_multi)
from .starsig import (Signature, VerificationKey, sign, verify,  # noqa: F401
                      verify_batch)
