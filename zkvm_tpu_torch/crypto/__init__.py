"""L2: Schnorr signatures, MuSig multisignatures, Merkle trees and key
derivation.

Upstream counterparts (SURVEY.md §2.3): slingshot/{starsig, musig, merkle,
keytree} — Schnorr over Ristretto with Merlin transcripts (signing, single
and batch verification), n-of-n MuSig key aggregation and 3-round
signing, Merlin-hashed binary Merkle trees, and hierarchical Xprv/Xpub
key derivation.
"""

from .keytree import Xprv, Xpub  # noqa: F401
from .merkle import MerkleTree, Path  # noqa: F401
from .musig import (Multikey, MusigError, Party, aggregate_shares,  # noqa: F401
                    sign_multi)
from .starsig import (Signature, VerificationKey, sign, verify,  # noqa: F401
                      verify_batch)
