"""keytree: hierarchical key derivation over Ristretto.

Upstream counterpart: slingshot/keytree/src/lib.rs — Xprv/Xpub extended keys
with Merlin-based child derivation; public derivation of Xpub children
matches private derivation of Xprv children.  The port's copy of the JAX
package's crypto/keytree.py.

Each k·B runs on the engine (`engine=`, else the default engine, the
card's): Xprv.to_xpub's x·B on a secret x and Xpub.derive_key's f·B on a
public f, both on the fixed-base kernel K17, constant-time in the scalar
(kernels/engine.py TorchEngine.basepoint_mul).  The child point P + f·B
adds two points on the host, as the reference does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..constants import L, LABEL_KEYTREE
from ..oracle import scalar
from ..oracle.merlin import Transcript
from ..oracle.ristretto import RistrettoPoint
from ..proofs.engine import Engine, resolve_engine
from .starsig import VerificationKey


@dataclass
class Xpub:
    point: bytes       # compressed public key
    dk: bytes          # 32-byte derivation key

    def derive_key(self, customize,
                   engine: Engine | None = None) -> "Xpub":
        f, child_dk = _derivation(self.point, self.dk, customize)
        P = (RistrettoPoint.decompress(self.point)
             + resolve_engine(engine=engine).basepoint_mul(f, ct=False))
        return Xpub(P.compress(), child_dk)

    def verification_key(self) -> VerificationKey:
        return VerificationKey(self.point)


@dataclass
class Xprv:
    scalar_key: int
    dk: bytes

    @staticmethod
    def random(seed: bytes | None = None) -> "Xprv":
        seed = seed if seed is not None else os.urandom(64)
        t = Transcript(LABEL_KEYTREE)
        t.append_message(b"seed", seed)
        x = scalar.from_bytes_mod_order_wide(t.challenge_bytes(b"xprv", 64))
        dk = t.challenge_bytes(b"dk", 32)
        return Xprv(x, dk)

    def to_xpub(self, engine: Engine | None = None) -> Xpub:
        return Xpub(resolve_engine(engine=engine).basepoint_mul(
            self.scalar_key).compress(), self.dk)

    def derive_key(self, customize,
                   engine: Engine | None = None) -> "Xprv":
        xpub = self.to_xpub(engine)
        f, child_dk = _derivation(xpub.point, self.dk, customize)
        return Xprv((self.scalar_key + f) % L, child_dk)


def _derivation(point: bytes, dk: bytes, customize) -> tuple[int, bytes]:
    """Shared derivation: customize is a callable(transcript) appending the
    selector (e.g. t.append_u64(b"account", n)) — upstream's closure API."""
    t = Transcript(LABEL_KEYTREE)
    t.append_message(b"pt", point)
    t.append_message(b"dk", dk)
    customize(t)
    f = scalar.from_bytes_mod_order_wide(t.challenge_bytes(b"f", 64))
    child_dk = t.challenge_bytes(b"dk", 32)
    return f, child_dk
