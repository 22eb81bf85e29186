"""starsig: Schnorr signatures over Ristretto with Merlin transcripts, the
verifier half.

Upstream counterpart: slingshot/starsig/src/* — Signature::{verify,
verify_batch}, VerificationKey.  Protocol:

  R = r*B;  c = H(transcript, X, R);  s = r + c*x
  verify: s*B == R + c*X  (deferred as a PointOp for one-MSM batching)

The transcript carries the message context (callers append the message or
txid before signing), with the starsig domain label prefixed.  Signing
(which needs a fixed-base multiplication on the card) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import L, LABEL_STARSIG
from ..oracle import scalar
from ..oracle.merlin import Transcript
from ..oracle.ristretto import RistrettoPoint
from ..proofs.engine import Engine


@dataclass(frozen=True)
class VerificationKey:
    point: bytes  # compressed

    def decompress(self) -> RistrettoPoint:
        return RistrettoPoint.decompress(self.point)


@dataclass
class Signature:
    s: int
    R: bytes  # compressed nonce point

    def to_bytes(self) -> bytes:
        return scalar.to_bytes(self.s) + self.R

    @staticmethod
    def from_bytes(data: bytes) -> "Signature":
        if len(data) != 64:
            raise ValueError("signature must be 64 bytes")
        return Signature(scalar.from_canonical_bytes(data[:32]), data[32:])


def _challenge(transcript: Transcript, X: bytes, R: bytes) -> int:
    t = transcript.clone()
    t.append_message(b"dom-sep", LABEL_STARSIG)
    t.append_message(b"X", X)
    t.append_message(b"R", R)
    return scalar.from_bytes_mod_order_wide(t.challenge_bytes(b"c", 64))


def verify(sig: Signature, transcript: Transcript, key: VerificationKey,
           engine: Engine | None = None) -> None:
    """s*B - R - c*X == 0 on `engine` (else the default engine); raises
    InvalidSignature on failure."""
    verify_batch([sig], [transcript], [key], engine)


def verify_op(sig: Signature, transcript: Transcript, key: VerificationKey):
    """Emit the deferred PointOp (the batching seam, SURVEY.md §2.9 P3)."""
    from ..vm.point_ops import PointOp
    c = _challenge(transcript, key.point, sig.R)
    return PointOp(
        primary=sig.s % L,
        secondary=None,
        arbitrary=[((-1) % L, sig.R), ((-c) % L, key.point)],
    )


def verify_batch(sigs: list[Signature], transcripts: list[Transcript],
                 keys: list[VerificationKey],
                 engine: Engine | None = None) -> None:
    """Random linear combination -> one MSM (upstream verify_batch)."""
    from ..vm.point_ops import verify_batch as batch
    ops = [
        verify_op(s, t, k) for s, t, k in zip(sigs, transcripts, keys, strict=True)
    ]
    batch(ops, engine=engine)
