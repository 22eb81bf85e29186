"""starsig: Schnorr signatures over Ristretto with Merlin transcripts.

Upstream counterpart: slingshot/starsig/src/* — Signature::{sign, verify,
verify_batch}, VerificationKey.  Protocol:

  R = r*B;  c = H(transcript, X, R);  s = r + c*x
  verify: s*B == R + c*X  (deferred as a PointOp for one-MSM batching)

The transcript carries the message context (callers append the message or
txid before signing), with the starsig domain label prefixed.  The
signer's k·B (the key, the nonce) is Engine.basepoint_mul on the engine,
the card's unless the caller passes another: the fixed-base kernel K17
there, constant-time in the secret scalar (README, "Proving").
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import L, LABEL_STARSIG
from ..oracle import scalar
from ..oracle.merlin import Transcript, TranscriptRng
from ..oracle.ristretto import RistrettoPoint
from ..proofs.engine import Engine, resolve_engine


@dataclass(frozen=True)
class VerificationKey:
    point: bytes  # compressed

    @staticmethod
    def from_secret(x: int,
                    engine: Engine | None = None) -> "VerificationKey":
        """x·B on `engine` (else the default engine, the card)."""
        return VerificationKey(
            resolve_engine(engine=engine).basepoint_mul(x).compress())

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


def sign(transcript: Transcript, privkey: int,
         rng: TranscriptRng | None = None,
         engine: Engine | None = None) -> Signature:
    """Sign the transcript state (caller appended the message); the key's
    and the nonce's k·B run on `engine` (else the default engine)."""
    eng = resolve_engine(engine=engine)
    x = privkey % L
    X = VerificationKey.from_secret(x, eng).point
    if rng is None:
        rng = (
            transcript.clone().build_rng()
            .rekey_with_witness_bytes(b"x", scalar.to_bytes(x))
            .finalize()
        )
    r = rng.random_scalar()
    R = eng.basepoint_mul(r).compress()
    c = _challenge(transcript, X, R)
    return Signature((r + c * x) % L, R)


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
