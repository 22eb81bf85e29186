"""TranscriptProtocol: typed transcript operations for the proof system.

Upstream counterpart: bulletproofs/src/transcript.rs — an extension trait on
merlin::Transcript adding domain separators and typed append/challenge ops.
Implemented here as a subclass of the oracle Merlin transcript.
"""

from __future__ import annotations

from ..constants import LABEL_IPP, LABEL_RANGEPROOF
from ..oracle import scalar
from ..oracle.merlin import Transcript
from ..oracle.ristretto import RistrettoPoint
from .errors import ProofError


class ProofTranscript(Transcript):
    """merlin Transcript + the bulletproofs TranscriptProtocol extension."""

    # -- domain separators --------------------------------------------------
    def rangeproof_domain_sep(self, n: int, m: int):
        self.append_message(b"dom-sep", LABEL_RANGEPROOF)
        self.append_u64(b"n", n)
        self.append_u64(b"m", m)

    def innerproduct_domain_sep(self, n: int):
        self.append_message(b"dom-sep", LABEL_IPP)
        self.append_u64(b"n", n)

    # -- typed appends ------------------------------------------------------
    def append_scalar(self, label: bytes, s: int):
        self.append_message(label, scalar.to_bytes(s))

    def append_point(self, label: bytes, p: RistrettoPoint | bytes):
        self.append_message(label, p if isinstance(p, bytes) else p.compress())

    def validate_and_append_point(self, label: bytes, compressed: bytes):
        """Reject the identity encoding (upstream validate_and_append_point:
        a byte comparison against CompressedRistretto::identity(), NOT a
        decompression — malformed encodings are rejected later when the
        verifier decompresses the points for its mega-check MSM)."""
        if len(compressed) != 32:
            raise ProofError("point validation failed: bad length")
        if compressed == b"\x00" * 32:
            raise ProofError("point validation failed: identity")
        self.append_message(label, compressed)

    # -- challenges ---------------------------------------------------------
    def challenge_scalar(self, label: bytes) -> int:
        """64-byte PRF reduced wide mod ℓ (upstream challenge_scalar)."""
        return scalar.from_bytes_mod_order_wide(self.challenge_bytes(label, 64))
