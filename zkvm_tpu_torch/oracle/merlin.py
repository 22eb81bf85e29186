"""Merlin transcripts: Fiat-Shamir over STROBE-128.

Upstream counterpart: merlin/src/transcript.rs — Transcript::{new, append_message,
append_u64, challenge_bytes, build_rng} and TranscriptRng.  The known-answer test
(Transcript(b"test protocol") + "some label"/"some data" -> challenge hex
d5a21972...) pins bit-exactness against the upstream crate.

Every transcript runs on the port's C++ STROBE (native.NativeStrobe128);
Transcript.plain builds one on the pure-Python twin (strobe.Strobe128),
which the tests and chip_smoke.py hold the native one against.
"""

from __future__ import annotations

import os

from ..constants import MERLIN_PROTOCOL_LABEL, MERLIN_DOMSEP_LABEL
from ..native import NativeStrobe128
from .strobe import Strobe128


def _le32(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = NativeStrobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(MERLIN_DOMSEP_LABEL, label)

    @classmethod
    def plain(cls, label: bytes) -> "Transcript":
        """The same transcript over the pure-Python STROBE twin."""
        t = cls._from_strobe(Strobe128(MERLIN_PROTOCOL_LABEL))
        t.append_message(MERLIN_DOMSEP_LABEL, label)
        return t

    @classmethod
    def _from_strobe(cls, strobe) -> "Transcript":
        t = cls.__new__(cls)
        t.strobe = strobe
        return t

    def clone(self) -> "Transcript":
        # type(self), not Transcript: subclasses (ProofTranscript) keep
        # their protocol methods across a clone
        return type(self)._from_strobe(self.strobe.clone())

    def append_message(self, label: bytes, message: bytes):
        self.strobe.append_message(label, message)

    def append_u64(self, label: bytes, n: int):
        self.append_message(label, int(n).to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        return self.strobe.challenge_bytes(label, n)

    def build_rng(self) -> "TranscriptRngBuilder":
        return TranscriptRngBuilder(self.strobe.clone())


class TranscriptRngBuilder:
    """Deterministic-but-randomized witness RNG (merlin TranscriptRngBuilder):
    clone transcript state, KEY in witness data, then rekey with external entropy."""

    __slots__ = ("strobe",)

    def __init__(self, strobe):
        self.strobe = strobe

    def rekey_with_witness_bytes(self, label: bytes, witness: bytes) -> "TranscriptRngBuilder":
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(len(witness)), True)
        self.strobe.key(witness, False)
        return self

    def finalize(self, entropy: bytes | None = None) -> "TranscriptRng":
        if entropy is None:
            entropy = os.urandom(32)
        assert len(entropy) == 32
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(entropy, False)
        return TranscriptRng(self.strobe)


class TranscriptRng:
    __slots__ = ("strobe",)

    def __init__(self, strobe):
        self.strobe = strobe

    def fill_bytes(self, n: int) -> bytes:
        self.strobe.meta_ad(_le32(n), False)
        return self.strobe.prf(n, False)

    def random_scalar(self) -> int:
        from . import scalar
        return scalar.from_bytes_mod_order_wide(self.fill_bytes(64))
