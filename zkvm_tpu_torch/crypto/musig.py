"""MuSig key aggregation: the verifier's half of n-of-n multisignatures.

Upstream counterpart: slingshot/musig/src/* — Multikey aggregation with
delinearization factors from a Merlin transcript.  Aggregated signatures
verify exactly like starsig signatures under the aggregated key.  The
3-round signing protocol is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import LABEL_MUSIG
from ..oracle import scalar
from ..oracle.merlin import Transcript
from ..proofs.engine import Engine, resolve_engine
from .starsig import VerificationKey


class MusigError(Exception):
    def __init__(self, msg: str, bad_parties: list[int] | None = None):
        super().__init__(msg)
        self.bad_parties = bad_parties or []


@dataclass
class Multikey:
    """Aggregated key: X = sum_i a_i * X_i with delinearization factors
    a_i = H(<L>, X_i) (upstream Multikey)."""

    keys: list[VerificationKey]

    def _factor_transcript(self) -> Transcript:
        t = Transcript(LABEL_MUSIG)
        t.append_u64(b"n", len(self.keys))
        for k in self.keys:
            t.append_message(b"X", k.point)
        return t

    def factor(self, i: int) -> int:
        t = self._factor_transcript()
        t.append_u64(b"i", i)
        return scalar.from_bytes_mod_order_wide(t.challenge_bytes(b"a_i", 64))

    def aggregated_key(self, engine: Engine | None = None) -> VerificationKey:
        """X as one MSM on `engine` (else the default engine, the card): a
        round trip to the device per call, as the JAX package's engine.msm
        makes one."""
        if not self.keys:
            raise MusigError("empty multikey")
        agg = resolve_engine(engine=engine).msm(
            [self.factor(i) for i in range(len(self.keys))],
            [k.decompress() for k in self.keys],
        )
        return VerificationKey(agg.compress())
