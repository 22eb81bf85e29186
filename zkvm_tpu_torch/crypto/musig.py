"""MuSig: n-of-n multisignatures with key aggregation.

Upstream counterpart: slingshot/musig/src/* — Multikey aggregation with
delinearization factors from a Merlin transcript, and the 3-round signing
state machine (nonce precommit -> nonce commit -> share), with share-level
error attribution.  Aggregated signatures verify exactly like starsig
signatures under the aggregated key.

The verifier's Multikey.aggregated_key is one TorchEngine.msm.  The
signers' group operations run on their engine (the card's unless the
caller passes another): each nonce R_i = r_i·B (basepoint_mul, K17 on the
card, constant-time in r_i), and as msm_batch calls over public scalars
the sum of the R_i and the aggregated key together (unit scalars over the
R_i, the factors over the X_i), and the dealer's share checks s_i·B - R_i
- c·a_i·X_i, one group each, tested against the identity after the
fetch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..constants import L, LABEL_MUSIG
from ..oracle import scalar
from ..oracle.merlin import Transcript
from ..oracle.ristretto import BASEPOINT, decompress_many
from ..proofs.engine import Engine, resolve_engine
from .starsig import Signature, VerificationKey, _challenge


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


def _nonce_and_key(multikey: Multikey, commitments: list[bytes],
                   engine: Engine) -> tuple[bytes, VerificationKey]:
    """(Σ R_i compressed, the aggregated key X): the reference's
    _sum_compressed and the signer's aggregated_key as one msm_batch of
    two groups."""
    R, X = engine.msm_batch(
        [[1] * len(commitments),
         [multikey.factor(i) for i in range(len(multikey.keys))]],
        [decompress_many(commitments),
         [k.decompress() for k in multikey.keys]])
    return R.compress(), VerificationKey(X.compress())


class Party:
    """One signer in the 3-round protocol (upstream party state machine);
    its nonce point runs on `engine` (else the default engine)."""

    def __init__(self, multikey: Multikey, privkey: int, position: int,
                 transcript: Transcript, engine: Engine | None = None):
        self.multikey = multikey
        self.x = privkey % L
        self.i = position
        self.transcript = transcript  # carries the message being signed
        self.engine = resolve_engine(engine=engine)
        self.r = (
            transcript.clone().build_rng()
            .rekey_with_witness_bytes(b"x", scalar.to_bytes(self.x))
            .finalize(os.urandom(32))
            .random_scalar()
        )
        self.R_i = self.engine.basepoint_mul(self.r).compress()

    # round 1: precommit H(R_i)
    def precommitment(self) -> bytes:
        t = Transcript(b"Musig.precommitment")
        t.append_message(b"R", self.R_i)
        return t.challenge_bytes(b"precommitment", 32)

    # round 2: reveal R_i
    def commitment(self) -> bytes:
        return self.R_i

    # round 3: share s_i given everyone's R
    def share(self, precommitments: list[bytes], commitments: list[bytes]) -> int:
        bad = []
        for j, (pre, com) in enumerate(zip(precommitments, commitments, strict=True)):
            t = Transcript(b"Musig.precommitment")
            t.append_message(b"R", com)
            if t.challenge_bytes(b"precommitment", 32) != pre:
                bad.append(j)
        if bad:
            raise MusigError("nonce precommitment mismatch", bad_parties=bad)
        R, X = _nonce_and_key(self.multikey, commitments, self.engine)
        c = _challenge(self.transcript, X.point, R)
        a_i = self.multikey.factor(self.i)
        return (self.r + c * a_i % L * self.x) % L


def _aggregate_shares(multikey: Multikey, transcript: Transcript,
                      commitments: list[bytes], shares: list[int],
                      engine: Engine) -> tuple[Signature, VerificationKey]:
    """aggregate_shares -> (the signature, the aggregated key)."""
    R, X = _nonce_and_key(multikey, commitments, engine)
    c = _challenge(transcript, X.point, R)
    # s_i·B - R_i - c·a_i·X_i, each the identity for a valid share
    checks = engine.msm_batch(
        [[s_i, L - 1, (-c * multikey.factor(i)) % L]
         for i, s_i in enumerate(shares)],
        [[BASEPOINT, R_i, k.decompress()] for R_i, k in zip(
            decompress_many(commitments), multikey.keys, strict=True)])
    bad = [i for i, p in enumerate(checks) if not p.is_identity()]
    if bad:
        raise MusigError("invalid signature shares", bad_parties=bad)
    return Signature(sum(shares) % L, R), X


def aggregate_shares(
    multikey: Multikey,
    transcript: Transcript,
    commitments: list[bytes],
    shares: list[int],
    engine: Engine | None = None,
) -> Signature:
    """Dealer: s = sum s_i, R = sum R_i; verifies each share and attributes
    failures (upstream receive_trusted/untrusted pattern), on `engine`
    (else the default engine)."""
    return _aggregate_shares(multikey, transcript, commitments, shares,
                             resolve_engine(engine=engine))[0]


def sign_multi(
    privkeys: list[int], transcript: Transcript,
    engine: Engine | None = None,
) -> tuple[Signature, VerificationKey]:
    """Run the whole protocol locally (the single-process path used by the
    ZkVM's build_tx for signtx), every group operation on `engine`
    (else the default engine)."""
    eng = resolve_engine(engine=engine)
    multikey = Multikey([VerificationKey.from_secret(x, eng)
                         for x in privkeys])
    parties = [
        Party(multikey, x, i, transcript.clone(), eng)
        for i, x in enumerate(privkeys)
    ]
    pres = [p.precommitment() for p in parties]
    coms = [p.commitment() for p in parties]
    shares = [p.share(pres, coms) for p in parties]
    return _aggregate_shares(multikey, transcript, coms, shares, eng)
