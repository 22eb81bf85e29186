"""Pedersen and Bulletproof generators.

Upstream counterpart: bulletproofs/src/generators.rs —
- PedersenGens { B = ristretto basepoint, B_blinding = SHA3-512 hash-to-group
  of B's compressed encoding };
- GeneratorsChain: SHAKE-256("GeneratorsChain" || label) XOF, points drawn as
  from_uniform_bytes on successive 64-byte reads;
- BulletproofGens: per-party G/H chains with labels b"G"/b"H" || u32-LE party id.

Derived on the host once; kernels/batch_verify_device.py keeps their
canonical words resident on the device.  The prover's commitments
(PedersenGens.commit_batch) go through the engine; PedersenGens.commit
stays the host formula for the verifier's one public commitment
(vm/constraints.py), which must not cost a round trip to the card.
"""

from __future__ import annotations

import hashlib

from ..constants import GENERATORS_CHAIN_LABEL
from ..oracle.ristretto import BASEPOINT, RistrettoPoint
from .engine import resolve_engine


class PedersenGens:
    """Commit(v, b) = v*B + b*B_blinding (upstream PedersenGens)."""

    __slots__ = ("B", "B_blinding")
    _B_BLINDING_CACHE: RistrettoPoint | None = None

    def __init__(self):
        self.B = BASEPOINT
        if PedersenGens._B_BLINDING_CACHE is None:
            PedersenGens._B_BLINDING_CACHE = (
                RistrettoPoint.hash_from_bytes_sha3_512(BASEPOINT.compress())
            )
        self.B_blinding = PedersenGens._B_BLINDING_CACHE

    def commit(self, value: int, blinding: int) -> RistrettoPoint:
        return self.B * value + self.B_blinding * blinding

    def commit_batch(self, values, blindings,
                     engine=None) -> list[RistrettoPoint]:
        """[Commit(v_i, b_i)] in one engine call (engine=, else the default
        engine, on the card)."""
        return resolve_engine(engine=engine).commit_batch(
            values, blindings, self.B, self.B_blinding)


class GeneratorsChain:
    """Deterministic point stream from SHAKE-256 (upstream GeneratorsChain)."""

    def __init__(self, label: bytes):
        self._shake = hashlib.shake_256(GENERATORS_CHAIN_LABEL + label)
        self._offset = 0

    def take(self, n: int) -> list[RistrettoPoint]:
        end = self._offset + n
        buf = self._shake.digest(end * 64)
        out = [
            RistrettoPoint.from_uniform_bytes(buf[i * 64: (i + 1) * 64])
            for i in range(self._offset, end)
        ]
        self._offset = end
        return out


class BulletproofGens:
    """Per-party G/H generator vectors (upstream BulletproofGens).

    gens_capacity: generators per party (max bitsize n per aggregated value);
    party_capacity: max number m of aggregated parties.
    """

    def __init__(self, gens_capacity: int, party_capacity: int = 1):
        self.gens_capacity = 0
        self.party_capacity = party_capacity
        self.G_vec: list[list[RistrettoPoint]] = [[] for _ in range(party_capacity)]
        self.H_vec: list[list[RistrettoPoint]] = [[] for _ in range(party_capacity)]
        self._g_chains = [
            GeneratorsChain(b"G" + j.to_bytes(4, "little"))
            for j in range(party_capacity)
        ]
        self._h_chains = [
            GeneratorsChain(b"H" + j.to_bytes(4, "little"))
            for j in range(party_capacity)
        ]
        self.increase_capacity(gens_capacity)

    def increase_capacity(self, new_capacity: int):
        if new_capacity <= self.gens_capacity:
            return
        extra = new_capacity - self.gens_capacity
        for j in range(self.party_capacity):
            self.G_vec[j].extend(self._g_chains[j].take(extra))
            self.H_vec[j].extend(self._h_chains[j].take(extra))
        self.gens_capacity = new_capacity

    def share(self, j: int) -> "BulletproofGensShare":
        return BulletproofGensShare(self, j)

    def G(self, n: int, m: int) -> list[RistrettoPoint]:
        """The first n generators of each of the first m parties, party-major
        (upstream AggregatedGensIter)."""
        return [g for j in range(m) for g in self.G_vec[j][:n]]

    def H(self, n: int, m: int) -> list[RistrettoPoint]:
        return [h for j in range(m) for h in self.H_vec[j][:n]]


class BulletproofGensShare:
    """One party's view of the generators (upstream BulletproofGensShare)."""

    def __init__(self, gens: BulletproofGens, share: int):
        self._gens = gens
        self._share = share

    def G(self, n: int) -> list[RistrettoPoint]:
        return self._gens.G_vec[self._share][:n]

    def H(self, n: int) -> list[RistrettoPoint]:
        return self._gens.H_vec[self._share][:n]
