"""Compact tx relay short ids (SipHash-2-4 based).

The port's copy of the JAX package's chain/shortid.py: the same ids.

Upstream counterpart: slingshot/blockchain/src/shortid.rs — BIP152-style
6-byte short ids keyed per (block, nonce) so peers exchange inventories
without full tx hashes.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _MASK


def siphash24(key: bytes, data: bytes) -> int:
    """SipHash-2-4 with a 16-byte key -> 64-bit hash."""
    assert len(key) == 16
    k0 = int.from_bytes(key[:8], "little")
    k1 = int.from_bytes(key[8:], "little")
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573

    def sipround():
        nonlocal v0, v1, v2, v3
        v0 = (v0 + v1) & _MASK
        v1 = _rotl(v1, 13) ^ v0
        v0 = _rotl(v0, 32)
        v2 = (v2 + v3) & _MASK
        v3 = _rotl(v3, 16) ^ v2
        v0 = (v0 + v3) & _MASK
        v3 = _rotl(v3, 21) ^ v0
        v2 = (v2 + v1) & _MASK
        v1 = _rotl(v1, 17) ^ v2
        v2 = _rotl(v2, 32)

    b = len(data) & 0xFF
    padded = data + b"\x00" * ((8 - (len(data) + 1) % 8) % 8) + bytes([b])
    for i in range(0, len(padded), 8):
        m = int.from_bytes(padded[i: i + 8], "little")
        v3 ^= m
        sipround()
        sipround()
        v0 ^= m
    v2 ^= 0xFF
    for _ in range(4):
        sipround()
    return (v0 ^ v1 ^ v2 ^ v3) & _MASK


class ShortIDNonce:
    """Per-message key derivation for short ids."""

    def __init__(self, seed: bytes, nonce: int):
        from ..oracle.merlin import Transcript
        t = Transcript(b"ZkVM.shortid")
        t.append_message(b"seed", seed)
        t.append_u64(b"nonce", nonce)
        self.key = t.challenge_bytes(b"key", 16)

    def short_id(self, tx_hash: bytes) -> bytes:
        """6-byte short id (upstream ShortID)."""
        return (siphash24(self.key, tx_hash) & ((1 << 48) - 1)).to_bytes(6, "little")
