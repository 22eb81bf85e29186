"""Binary Merkle trees hashed with Merlin transcripts.

Upstream counterpart: slingshot/merkle/src/lib.rs — MerkleTree::root with
leaf/node domain separation by Merlin labels, inclusion Paths with
position bits.  Used for TxID (tx log entries) and taproot
program trees.

Hashing discipline (upstream MerkleItem/MerkleTree):
  leaf:  T = Transcript(label); T.append(b"leaf", item);    hash = challenge
  node:  T = Transcript(label); T.append(b"L", l); append(b"R", r); challenge
  empty: T = Transcript(label); challenge_bytes(b"merkle.empty")
"""

from __future__ import annotations

from dataclasses import dataclass

from ..oracle.merlin import Transcript


def _leaf_hash(label: bytes, item: bytes) -> bytes:
    t = Transcript(label)
    t.append_message(b"leaf", item)
    return t.challenge_bytes(b"merkle.leaf", 32)


def _node_hash(label: bytes, left: bytes, right: bytes) -> bytes:
    t = Transcript(label)
    t.append_message(b"L", left)
    t.append_message(b"R", right)
    return t.challenge_bytes(b"merkle.node", 32)


def _empty_hash(label: bytes) -> bytes:
    t = Transcript(label)
    return t.challenge_bytes(b"merkle.empty", 32)


@dataclass
class Path:
    """Inclusion proof: leaf position + sibling hashes bottom-up."""
    position: int
    neighbors: list[bytes]

    def compute_root(self, label: bytes, item: bytes) -> bytes:
        h = _leaf_hash(label, item)
        pos = self.position
        for sibling in self.neighbors:
            if pos & 1:
                h = _node_hash(label, sibling, h)
            else:
                h = _node_hash(label, h, sibling)
            pos >>= 1
        return h


class MerkleTree:
    """Merkle tree over serialized items (bytes)."""

    def __init__(self, label: bytes, items: list[bytes]):
        self.label = label
        self.items = list(items)
        if not items:
            self._levels = [[_empty_hash(label)]]
        else:
            level = [_leaf_hash(label, it) for it in items]
            # pad to a power of two with the empty hash so every node has a
            # sibling and inclusion paths are uniform
            size = 1
            while size < len(level):
                size *= 2
            level = level + [_empty_hash(label)] * (size - len(level))
            levels = [level]
            while len(level) > 1:
                level = [
                    _node_hash(label, level[i], level[i + 1])
                    for i in range(0, len(level), 2)
                ]
                levels.append(level)
            self._levels = levels

    def root(self) -> bytes:
        return self._levels[-1][0]

    @staticmethod
    def root_of(label: bytes, items: list[bytes]) -> bytes:
        return MerkleTree(label, items).root()

    def prove_inclusion(self, index: int) -> Path:
        if not self.items:
            raise IndexError("empty tree has no inclusion proofs")
        neighbors = []
        pos = index
        for level in self._levels[:-1]:
            neighbors.append(level[pos ^ 1])
            pos >>= 1
        return Path(position=index, neighbors=neighbors)

    def verify_inclusion(self, item: bytes, path: Path) -> bool:
        return path.compute_root(self.label, item) == self.root()
