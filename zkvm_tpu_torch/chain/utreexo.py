"""Utreexo: a dynamic hash accumulator for the UTXO set.

The port's copy of the JAX package's chain/utreexo.py, hashing with the
port's Merlin transcript (native STROBE): the same roots, proofs and bytes.

Upstream counterpart: slingshot/blockchain/src/utreexo (SURVEY.md §2.7):
a forest of perfect Merkle trees; O(log n) membership proofs; insertion by
binary carries; deletion by splitting the containing tree into its path-
sibling subtrees; a Catchup structure re-bases stale proofs after updates.

Key invariant exploited for deletion (and proof catch-up): in a perfect
tree, the proof siblings of a leaf are exactly the roots of the perfect
subtrees left over when that leaf is removed — so a valid proof carries all
material needed to restructure the forest, and an old proof stays usable as
long as SOME prefix of its climb lands on a current root or on a node the
latest Catchup knows how to re-parent.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..oracle.merlin import Transcript

_LABEL = b"ZkVM.utreexo"


def leaf_hash(item: bytes) -> bytes:
    t = Transcript(_LABEL)
    t.append_message(b"leaf", item)
    return t.challenge_bytes(b"utreexo.leaf", 32)


def node_hash(left: bytes, right: bytes) -> bytes:
    t = Transcript(_LABEL)
    t.append_message(b"L", left)
    t.append_message(b"R", right)
    return t.challenge_bytes(b"utreexo.node", 32)


@dataclass
class UtreexoProof:
    """Position bits (LSB = level 0: 0 = leaf is left child) + siblings."""
    position: int
    neighbors: list[bytes]

    def serialize(self) -> bytes:
        from ..vm.encoding import Writer
        w = Writer()
        w.write_u64(self.position)
        w.write_u32(len(self.neighbors))
        for nb in self.neighbors:
            w.write_bytes(nb)
        return w.to_bytes()

    @staticmethod
    def deserialize(data: bytes) -> "UtreexoProof":
        from ..vm.encoding import Reader
        r = Reader(data)
        pos = r.read_u64()
        n = r.read_u32()
        if n > 64:
            raise UtreexoError("proof too deep")
        neighbors = [r.read_u8x32() for _ in range(n)]
        if not r.done():
            raise UtreexoError("trailing bytes in utreexo proof")
        return UtreexoProof(pos, neighbors)


class UtreexoError(Exception):
    pass


@dataclass
class Catchup:
    """Re-bases proofs issued before the latest update.

    parent: child_hash -> (parent_hash, sibling_hash, child_is_right)
    for every node merged during the update.
    """
    parent: dict[bytes, tuple[bytes, bytes, bool]] = field(default_factory=dict)
    root_set: set[bytes] = field(default_factory=set)

    def update_proof(self, item: bytes, proof: UtreexoProof) -> UtreexoProof:
        """Climb the old proof until a hash the new forest knows, then splice
        the new climb on top (upstream Catchup::update_proof)."""
        h = leaf_hash(item)
        pos = proof.position
        kept: list[bytes] = []
        level = 0
        cur = h
        while True:
            if cur in self.root_set or cur in self.parent:
                break
            if level >= len(proof.neighbors):
                raise UtreexoError("proof cannot be caught up")
            sib = proof.neighbors[level]
            kept.append(sib)
            cur = node_hash(sib, cur) if (pos >> level) & 1 else node_hash(cur, sib)
            level += 1
        # now climb the new-parent map
        new_neighbors = list(kept)
        new_pos_bits = pos & ((1 << level) - 1)
        bit = level
        while cur in self.parent:
            parent_h, sibling, is_right = self.parent[cur]
            new_neighbors.append(sibling)
            if is_right:
                new_pos_bits |= 1 << bit
            bit += 1
            cur = parent_h
        return UtreexoProof(new_pos_bits, new_neighbors)

    def proof_for_new_item(self, item: bytes) -> UtreexoProof:
        """Bootstrap the first proof for an item inserted by the update that
        produced this Catchup: the leaf either became its own root or was
        merged upward — the parent map records the whole climb (upstream
        Catchup covers fresh inserts the same way: WorkForest tracks the
        new leaf nodes it created)."""
        return self.update_proof(item, UtreexoProof(0, []))

    def serialize(self) -> bytes:
        from ..vm.encoding import Writer
        w = Writer()
        w.write_u32(len(self.parent))
        for child in sorted(self.parent):
            parent_h, sibling, is_right = self.parent[child]
            w.write_bytes(child)
            w.write_bytes(parent_h)
            w.write_bytes(sibling)
            w.write_u8(1 if is_right else 0)
        w.write_u32(len(self.root_set))
        for r in sorted(self.root_set):
            w.write_bytes(r)
        return w.to_bytes()

    @staticmethod
    def deserialize(data: bytes) -> "Catchup":
        from ..vm.encoding import Reader
        r = Reader(data)
        c = Catchup()
        for _ in range(r.read_u32()):
            child = r.read_u8x32()
            parent_h = r.read_u8x32()
            sibling = r.read_u8x32()
            flag = r.read_u8()
            if flag > 1:
                raise UtreexoError("bad catchup flag")
            c.parent[child] = (parent_h, sibling, flag == 1)
        c.root_set = {r.read_u8x32() for _ in range(r.read_u32())}
        if not r.done():
            raise UtreexoError("trailing bytes in catchup")
        return c


@dataclass
class CatchupChain:
    """Re-bases proofs across MULTIPLE updates: a wallet that was offline
    for j blocks applies the j per-block Catchups in order (upstream nodes
    keep only the latest Catchup and require wallets to update every block;
    retaining a bounded window of them lets stale-by-several-blocks proofs
    recover — SURVEY.md §5.4)."""
    catchups: list[Catchup] = field(default_factory=list)
    max_window: int = 64

    def push(self, c: Catchup):
        self.catchups.append(c)
        if len(self.catchups) > self.max_window:
            del self.catchups[: len(self.catchups) - self.max_window]

    def update_proof(self, item: bytes, proof: UtreexoProof,
                     stale_by: int) -> UtreexoProof:
        """Catch a proof issued `stale_by` updates ago up to the present."""
        if stale_by > len(self.catchups):
            raise UtreexoError(
                f"proof is {stale_by} updates stale; window holds "
                f"{len(self.catchups)}"
            )
        if stale_by == 0:
            return proof
        for c in self.catchups[len(self.catchups) - stale_by:]:
            proof = c.update_proof(item, proof)
        return proof


class Utreexo:
    """The accumulator: at most one perfect-tree root per height."""

    MAX_HEIGHT = 64

    def __init__(self):
        self.roots: list[bytes | None] = [None] * self.MAX_HEIGHT
        self.num_leaves = 0

    # -------------------------------------------------------------- queries
    def root_list(self) -> list[tuple[int, bytes]]:
        return [(h, r) for h, r in enumerate(self.roots) if r is not None]

    def state_hash(self) -> bytes:
        t = Transcript(_LABEL)
        for h, r in self.root_list():
            t.append_u64(b"height", h)
            t.append_message(b"root", r)
        return t.challenge_bytes(b"utreexo.state", 32)

    def verify(self, item: bytes, proof: UtreexoProof) -> int:
        """Return the level at which the proof's climb meets a current root;
        raises if it never does."""
        cur = leaf_hash(item)
        pos = proof.position
        for level in range(len(proof.neighbors) + 1):
            if level < len(self.roots) and self.roots[level] == cur:
                return level
            if level == len(proof.neighbors):
                break
            sib = proof.neighbors[level]
            cur = (
                node_hash(sib, cur) if (pos >> level) & 1 else node_hash(cur, sib)
            )
        raise UtreexoError("invalid utreexo proof")

    # -------------------------------------------------------------- updates
    def insert(self, item: bytes):
        """Single insert without catchup tracking (use update() when
        outstanding proofs must be re-based)."""
        self._insert_node(0, leaf_hash(item), None)
        self.num_leaves += 1

    def _insert_node(self, height: int, h: bytes, events: list | None):
        while self.roots[height] is not None:
            left = self.roots[height]
            self.roots[height] = None
            merged = node_hash(left, h)
            if events is not None:
                events.append((merged, left, h, height))
            h = merged
            height += 1
        self.roots[height] = h

    def delete(self, item: bytes, proof: UtreexoProof):
        """Remove one proven leaf (single-deletion form of update)."""
        self.update([(item, proof)], [])

    def update(self, deletions: list[tuple[bytes, UtreexoProof]],
               insertions: list[bytes]) -> Catchup:
        """Apply a block's worth of changes; returns the Catchup for
        re-basing outstanding proofs (upstream Forest::update + Catchup).

        Two phases, mirroring upstream's WorkForest-then-normalize: every
        deletion proof is resolved against a FRAGMENT SET seeded with the
        pre-state roots (deleting a leaf removes its containing fragment and
        stages the proof's sibling subtrees as new fragments — no carries
        yet), then one rebuild pass re-inserts all fragments and new leaves
        with carries.  Splitting the phases makes deletion order-independent:
        with eager carries, a reinserted sibling could merge into ANOTHER
        tree's root and invalidate a later deletion proof that was valid
        against the pre-state.

        Raises (leaving the forest untouched) if any proof is invalid or the
        same leaf is deleted twice.  Hash-keyed fragments assume distinct
        leaf items; contract IDs are unique by the anchor ratchet.
        """
        frags: dict[bytes, int] = {r: h for h, r in self.root_list()}
        for item, proof in deletions:
            cur = leaf_hash(item)
            pos = proof.position
            for level in range(len(proof.neighbors) + 1):
                if frags.get(cur) == level:
                    del frags[cur]
                    for lo in range(level - 1, -1, -1):
                        frags[proof.neighbors[lo]] = lo
                    break
                if level == len(proof.neighbors):
                    raise UtreexoError("invalid utreexo proof")
                sib = proof.neighbors[level]
                cur = (
                    node_hash(sib, cur) if (pos >> level) & 1
                    else node_hash(cur, sib)
                )

        events: list = []
        rebuilt = Utreexo()
        for h, height in sorted(frags.items(), key=lambda kv: (-kv[1], kv[0])):
            rebuilt._insert_node(height, h, events)
        for item in insertions:
            rebuilt._insert_node(0, leaf_hash(item), events)
        self.roots = rebuilt.roots
        self.num_leaves += len(insertions) - len(deletions)
        self.check_invariants()

        catchup = Catchup()
        for merged, left, right, _h in events:
            catchup.parent[left] = (merged, right, False)
            catchup.parent[right] = (merged, left, True)
        catchup.root_set = {r for _, r in self.root_list()}
        return catchup

    def copy(self) -> "Utreexo":
        c = Utreexo()
        c.roots = list(self.roots)
        c.num_leaves = self.num_leaves
        return c

    # ----------------------------------------------------------- invariants
    def check_invariants(self):
        """The forest is ALWAYS normalized: `_insert_node` carries eagerly,
        so there is at most one perfect-tree root per height (the list index
        IS the height) and the occupied heights sum to num_leaves.  Upstream
        reaches the same canonical form lazily (Forest::normalize at block
        end); here every update leaves the forest normalized, which is why
        no separate normalization pass exists."""
        total = sum(1 << h for h, r in enumerate(self.roots) if r is not None)
        if total != self.num_leaves:
            raise UtreexoError(
                f"forest de-normalized: roots sum to {total} leaves, "
                f"tracked {self.num_leaves}"
            )

    # -------------------------------------------------------- serialization
    def serialize(self) -> bytes:
        """Durable node state (upstream's only checkpoint use-case,
        SURVEY.md §5.4): height-tagged root list + leaf count."""
        from ..vm.encoding import Writer
        w = Writer()
        w.write_u64(self.num_leaves)
        occupied = self.root_list()
        w.write_u32(len(occupied))
        for h, r in occupied:
            w.write_u8(h)
            w.write_bytes(r)
        return w.to_bytes()

    @staticmethod
    def deserialize(data: bytes) -> "Utreexo":
        from ..vm.encoding import Reader
        r = Reader(data)
        u = Utreexo()
        u.num_leaves = r.read_u64()
        n = r.read_u32()
        prev_h = -1
        for _ in range(n):
            h = r.read_u8()
            if h <= prev_h or h >= Utreexo.MAX_HEIGHT:
                raise UtreexoError("root heights must be strictly increasing")
            prev_h = h
            u.roots[h] = r.read_u8x32()
        if not r.done():
            raise UtreexoError("trailing bytes in utreexo state")
        u.check_invariants()
        return u
