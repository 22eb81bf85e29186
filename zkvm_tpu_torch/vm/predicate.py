"""Taproot predicates.

Upstream counterpart: slingshot/zkvm/src/predicate.rs (SURVEY.md §2.6):
a Predicate is an opaque Ristretto point; a PredicateTree commits a signing
key X and a Merkle tree of program leaves M as P = X + h(X, M)*B.  `call`
proves one leaf with a CallProof (X + Merkle path) and a deferred PointOp;
`signtx` uses P directly as a (possibly taproot-tweaked) verification key.

The verifier's half: PredicateTree, which makes P on the prover's side
with a fixed-base multiplication, is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import L, LABEL_ZKVM_TAPROOT
from ..crypto.merkle import Path
from ..oracle import scalar as sc
from ..oracle.merlin import Transcript
from .encoding import Reader, Writer
from .errors import FormatError
from .point_ops import PointOp


@dataclass(frozen=True)
class Predicate:
    """Opaque predicate point (compressed)."""
    point: bytes

    def to_bytes(self) -> bytes:
        return self.point


def _adjustment(X: bytes, root: bytes) -> int:
    t = Transcript(LABEL_ZKVM_TAPROOT)
    t.append_message(b"X", X)
    t.append_message(b"M", root)
    return sc.from_bytes_mod_order_wide(t.challenge_bytes(b"h", 64))


@dataclass
class CallProof:
    X: bytes       # inner verification key point
    path: Path

    def to_bytes(self) -> bytes:
        w = Writer()
        w.write_bytes(self.X)
        w.write_u32(self.path.position)
        w.write_u32(len(self.path.neighbors))
        for nb in self.path.neighbors:
            w.write_bytes(nb)
        return w.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "CallProof":
        r = Reader(data)
        X = r.read_u8x32()
        position = r.read_u32()
        n = r.read_u32()
        if n > 32:
            raise FormatError("call proof too deep")
        neighbors = [r.read_u8x32() for _ in range(n)]
        if not r.done():
            raise FormatError("trailing bytes in call proof")
        return CallProof(X, Path(position, neighbors))


def taproot_check_op(predicate: Predicate, prog: bytes, proof: CallProof) -> PointOp:
    """Deferred check: X + h(X, root(path, prog))*B - P == 0."""
    root = proof.path.compute_root(LABEL_ZKVM_TAPROOT, prog)
    h = _adjustment(proof.X, root)
    return PointOp(
        primary=h,
        secondary=None,
        arbitrary=[(1, proof.X), ((-1) % L, predicate.point)],
    )
