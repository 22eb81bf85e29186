"""Taproot predicates.

Upstream counterpart: slingshot/zkvm/src/predicate.rs (SURVEY.md §2.6):
a Predicate is an opaque Ristretto point; a PredicateTree commits a signing
key X and a Merkle tree of program leaves M as P = X + h(X, M)*B.  `call`
proves one leaf with a CallProof (X + Merkle path) and a deferred PointOp;
`signtx` uses P directly as a (possibly taproot-tweaked) verification key.

PredicateTree makes P on the prover's side: h·B on the engine (`engine=`,
else the default engine, the card's fixed-base kernel K17), then X + h·B
on the host, as the reference adds them.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import L, LABEL_ZKVM_TAPROOT
from ..crypto.merkle import MerkleTree, Path
from ..oracle import scalar as sc
from ..oracle.merlin import Transcript
from ..oracle.ristretto import RistrettoPoint
from ..proofs.engine import Engine, resolve_engine
from .encoding import Reader, Writer
from .errors import FormatError, InvalidPredicateTree
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


class PredicateTree:
    """A signing key and program leaves -> a taproot predicate."""

    def __init__(self, key_point: bytes, progs: list[bytes]):
        if len(progs) > 2**20:
            raise InvalidPredicateTree("too many program leaves")
        self.key_point = key_point
        self.progs = list(progs)
        self.tree = MerkleTree(LABEL_ZKVM_TAPROOT, self.progs)

    def adjustment_factor(self) -> int:
        return _adjustment(self.key_point, self.tree.root())

    def predicate(self, engine: Engine | None = None) -> Predicate:
        h = self.adjustment_factor()
        P = (RistrettoPoint.decompress(self.key_point)
             + resolve_engine(engine=engine).basepoint_mul(h, ct=False))
        return Predicate(P.compress())

    def call_proof(self, index: int) -> "CallProof":
        return CallProof(self.key_point, self.tree.prove_inclusion(index))

    def signing_key_adjustment(self) -> int:
        """Secret-key tweak: sk' = sk + h so that P = sk'*B when X = sk*B."""
        return self.adjustment_factor()


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
