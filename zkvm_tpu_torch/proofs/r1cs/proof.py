"""R1CSProof container + serialization.

Upstream counterpart: bulletproofs/src/r1cs/proof.rs — eleven group elements
(A_I1, A_O1, S1, A_I2, A_O2, S2, T_1, T_3, T_4, T_5, T_6), three scalars
(t_x, t_x_blinding, e_blinding), and the inner-product proof.  Phase-2 points
are the identity for one-phase proofs (kept on the wire for simplicity).
"""

from __future__ import annotations

from dataclasses import dataclass

from ...oracle import scalar
from ..errors import FormatError
from ..ipp import InnerProductProof

_POINT_LABELS = (
    "A_I1", "A_O1", "S1", "A_I2", "A_O2", "S2", "T_1", "T_3", "T_4", "T_5", "T_6",
)


@dataclass
class R1CSProof:
    A_I1: bytes
    A_O1: bytes
    S1: bytes
    A_I2: bytes
    A_O2: bytes
    S2: bytes
    T_1: bytes
    T_3: bytes
    T_4: bytes
    T_5: bytes
    T_6: bytes
    t_x: int
    t_x_blinding: int
    e_blinding: int
    ipp_proof: InnerProductProof

    def points(self) -> list[bytes]:
        return [getattr(self, n) for n in _POINT_LABELS]

    def to_bytes(self) -> bytes:
        out = b"".join(self.points())
        out += scalar.to_bytes(self.t_x)
        out += scalar.to_bytes(self.t_x_blinding)
        out += scalar.to_bytes(self.e_blinding)
        out += self.ipp_proof.to_bytes()
        return out

    @staticmethod
    def from_bytes(data: bytes) -> "R1CSProof":
        if len(data) < 14 * 32 or len(data) % 32 != 0:
            raise FormatError("bad R1CS proof length")
        pts = [data[i * 32: (i + 1) * 32] for i in range(11)]
        t_x = scalar.from_canonical_bytes(data[11 * 32: 12 * 32])
        t_x_blinding = scalar.from_canonical_bytes(data[12 * 32: 13 * 32])
        e_blinding = scalar.from_canonical_bytes(data[13 * 32: 14 * 32])
        ipp = InnerProductProof.from_bytes(data[14 * 32:])
        return R1CSProof(*pts, t_x, t_x_blinding, e_blinding, ipp)
