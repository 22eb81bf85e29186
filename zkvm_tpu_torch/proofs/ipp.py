"""The inner-product proof's fields and wire format.

Upstream counterpart: bulletproofs/src/inner_product_proof.rs —
InnerProductProof::{to_bytes, from_bytes}.  The verifier never folds: the
range-proof mega-check consumes the L/R encodings and the final a, b
directly (kernels/batch_verify_device.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..oracle import scalar
from .errors import FormatError


@dataclass
class InnerProductProof:
    L_vec: list[bytes]  # compressed round commitments
    R_vec: list[bytes]
    a: int
    b: int

    def to_bytes(self) -> bytes:
        out = bytearray()
        for Lb, Rb in zip(self.L_vec, self.R_vec):
            out += Lb
            out += Rb
        out += scalar.to_bytes(self.a)
        out += scalar.to_bytes(self.b)
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "InnerProductProof":
        if len(data) % 32 != 0 or len(data) < 64:
            raise FormatError("bad inner product proof length")
        num_elems = len(data) // 32
        lg_n = (num_elems - 2) // 2
        if 2 * lg_n + 2 != num_elems or lg_n >= 32:
            raise FormatError("bad inner product proof structure")
        L_vec, R_vec = [], []
        for i in range(lg_n):
            L_vec.append(data[64 * i: 64 * i + 32])
            R_vec.append(data[64 * i + 32: 64 * i + 64])
        a = scalar.from_canonical_bytes(data[-64:-32])
        b = scalar.from_canonical_bytes(data[-32:])
        return InnerProductProof(L_vec, R_vec, a, b)
