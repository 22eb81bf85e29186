"""Deferred point operations: the verifier's seam into the device.

Upstream counterpart: slingshot/zkvm point_ops / musig BatchVerification
(SURVEY.md §2.6): every signature check, taproot check and `unblind` is a
PointOp, and a transaction's ops fold into ONE random-linear-combination
MSM == identity, which the engine runs on the card
(kernels/engine.py::TorchEngine.msm_is_identity).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

from ..constants import L
from ..oracle.ristretto import RistrettoPoint
from ..proofs.engine import Engine, resolve_engine
from ..proofs.generators import PedersenGens
from ..proofs.util import add_time
from .errors import InvalidSignature


@dataclass
class PointOp:
    """primary*B + secondary*B_blinding + sum_i w_i*P_i == 0"""
    primary: int | None = None
    secondary: int | None = None
    arbitrary: list[tuple[int, bytes]] = field(default_factory=list)

    def verify(self, engine: Engine | None = None) -> None:
        verify_batch([self], engine=engine)


def verification_job(ops: list[PointOp], entropy: bytes = b""):
    """Combine all ops with random weights into one MSM job, (scalars,
    points) over [B, B_blinding] + each op's points (decoded on the host:
    an invalid encoding raises ValueError).

    Weights are derived by hashing the ops themselves plus caller entropy, so
    a malicious prover cannot craft cancelling ops without breaking the hash.
    """
    pc = PedersenGens()

    h = hashlib.sha3_512()
    h.update(entropy)
    for op in ops:
        h.update(b"op")
        h.update((op.primary or 0).to_bytes(32, "little"))
        h.update((op.secondary or 0).to_bytes(32, "little"))
        for w, p in op.arbitrary:
            h.update(int(w % L).to_bytes(32, "little"))
            h.update(p)
    seed = h.digest()

    prim = 0
    sec = 0
    scalars: list[int] = []
    points: list[RistrettoPoint] = []
    for i, op in enumerate(ops):
        r = int.from_bytes(
            hashlib.sha3_512(seed + i.to_bytes(8, "little")).digest(), "little"
        ) % L
        if op.primary is not None:
            prim = (prim + r * op.primary) % L
        if op.secondary is not None:
            sec = (sec + r * op.secondary) % L
        for w, pbytes in op.arbitrary:
            scalars.append(r * (w % L) % L)
            points.append(RistrettoPoint.decompress(pbytes))
    return [prim, sec] + scalars, [pc.B, pc.B_blinding] + points


def verify_batch(ops: list[PointOp], entropy: bytes = b"",
                 engine: Engine | None = None,
                 timings: dict | None = None) -> None:
    """The ops' verification_job == identity on `engine` (else the default
    engine, the card); raises InvalidSignature if not.  timings, when
    given, accumulates the engine call's seconds in device_s."""
    if not ops:
        return
    scalars, points = verification_job(ops, entropy)
    t = time.perf_counter()
    ok = resolve_engine(engine=engine).msm_is_identity(scalars, points)
    add_time(timings, "device_s", t)
    if not ok:
        raise InvalidSignature("batched point-op verification failed")
