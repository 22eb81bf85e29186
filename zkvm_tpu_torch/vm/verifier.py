"""Verifier driver: verify a serialized transaction.

Upstream counterpart: slingshot/zkvm/src/verifier.rs (SURVEY.md §3.4):
replay the VM with opaque commitments, collect deferred point ops (taproot,
signid/signtag, unblind, plus the tx signature), verify the R1CS proof, and
fold every point op into one batched MSM.  The replay runs on the host;
every group operation goes through one engine (proofs/engine.py), the
card's unless the caller passes a CPU device or engine: the MuSig key
aggregation of `signtx`, the R1CS mega-check and the point-op check.
parallel/tx_batch.py batches a whole block through the same replay.
"""

from __future__ import annotations

import time

from ..constants import LABEL_ZKVM_R1CS, LABEL_ZKVM_TXID
from ..crypto.musig import Multikey
from ..crypto.starsig import Signature, VerificationKey, verify_op
from ..oracle.merlin import Transcript
from ..proofs.engine import Engine, resolve_engine
from ..proofs.errors import VerificationError
from ..proofs.generators import BulletproofGens, PedersenGens
from ..proofs.r1cs import R1CSProof
from ..proofs.r1cs import Verifier as R1CSVerifier
from ..proofs.transcript import ProofTranscript
from ..proofs.util import add_time
from .constraints import Commitment
from .errors import UnsignedTx
from .point_ops import verify_batch
from .tx import Tx, VerifiedTx
from .vm import VM


class _VerifierDelegate:
    is_prover = False

    def __init__(self, cs: R1CSVerifier):
        self.cs = cs
        self._committed: dict[bytes, object] = {}

    def commit_variable(self, commitment: Commitment):
        cached = self._committed.get(commitment.point)
        if cached is not None:
            return cached
        var = self.cs.commit(commitment.point)
        self._committed[commitment.point] = var
        return var


def _replay_tx(tx: Tx, engine: Engine | None, timings: dict | None):
    """Replay the VM; the signtx keys aggregate on `engine` (their seconds
    and count into timings["aggregated_key_s"] and ["aggregated_keys"])."""
    cs = R1CSVerifier(ProofTranscript(LABEL_ZKVM_R1CS))
    vm = VM(tx.header, tx.program, _VerifierDelegate(cs))
    vm.run()
    vm.check_stack_clean()
    txid = vm.finalize_txid()

    point_ops = list(vm.point_ops)

    # tx signature over txid by the aggregated signtx predicate keys
    if vm.signtx_keys:
        sig = Signature.from_bytes(tx.signature)
        multikey = Multikey([VerificationKey(p) for p in vm.signtx_keys])
        t = time.perf_counter()
        agg = multikey.aggregated_key(engine)
        add_time(timings, "aggregated_key_s", t)
        if timings is not None:
            timings["aggregated_keys"] = timings.get("aggregated_keys", 0) + 1
        sig_transcript = Transcript(LABEL_ZKVM_TXID)
        sig_transcript.append_message(b"txid", txid)
        point_ops.append(verify_op(sig, sig_transcript, agg))
    elif tx.signature != b"\x00" * 64:
        raise UnsignedTx("unexpected signature on unsigned tx")

    proof = R1CSProof.from_bytes(tx.proof)
    verified = VerifiedTx(
        header=tx.header, id=txid, log=vm.txlog, fee=vm.total_fee
    )
    return verified, point_ops, cs, proof


def precompute_tx(tx: Tx, bp_gens: BulletproofGens,
                  engine: Engine | None = None,
                  timings: dict | None = None):
    """Replay the VM and emit everything needed for (batched) verification:
    (VerifiedTx, point_ops, R1CS (scalars, points) job), the job's points
    decoded on the host."""
    verified, point_ops, cs, proof = _replay_tx(tx, engine, timings)
    return verified, point_ops, cs.verification_job(proof, bp_gens,
                                                    PedersenGens())


def precompute_tx_split_vec(tx: Tx, bp_gens: BulletproofGens,
                            engine: Engine | None = None,
                            timings: dict | None = None):
    """precompute_tx with the R1CS job in the tx batch's form:
    (VerifiedTx, point_ops, (dyn_scalars, dyn_encodings, bb, bs, g_vec,
    h_vec, padded_n)), static columns [B_blinding, B] + G + H, the dynamic
    points raw 32-byte encodings for the card's decode (K1)."""
    verified, point_ops, cs, proof = _replay_tx(tx, engine, timings)
    return verified, point_ops, cs.verification_job_split_vec(
        proof, bp_gens, PedersenGens())


def verify_tx(tx: Tx, bp_gens: BulletproofGens, device=None,
              engine: Engine | None = None,
              timings: dict | None = None) -> VerifiedTx:
    """Full single-tx verification (upstream Verifier::verify_tx) on
    `engine`, else on a TorchEngine on `device` ("cpu" runs the kernels'
    plain versions, as the tests do), else on the default engine (the
    card), as R1CS Verifier.verify resolves its engine.  Raises
    VerificationError (R1CS) or InvalidSignature (point ops) on reject,
    VMError/ProofError/ValueError on malformed input.  timings, when given,
    receives aggregated_key_s (the signtx key's MSM), device_s (the R1CS
    and point-op checks, packing included), host_s (the rest: replay,
    transcripts, job assembly and host decode) and msm_size (the R1CS
    MSM's points)."""
    eng = resolve_engine(device, engine)
    t0 = time.perf_counter()
    tm: dict = {}
    verified, point_ops, (scalars, points) = precompute_tx(tx, bp_gens, eng,
                                                           tm)
    t = time.perf_counter()
    ok = eng.msm_is_identity(scalars, points)
    add_time(tm, "device_s", t)
    if not ok:
        raise VerificationError("R1CS proof verification failed")
    verify_batch(point_ops, engine=eng, timings=tm)
    if timings is not None:
        wall = time.perf_counter() - t0
        timings.update(aggregated_key_s=tm.get("aggregated_key_s", 0.0),
                       device_s=tm["device_s"], msm_size=len(points))
        timings["host_s"] = (wall - timings["aggregated_key_s"]
                             - timings["device_s"])
    return verified
