"""Batched full-transaction verification on one card (BASELINE config 5,
"full ZkVM transaction verification").

Per tx, the host replays the VM, producing (a) the R1CS mega-check MSM job
and (b) the deferred PointOps (signatures, taproot, unblind).

- fused_verify_tx_batch folds every tx's R1CS check and every PointOp into
  ONE random-linear-combination MSM whose generator columns appear once
  for the whole batch, and runs it on the card through
  kernels/batch_verify_device.py::fused_split_check (K1 decodes the
  dynamic points, then K2/K3 or the small route, and K4);
- verify_tx_batch checks job by job through the engine: one MSM per tx's
  R1CS job and one over all the PointOps.

The JAX package's mesh path, its spawn process pool for the replay, its
environment switch for the device mode and its host fallback are not
ported: the fused check always runs on the engine's device, and a device
failure raises.
"""

from __future__ import annotations

import hashlib
import os
import time

from ..constants import L
from ..kernels.batch_verify_device import fused_split_check
from ..proofs.engine import Engine, resolve_engine
from ..proofs.errors import ProofError, R1CSError, VerificationError
from ..proofs.generators import BulletproofGens, PedersenGens
from ..proofs.scalarvec import ScalarVec
from ..vm.errors import VMError
from ..vm.point_ops import PointOp
from ..vm.point_ops import verification_job as _point_ops_job
from ..vm.tx import Tx, VerifiedTx
from ..vm.verifier import precompute_tx, precompute_tx_split_vec


def verify_tx_batch(
    txs: list[Tx],
    bp_gens: BulletproofGens,
    entropy: bytes | None = None,
    device=None,
    engine: Engine | None = None,
) -> list[VerifiedTx]:
    """Verify a batch of transactions job by job on `engine` (else a
    TorchEngine on `device`, else the default engine, the card): every
    tx's R1CS mega-check, then one check combining every PointOp of the
    batch.  Raises VerificationError naming the first failing job (job i <
    len(txs) is tx i's R1CS check)."""
    if not txs:
        return []
    eng = resolve_engine(device, engine)
    if entropy is None:
        entropy = os.urandom(32)
    verified: list[VerifiedTx] = []
    jobs = []
    all_ops: list[PointOp] = []
    for tx in txs:
        vtx, point_ops, r1cs_job = precompute_tx(tx, bp_gens, eng)
        verified.append(vtx)
        jobs.append(r1cs_job)
        all_ops.extend(point_ops)
    if all_ops:
        jobs.append(_point_ops_job(all_ops, entropy))
    for i, (scalars, points) in enumerate(jobs):
        if not eng.msm_is_identity(scalars, points):
            raise VerificationError(f"tx batch check failed (job {i})")
    return verified


def _weight(entropy: bytes, wid: bytes, tag: bytes, j: int = 0) -> int:
    """Per-check RLC weight.  Bound to the verifier's entropy and the FULL
    tx wire bytes (wid = sha3-256 of tx.to_bytes(), which covers the R1CS
    proof and signature bytes — txid alone does not commit to them), so an
    attacker cannot fix the weights and then solve for proof points whose
    residuals cancel across the batch — same argument as upstream
    PointOp::verify_batch's thread_rng weights."""
    return int.from_bytes(
        hashlib.sha3_512(
            entropy + wid + tag + j.to_bytes(8, "little")).digest(),
        "little") % L


def _chunk_precompute(txs_bytes: list[bytes], bp_gens: BulletproofGens,
                      entropy: bytes, engine: Engine | None = None,
                      timings: dict | None = None):
    """Replay, weight and accumulate txs: returns (verified_txs, head_acc
    ([B_blinding, B], 2 ints), g_acc_buf, h_acc_buf (raw ScalarVec bytes),
    dyn_scalars, dyn_encodings (one blob of raw 32-byte encodings, which
    the card's decode validates)).  The JAX package's encoding mode
    (enc_mode=True), byte for byte; the signtx keys aggregate on `engine`.

    The G and H generator-column sums are kept as SEPARATE growable
    segments: per-tx static layouts are [Bb, B] + G(padded_n) +
    H(padded_n) with padded_n varying per circuit size, so positional
    accumulation into one flat vector would pair a small tx's H scalars
    with the merged layout's G points.  PointOps add their primary to B
    (index 1) and their secondary to B_blinding (index 0)."""
    head_acc: list[int] = [0, 0]
    g_acc = h_acc = None                    # ScalarVec, grown as needed
    dyn_s: list[int] = []
    dyn_enc: list[bytes] = []
    out = []
    for tb in txs_bytes:
        vtx, ops, (ds, dp, bb, bs, g_v, h_v, padded_n) = \
            precompute_tx_split_vec(Tx.from_bytes(tb), bp_gens, engine,
                                    timings)
        out.append(vtx)
        wid = hashlib.sha3_256(tb).digest()
        r = _weight(entropy, wid, b"r1cs")
        head_acc[0] += r * bb
        head_acc[1] += r * bs
        if g_acc is None:
            g_acc, h_acc = g_v.scale(r), h_v.scale(r)
        else:
            if len(g_acc) < padded_n:
                pad = b"\x00" * (32 * (padded_n - len(g_acc)))
                g_acc = ScalarVec(g_acc.buf + pad, padded_n)
                h_acc = ScalarVec(h_acc.buf + pad, padded_n)
            elif padded_n < len(g_acc):
                pad = b"\x00" * (32 * (len(g_acc) - padded_n))
                g_v = ScalarVec(g_v.buf + pad, len(g_acc))
                h_v = ScalarVec(h_v.buf + pad, len(h_acc))
            g_acc = g_v.scale(r).add(g_acc)
            h_acc = h_v.scale(r).add(h_acc)
        dyn_s.extend(r * s % L for s in ds)
        dyn_enc.extend(dp)
        for j, op in enumerate(ops):
            ro = _weight(entropy, wid, b"op", j)
            if op.primary is not None:
                head_acc[1] += ro * op.primary
            if op.secondary is not None:
                head_acc[0] += ro * op.secondary
            for w, pbytes in op.arbitrary:
                dyn_s.append(ro * (w % L) % L)
                dyn_enc.append(pbytes)
    return (out, [v % L for v in head_acc], g_acc.buf, h_acc.buf, dyn_s,
            b"".join(dyn_enc))


def _attribute_failure(txs: list[Tx], bp_gens: BulletproofGens,
                       entropy: bytes, eng: Engine) -> None:
    """The slow path after a rejected batch: re-verify tx by tx and raise
    VerificationError naming the first that fails (a malformed tx's VMError,
    ProofError, R1CSError or ValueError, FormatErrors included, becomes
    one naming it)."""
    for i, tx in enumerate(txs):
        try:
            _, ops, job = precompute_tx(tx, bp_gens, eng)
            if not eng.msm_is_identity(*job):
                raise VerificationError(
                    f"fused tx batch verification failed (tx {i})")
            if ops and not eng.msm_is_identity(*_point_ops_job(ops, entropy)):
                raise VerificationError(
                    f"fused tx batch verification failed (tx {i} point ops)")
        except VerificationError:
            raise
        except (VMError, ProofError, R1CSError, ValueError) as e:
            raise VerificationError(
                f"fused tx batch verification failed (tx {i}: "
                f"{type(e).__name__})") from e


def fused_verify_tx_batch(
    txs: list[Tx],
    bp_gens: BulletproofGens,
    entropy: bytes | None = None,
    attribute_failures: bool = True,
    device=None,
    engine: Engine | None = None,
    timings: dict | None = None,
) -> list[VerifiedTx]:
    """Fused tx batch verification on one card: every tx's R1CS mega-check
    and every PointOp fold into ONE MSM (per-job random weights, upstream
    PointOp::verify_batch's random-linear-combination argument applied
    across jobs), the bp/pc generator columns once for the whole batch, so
    the MSM grows with the proofs' points rather than txs * gens.  It runs
    through fused_split_check on `engine`'s device and MSM configuration
    (else a TorchEngine on `device`, else the default engine, the card),
    as verify_tx resolves its engine.

    Raises VerificationError on a bad batch; with attribute_failures,
    re-verifies tx by tx first to name the failing tx (only on failure).
    timings, when given, receives aggregated_key_s (the signtx keys' MSMs,
    one round trip per signed tx), aggregated_keys (their count), device_s
    (upload, device chain, the verdict's fetch), host_s (the rest: replay,
    transcripts, weights, accumulation, packing), msm_size, wbits and
    route."""
    if not txs:
        return []
    eng = resolve_engine(device, engine)
    if not eng.supports_fused_batch_verify:
        raise TypeError("the fused tx batch needs an engine with the fused "
                        "split check (a TorchEngine)")
    if entropy is None:
        entropy = os.urandom(32)
    t0 = time.perf_counter()
    tm: dict = {}
    verified, head, g_buf, h_buf, dyn_s, dyn_enc = _chunk_precompute(
        [tx.to_bytes() for tx in txs], bp_gens, entropy, eng, tm)
    static_buf = (head[0].to_bytes(32, "little")
                  + head[1].to_bytes(32, "little") + g_buf + h_buf)
    t = time.perf_counter()
    check: dict = {}
    ok = fused_split_check(static_buf, dyn_s, dyn_enc, bp_gens,
                           PedersenGens(), eng.device, check, eng.config)
    if timings is not None:
        agg_s = tm.get("aggregated_key_s", 0.0)
        timings.update(aggregated_key_s=agg_s,
                       aggregated_keys=tm.get("aggregated_keys", 0),
                       device_s=check["device_s"],
                       host_s=t - t0 - agg_s + check["host_s"],
                       msm_size=check["msm_size"], wbits=check["wbits"],
                       route=check["route"])
    if not ok:
        if attribute_failures:
            _attribute_failure(txs, bp_gens, entropy, eng)
        raise VerificationError("fused tx batch verification failed")
    return verified
