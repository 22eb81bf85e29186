"""Multi-rank fused batch verification: the proofs shard over the mesh,
every rank runs the fused device half (kernels/batch_verify_device.py:
on-card scalar synthesis, K1 decode, window totals) on its sub-batch, and
the ranks' window totals sum into the combined mega-check.  An MSM is a
sum, so sharding the proof axis commutes with the random-linear-
combination batching (SURVEY §2.9 P3 x P5; BASELINE config 4).

Counterpart of the JAX package's parallel/fused_batch_verify.py, on its
device-combine path: after K6's tree entry over the gathered totals
(sharded_msm.combine_gathered), K4 runs Horner's rule and the identity
test on the card and one int crosses back.  The static generator block
([B_blinding, B] + G + H) is resident on every rank; each rank takes its
slice of the params and dynamic encodings and sums its own proofs'
[B_blinding, B] weights mod ℓ.  The host half is the single-card path's
(prepare_batch_inputs), run whole on every rank as the reference runs it,
so that every proof keeps its batch index's weight.  The reference's
interpret and dev_decompress arguments have no counterpart: K1 always
decodes on the card.
"""

from __future__ import annotations

import time

from ..kernels.batch_verify_device import (
    batch_msm_totals, prepare_batch_inputs, static_gens_words, sum_bbB)
from ..kernels.combine import horner_check
from ..kernels.msm import best_wbits
from ..kernels.words import to_device
from .mesh import Mesh
from .sharded_msm import combine_gathered


def sharded_batch_verify(mesh: Mesh, proofs, bp_gens, pc_gens, transcripts,
                         value_commitments, n: int,
                         entropy: bytes = b"\x01" * 32,
                         timings: dict | None = None) -> bool:
    """Batched range-proof verification sharded over the whole mesh, on
    mesh.device; every rank passes the whole batch and gets the same
    verdict.  Every proof must aggregate the same m.  A batch that does
    not divide the mesh is padded by re-verifying a prefix of it (each pad
    slot draws its own weight, so duplicates neither mask a bad proof nor
    admit a forged one).  An invalid point encoding makes it False;
    malformed proofs raise FormatError/ProofError.  timings, when given,
    receives host_s (the host half, this rank's slice and its upload),
    device_s (the device half, the gathers, the K6 tree, K4 and the
    verdict's fetch), msm_size (a rank's MSM) and wbits."""
    t0 = time.perf_counter()
    ndev, nb = mesh.size, len(proofs)
    if nb % ndev:
        npad = ndev - nb % ndev
        proofs = list(proofs) + [proofs[i % nb] for i in range(npad)]
        transcripts = list(transcripts) + [
            transcripts[i % nb].clone() for i in range(npad)]
        value_commitments = list(value_commitments) + [
            value_commitments[i % nb] for i in range(npad)]
        nb += npad
    params, bbB_pp, dyn, m, lg = prepare_batch_inputs(
        proofs, bp_gens, pc_gens, transcripts, value_commitments, n, entropy)
    per = nb // ndev
    k = dyn.shape[1] // nb                       # 4 + 2 lg + m points a proof
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    dev = mesh.device
    static = static_gens_words(bp_gens, pc_gens, n, m, dev)
    params_t = to_device(params[mine], dev)
    dyn_t = to_device(dyn[:, mesh.rank * per * k:(mesh.rank + 1) * per * k],
                      dev)
    bbB_t = to_device(sum_bbB(bbB_pp[mine]), dev)
    total = static.shape[2] + per * k
    wbits = best_wbits(total)             # the shard's size sets the width
    t_host = time.perf_counter()
    totals, ok = batch_msm_totals(static, dyn_t, params_t, bbB_t, n, m, lg,
                                  wbits)
    ok = mesh.all_gather(ok.reshape(1)).min()
    combined = combine_gathered(mesh, totals)
    verdict = bool((ok & horner_check(combined.unsqueeze(2).contiguous(),
                                      wbits)[0]).item())
    if timings is not None:
        timings.update(host_s=t_host - t0,
                       device_s=time.perf_counter() - t_host,
                       msm_size=total, wbits=wbits)
    return verdict
