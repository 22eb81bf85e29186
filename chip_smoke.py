"""Drives the PyTorch/CUDA port on one NVIDIA card end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the nineteen CUDA
   kernels (K1 ristretto_decode, K2 bucket_accumulate, K3 bucket_fold, K4
   horner_check, K5 seg_combine, K6 point_add, K7 fe_mul, K8 fe_add, K9
   radix_sort, K10 gather_words, K11 bucket_accumulate_words, K12
   bucket_accumulate_affine, the small route's K5s small_scan, the
   micro-kernels K13 micro_mul, K14 micro_parts, K15 micro_add_chain, K16
   micro_add_chain_lanes, and the constant-time K17 fixed_base_ct and K18
   msm_ct) from kernels/csrc, one nvcc per source in parallel (K11 and K12
   are entries of K2's source, K13-K16 of field_micro.cu), and prints the
   build time and each kernel function's ptxas registers and spills;
1b. builds the native host library (zkvm_tpu_torch/native, g++
   -march=native on this machine) and prints its build time beside
   os.cpu_count(); holds every native entry and host half byte for byte
   against its pure-Python twin at small size, the R1CS prover's
   ScalarVec polynomial chain against its VecPoly3 twin too
   (native_phase);
2. holds K1-K4 against their plain PyTorch versions on the card at the
   range-proof path's shapes (nb = 1024 proofs of 64 bits, m = 1, whose
   native host half it times by stage: replay, weights, params), words
   and flags exactly equal, and times both (CUDA events and the
   profiler's device time); K1 also limb for limb, and at n = 1, 7, 33
   and 1,055 (the tails of its groups of five lanes), each with invalid
   encodings, with its registers and products per second; K2 and K3 with
   a scratch one element short, which each must refuse (the wrapper
   raises, nothing launches); K2 also on the same points with every scalar
   equal (one run of all the points per window), whose time must stay
   within 3x the random-digit time; K4's verdict and folded point (also
   in canonical words) on the batch's totals, which sum to the identity,
   and on those of the same MSM with one digit raised by one, which sum
   to that digit's point; K3 also at nb = 1 to 256; then the device half's
   stages, and window_totals at the widths around msm.best_wbits's choice
   (11 on this route), the minimum and median of several timings;
3. holds K2 and K3 against their plain versions on the nb = 4096 batch's
   MSM, with the same width sweep; K9 and K10 on the key rows of the
   nb = 1024 and nb = 4096 batches' MSMs (K9 sorting the (|digit|, sign)
   bits, equal also to torch.sort), K9 at full width on random 63-bit
   keys of the nb = 4096 shape, and times them beside torch.sort (K9) and
   torch indexing (K10); holds K11 and K12 (K2's levels over K10's word
   and affine rows) bit for bit against their plain versions and equal to
   K2's bucket sums as points on the nb = 1024 MSM, on its equal-scalar
   digits (each within 3x its random-digit time), on the nb = 4096 MSM
   and at w = 12 (the top window holds only the carry), times each
   (events and device time), and shows each refusing a scratch one
   element short;
4. with every launch count set to 0, runs the range-proof path through its
   entry point zkvm_tpu_torch.proofs.rangeproof.batch_verify at nb = 1024
   and nb = 4096: a valid batch must accept, a batch with one t_x changed
   and one with a non-canonical point encoding must reject;
5. holds the elementwise K5 and K6 against their plain versions at the
   shapes of the Cloak verification's small-route MSM (a scan step and a
   fold step), K7 and K8 at 2^16 elements; holds K5s and K3 (the small
   route, kernels/msm.py window_totals_small: K5s's bucket sums, K3's
   one-launch fold at nb = 128) limb for limb and in canonical words
   against their plain versions, and their totals against
   window_totals_large as points, at the Cloak MSM (1,055 points, w = 8),
   at n = 1, 17, 1,282 and 2,048, on equal scalars and with an all-zero
   window, and times them (events, device-only, plain, bound); times the
   small route at w = 6 to 10 at 1,055, 1,282 and 2,048 points (min and
   median), and the Cloak device half by stage; shows that
   window_totals_small launches K5s and K3 once each (launch counts) and
   no other kernel after the sort (torch.profiler, in child processes:
   python3 chip_smoke.py --launch-check whole|sort), with no host sync
   (CUDA sync debug mode); and prints the route crossover (both routes on
   the same inputs at 1,055, 1,282 and 2,048 points, totals equal);
6. runs the bucket pipeline's three configurations (msm.MsmConfig: the
   default, sort + gather, affine) on the fused nb = 1024 and nb = 4096
   device halves and the 2^15-multiplier R1CS split check: equal window
   totals as points and the same verdict, with a non-canonical encoding
   rejected under the affine configuration too;
7. with every launch count set to 0, runs R1CS verification through
   zkvm_tpu_torch.proofs.r1cs.Verifier.verify (the Cloak with engine=, the
   range circuit with device=) on the two committed fixtures (a Cloak 4x4
   with 64-bit values, on the small route, K5s and K3, and 512 64-bit
   range gadgets, 2^15 multipliers, on K2/K3): the valid proof must
   accept, a proof with t_x + 1 and one with a non-canonical encoding
   (which K1 must flag) must raise VerificationError;
8. with every launch count set to 0, calls the entry points
   pointwise.seg_combine, point_add, mul and add (K5-K8; on no verify
   path);
8b. holds the micro-kernels K13-K16 (the counterparts of
   bench/pallas_micro.py) bit for bit against their plain versions in
   every form and variant at depth 1 and 8, at B = 4,096 and 4,099 (a
   partial five-lane group and four-lane warp), and at B = 2^16, depth 1
   (timed: the kernels line); prints the wide multiplies (IMAD.WIDE,
   IMAD.HI) of each function in field_micro's SASS (cuobjdump), which
   must hold prod's and fe_mul's 100 products; then, with every launch
   count set to 0, runs the entry point (zkvm_tpu_torch.micro.run, every
   variant): the reference's table at B = 2^16 (ms, device-only ms,
   Mmul/s, Madd/s), the saturated rates at B = 2^20, depth 64 (products
   alone, fe_mul and lf_mul; products alone beside the guide's peak of
   wide products at the logged SM clock), and one warp's time a
   dependent step of fe_mul, lf_mul, pt_add and lane_add, every output
   held whole against its twin;
9. with every launch count set to 0, runs the engine path
   (kernels/engine.py TorchEngine): a batch of 1,024 proofs of mixed
   aggregation (256 each of m = 1, 2, 4, 8) through batch_verify, then
   the same host-assembled MSM (24,322 points) under each configuration,
   selected by the JAX package's switches (ZKVM_MSM_SORT, ZKVM_MSM_GATHER,
   ZKVM_MSM_AFFINE): equal totals, accept, and reject a batch with one t_x
   changed and one with an encoding swapped for another point's; a
   non-canonical encoding must raise on the host decode; one aggregated
   m = 32 proof through verify_multiple (accepted, its t_x + 1 copy
   rejected); TorchEngine.msm on 4,096 points, checked by msm_is_identity,
   then window_totals by width on those points;
10. with every launch count set to 0, runs the ZkVM transaction path on
   the committed block (zkvm_tpu_torch/data/txs_block256.bin: 192 issues
   and 64 payments, and one transaction each for taproot call, signid,
   signtag, unblind, borrow/retire and fee): verify_tx on one issue, one
   payment and each coverage transaction (its txid must equal the JAX
   verifier's in the fixture; a flipped proof byte and a flipped
   signature byte must each raise); fused_verify_tx_batch on the 256
   (one MSM, K1, K2/K3, K4; the 256 MuSig aggregated_key MSMs on the
   small route) with every txid equal, tx 3's proof tampered (the
   attribution must name tx 3) and tx 255's tampered with attribution
   off; verify_tx_batch job by job with the same verdicts; and one more
   replay of the block, whose split check must accept under the sort +
   gather and affine configurations; prints host_s, device_s, tx/s and
   the MSM's size, width and route;
10b. with every launch count set to 0 and every host group operation of
   the port raising (the oracle's Edwards formulas, RistrettoPoint's
   arithmetic, the host Horner of TorchEngine.msm), proves the committed
   prover fixture's cases on the card (zkvm_tpu_torch/data/
   prove_seeded_n64.bin, made by the JAX package's prover): a 64-bit range
   proof (m = 1) and a 32-party aggregate (RangeProof.prove_multiple on
   TorchEngine: commitments through msm_batch and K4, the inner-product
   argument resident on the card, kernels/ipp_device.py) and a standalone
   n = 1,024 argument (InnerProductProof.create), each byte-equal to the
   fixture; K2, K3, K4, K5s, K17 and K18 must have launched (the
   commitments on secret scalars take K17 and K18).  verify_multiple and
   InnerProductProof.verify accept each and reject a flipped t_x bit (a +
   1); K4's folded identity encodes as 32 zero bytes.  Times each call
   (events and wall, min and median of 3; m = 32 also with its stage
   timings on), splits the m = 32 and m = 1 proves (commitments for V, S
   and A, T; the argument's rounds: issue, wait, fetch and host by wall,
   scalar step and MSMs + K4 by events) and the argument, each key the
   median of 3 calls, and times a round's MSM over all 2n + 1 points
   (half the digits zero) against the n + 1 live ones at n = 64, 1,024
   and 2,048 (equal as points), and the small route at 2,048 points with
   2,046 zero digits against random ones;
10c. with every launch count set to 0, proves the two seeded circuits of
   the committed R1CS prover fixture (zkvm_tpu_torch/data/
   prove_r1cs_seeded.bin, made by the JAX package: a Cloak 4x4 with 64-bit
   values, two phases, and 512 committed values under 64-bit range
   gadgets, 2^15 multipliers) with the R1CS Prover on TorchEngine and
   every host group operation raising, byte-equal to the fixture, and
   builds its two issues and its payment (MuSig of two parties) with the
   port's apps and build_tx, the R1CS prover's and MuSig's host group
   operations raising: txid, fee, log and program equal to the JAX
   build_tx's; K2, K3, K4, K5s, K17 and K18 must have launched.  R1CS
   Verifier.verify accepts each proof and rejects a flipped t_x bit;
   verify_tx accepts each transaction and rejects a flipped proof byte and
   a flipped signature byte; starsig.verify accepts each MuSig signature.
   Times each prove (the circuit laid, then proved) and each build_tx,
   min and median of 3 calls, wall beside CUDA events, and splits them
   (medians): V commitments, phase commitments, T, Q, the argument and
   the host; the VM run, signing and the prove;
10d. holds the constant-time kernels against their plain versions bit for
   bit: K17 fixed_base_ct's tables of B and B_blinding (built on the card)
   and its batches of 1, 4, 512 (the 2^15 circuit's V) and 4,096
   commitments, with one and two bases;
   K18 msm_ct on groups of 1, 2, 129 x 2 (m = 1's A and S), 129 x 32
   (m = 32's bit commitments) and the 2^15 circuit's phases (65,537 +
   32,769 + 65,537 points), scalars 0, ℓ - 1 and 2^64 - 1 among random
   ones; K18 + K4 equal to the bucket route as points; K18 refusing a
   scratch one element short; times K17 at one output with one base
   (basepoint_mul) and with two (an R1CS V), 512 and 4,096 commitments,
   and K18 at 1, 2, 129 x 32 points and the 2^15 phases (events, min and
   median of 5, and the profiler's kernel time, min and median of 3
   traces) on all-zero, all ℓ - 1 and random scalars and prints the
   spreads and bounds; then, with every launch count set to 0, runs
   basepoint_mul, commit, commit_batch, msm_secret, msm_batch(ct=True) and
   bit_commit_batch on TorchEngine with msm.window_totals, torch.sort and
   the K2, K3, K5s and K9 wrappers raising, equal to the public route and
   the host formula, and times V's engine.commit;
10e. with every launch count set to 0, derives the committed keys and MPC
   fixture's keytree cases and PredicateTrees on the card
   (zkvm_tpu_torch/data/keys_mpc_seeded.bin, made by the JAX package),
   builds its taproot `call` transaction with build_tx (txid, fee, log and
   program equal to the JAX build_tx's; verify_tx accepts), runs
   distributed_prove over ThreadLocalTransport with 4 hosts x 8 parties at
   n = 64, a TorchEngine a host (commitments equal to the fixture's,
   verify_multiple accepts, a flipped t_x bit rejects; min and median of 3
   walls), and one host corrupting its share, attributed to the
   reference's party positions; K17 and K18 must have launched;
11. the serving pipeline: TorchEngine.msm_start / msm_finish_is_identity
   against msm_is_identity at 1,055 and 17,538 points (the start under
   CUDA sync debug mode); then, with every launch count set to 0,
   batch_verify_device_pipelined (kernels/batch_verify_device.py) on
   streams of 8 batches at nb = 1024 and 4 at nb = 4096, one batch of each
   with a t_x changed, every launch half under sync debug mode: the
   verdicts must equal phase 4's on the same batches; prints each batch's
   wall, host_s and device_s, the stream's verifies/s and the one-shot
   batch_verify_device's on the same batch;
12. the node (zkvm_tpu_torch.chain), with every launch count set to 0:
   node A admits the committed block's 192 issue transactions through its
   mempool and mines them, node B cold-syncs (chain.node.sync), node C
   over the encrypted channel (chain.p2p.encrypted_sync, the handshakes'
   secret scalars on K17 and K18, every host group operation raising in
   them); tips, utxoroots and snapshots must agree, a restart from A's
   snapshot keep the tip, a block with a tampered transaction or with its
   transactions dropped be refused; prints each pass's seconds and tx/s;
   then runs `python -m zkvm_tpu_torch.cli node-demo --blocks 3` (tips
   must agree) and `verify` on one committed transaction in child
   processes;
13. prints each phase's seconds, the kernels line (every launch count must
   be > 0) and, last, the device line.

Range proofs come from the committed fixtures in zkvm_tpu_torch/data,
tiled to the batch size; each copy gets its own random weight, so the MSM
is full size with real points and distinct digits.  Exits non-zero on any
failure, and without a CUDA device.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
# 32x32->64 integer products per second.  The H100 SXM has no published
# integer rate outside the tensor cores; its fp32 rate (67 TFLOP/s,
# 33.5e12 multiply-adds/s) bounds 32-bit multiply-adds, and a 64-bit
# product takes two (its low and high halves).
PRODUCTS_PER_S = 67e12 / 2 / 2
# The CUDA C++ Programming Guide's throughput table (arithmetic
# instructions) gives compute capability 9.0 64 32-bit integer multiplies
# or multiply-adds a clock per SM; a 32x32->64 product takes two.
WIDE_PRODUCTS_PER_CLOCK_SM = 64 / 2
MUL, SQR = 100, 55              # products per field multiplication, square
ADD, DBL = 9 * MUL, 4 * SQR + 4 * MUL   # per point addition, doubling
DECODE = 257 * SQR + 24 * MUL   # per Ristretto decode


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card over reps runs, after one."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernels, reps):
    """Mean device time in ms per call of fn(), from torch.profiler's trace
    over reps calls: the card's own time, without the host's launch cost
    that the events include.  kernels maps a substring of each kernel's
    name to its launches per call (a bare string means one).  A trace has
    been seen to drop kernel events, so each kernel's time is its mean over
    the launches the trace holds, times its launches per call; a trace
    without some kernel is taken again, up to three times; None if all
    three miss one."""
    from torch.profiler import ProfilerActivity, profile
    if isinstance(kernels, str):
        kernels = {kernels: 1}
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        ms = 0.0
        for name, per_call in kernels.items():
            if not per_call:
                continue
            rows = [e for e in events if name in e.key]
            count = sum(e.count for e in rows)
            total = sum(getattr(e, "device_time_total", 0) for e in rows)
            if not (count and total):
                break
            ms += total / count * per_call / 1e3
        else:
            return ms
    return None


def radix_launches(lo_bit, hi_bit):
    """K9's launches of each of its three kernels for one sort by bits
    [lo_bit, hi_bit) (csrc/radix_sort.cu): one each per pass."""
    from zkvm_tpu_torch.kernels.sort import passes
    k = len(passes(lo_bit, hi_bit))
    return {"radix_hist_kernel": k, "radix_scan_kernel": k,
            "radix_scatter_kernel": k}


def bound_ms(nbytes, products, products_per_s=PRODUCTS_PER_S):
    """(bound ms, "bytes" or "operations", nbytes, products): the larger of
    the bytes over the memory rate and the products over products_per_s."""
    by_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    by_ops = products / products_per_s * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes, products)


def ptxas_report(build, src):
    """[(function, "Used ... registers ...; spills")] from the ptxas log of
    library `src`, the function's name cut to its kernel and template
    argument."""
    out, fn, spill = [], "?", ""
    for line in build.lib_path(src).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            m = re.search(r"\d+([a-z_]+_kernel)", name)
            fn = m[1] if m else "?"
            t = m and re.match(r"I(?:NS_)?(\d+)", name[m.end():])
            arg = t and name[m.end() + t.end():][:int(t[1])]
            if arg and arg.isalpha():
                fn += f"<{arg}>"
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line:
            out.append((fn, f"{line.split(':', 1)[-1].strip()}; {spill}"))
    return out


def sass_multiplies(build, src):
    """{kernel function: [wide multiplies (IMAD.WIDE, IMAD.HI), other
    IMADs]} in the SASS of library `src` (cuobjdump -sass, beside the
    toolkit's nvcc)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.lib_path(src))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"\d+([a-z_]+_kernel)", line)
            fn = m[1] if m else line.split("Function :")[1].strip()
            counts[fn] = [0, 0]
        elif fn and re.search(r"\bIMAD\b", line):
            counts[fn][0 if re.search(r"\bIMAD\.(WIDE|HI)\b", line)
                       else 1] += 1
    return counts


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.5f}"


def same_points(a, b):
    """(4, 10, k) points equal as projective points, X1 Z2 = X2 Z1 and so
    on: two routes or configurations add in other orders or coordinates,
    so their limbs differ while the points agree."""
    from zkvm_tpu_torch.kernels import field as F
    A, B = F.unpack_points(a), F.unpack_points(b)
    return all(bool(F.is_zero(F.sub(F.mul(A[i], B[2]),
                                    F.mul(B[i], A[2]))).all())
               for i in (0, 1, 3))


def same_ristretto(a, b):
    """(4, 10, k) points equal as Ristretto elements (RFC 9496's equality,
    X1 Y2 = Y1 X2 or Y1 Y2 = X1 X2): equal up to the 4-torsion that the
    identity test also ignores."""
    from zkvm_tpu_torch.kernels import field as F
    (X1, Y1, _, _), (X2, Y2, _, _) = F.unpack_points(a), F.unpack_points(b)
    return bool((F.is_zero(F.sub(F.mul(X1, Y2), F.mul(Y1, X2)))
                 | F.is_zero(F.sub(F.mul(Y1, Y2), F.mul(X1, X2)))).all())


class TraceLost(RuntimeError):
    """Every trace of kernel_counts lost one of its marker kernels."""


def kernel_counts(fn, reps=5, traces=8):
    """Kernels (and copies) fn() runs on the card per call, by name, from
    traces of reps calls each, and how many traces were kept.  A trace can
    drop kernel events, at its start as well as at its end, so each trace
    is bracketed by two marker kernels (torch.cuda._sleep's spin_kernel),
    launched after a pause on the host once the profiler is on, and kept
    only if both are in it; each name keeps its largest count over the
    kept traces: a trace drops events but never adds one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best, kept = {}, 0
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.05)
            torch.cuda._sleep(100000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.05)
        rows = {e.key: e.count for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0}
        if sum(v for k, v in rows.items() if "spin_kernel" in k) != 2:
            continue
        kept += 1
        for k, v in rows.items():
            if "spin_kernel" not in k:
                best[k] = max(best.get(k, 0), v)
    if not kept:
        raise TraceLost(f"chip smoke failed: {traces} traces, none with "
                        "both its marker kernels")
    return {k: v / reps for k, v in best.items()}, kept


def native_phase(smi):
    """Phase 1b: the native host library (zkvm_tpu_torch/native) on this
    machine's build (-march=native): its build time beside os.cpu_count();
    every entry held byte for byte against its pure-Python twin at small
    size (STROBE and Keccak-f, ScalarVec, inversion, the Ristretto decode
    with invalid and zero encodings and the encode, the range-proof replay
    with a zero point, the scalar and params assemblies with a zero
    challenge and y = 1, the R1CS flatten, the R1CS prover's polynomial
    chain against VecPoly3's); the host halves against theirs
    (prepare_batch_inputs at nb = 8, batch_verification_job on four proofs
    of m = 1, 1, 2, 4, verification_job_split_vec on the Cloak)."""
    import hashlib

    from zkvm_tpu_torch import fixture, native
    from zkvm_tpu_torch.constants import L, P
    from zkvm_tpu_torch.kernels import batch_verify_device as bvd
    from zkvm_tpu_torch.oracle import keccak, scalar
    from zkvm_tpu_torch.oracle import ristretto as rist
    from zkvm_tpu_torch.oracle.strobe import Strobe128
    from zkvm_tpu_torch.proofs import rangeproof as rp
    from zkvm_tpu_torch.proofs.errors import ProofError
    from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
    from zkvm_tpu_torch.proofs.r1cs import R1CSProof
    from zkvm_tpu_torch.proofs.r1cs import constraint_system as cs
    from zkvm_tpu_torch.proofs.r1cs import prover as r1cs_prover
    from zkvm_tpu_torch.proofs.r1cs.lc import LinearCombination, Variable
    from zkvm_tpu_torch.proofs.scalarvec import PlainScalarVec, ScalarVec
    from zkvm_tpu_torch.proofs.transcript import ProofTranscript
    from zkvm_tpu_torch.proofs.util import powers

    t0 = time.perf_counter()
    native.lib()
    built = (f"built in {native.build_seconds:.2f} s" if native.build_seconds
             else "reused")
    print(f"native host library: {built}, loaded in "
          f"{time.perf_counter() - t0:.2f} s ({' '.join(native.COMPILER)} "
          f"{' '.join(native.FLAGS)}); os.cpu_count() = {os.cpu_count()}",
          flush=True)
    rs = np.random.default_rng(1117)
    edge = [0, 1, L - 1, L - 2]

    def ints(n):
        return (edge + [int.from_bytes(rs.bytes(32), "little") % L
                        for _ in range(n)])[:n]

    # STROBE, Keccak-f
    nat, twin = native.NativeStrobe128(b"smoke"), Strobe128(b"smoke")
    for step in range(40):
        size = int(rs.choice([0, 1, 64, 165, 166, 167, 400]))
        data = rs.bytes(size)
        op = step % 5
        if op == 0:
            outs = [s.prf(size, False) for s in (nat, twin)]
        elif op == 1:
            outs = [s.challenge_bytes(b"c", size) for s in (nat, twin)]
        else:
            for s in (nat, twin):
                (s.append_message if op == 2 else s.key if op == 3
                 else s.meta_ad)(*((b"l", data) if op == 2 else (data, False)))
            outs = [0, 0]
        require(outs[0] == outs[1] and nat.state_bytes()
                == twin.state_bytes(), f"native STROBE differs at {step}")
    st = rs.bytes(200)
    want = bytearray(st)
    keccak.keccak_f1600_bytes(want)
    require(native.keccak_f1600(st) == bytes(want), "native Keccak-f differs")
    # ScalarVec and inversion, at n = 0, 1, 17
    for n in (0, 1, 17):
        a, b, c = ints(n), ints(n)[::-1], ints(n)
        k, x0 = ints(6)[4:]
        wide = (b"\xff" * 64 + rs.bytes(64 * n))[:64 * n]
        outs = []
        for cls in (ScalarVec, PlainScalarVec):
            va, vb, vc = (cls.from_ints(v) for v in (a, b, c))
            outs.append([va.mul(vb).buf, va.add(vb).buf, va.sub(vb).buf,
                         va.scale(k).buf, va.axpb(k, x0).buf,
                         va.muladd(vb, vc).buf, va.neg().buf,
                         va.batch_invert().buf, va.sum(), va.inner(vb),
                         cls.powers(k, n).buf, cls.from_wide_bytes(wide, n).buf])
        require(outs[0] == outs[1], f"native ScalarVec differs at n = {n}")
    xs = [0, 5, L - 1, 0] + ints(9)
    require(scalar.batch_invert(xs) == scalar.batch_invert_plain(xs),
            "native batch inversion differs")
    # the Ristretto decode and encode
    pts = [rist.BASEPOINT * (i + 2) for i in range(5)]
    pts.append(pts[0] + pts[1])
    enc = [bytes(32)] + [p._compress_py() for p in pts]
    require(rist.compress_batch([p.ep for p in pts]) == enc[1:],
            "native encode differs")
    require([p.ep for p in rist.decompress_many(enc)]
            == [p.ep for p in rist.decompress_many_plain(enc)],
            "native decode differs")
    for bad in ((P + 2).to_bytes(32, "little"), (1).to_bytes(32, "little")):
        for fn in (rist.decompress_many, rist.decompress_many_plain):
            try:
                fn([enc[1], bad])
                require(False, f"{fn.__name__} accepted an invalid encoding")
            except ValueError:
                pass
    # the replay (and a zero point), the assemblies
    label, n, _, recs = fixture.load()
    mlabel, _, mrecs = fixture.load_mixed()
    four = ([(label, w, v) for w, v in recs[:2]]
            + [next((mlabel, w, v) for w, v in mrecs if len(v) == mm)
               for mm in (2, 4)])
    bp, pc = BulletproofGens(n, 4), PedersenGens()
    for lb, w, vcs in four:
        proof = rp.RangeProof.from_bytes(w)
        tn, tt = ProofTranscript(lb), ProofTranscript.plain(lb)
        require(proof._replay_challenges(bp, pc, tn, vcs, n)
                == proof._replay_challenges_plain(bp, pc, tt, vcs, n)
                and tn.strobe.state_bytes() == tt.strobe.state_bytes(),
                "native replay differs")
    zero = rp.RangeProof.from_bytes(four[0][1])
    zero.ipp_proof.L_vec[2] = bytes(32)
    for fn, t in ((zero._replay_challenges, ProofTranscript(label)),
                  (zero._replay_challenges_plain, ProofTranscript.plain(label))):
        try:
            fn(bp, pc, t, four[0][2], n)
            require(False, "a zero L was accepted")
        except ProofError as e:
            require(str(e) == rp.IDENTITY_ERROR, f"a zero L: {e}")
    for case in range(3):
        u, (y, z, a, b) = ints(8)[4:], ints(10)[6:]
        if case == 1:
            u[1] = 0
        elif case == 2:
            y = 1
        g, wt = rp.scalar_assembly(u, 8, 2, y, z, a, b), \
            rp.scalar_assembly_plain(u, 8, 2, y, z, a, b)
        require(g[:2] == wt[:2] and g[4] == wt[4] and g[2].buf == wt[2].buf
                and g[3].buf == wt[3].buf, f"native scalar assembly differs "
                                           f"(case {case})")
    proofs = [rp.RangeProof.from_bytes(w) for w, _ in recs[:3]]
    reps = []
    for i in range(3):
        v = ints(15)[4:]
        reps.append({"y": 1 if i == 1 else v[0], "z": v[1], "x": v[2],
                     "w": v[3], "c": v[4],
                     "u": [0 if (i == 2 and j == 3) else v[5 + j]
                           for j in range(6)]})
    ent = bytes(32)
    chal = b"".join(scalar.to_bytes(x) for r in reps for x in
                    [r["y"], r["z"], r["x"], r["w"], r["c"], *r["u"]])
    prf = b"".join(scalar.to_bytes(x) for p in proofs for x in
                   (p.t_x, p.t_x_blinding, p.e_blinding, p.ipp_proof.a,
                    p.ipp_proof.b))
    dig = b"".join(hashlib.sha3_512(ent + i.to_bytes(8, "little")
                                    + p.to_bytes()).digest()
                   for i, p in enumerate(proofs))
    got = native.fused_params_assembly(chal, prf, dig, 3, 6, n, 1)
    want = bvd.params_plain(proofs, reps, n, 1, 6, ent)
    require(all((g == w).all() for g, w in zip(got, want)),
            "native params assembly differs")
    # the flatten
    mk = [Variable.multiplier_left, Variable.multiplier_right,
          Variable.multiplier_output, Variable.committed]
    coeffs = [1, -1, 1 << 63, (1 << 64) + 5, -(1 << 70), L - 1, 0]
    cons = [LinearCombination([
        ((Variable("one", 0) if kd == 4 else mk[kd](int(rs.integers(3)))),
         coeffs[int(rs.integers(len(coeffs)))])
        for kd in rs.integers(0, 5, size=int(rs.integers(0, 5)))])
        for _ in range(12)]
    z = ints(5)[4]
    fl = cs.flatten_constraints_vec(cons, z, 4, 3, 1)
    tw = cs.flatten_constraints(cons, z, 4, 3)
    require([fl[0].to_ints(), fl[1].to_ints(), fl[2].to_ints(), fl[3], fl[4]]
            == [tw[0] + [0], tw[1] + [0], tw[2] + [0], tw[3], tw[4]],
            "native flatten differs")
    # the R1CS prover's polynomial chain against its VecPoly3 twin
    vecs = [ints(17) for _ in range(8)]
    y, x = ints(7)[5:]
    ey, eyi = powers(y, 17), powers(scalar.invert(y), 17)
    lc, rc, tc = r1cs_prover.polynomials(*(ScalarVec.from_ints(v)
                                           for v in vecs + [ey, eyi]))
    lp, rpl, tp = r1cs_prover.polynomials_plain(*vecs, ey, eyi)
    lv, rv = r1cs_prover.evaluate(lc, rc, x)
    require(tc.t == tp.t and lv.to_ints() == lp.eval(x)
            and rv.to_ints() == rpl.eval(x),
            "the R1CS prover's ScalarVec chain differs from VecPoly3's")
    # the host halves
    batch = [rp.RangeProof.from_bytes(recs[i % len(recs)][0])
             for i in range(8)]
    vcs8 = [recs[i % len(recs)][1] for i in range(8)]
    got = bvd.prepare_batch_inputs(batch, bp, pc, [ProofTranscript(label)
                                                   for _ in range(8)],
                                   vcs8, n, ent)
    want = bvd.prepare_batch_inputs_plain(
        batch, bp, pc, [ProofTranscript.plain(label) for _ in range(8)],
        vcs8, n, ent)
    require(all((g == w).all() for g, w in zip(got[:3], want[:3]))
            and got[3:] == want[3:], "prepare_batch_inputs differs")
    outs = []
    for job, pt in ((rp.batch_verification_job, ProofTranscript),
                    (rp.batch_verification_job_plain, ProofTranscript.plain)):
        sc, pp = job([rp.RangeProof.from_bytes(w) for _, w, _ in four], bp,
                     pc, [pt(lb) for lb, _, _ in four],
                     [v for _, _, v in four], n, ent)
        outs.append((sc.buf, [p.ep for p in pp]))
    require(outs[0] == outs[1], "batch_verification_job differs")
    fx = fixture.load_r1cs(fixture.R1CS_CLOAK)
    outs = []
    for plain in (False, True):
        ver = fixture.r1cs_verifier(
            fx, ProofTranscript.plain(fx.label) if plain else None)
        fn = (ver.verification_job_split_vec_plain if plain
              else ver.verification_job_split_vec)
        r = fn(R1CSProof.from_bytes(fx.wire),
               BulletproofGens(fx.gens_capacity), pc)
        outs.append(r[:4] + (r[4].buf, r[5].buf, r[6]))
    require(outs[0] == outs[1], "verification_job_split_vec differs")
    print("native host library: every entry and host half equal to its "
          "pure-Python twin (STROBE, Keccak-f, ScalarVec at n = 0, 1, 17, "
          "inversion, decode with invalid and zero encodings, encode, replay "
          "with a zero L, scalar and params assemblies with a zero challenge "
          "and y = 1, flatten, the R1CS prover's polynomial chain at n = "
          "17; prepare_batch_inputs at nb = 8, "
          "batch_verification_job at m = 1, 1, 2, 4, the Cloak's "
          f"verification_job_split_vec) [{smi}]", flush=True)


LAUNCH_CHECK = ("whole", "sort")
TRACE_LOST = 3     # launch_check's exit code when every trace lost a marker


def launch_check(which):
    """python3 chip_smoke.py --launch-check whole|sort, run by main() as a
    child process: the kernels that window_totals_small ("whole") or its
    sort alone ("sort") runs per call on a 1,055-point MSM at w = 8, the
    Cloak's shape, printed as one JSON line [counts, kept traces, traces].
    A fresh process for each, because the traces of a long one drop kernel
    events; it exits with TRACE_LOST if none of its traces could be read."""
    from zkvm_tpu_torch.constants import L
    from zkvm_tpu_torch.kernels import batch_verify_device as bvd
    from zkvm_tpu_torch.kernels import msm
    from zkvm_tpu_torch.kernels import scalarmod as sm
    from zkvm_tpu_torch.kernels.words import words_to_points
    from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
    dev = torch.device("cuda")
    n = 1055
    pts = words_to_points(bvd.static_gens_words(
        BulletproofGens(1024), PedersenGens(), 1024, 1, dev))[:, :, :n]
    pts = pts.contiguous()
    rs = np.random.default_rng(2030)
    ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(n)]
    digits = sm.signed_digits(sm.ints_to_limbs(ks, dev), 8)

    def sort_only():
        keys, _ = msm.pack_keys(digits)
        return torch.sort(keys, dim=1).values.contiguous()

    fn = {"whole": lambda: msm.window_totals_small(pts, digits, 8),
          "sort": sort_only}[which]
    traces = 8
    try:
        counts, kept = kernel_counts(fn, traces=traces)
    except TraceLost as e:
        print(e, file=sys.stderr)
        return TRACE_LOST
    print(json.dumps([counts, kept, traces]))
    return 0


def launch_counts(which, tries=3):
    """launch_check(which) in a fresh child process, and the number of
    processes it took: a child whose traces all lost a marker read no
    count, and a fresh one is started, up to `tries` in all; any other
    failure ends the smoke."""
    for started in range(1, tries + 1):
        child = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--launch-check", which], capture_output=True,
                               text=True, timeout=600)
        if child.returncode == 0:
            counts, kept, traces = json.loads(
                child.stdout.strip().splitlines()[-1])
            return counts, f"{kept} of {traces} traces kept, process {started}"
        require(child.returncode == TRACE_LOST,
                f"the launch check ({which}) failed: {child.stderr[-2000:]}")
    require(False, f"the launch check ({which}): in {tries} processes every "
                   f"trace lost a marker kernel")


@contextlib.contextmanager
def swapped(swaps, stub):
    """Each (owner, attribute) of swaps set to stub while the block runs."""
    saved = [(o, k, getattr(o, k)) for o, k in swaps]
    for o, k in swaps:
        setattr(o, k, stub)
    try:
        yield
    finally:
        for o, k, v in saved:
            setattr(o, k, v)


def short_scratch(owner, cases):
    """cases: (name, owner's scratch size helper, call, wrapper).  Each
    call runs with its helper made one element short; each must raise that
    the scratch is short, its wrapper counting no launch."""
    refused = []
    for name, attr, call, fn in cases:
        real, before = getattr(owner, attr), fn.launches
        with swapped([(owner, attr)], lambda *a, real=real: real(*a) - 1):
            try:
                call()
                torch.cuda.synchronize()
            except RuntimeError as e:
                if "scratch" in str(e) and fn.launches == before:
                    refused.append(name)
    names = [c[0] for c in cases]
    require(refused == names, f"a scratch one element short was not "
                              f"refused: {refused} of {names}")
    print(f"{', '.join(names)} with a scratch one element short: "
          f"refused, nothing launched", flush=True)


@contextlib.contextmanager
def host_group_ops_raise():
    """Every host group operation of the port raises: the oracle's Edwards
    formulas, RistrettoPoint's arithmetic and the host Horner of
    TorchEngine.msm."""
    from zkvm_tpu_torch.kernels import engine as engine_mod
    from zkvm_tpu_torch.kernels import frontend
    from zkvm_tpu_torch.oracle import edwards
    from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint

    def stub(*args, **kwargs):
        raise RuntimeError("chip smoke failed: a host group operation "
                           "ran on the prove path")
    swaps = [(edwards, k) for k in ("add", "sub", "double", "scalar_mul")]
    swaps += [(RistrettoPoint, k) for k in ("__add__", "__sub__", "__mul__",
                                            "__rmul__", "double")]
    swaps += [(frontend, "combine_window_totals"),
              (engine_mod, "combine_window_totals")]
    with swapped(swaps, stub):
        yield


@contextlib.contextmanager
def host_group_ops_raise_in(*targets):
    """host_group_ops_raise while one of the functions named by targets,
    (owner, attribute) pairs, runs, in any thread: the stubs go in when the
    first call enters and come out when the last one leaves."""
    lock, active = threading.Lock(), []

    def raising(f):
        def inner(*args, **kwargs):
            with lock:
                if not active:
                    stubs = host_group_ops_raise()
                    stubs.__enter__()
                    active.append(stubs)
                active.append(None)
            try:
                return f(*args, **kwargs)
            finally:
                with lock:
                    active.pop()
                    if len(active) == 1:
                        active.pop().__exit__(None, None, None)
        return inner
    saved = [(o, k, getattr(o, k)) for o, k in targets]
    for o, k, f in saved:
        setattr(o, k, raising(f))
    try:
        yield
    finally:
        for o, k, f in saved:
            setattr(o, k, f)


def prove_phase(smi, dev, bp32, pc, reset, counts):
    """Phase 10b: range-proof proving on the card (kernels/engine.py's
    prover calls, kernels/ipp_device.py) from the committed prover fixture
    (zkvm_tpu_torch/data/prove_seeded_n64.bin, made by the JAX package's
    prover); -> the prove path's launch counts."""
    from zkvm_tpu_torch import fixture
    from zkvm_tpu_torch.kernels import msm
    from zkvm_tpu_torch.kernels import scalarmod as sm
    from zkvm_tpu_torch.kernels.combine import horner_fold
    from zkvm_tpu_torch.kernels.engine import TorchEngine, _point_words
    from zkvm_tpu_torch.kernels.words import to_device, words_to_points
    from zkvm_tpu_torch.constants import L
    from zkvm_tpu_torch.proofs.errors import VerificationError
    from zkvm_tpu_torch.proofs.generators import BulletproofGens
    from zkvm_tpu_torch.proofs.ipp import InnerProductProof
    from zkvm_tpu_torch.proofs.rangeproof import RangeProof
    from zkvm_tpu_torch.proofs.transcript import ProofTranscript

    m1, m32, ipp = fixture.load_prove()
    t = time.perf_counter()
    ipp_bp = BulletproofGens(ipp.n, 1)
    G, H, Q = ipp_bp.G(ipp.n, 1), ipp_bp.H(ipp.n, 1), pc.B_blinding
    a, b, gf, hf = fixture.ipp_inputs(ipp.seed, ipp.n)
    print(f"generators for the n = {ipp.n} argument: "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    eng = TorchEngine(dev)

    def prove(case, timings=None):
        return RangeProof.prove_multiple(
            bp32, pc, ProofTranscript(case.label), case.values,
            case.blindings, case.n, rng=fixture.witness_rng(case.seed),
            engine=eng, timings=timings)

    def argument(timings=None):
        return InnerProductProof.create(ProofTranscript(ipp.label), Q, gf, hf,
                                        G, H, a, b, engine=eng,
                                        timings=timings)

    # the counted run: the fixture's three cases, host group ops raising
    reset()
    with host_group_ops_raise():
        got = {"m = 1": prove(m1), "m = 32": prove(m32)}
        arg = argument()
    prove_path = counts()
    for (name, (proof, vcs)), case in zip(got.items(), (m1, m32)):
        require(proof.to_bytes() == case.wire and vcs == case.commitments,
                f"the {name} proof differs from the JAX prover's")
    require(arg.to_bytes() == ipp.wire,
            "the n = 1024 argument differs from the JAX prover's")
    require(all(prove_path[i] > 0 for i in (1, 2, 3, 12, 17, 18)),
            f"the prove path skipped a kernel: {prove_path}")
    print(f"prove path (m = 1, m = 32, n = {ipp.n} argument, every host "
          f"group operation raising): bytes equal to the fixture's; "
          f"launches {prove_path}", flush=True)

    # the port's verifier accepts each proof and rejects a flipped byte
    for (name, (proof, vcs)), case in zip(got.items(), (m1, m32)):
        wire = bytearray(proof.to_bytes())
        RangeProof.from_bytes(bytes(wire)).verify_multiple(
            bp32, pc, ProofTranscript(case.label), vcs, case.n, engine=eng)
        wire[4 * 32] ^= 1                                # t_x's low bit
        try:
            RangeProof.from_bytes(bytes(wire)).verify_multiple(
                bp32, pc, ProofTranscript(case.label), vcs, case.n,
                engine=eng)
            rejected = False
        except VerificationError:
            rejected = True
        require(rejected, f"the {name} proof with a flipped byte was accepted")
        print(f"prove {name}: verify_multiple accepts, a flipped t_x bit "
              "rejects", flush=True)
    P = eng.msm_batch([[x * g % L for x, g in zip(a, gf)]
                       + [x * h % L for x, h in zip(b, hf)]
                       + [sum(x * y for x, y in zip(a, b)) % L]],
                      [G + H + [Q]])[0]
    arg.verify(ipp.n, ProofTranscript(ipp.label), gf, hf, P, Q, G, H,
               engine=eng)
    bad = InnerProductProof.from_bytes(arg.to_bytes())
    bad.a = (bad.a + 1) % L
    try:
        bad.verify(ipp.n, ProofTranscript(ipp.label), gf, hf, P, Q, G, H,
                   engine=eng)
        rejected = False
    except VerificationError:
        rejected = True
    require(rejected, "the argument with a + 1 was accepted")
    print(f"n = {ipp.n} argument: verify accepts, a + 1 rejects", flush=True)
    zero = eng.msm_batch([[0, 0]], [[pc.B, Q]])[0]
    require(zero.compress() == bytes(32),
            "K4's folded identity does not encode as 32 zero bytes")

    # times: CUDA events and wall clock around each whole call
    def timed(fn, reps=3):
        walls, evs = [], []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            evs.append(start.elapsed_time(end))
        return (f"wall {min(walls):.4f} / {sorted(walls)[reps // 2]:.4f} s, "
                f"events {min(evs):.2f} / {sorted(evs)[reps // 2]:.2f} ms "
                f"(min / median of {reps})")

    for name, fn in (("prove m = 1", lambda: prove(m1)),
                     ("prove m = 32", lambda: prove(m32)),
                     ("prove m = 32, timed by stage", lambda: prove(m32, {})),
                     (f"argument n = {ipp.n}", argument)):
        print(f"{name}: {timed(fn)} [{smi}]", flush=True)

    # the split: each key's median over three timed calls; a round's wall
    # is issue + wait + fetch + host, its device time scalar step + MSMs and
    # K4 by events
    def split(fn, reps=3):
        runs = []
        for _ in range(reps):
            tm = {}
            torch.cuda.synchronize()
            fn(tm)
            runs.append(tm)
        med = {k: sorted(r[k] for r in runs)[reps // 2] for k in runs[0]}
        k = med["rounds"]
        rnd = (f"{k} rounds, a round: wall {1e3 * med['ipp_round_s'] / k:.3f}"
               f" ms = issue {1e3 * med['ipp_issue_s'] / k:.3f} + wait "
               f"{1e3 * med['ipp_wait_s'] / k:.3f} + fetch "
               f"{1e3 * med['ipp_fetch_s'] / k:.3f} + host "
               f"{1e3 * med['ipp_host_s'] / k:.3f}; events: scalar step "
               f"{med['ipp_scalar_ms'] / k:.3f} ms, MSMs + K4 "
               f"{med['ipp_msm_ms'] / k:.3f} ms")
        return med, runs, rnd

    for name, case in (("m = 32", m32), ("m = 1", m1)):
        med, runs, rnd = split(lambda tm: prove(case, tm))
        each = ", ".join(f"{r['prove_s']:.4f}" for r in runs)
        print(f"prove {name} split (median of {len(runs)}; prove_s {each}): "
              f"prove_s={med['prove_s']:.4f} s = commitments "
              f"{med['commit_s']:.4f} (V {med['commit_v_s']:.4f}, S and A "
              f"{med['commit_sa_s']:.4f}, T {med['commit_t_s']:.4f}) + "
              f"argument {med['ipp_s']:.4f} in {rnd} + the rest (host "
              f"polynomials, transcript, RNG) "
              f"{med['prove_s'] - med['commit_s'] - med['ipp_s']:.4f} s "
              f"[{smi}]", flush=True)
    med, runs, rnd = split(argument)
    print(f"argument n = {ipp.n} split (median of {len(runs)}): "
          f"{med['ipp_s']:.4f} s in {rnd} [{smi}]", flush=True)

    # zero digits: a round's MSM over all 2n + 1 points, half its scalars
    # zero by the mask, against the same MSM over the n + 1 live points;
    # and a 2,048-point small-route MSM of almost all zero digits
    gens = bp32.G(64, 32) + bp32.H(64, 32) + [Q]
    rs = np.random.default_rng(2031)
    for n in (64, 1024, 2048):
        pts = [*gens[:n], *gens[2048:2048 + n], Q]
        live = [j for j in range(n) if j >= n // 2] + \
            [n + j for j in range(n) if j < n // 2] + [2 * n]
        ks = [0] * (2 * n + 1)
        for j in live:
            ks[j] = int.from_bytes(rs.bytes(32), "little") % L
        words = np.stack([_point_words(p) for p in pts]).transpose(1, 2, 0)
        allp = words_to_points(to_device(np.ascontiguousarray(words), dev))
        idx = torch.tensor(live, device=dev)
        livep = allp[:, :, idx].contiguous()
        lim = sm.ints_to_limbs(ks, dev)
        w_all, w_live = msm.best_wbits(2 * n + 1), msm.best_wbits(n + 1)
        d_all = sm.signed_digits(lim, w_all)
        d_live = sm.signed_digits(lim[:, idx], w_live)
        f_all = horner_fold(msm.window_totals(allp, d_all, w_all)
                            .unsqueeze(2).contiguous(), w_all)
        f_live = horner_fold(msm.window_totals(livep, d_live, w_live)
                             .unsqueeze(2).contiguous(), w_live)
        require(same_ristretto(f_all, f_live),
                f"the masked and the gathered MSM differ at n = {n}")
        print(f"zero digits, argument n = {n}: masked {2 * n + 1} points "
              f"({msm.route(2 * n + 1)}, w = {w_all}) "
              f"{cuda_ms(lambda: msm.window_totals(allp, d_all, w_all), 10):.4f}"
              f" ms, gathered {n + 1} live points ({msm.route(n + 1)}, w = "
              f"{w_live}) {cuda_ms(lambda: msm.window_totals(livep, d_live, w_live), 10):.4f}"
              f" ms, gather {cuda_ms(lambda: allp[:, :, idx].contiguous(), 10):.4f}"
              f" ms; equal as points [{smi}]", flush=True)
    pts2k = words_to_points(to_device(np.ascontiguousarray(np.stack(
        [_point_words(p) for p in gens[:2048]]).transpose(1, 2, 0)), dev))
    ks = [0] * 2048
    ks[5], ks[1999] = 7, L - 3
    sparse = sm.signed_digits(sm.ints_to_limbs(ks, dev), 8)
    dense = sm.signed_digits(sm.ints_to_limbs(
        [int.from_bytes(rs.bytes(32), "little") % L for _ in range(2048)],
        dev), 8)
    require(same_points(msm.window_totals_small(pts2k, sparse, 8),
                        msm.window_totals_large(pts2k, sparse, 8)),
            "the small route on 2,046 zero digits differs from the large")
    print(f"small route at 2,048 points, w = 8: 2,046 zero digits "
          f"{cuda_ms(lambda: msm.window_totals_small(pts2k, sparse, 8), 10):.4f}"
          f" ms, random digits "
          f"{cuda_ms(lambda: msm.window_totals_small(pts2k, dense, 8), 10):.4f}"
          f" ms [{smi}]", flush=True)
    return prove_path


def r1cs_prove_phase(smi, dev, r1cs_bp, pc, reset, counts):
    """Phase 10c: R1CS proving and transaction building on the card (the
    R1CS Prover, MuSig's signers and build_tx on TorchEngine) from the
    committed R1CS prover fixture (zkvm_tpu_torch/data/
    prove_r1cs_seeded.bin, made by the JAX package); -> the path's launch
    counts (the proves, the builds and their verification)."""
    from zkvm_tpu_torch import fixture
    from zkvm_tpu_torch.constants import LABEL_ZKVM_TXID
    from zkvm_tpu_torch.crypto import musig, starsig
    from zkvm_tpu_torch.kernels.engine import TorchEngine
    from zkvm_tpu_torch.oracle.merlin import Transcript
    from zkvm_tpu_torch.proofs.errors import ProofError, VerificationError
    from zkvm_tpu_torch.proofs.r1cs import Prover, R1CSProof
    from zkvm_tpu_torch.vm import Tx, build_tx, verify_tx
    from zkvm_tpu_torch.vm.errors import VMError

    cases = fixture.load_prove_r1cs()
    r1cs_cases, tx_cases = cases[:2], cases[2:]
    programs = fixture.tx_programs(cases)      # host-formula commitments
    eng = TorchEngine(dev)

    def prove(case, timings=None):
        return fixture.r1cs_prover(case, eng, timings).prove(r1cs_bp)

    def build(i, timings=None):
        prog, header, keys = programs[i]
        return build_tx(prog, header, r1cs_bp, keys, engine=eng,
                        timings=timings)

    def rejected(fn):
        try:
            fn()
        except (ProofError, VMError, ValueError):
            return True
        return False

    # the counted run: both circuits with every host group operation
    # raising; the transactions with the R1CS prover's and MuSig's raising
    # (the VM's issue makes its flavor commitment with the host formula);
    # then their verification
    reset()
    with host_group_ops_raise():
        proofs = [prove(c) for c in r1cs_cases]
    with host_group_ops_raise_in((Prover, "commit"), (Prover, "prove"),
                                 (musig, "sign_multi")):
        built = [build(i) for i in range(len(tx_cases))]
    made = counts()
    require(all(made[i] > 0 for i in (1, 2, 3, 12, 17, 18)),
            f"the R1CS prove path skipped a kernel: {made}")
    for proof, c in zip(proofs, r1cs_cases):
        wire = proof.to_bytes()
        require(wire == c.wire, f"the {c.kind} proof differs from the JAX "
                                "prover's")
        fx = fixture.r1cs_fixture(c)
        fixture.r1cs_verifier(fx).verify(R1CSProof.from_bytes(wire), pc,
                                         r1cs_bp, engine=eng)
        bad = bytearray(wire)
        bad[11 * 32] ^= 1                                # t_x's low bit
        require(rejected(lambda: fixture.r1cs_verifier(fx).verify(
            R1CSProof.from_bytes(bytes(bad)), pc, r1cs_bp, engine=eng)),
            f"the {c.kind} proof with a flipped t_x bit was accepted")
        print(f"R1CS prove {c.kind} ({len(R1CSProof.from_bytes(wire).ipp_proof.L_vec)}"
              f" rounds, every host group operation raising): bytes equal "
              "to the fixture's; Verifier.verify accepts, a flipped t_x "
              "bit rejects", flush=True)
    for (tx, vtx), c, (prog, _, _) in zip(built, tx_cases, programs):
        require(vtx.id == c.txid and vtx.fee == c.fee
                and tuple(e.encode() for e in vtx.log) == c.log
                and tx.program == Tx.from_bytes(c.wire).program,
                f"build_tx {c.kind}: txid, fee, log or program differs "
                "from the JAX build_tx's")
        wire = tx.to_bytes()
        require(verify_tx(Tx.from_bytes(wire), r1cs_bp, engine=eng).id
                == c.txid, f"verify_tx {c.kind}: txid")
        signers = sum(ins.op == "signtx" for ins in prog)
        t = Transcript(LABEL_ZKVM_TXID)
        t.append_message(b"txid", vtx.id)
        key = musig.Multikey([starsig.VerificationKey(c.points[0])]
                             * signers).aggregated_key(eng)
        starsig.verify(starsig.Signature.from_bytes(tx.signature), t, key,
                       engine=eng)
        for part in ("proof", "signature"):
            require(rejected(lambda: verify_tx(Tx.from_bytes(
                fixture.tampered_tx(wire, part)), r1cs_bp, engine=eng)),
                f"build_tx {c.kind} with a flipped {part} byte was accepted")
        print(f"build_tx {c.kind} (MuSig of {signers}, R1CS and MuSig host "
              "group operations raising): txid, fee, log and program equal "
              "to the JAX build_tx's; verify_tx and starsig.verify accept, "
              "a flipped proof byte and a flipped signature byte reject",
              flush=True)
    path = counts()
    print(f"R1CS prove path launches: proves and builds {made}; with their "
          f"verification {path}", flush=True)

    # times: min / median of 3 calls, wall beside CUDA events, each call's
    # split (host_s: the wall less `parts`), the median of each key
    def timed(fn, parts=(), reps=3):
        walls, evs, runs = [], [], []
        for _ in range(reps):
            tm = {}
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fn(tm)
            end.record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            evs.append(start.elapsed_time(end))
            tm["host_s"] = walls[-1] - sum(tm.get(k, 0.0) for k in parts)
            runs.append(tm)
        med = {k: sorted(r.get(k, 0.0) for r in runs)[reps // 2]
               for k in set(runs[0]) | set(parts)}
        return (f"wall {min(walls):.4f} / {sorted(walls)[reps // 2]:.4f} s, "
                f"events {min(evs):.2f} / {sorted(evs)[reps // 2]:.2f} ms "
                f"(min / median of {reps})"), med

    parts = ("commit_v_s", "commit_phase_s", "commit_t_s", "q_s", "ipp_s")
    for c in r1cs_cases:
        head, m = timed(lambda tm: prove(c, tm), parts)
        k = m["rounds"]
        print(f"R1CS prove {c.kind} (circuit laid, then prove): {head}; "
              f"split (medians): V commitments {m['commit_v_s']:.4f} ("
              f"{len(c.points)} calls), phase commitments "
              f"{m['commit_phase_s']:.4f}, T {m['commit_t_s']:.4f}, Q "
              f"{m['q_s']:.4f}, argument {m['ipp_s']:.4f} ({k:.0f} rounds; "
              f"a round: wall {1e3 * m['ipp_round_s'] / k:.3f} ms = issue "
              f"{1e3 * m['ipp_issue_s'] / k:.3f} + wait "
              f"{1e3 * m['ipp_wait_s'] / k:.3f} + fetch "
              f"{1e3 * m['ipp_fetch_s'] / k:.3f} + host "
              f"{1e3 * m['ipp_host_s'] / k:.3f}; events: scalar step "
              f"{m['ipp_scalar_ms'] / k:.3f} ms, MSMs + K4 "
              f"{m['ipp_msm_ms'] / k:.3f} ms), host {m['host_s']:.4f} s "
              f"[{smi}]", flush=True)
    for i, c in enumerate(tx_cases):
        head, m = timed(lambda tm: build(i, tm))
        print(f"build_tx {c.kind}: {head}; split (medians): VM run "
              f"{m['vm_s']:.4f}, signing {m['sign_s']:.4f}, prove "
              f"{m['prove_s']:.4f} s [{smi}]", flush=True)
    return path


CT_SETS = ("zero", "max", "random")
# K17's timed shapes: (name, outputs, bases); one output with one base is
# every basepoint_mul, with two every R1CS commit's V
CT_K17_SHAPES = (("1 output, one base", 1, 1), ("1 output, two bases", 1, 2),
                 ("512 commitments", 512, 2), ("4,096 commitments", 4096, 2))
# K18's timed and checked groups: a 1- and 2-point msm_secret, m = 1's A
# and S, m = 32's bit commitments, the 2^15 circuit's phases
CT_K18_SHAPES = {"1": [1], "2": [2], "129 x 2": [129, 129],
                 "129 x 32": [129] * 32,
                 "2^15 phases": [65537, 32769, 65537]}
CT_K18_TIMED = ("1", "2", "129 x 32", "2^15 phases")


def ct_scalar_words(dev, seed):
    """-> words(n, kind): (8, n) canonical scalar words on the card, kind
    "zero", "max" (ℓ - 1 each), "random" (below 2^252) or "edges" (random
    with 0, ℓ - 1, 2^64 - 1 and 1 in the first columns)."""
    from zkvm_tpu_torch.constants import L
    from zkvm_tpu_torch.kernels.words import scalar_words, to_device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    special = to_device(scalar_words([0, L - 1, (1 << 64) - 1, 1]).T, dev)

    def words(n, kind):
        if kind == "zero":
            return torch.zeros((8, n), dtype=torch.int32, device=dev)
        if kind == "max":
            return special[:, 1:2].expand(8, n).contiguous()
        w = torch.randint(-2**31, 2**31 - 1, (8, n), dtype=torch.int32,
                          device=dev, generator=gen)
        w[7] &= 0x0FFFFFFF
        if kind == "edges":
            k = min(n, 4)
            w[:, :k] = special[:, :k]
        return w
    return words


def ct_spread(smi, tag, make, call, kernels):
    """Events (each call alone, min and median of 5) and profiler kernel
    time (min and median of three traces of three calls) on each scalar
    set of CT_SETS -> {set: (event min, event median, device min, device
    median)}; prints them with the spreads, (max - min) / min, of the event
    and the device medians."""
    out = {}
    for kind in CT_SETS:
        args = make(kind)
        call(*args)
        evs = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            call(*args)
            end.record()
            torch.cuda.synchronize()
            evs.append(start.elapsed_time(end))
        devs = [device_ms(lambda: call(*args), kernels, 3) for _ in range(3)]
        devs = sorted(x for x in devs if x is not None)
        out[kind] = (min(evs), sorted(evs)[2], devs[0] if devs else None,
                     devs[len(devs) // 2] if devs else None)

    def spread(i):
        v = [x[i] for x in out.values()]
        return "not measured" if None in v else \
            f"{(max(v) - min(v)) / min(v):.4f}"
    print(f"{tag} by scalar set, ms (event min / median of 5; device "
          "min / median of 3 traces): " + "; ".join(
              f"{k} {v[0]:.4f} / {v[1]:.4f}, device {fmt_ms(v[2])} / "
              f"{fmt_ms(v[3])}" for k, v in out.items())
          + f"; spread of the medians (max - min) / min: events "
          f"{spread(1)}, device {spread(3)} [{smi}]", flush=True)
    return out


def ct_timings(smi, fb, mc, tabs, points_for, words):
    """K17 (fixed_base module fb, over the tables `tabs` of two bases) at
    CT_K17_SHAPES and K18 (msm_ct module mc) at CT_K18_TIMED, each on the three
    scalar sets (ct_spread) -> {tag: {set: stats, "bound": bound_ms(...)}}.
    Bounds count ADD products an addition, as for K3 and K5s: K17 64 a
    base and output, K18 71 a point and 8 MUL (its table's cached forms);
    neither counts the tree its kernel adds."""
    out = {}
    for name, n, nb in CT_K17_SHAPES:
        def make(kind, n=n, nb=nb):
            w = words(2 * n, kind)
            args = (tabs[0], w[:, :n].contiguous())
            return args + (tabs[1], w[:, n:].contiguous()) if nb == 2 else args
        tag = f"K17 {name}"
        out[tag] = ct_spread(smi, tag, make, fb.fixed_base_ct,
                             {"fixed_base_kernel": 1})
        out[tag]["bound"] = bound_ms(
            nb * (n * 32 + tabs[0].numel() * 4) + n * 160, nb * n * 64 * ADD)
    for name in CT_K18_TIMED:
        sizes = CT_K18_SHAPES[name]
        N, lv = sum(sizes), len(mc.plan(sizes))
        pts = points_for(sizes)
        tag = f"K18 {name}"
        out[tag] = ct_spread(
            smi, tag, lambda kind: (pts, words(N, kind), sizes), mc.msm_ct,
            {"msm_ct_chunk_kernel": 1, "msm_ct_reduce_kernel": lv - 1})
        out[tag]["bound"] = bound_ms(N * (160 + 32) + len(sizes) * 64 * 160,
                                     N * 71 * ADD + 8 * N * MUL)
    for tag, v in out.items():
        print(f"{tag}: bound_ms={v['bound'][0]:.5f} ({v['bound'][1]})",
              flush=True)
    return out


def ct_phase(smi, dev, r1cs_bp, pc, reset, counts):
    """Phase 10d: K17 fixed_base_ct and K18 msm_ct on the card, the routes
    of every call on secret scalars; -> (their results for the kernels
    line, the launch counts of the route check's engine calls)."""
    from zkvm_tpu_torch.constants import L
    from zkvm_tpu_torch.kernels import engine as engine_mod
    from zkvm_tpu_torch.kernels import fixed_base as fb
    from zkvm_tpu_torch.kernels import msm, msm_ct, sort
    from zkvm_tpu_torch.kernels import scalarmod as sm
    from zkvm_tpu_torch.kernels.combine import horner_fold
    from zkvm_tpu_torch.kernels.engine import TorchEngine, _point_words
    from zkvm_tpu_torch.kernels.words import to_device, words_to_points

    eng = TorchEngine(dev)
    scalar_words_dev = ct_scalar_words(dev, 2032)

    def halves(w):
        n = w.shape[1] // 2
        return w[:, :n].contiguous(), w[:, n:].contiguous()

    # K17's tables of B and B_blinding, built on the card
    tabs = []
    for p in (pc.B, pc.B_blinding):
        pt = words_to_points(to_device(_point_words(p)[:, :, None],
                                       dev)).contiguous()
        tk, tp = fb.table(pt), fb.table_plain(pt)
        torch.cuda.synchronize()
        require(torch.equal(tk, tp), "K17's table differs from its plain "
                                     "version")
        tabs.append(tk)
    require(torch.equal(eng.fixed_table(pc.B), tabs[0]),
            "the engine's resident table of B differs")
    tab_b, tab_bb = tabs

    # K17 bit for bit: batches of 1, 4, 512 (the 2^15 circuit's V) and
    # 4,096 commitments, and basepoint_mul's one base
    err17 = 0
    for n in (1, 4, 512, 4096):
        wv, wb = halves(scalar_words_dev(2 * n, "edges"))
        for args in ((tab_b, wv, tab_bb, wb), (tab_b, wv)):
            k, p = fb.fixed_base_ct(*args), fb.fixed_base_plain(*args)
            torch.cuda.synchronize()
            require(torch.equal(k, p), f"K17 differs from its plain version "
                                       f"(n = {n}, {len(args) // 2} bases)")
            err17 = max(err17, max_abs_err(k, p))
    vs, bs = [0, L - 1, (1 << 64) - 1, 12345], [7, 0, L - 1, (1 << 63) + 1]
    got = eng.commit_batch(vs, bs, pc.B, pc.B_blinding)
    require([g.compress() for g in got] == [pc.commit(v, b).compress()
                                            for v, b in zip(vs, bs)],
            "K17's commitments differ from the host formula")
    require(eng.basepoint_mul(L - 1) == pc.B * (L - 1),
            "K17's basepoint_mul differs from the host formula")
    print(f"K17 fixed_base_ct: its tables of B and B_blinding, and batches "
          f"of 1, 4, 512 and 4,096 (one and two bases, scalars 0, ℓ - 1, "
          f"2^64 - 1 among random ones) equal to the plain "
          f"version bit for bit; commitments equal to the host formula "
          f"[{smi}]", flush=True)

    # K18 bit for bit: groups of 1, 2, 129 (m = 1's A and S), 32 x 129
    # (m = 32's bit commitments) and the 2^15 circuit's phase shapes
    gens = [pc.B_blinding] + r1cs_bp.G(32768, 1) + r1cs_bp.H(32768, 1)
    allp = words_to_points(to_device(np.ascontiguousarray(np.stack(
        [_point_words(p) for p in gens]).transpose(1, 2, 0)), dev))
    shapes = CT_K18_SHAPES

    def points_for(sizes):
        return torch.cat([allp[:, :, :n] for n in sizes], 2).contiguous()

    err18, cases = 0, {}
    for name, sizes in shapes.items():
        pts, w = points_for(sizes), scalar_words_dev(sum(sizes), "edges")
        k, p = msm_ct.msm_ct(pts, w, sizes), msm_ct.msm_ct_plain(pts, w,
                                                                 sizes)
        torch.cuda.synchronize()
        require(torch.equal(k, p), f"K18 differs from its plain version "
                                   f"({name})")
        err18 = max(err18, max_abs_err(k, p))
        cases[name] = (pts, w, sizes, k)
    # as points: K18 then K4 against the public route on the same scalars
    for name, g in (("129 x 32", 5), ("2^15 phases", 1)):
        pts, w, sizes, k = cases[name]
        lo, hi = sum(sizes[:g]), sum(sizes[:g + 1])
        ct_pt = horner_fold(k[:, :, g:g + 1].contiguous(), fb.WBITS)
        wb = msm.best_wbits(hi - lo)
        pub = msm.window_totals(pts[:, :, lo:hi].contiguous(),
                                sm.signed_digits(sm.decode_words_first(
                                    w[:, lo:hi]), wb), wb)
        pub_pt = horner_fold(pub.unsqueeze(2).contiguous(), wb)
        require(same_ristretto(ct_pt, pub_pt),
                f"K18 + K4 differ from the bucket route ({name})")
    print(f"K18 msm_ct: groups of {', '.join(shapes)} points (scalars 0, "
          f"ℓ - 1, 2^64 - 1 among random ones) equal to the plain version "
          f"bit for bit; with K4 equal to the bucket route as points "
          f"[{smi}]", flush=True)
    pts, w, sizes, _ = cases["129 x 2"]
    short_scratch(msm_ct, [("K18", "scratch_len",
                            lambda: msm_ct.msm_ct(pts, w, sizes),
                            msm_ct.msm_ct)])

    # times on three sets of scalars: all zero, all ℓ - 1, random
    t = ct_timings(smi, fb, msm_ct, (tab_b, tab_bb), points_for,
                   scalar_words_dev)
    n = 512
    args17 = (tab_b,) + halves(scalar_words_dev(2 * n, "random"))
    args17 = args17[:2] + (tab_bb, args17[2])
    t17 = t["K17 512 commitments"]
    res17 = dict(
        err=err17, ms=t17["random"][1], dev_ms=t17["random"][3],
        plain_ms=cuda_ms(lambda: fb.fixed_base_plain(*args17), 1),
        lib_ms=None, bound=t17["bound"])
    sizes = shapes["2^15 phases"]
    pts, w = points_for(sizes), scalar_words_dev(sum(sizes), "random")
    t18 = t["K18 2^15 phases"]
    res18 = dict(
        err=err18, ms=t18["random"][1], dev_ms=t18["random"][3],
        plain_ms=cuda_ms(lambda: msm_ct.msm_ct_plain(pts, w, sizes), 1),
        lib_ms=None, bound=t18["bound"])
    for key, v, what in (("K17", res17, "512 commitments, two bases"),
                         ("K18", res18, "the 2^15 phases, 163,843 points")):
        print(f"{key} ({what}): kernel_ms={v['ms']:.4f} device_only_ms="
              f"{fmt_ms(v['dev_ms'])} plain_ms={v['plain_ms']:.2f} "
              f"bound_ms={v['bound'][0]:.5f} ({v['bound'][1]}) "
              f"max_abs_err={v['err']} [{smi}]", flush=True)

    # the routes: every call on secret scalars through the engine with the
    # bucket route, torch.sort and K2, K3, K5s and K9 raising
    def stub(*args, **kwargs):
        raise RuntimeError("chip smoke failed: a call on secret scalars "
                           "reached the bucket route")
    swaps = [(msm, "window_totals"), (msm, "window_totals_small"),
             (msm, "window_totals_large"), (engine_mod, "window_totals"),
             (msm, "bucket_accumulate"), (msm, "bucket_fold"),
             (msm, "small_scan"), (msm, "radix_sort"), (sort, "radix_sort"),
             (torch, "sort")]
    gl = [gens[1:65], gens[32769:32833]]           # 64 of G, 64 of H
    rs = np.random.default_rng(2033)
    ks = [[int.from_bytes(rs.bytes(32), "little") % L for _ in range(n)]
          for n in (129, 2, 0)]
    groups = [[gens[0]] + gl[0] + gl[1], gens[1:3], []]
    bits = [int(x) for x in rs.integers(0, 2, 64)]
    reset()
    with swapped(swaps, stub):
        secret = [eng.basepoint_mul(ks[0][0]), eng.basepoint_mul(7, ct=False),
                  eng.commit(ks[0][1], ks[0][2], pc.B, pc.B_blinding),
                  *eng.commit_batch(ks[0][:3], ks[0][3:6], pc.B,
                                    pc.B_blinding),
                  eng.msm_secret(ks[0], groups[0]),
                  *eng.msm_batch(ks, groups, ct=True),
                  *eng.bit_commit_batch([(ks[0][7], bits, pc.B_blinding,
                                          gl[0], gl[1])])]
    ct_path = counts()
    public = [pc.B * ks[0][0], pc.B * 7, pc.commit(ks[0][1], ks[0][2]),
              *[pc.commit(v, b) for v, b in zip(ks[0][:3], ks[0][3:6])],
              *eng.msm_batch([ks[0]], [groups[0]]),
              *eng.msm_batch(ks, groups),
              *eng.msm_batch([[ks[0][7]] + bits + [(b - 1) % L for b in bits]],
                             [[pc.B_blinding] + gl[0] + gl[1]])]
    require(secret == public, "a constant-time route's point differs from "
                              "the public route's")
    require(ct_path[17] > 0 and ct_path[18] > 0 and ct_path[3] > 0
            and all(ct_path[i] == 0 for i in (1, 2, 8, 12)),
            f"the constant-time routes launched {ct_path}")
    print(f"routes: basepoint_mul (both ct), commit, commit_batch (K17), "
          f"msm_secret, msm_batch(ct=True), bit_commit_batch (K18, K4) "
          f"with the bucket route, torch.sort, K2, K3, K5s and K9 raising: "
          f"equal to the public route and the host formula; launches "
          f"{ct_path}", flush=True)

    # V's time a commit: one K17 launch and one fetch
    walls = []
    for i in range(21):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.commit(ks[0][i], ks[0][i + 21], pc.B, pc.B_blinding)
        walls.append(time.perf_counter() - t)
    walls.sort()
    print(f"V a commit (engine.commit: K17, one fetch): wall "
          f"{1e3 * walls[0]:.3f} / {1e3 * walls[10]:.3f} ms (min / median "
          f"of 21) [{smi}]", flush=True)
    return {"K17": res17, "K18": res18}, ct_path


def keys_phase(smi, dev, bp32, pc, reset, counts):
    """Phase 10e: keytree, PredicateTree, the taproot `call` transaction and
    the multi-host MPC on the card against the committed keys and MPC
    fixture (zkvm_tpu_torch/data/keys_mpc_seeded.bin, made by the JAX
    package); -> the path's launch counts."""
    from zkvm_tpu_torch import fixture
    from zkvm_tpu_torch.crypto import Xprv
    from zkvm_tpu_torch.kernels.engine import TorchEngine
    from zkvm_tpu_torch.parallel import mpc_hosts
    from zkvm_tpu_torch.proofs.errors import MPCError, VerificationError
    from zkvm_tpu_torch.proofs.generators import BulletproofGens
    from zkvm_tpu_torch.proofs.rangeproof import RangeProof
    from zkvm_tpu_torch.proofs.transcript import ProofTranscript
    from zkvm_tpu_torch.vm import Instruction, Tx, TxHeader, build_tx
    from zkvm_tpu_torch.vm import verify_tx
    from zkvm_tpu_torch.vm.predicate import PredicateTree

    fx = fixture.load_keys_mpc()
    eng = TorchEngine(dev)
    reset()
    t = time.perf_counter()
    for k in fx.keytree:
        def sel(tr, a=k.account):
            tr.append_u64(b"account", a)
        xprv = Xprv.random(k.seed)
        xpub = xprv.to_xpub(eng)
        child = xprv.derive_key(sel, eng)
        require((xprv.scalar_key, xprv.dk, xpub.point) == (k.scalar, k.dk,
                                                           k.point)
                and (child.scalar_key, child.dk) == (k.child_scalar,
                                                     k.child_dk)
                and xpub.derive_key(sel, eng).point == k.child_point
                and child.to_xpub(eng).point == k.child_point,
                "a keytree derivation differs from the JAX package's")
    for c in fx.predicates:
        tree = PredicateTree(c.key_point, c.progs)
        require(tree.adjustment_factor() == c.adjustment
                and tree.predicate(eng).point == c.predicate
                and [tree.call_proof(i).to_bytes()
                     for i in range(len(c.progs))] == c.call_proofs,
                "a PredicateTree differs from the JAX package's")
    call = fx.call
    c = fx.predicates[call.tree]
    tree = PredicateTree(c.key_point, c.progs)
    program = fixture.taproot_call_program(
        Instruction, tree.predicate(eng).point, c.progs[call.leaf],
        tree.call_proof(call.leaf).to_bytes(), call.payload)
    call_bp = BulletproofGens(16)
    tx, vtx = build_tx(program, TxHeader(*call.header), call_bp, engine=eng)
    require((vtx.id, vtx.fee, tuple(e.encode() for e in vtx.log)) == (
        call.txid, call.fee, call.log)
        and tx.program == Tx.from_bytes(call.wire).program,
        "the taproot call transaction differs from the JAX build_tx's")
    require(verify_tx(Tx.from_bytes(tx.to_bytes()), call_bp,
                      engine=eng).id == call.txid,
            "verify_tx of the taproot call transaction")
    print(f"keytree ({len(fx.keytree)} derivations) and PredicateTree "
          f"({len(fx.predicates)} trees) equal to the JAX package's; the "
          f"taproot call transaction built on the card: txid, fee, log and "
          f"program equal to the JAX build_tx's, verify_tx accepts; "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    m = fx.mpc
    hosts, at = [], 0
    for k in m.party_counts:
        hosts.append((m.values[at:at + k], m.blindings[at:at + k]))
        at += k
    vals, blinds = [h[0] for h in hosts], [h[1] for h in hosts]
    engines = [TorchEngine(dev) for _ in hosts]
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof, vcs = mpc_hosts.distributed_prove(
            bp32, pc, m.label, vals, blinds, m.n, engines=engines)
        walls.append(time.perf_counter() - t)
        require(vcs == m.commitments, "distributed_prove's commitments "
                                      "differ from the fixture's")
        wire = bytearray(proof.to_bytes())
        RangeProof.from_bytes(bytes(wire)).verify_multiple(
            bp32, pc, ProofTranscript(m.label), vcs, m.n, engine=eng)
    wire[4 * 32] ^= 1                                # t_x's low bit
    try:
        RangeProof.from_bytes(bytes(wire)).verify_multiple(
            bp32, pc, ProofTranscript(m.label), vcs, m.n, engine=eng)
        rejected = False
    except VerificationError:
        rejected = True
    require(rejected, "the distributed proof with a flipped t_x bit was "
                      "accepted")
    try:
        mpc_hosts.distributed_prove(
            bp32, pc, m.label, vals, blinds, m.n, engines=engines,
            corrupt={m.corrupt_host: fixture.corrupt_first_share(mpc_hosts)})
        named = None
    except MPCError as e:
        named = e.bad_shares
    require(named == m.bad_shares, f"the corrupted share was attributed to "
                                   f"{named}, the reference to "
                                   f"{m.bad_shares}")
    path = counts()
    require(path[17] > 0 and path[18] > 0,
            f"the keys and MPC path skipped K17 or K18: {path}")
    walls.sort()
    print(f"distributed_prove, {len(hosts)} hosts x {m.party_counts[0]} "
          f"parties, n = {m.n} (ThreadLocalTransport, a TorchEngine a "
          f"host): commitments equal to the fixture's, verify_multiple "
          f"accepts, a flipped t_x bit rejects; host {m.corrupt_host}'s "
          f"corrupted share names parties {named}, as the reference; wall "
          f"{walls[0]:.4f} / {walls[1]:.4f} s (min / median of 3); "
          f"launches {path} [{smi}]", flush=True)
    return path


def sync_free(fn):
    """fn run with CUDA's sync debug mode at "error": any host sync inside
    it raises (for the launch halves, which must not wait for the card)."""
    def inner(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return inner


def pipeline_phase(smi, dev, bp, pc, n, batch, verdicts, r1cs_bp, reset,
                   counts):
    """Phase 11: the serving pipeline.  TorchEngine.msm_start /
    msm_finish_is_identity against msm_is_identity at 1,055 and 17,538
    points, the start with no host sync; then, with every launch count set
    to 0, batch_verify_device_pipelined on streams of 8 batches at nb =
    1024 and 4 at nb = 4096 (one batch of each with a t_x changed), each
    launch half under sync debug mode, the verdicts equal to phase 4's
    batch_verify on the same batches; times each batch, the stream
    (verifies/s) and the one-shot batch_verify_device on the same batch
    (min of 2); -> the path's launch counts, those of the two pipelined
    streams alone."""
    from zkvm_tpu_torch.constants import L
    from zkvm_tpu_torch.kernels import batch_verify_device as bvd
    from zkvm_tpu_torch.kernels.engine import TorchEngine
    from zkvm_tpu_torch.oracle import edwards
    from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint

    eng = TorchEngine(dev)
    rs = np.random.default_rng(2033)
    for k in (1055, 17538):
        pts = r1cs_bp.G(k, 1)
        ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in pts]
        half = pts[:k // 2]
        pair_pts = half + [RistrettoPoint(edwards.neg(p.ep)) for p in half]
        pair_ks = ks[:k // 2] * 2
        for s, p, want in ((ks, pts, False), (pair_ks, pair_pts, True)):
            eng.msm_finish_is_identity(eng.msm_start(s, p))   # warm-up
            handle = sync_free(eng.msm_start)(s, p)
            got = eng.msm_finish_is_identity(handle)
            require(got == eng.msm_is_identity(s, p) == want,
                    f"msm_start / msm_finish_is_identity at {len(p)} points "
                    f"gave {got}, msm_is_identity and the expected {want}")
        print(f"msm_start / msm_finish_is_identity at {k} and {2 * (k // 2)}"
              f" points: equal to msm_is_identity (non-identity, identity), "
              f"no host sync before the fetch", flush=True)

    path = None
    for nb, count, bad in ((1024, 8, 5), (4096, 4, 2)):
        stream = []
        for k in range(count):
            proofs, _, _, transcripts, vcs, _ = batch(
                nb, "t_x" if k == bad else None)
            stream.append((proofs, transcripts, vcs))
        want = [verdicts[(nb, "t_x" if k == bad else None)]
                for k in range(count)]
        tm = {}
        reset()
        with swapped([(bvd, "_launch")], sync_free(bvd._launch)):
            got = bvd.batch_verify_device_pipelined(stream, bp, pc, n,
                                                    engine=eng, timings=tm)
        # the path's counts: the pipelined streams alone, not the one-shot
        # timing runs below
        path = [a + b for a, b in zip(path or [0] * len(counts()), counts())]
        require(got == want, f"nb={nb}: the pipelined verdicts {got} differ "
                             f"from phase 4's {want}")
        one = []
        for _ in range(2):
            proofs, _, _, transcripts, vcs, _ = batch(nb)
            t1 = {}
            require(bvd.batch_verify_device(proofs, bp, pc, transcripts, vcs,
                                            n, device=dev, timings=t1),
                    f"nb={nb}: the one-shot batch rejected")
            one.append(t1["host_s"] + t1["device_s"])
        print(f"pipelined nb={nb} x {count} (batch {bad} t_x tampered): "
              f"verdicts {got} equal to phase 4's; launch halves with no "
              f"host sync; per batch wall_s "
              + json.dumps([round(x, 4) for x in tm["wall_s"]])
              + " host_s " + json.dumps([round(x, 4) for x in tm["host_s"]])
              + " device_s " + json.dumps([round(x, 4) for x in tm["device_s"]])
              + f"; total_s {tm['total_s']:.4f} pipelined_verifies_per_s="
              f"{nb * count / tm['total_s']:.1f} single_batch_verifies_per_s="
              f"{nb / min(one):.1f} (one-shot, min of 2: {min(one):.4f} s) "
              f"[{smi}]", flush=True)
    require(all(path[i] > 0 for i in range(4)),
            f"the pipelined path skipped a kernel: {path}")
    print(f"pipelined path launches: {path}", flush=True)
    return path


def node_phase(smi, dev, tx_bp, reset, counts):
    """Phase 12: the node.  With every launch count set to 0: node A admits
    the committed block's 192 issue transactions through its mempool and
    mines them into one block; node B cold-syncs it (chain.node.sync),
    node C over the encrypted channel (chain.p2p.encrypted_sync, both
    handshakes with every host group operation raising); tips, utxoroots
    and snapshots must agree, a restart from A's snapshot keep the tip, and
    a block with a tampered transaction (its txroot made to match) or with
    its transactions dropped be refused.  Then `python -m
    zkvm_tpu_torch.cli node-demo --blocks 3` (tips must agree) and `verify`
    on one committed transaction, each as a child process; -> the path's
    launch counts."""
    from zkvm_tpu_torch import fixture
    from zkvm_tpu_torch.chain import BlockchainState
    from zkvm_tpu_torch.chain.block import Block, block_id, txroot
    from zkvm_tpu_torch.chain.node import Node, sync
    from zkvm_tpu_torch.chain.p2p import (PeerIdentity, SecurePeer,
                                          encrypted_sync)
    from zkvm_tpu_torch.chain.state import BlockchainError
    from zkvm_tpu_torch.kernels import _build
    from zkvm_tpu_torch.kernels.engine import TorchEngine
    from zkvm_tpu_torch.proofs.errors import ProofError
    from zkvm_tpu_torch.vm import Tx
    from zkvm_tpu_torch.vm.errors import VMError

    _, recs = fixture.load_txs()
    issues = recs[:192]
    require(all(r.kind == "issue" for r in issues), "the fixture's issues")

    def fresh():
        return Node(BlockchainState.make_initial(timestamp_ms=1000), tx_bp,
                    engine=TorchEngine(dev))

    reset()
    a = fresh()
    secs = {}
    t = time.perf_counter()
    for r in issues:
        require(a.submit_tx(Tx.from_bytes(r.wire)).id == r.txid,
                "an admitted txid differs from the JAX verifier's")
    secs["admit"] = time.perf_counter() - t
    t = time.perf_counter()
    blk = a.make_block(timestamp_ms=2000)
    secs["mine"] = time.perf_counter() - t
    require(len(blk.txs) == 192 and len(a.mempool) == 0
            and a.tip.height == 2, "the mined block's shape")
    b = fresh()
    t = time.perf_counter()
    rounds = sync(b, a)
    secs["sync"] = time.perf_counter() - t
    c = fresh()
    id_c = PeerIdentity.generate(engine=c.engine)
    id_a = PeerIdentity.generate(engine=a.engine)
    t = time.perf_counter()
    with host_group_ops_raise_in((SecurePeer, "handshake")):
        enc_rounds = encrypted_sync(c, a, id_c, id_a)
    secs["encrypted sync"] = time.perf_counter() - t
    snap = a.serialize()
    for name, x in (("B", b), ("C", c)):
        require(block_id(x.tip) == block_id(a.tip)
                and x.state.utreexo.state_hash() == a.state.utreexo.state_hash()
                and x.serialize() == snap,
                f"node {name}'s tip, utxoroot or snapshot differs from A's")
    restarted = Node.deserialize(snap, tx_bp, engine=TorchEngine(dev))
    require(block_id(restarted.tip) == block_id(a.tip)
            and restarted.serialize() == snap, "the restart lost the tip")

    bad_txs = [Tx.from_bytes(fixture.tampered_tx(issues[0].wire, "proof"))]
    bad_txs += blk.txs[1:]
    header = Block.from_bytes(blk.to_bytes()).header
    header.txroot = txroot(bad_txs)
    refused = []
    for what, bad in (("a tampered transaction",
                       Block(header, bad_txs, {})),
                      ("its transactions dropped",
                       Block(blk.header, [], {}))):
        d = fresh()
        try:
            d.receive_block(bad)
        except (ProofError, VMError, ValueError, BlockchainError) as e:
            refused.append(f"{what}: {type(e).__name__}: {e}")
        require(d.tip.height == 1, f"a block with {what} was applied")
    require(len(refused) == 2, f"a tampered block was accepted: {refused}")
    path = counts()
    require(all(path[i] > 0 for i in (2, 3, 12, 17, 18)),
            f"the node path skipped a kernel: {path}")
    print(f"node: A admitted and mined 192 issues (height {a.tip.height}), "
          f"B synced in {rounds} rounds, C over the encrypted channel in "
          f"{enc_rounds} (handshakes with every host group operation "
          f"raising); tips, utxoroots and snapshots agree; the restart keeps "
          f"the tip; refused: {refused}", flush=True)
    print("node passes, s and tx/s: " + json.dumps(
        {k: [round(v, 3), round(192 / v, 1)] for k, v in secs.items()})
        + f" [{smi}]", flush=True)
    print(f"node path launches: {path}", flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "zkvm_tpu_torch.cli"]
    t = time.perf_counter()
    child = subprocess.run(cli + ["node-demo", "--blocks", "3"], cwd=root,
                           capture_output=True, text=True, timeout=300)
    require(child.returncode == 0, f"cli node-demo failed: "
                                   f"{child.stderr[-2000:]}")
    demo = json.loads(child.stdout.strip().splitlines()[-1])
    require(demo["tips_agree"] and demo["height"] == 4,
            f"cli node-demo: {demo}")
    print(f"cli node-demo --blocks 3: {json.dumps(demo)}; "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    tx_file = str(_build.BUILD_DIR / "smoke_tx.bin")   # ignored by git
    with open(tx_file, "wb") as f:
        f.write(recs[192].wire)
    t = time.perf_counter()
    child = subprocess.run(cli + ["verify", "--tx-file", tx_file], cwd=root,
                           capture_output=True, text=True, timeout=300)
    require(child.returncode == 0, f"cli verify failed: "
                                   f"{child.stderr[-2000:]}")
    got = json.loads(child.stdout.strip().splitlines()[-1])
    require(got["txid"] == recs[192].txid.hex(),
            f"cli verify: the txid differs from the JAX verifier's: {got}")
    print(f"cli verify ({recs[192].kind}): {json.dumps(got)}; "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return path


def main():
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if len(sys.argv) == 3 and sys.argv[1] == "--launch-check":
        require(sys.argv[2] in LAUNCH_CHECK, f"--launch-check takes one of "
                                             f"{LAUNCH_CHECK}")
        return launch_check(sys.argv[2])
    from zkvm_tpu_torch import fixture
    from zkvm_tpu_torch import micro as micro_bench
    from zkvm_tpu_torch.convert import from_jax_limbs13
    from zkvm_tpu_torch.kernels import (_build, combine, decompress,
                                        fixed_base, gather, micro, msm,
                                        msm_ct, pointwise, sort)
    from zkvm_tpu_torch.kernels import batch_verify_device as bvd
    from zkvm_tpu_torch.kernels import field as F
    from zkvm_tpu_torch.kernels import scalarmod as sm
    from zkvm_tpu_torch.kernels.engine import TorchEngine
    from zkvm_tpu_torch.kernels.frontend import (combine_window_totals,
                                                 pack_words,
                                                 window_totals_from_words)
    from zkvm_tpu_torch.kernels.words import (encoding_words, points_to_words,
                                              scalar_words, to_device,
                                              words_to_points)
    from zkvm_tpu_torch.constants import L, P
    from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint
    from zkvm_tpu_torch.parallel.tx_batch import (_chunk_precompute,
                                                  fused_verify_tx_batch,
                                                  verify_tx_batch)
    from zkvm_tpu_torch.proofs.errors import ProofError, VerificationError
    from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
    from zkvm_tpu_torch.proofs.r1cs import R1CSProof
    from zkvm_tpu_torch.proofs.rangeproof import (RangeProof, batch_verify,
                                                  batch_verification_job)
    from zkvm_tpu_torch.proofs.transcript import ProofTranscript
    from zkvm_tpu_torch.vm import Tx, verify_tx
    from zkvm_tpu_torch.vm.errors import VMError

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase_s, t_mark = {}, [time.perf_counter()]

    def mark(name):
        """Close phase `name`: its seconds since the previous mark."""
        now = time.perf_counter()
        phase_s[name] = round(now - t_mark[0], 1)
        t_mark[0] = now
        print(f"phase {name}: {phase_s[name]} s", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} kernels "
          f"{sorted(built)} (parallel nvcc)", flush=True)
    for src in dict.fromkeys(map(_build.source, _build.SIGNATURES)):
        for fn, regs in ptxas_report(_build, src):
            print(f"  ptxas {src} {fn}: {regs}")
    dev = torch.device("cuda")
    mark("build")

    # --------------------------------------------------------- phase 1b
    native_phase(smi)
    mark("native")

    label, n, m, records = fixture.load()
    bp, pc = BulletproofGens(n, m), PedersenGens()

    def batch(nb, tamper=None):
        """batch_verify's positional arguments for nb tiled fixture proofs."""
        proofs = [RangeProof.from_bytes(records[i % len(records)][0])
                  for i in range(nb)]
        if tamper == "t_x":
            proofs[nb // 3].t_x = (proofs[nb // 3].t_x + 1) % L
        elif tamper == "encoding":
            s = int.from_bytes(proofs[nb // 2].S, "little")
            proofs[nb // 2].S = (s + P).to_bytes(32, "little")
        vcs = [records[i % len(records)][1] for i in range(nb)]
        return (proofs, bp, pc, [ProofTranscript(label) for _ in range(nb)],
                vcs, n)

    # ---------------------------------------------------------- phase 2
    nb = 1024
    t = time.perf_counter()
    stages = {}
    params, bbB_pp, dyn, m, lg = bvd.prepare_batch_inputs(*batch(nb),
                                                          timings=stages)
    print(f"host inputs for nb={nb}: {time.perf_counter() - t:.2f} s; native "
          "host half by stage (s): " + json.dumps(
              {k: round(v, 4) for k, v in stages.items()})
          + f"; os.cpu_count() = {os.cpu_count()} [{smi}]", flush=True)
    static = bvd.static_gens_words(bp, pc, n, m, dev)
    params_t = to_device(params, dev)
    bbB_t = to_device(bvd.sum_bbB(bbB_pp), dev)
    total = static.shape[2] + dyn.shape[1]
    wbits = msm.best_wbits(total)
    nbk = 1 << (wbits - 1)
    print(f"MSM: {total} points, wbits {wbits}", flush=True)

    # K1 on the batch's 17,408 encodings, a few made invalid
    enc = dyn.copy()
    bad_cols = [5, 1000, 9999, 17000]
    enc[:, bad_cols[0]] = encoding_words([(P + 2).to_bytes(32, "little")])[:, 0]
    enc[0, bad_cols[1]] |= 1                                    # negative s
    enc[:, bad_cols[2]] = encoding_words([bytes(range(32))])[:, 0]
    enc[7, bad_cols[3]] |= 0x80000000                           # bit 255
    words = to_device(enc, dev)

    def k1_check(w, bad):
        """K1 against its plain version on encoding words w whose columns
        `bad` are invalid: raw limbs, canonical words and flags equal, and
        exactly `bad` flagged; returns the decoded points and flags."""
        pts_k, ok_k = decompress.ristretto_decode(w)
        pts_p, ok_p = decompress.ristretto_decode_plain(w)
        torch.cuda.synchronize()
        nn = w.shape[1]
        require(torch.equal(ok_k, ok_p),
                f"K1 ok flags differ from the plain version (n = {nn})")
        require(torch.equal(pts_k, pts_p),
                f"K1 limbs differ from the plain version (n = {nn})")
        require(torch.equal(points_to_words(pts_k), points_to_words(pts_p)),
                f"K1 points differ from the plain version (n = {nn})")
        require(int(ok_k.sum()) == nn - len(bad)
                and all(int(ok_k[c]) == 0 for c in bad),
                f"K1 flags the wrong encodings (n = {nn})")
        return pts_k, ok_k, pts_p, ok_p

    pts_k, ok_k, pts_p, ok_p = k1_check(words, bad_cols)
    # the tail: a group of five lanes per encoding, six groups a warp, so
    # these sizes end inside a warp and inside a block; each has invalid
    # encodings of the four kinds above
    for nt in (1, 7, 33, 1055):
        et = dyn[:, :nt].copy()
        bad_t = sorted({0, nt // 3, nt - 1, (5 * nt) // 7})
        for i, c in enumerate(bad_t):
            et[:, c] = enc[:, bad_cols[i % len(bad_cols)]]
        k1_check(to_device(et, dev), bad_t)
    print(f"K1 at n = 1, 7, 33, 1,055 and {words.shape[1]:,}, invalid "
          f"encodings at each: limbs, canonical words and flags equal to "
          f"the plain version [{smi}]", flush=True)
    results = {}
    d1 = words.shape[1]
    results["K1"] = dict(
        err=max(max_abs_err(points_to_words(pts_k), points_to_words(pts_p)),
                max_abs_err(ok_k, ok_p)),
        ms=cuda_ms(lambda: decompress.ristretto_decode(words), 20),
        plain_ms=cuda_ms(lambda: decompress.ristretto_decode_plain(words), 2),
        bound=bound_ms(d1 * (32 + 164), d1 * DECODE))

    # K2 and K3 on the batch's MSM
    digits = sm.signed_digits(bvd.batch_msm_scalars(params_t, bbB_t, n, m, lg),
                              wbits)
    dyn_pts, _ = decompress.ristretto_decode(to_device(dyn, dev))
    points = torch.cat([words_to_points(static), dyn_pts], dim=2)
    nw = digits.shape[1]

    def k2_k3(tag, pts, dg, w):
        """K2 and K3 on one MSM, bit for bit against their plain versions;
        returns (K2's results, K3's results, keys, offsets, shift, K2's
        bucket sums)."""
        nbw = 1 << (w - 1)
        nww = dg.shape[1]
        keys, offsets, shift = msm.sort_keys(dg, nbw)
        b_k = msm.bucket_accumulate(keys, offsets, pts, nbw, shift)
        b_p = msm.bucket_accumulate_plain(keys, offsets, pts, nbw, shift)
        torch.cuda.synchronize()
        bw_k, bw_p = points_to_words(b_k), points_to_words(b_p)
        require(torch.equal(b_k, b_p) and torch.equal(bw_k, bw_p),
                f"K2 buckets differ from the plain version ({tag})")
        runs = offsets[:, 1:] - offsets[:, :-1]
        adds = int((runs - 1).clamp(min=0).sum())
        levels = len(msm.accumulate_levels(pts.shape[2]))    # + cached_points
        k2 = dict(
            err=max_abs_err(bw_k, bw_p),
            ms=cuda_ms(lambda: msm.bucket_accumulate(keys, offsets, pts, nbw,
                                                     shift), 20),
            dev_ms=device_ms(lambda: msm.bucket_accumulate(
                keys, offsets, pts, nbw, shift),
                {"bucket_accumulate_kernel": levels,
                 "cached_points_kernel": 1}, 20),
            plain_ms=cuda_ms(lambda: msm.bucket_accumulate_plain(
                keys, offsets, pts, nbw, shift), 2),
            bound=bound_ms(keys.numel() * 8 + offsets.numel() * 8
                           + pts.numel() * 4 + b_k.numel() * 4, adds * ADD),
            per_call=levels + 1)
        t_k = msm.bucket_fold(b_k, nww, nbw)
        t_p = msm.bucket_fold_plain(b_k, nww, nbw)
        torch.cuda.synchronize()
        tw_k, tw_p = points_to_words(t_k), points_to_words(t_p)
        require(torch.equal(t_k, t_p) and torch.equal(tw_k, tw_p),
                f"K3 totals differ from the plain version ({tag})")
        # the work the first fold design did (128 lanes of R buckets a
        # window, a suffix scan, a tree and log2 R doublings), kept as the
        # bound's count so that rows compare across designs
        lanes = min(128, nbw)
        r = nbw // lanes
        adds3 = nww * (2 * nbw + sum(lanes - (1 << k)
                                     for k in range(int(math.log2(lanes))))
                       + 2 * (lanes - 1) + 1)
        k3 = dict(
            err=max_abs_err(tw_k, tw_p),
            ms=cuda_ms(lambda: msm.bucket_fold(b_k, nww, nbw), 20),
            dev_ms=device_ms(lambda: msm.bucket_fold(b_k, nww, nbw),
                             {"bucket_fold_block_kernel": 1,
                              "bucket_fold_window_kernel": 1}, 20),
            plain_ms=cuda_ms(lambda: msm.bucket_fold_plain(b_k, nww, nbw), 2),
            bound=bound_ms(b_k.numel() * 4 + t_k.numel() * 4,
                           adds3 * ADD + nww * int(math.log2(r)) * DBL),
            per_call=2)
        for k, v in (("K2", k2), ("K3", k3)):
            print(f"{k} {tag} ({pts.shape[2]} points, w = {w}): "
                  f"kernel_ms={v['ms']:.4f} "
                  f"device_only_ms={fmt_ms(v['dev_ms'])} "
                  f"plain_ms={v['plain_ms']:.2f} "
                  f"bound_ms={v['bound'][0]:.7f} ({v['bound'][1]}) "
                  f"kernel_launches_per_call={v['per_call']} "
                  f"max_abs_err={v['err']} [{smi}]", flush=True)
        return k2, k3, keys, offsets, shift, b_k

    results["K2"], results["K3"], keys, offsets, shift, buckets_k = k2_k3(
        "nb=1024", points, digits, wbits)
    totals_k = msm.bucket_fold(buckets_k, nw, nbk)

    # K3 at the narrow windows a caller may ask for (wbits 1 to 9): a
    # first-pass block of fewer groups than a warp up to nb = 4, and one
    # launch up to nb = 256 (the small route's fold); bucket sums taken from
    # the nb = 1024 ones
    for nbs in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        b_s = buckets_k[:, :, :nw * nbs].contiguous()
        t_k, t_p = msm.bucket_fold(b_s, nw, nbs), msm.bucket_fold_plain(
            b_s, nw, nbs)
        torch.cuda.synchronize()
        require(torch.equal(t_k, t_p)
                and torch.equal(points_to_words(t_k), points_to_words(t_p)),
                f"K3 totals differ from the plain version at nb = {nbs}")
    print(f"K3 at nb = 1 to 256 ({nw} windows): equal to the "
          f"plain version bit for bit [{smi}]", flush=True)

    # the scratch contract: K2's and K3's C entries refuse a scratch one
    # element shorter than their own constants need, and the wrappers raise
    # without launching (K11's and K12's in phase 3)
    short_scratch(msm, [
        ("K2", "_accumulate_scratch",
         lambda: msm.bucket_accumulate(keys, offsets, points, nbk, shift),
         msm.bucket_accumulate),
        ("K3", "_fold_scratch", lambda: msm.bucket_fold(buckets_k, nw, nbk),
         msm.bucket_fold)])

    # K2 on the same points with every scalar equal: each window's digits
    # form one run of all the points (the skew the first K2 serialised)
    row = int(np.random.default_rng(2028).integers(0, total))
    digits_eq = digits[row:row + 1].expand(total, nw).contiguous()
    k2_eq, _, keys_eq, offsets_eq, shift_eq, buckets_eq = k2_k3(
        "nb=1024 equal scalars", points, digits_eq, wbits)
    print(f"K2 skew: equal scalars {k2_eq['ms']:.4f} ms "
          f"(device-only {fmt_ms(k2_eq['dev_ms'])}) against random "
          f"{results['K2']['ms']:.4f} ({fmt_ms(results['K2']['dev_ms'])}): "
          f"{k2_eq['ms'] / results['K2']['ms']:.3f}x [{smi}]", flush=True)
    require(k2_eq["ms"] <= 3 * results["K2"]["ms"],
            "K2 on equal scalars takes more than 3x its random-digit time")

    # K4 on the batch's totals (identity) and on those of the same MSM with
    # one digit raised by one, whose sum is that digit's point
    totals4 = totals_k.unsqueeze(2).contiguous()
    bump = int((digits[:, 0] < nbk).nonzero()[0])
    digits_bad = digits.clone()
    digits_bad[bump, 0] += 1
    bad4 = msm.window_totals_large(points, digits_bad, wbits,
                                   msm.MsmConfig()).unsqueeze(2).contiguous()
    k4_err = 0
    for tag, tot, want in (("identity", totals4, 1), ("non-identity", bad4, 0)):
        fold_k, check_k = combine.horner_fold(tot, wbits), combine.horner_check(
            tot, wbits)
        fold_p = F.pack_points(combine.horner_fold_plain(tot, wbits))
        check_p = combine.horner_check_plain(tot, wbits)
        torch.cuda.synchronize()
        canon_k, canon_p = points_to_words(fold_k), points_to_words(fold_p)
        require(torch.equal(check_k, check_p),
                f"K4 verdict differs from the plain version ({tag})")
        require(torch.equal(fold_k, fold_p) and torch.equal(canon_k, canon_p),
                f"K4 folded point differs from the plain version ({tag})")
        require(int(check_k[0]) == want, f"K4 verdict {int(check_k[0])} on "
                                         f"the {tag} totals")
        k4_err = max(k4_err, max_abs_err(check_k, check_p),
                     max_abs_err(canon_k, canon_p))
    # the valid MSM sums to the identity up to 4-torsion, so the raised
    # one sums to the digit's point up to 4-torsion
    require(same_ristretto(fold_k, points[:, :, bump:bump + 1]),
            "K4 folded the raised MSM to another point than the digit's")
    print(f"K4: verdict and folded point equal to the plain version's on the "
          f"identity and non-identity totals ({nw} windows; the raised MSM "
          f"folds to point {bump})", flush=True)
    results["K4"] = dict(
        err=k4_err,
        ms=cuda_ms(lambda: combine.horner_check(totals4, wbits), 20),
        plain_ms=cuda_ms(lambda: combine.horner_check_plain(totals4, wbits), 2),
        bound=bound_ms(totals4.numel() * 4 + 4 + 160,
                       (nw - 1) * (wbits * DBL + 8 * MUL) + nw * MUL))
    k4_levels = (nw - 1) * (2 * wbits + 2) + 1      # cached forms, then chain
    k4_muls = (nw - 1) * (8 * wbits + 9)            # one thread's, in a row
    k1_4 = {"K1": (lambda: decompress.ristretto_decode(words),
                   "ristretto_decode_kernel"),
            "K4": (lambda: combine.horner_check(totals4, wbits),
                   "horner_check_kernel")}
    for k, (fn, kname) in k1_4.items():
        v = results[k]
        v["dev_ms"] = device_ms(fn, kname, 20)
        print(f"{k}: kernel_ms={v['ms']:.4f} "
              f"device_only_ms={fmt_ms(v['dev_ms'])} "
              f"plain_ms={v['plain_ms']:.2f} "
              f"bound_ms={v['bound'][0]:.7f} ({v['bound'][1]}) "
              f"max_abs_err={v['err']} launches_per_verify=1 [{smi}]",
              flush=True)
    k1_dev = results["K1"]["dev_ms"]
    k1_regs = [line.split(":", 1)[-1].strip() for line in _build.lib_path(
        "decompress").with_suffix(".log").read_text().splitlines()
        if "Used" in line or "spill" in line]
    print(f"K1: {d1} encodings x {DECODE} products (257 squarings of {SQR}, "
          f"24 multiplications of {MUL}): "
          f"{d1 * DECODE / (results['K1']['ms'] * 1e-3):.4g} products/s by "
          f"events, "
          f"{'not measured' if k1_dev is None else f'{d1 * DECODE / (k1_dev * 1e-3):.4g}'}"
          f" device-only, against the bound's {PRODUCTS_PER_S:.4g}; ptxas "
          f"{k1_regs} [{smi}]", flush=True)
    k4_dev = results["K4"]["dev_ms"]
    print(f"K4 chain: {k4_levels} dependent field multiplications (a "
          f"one-thread chain runs {k4_muls} in a row); per level "
          f"{results['K4']['ms'] / k4_levels * 1e3:.5f} us by events, "
          f"{fmt_ms(None if k4_dev is None else k4_dev / k4_levels * 1e3)} us "
          f"device-only [{smi}]", flush=True)

    # stages of the device half at this shape, and window widths around
    # msm.best_wbits's choice (sort + K2 + K3 per width)
    stages = {
        "synthesis+recode": lambda: sm.signed_digits(
            bvd.batch_msm_scalars(params_t, bbB_t, n, m, lg), wbits),
        "K1 decode": lambda: decompress.ristretto_decode(words),
        "sort+offsets": lambda: msm.sort_keys(digits, nbk),
        "K2": lambda: msm.bucket_accumulate(keys, offsets, points, nbk, shift),
        "K3": lambda: msm.bucket_fold(buckets_k, nw, nbk),
        "K4": lambda: combine.horner_check(totals4, wbits),
        "whole device half": lambda: bvd.batch_msm_check(
            static, words, params_t, bbB_t, n, m, lg, wbits),
    }
    print("device half stages (ms): " + json.dumps(
        {k: round(cuda_ms(f, 5), 4) for k, f in stages.items()}), flush=True)

    def width_sweep(tag, pts, scalars, chosen):
        """window_totals (sort, K2, K3) at the widths around msm.best_wbits's
        choice and at 11: the minimum and median of 7 timings of 3 calls
        each, the widths taken in turn, and each stage's time by width."""
        widths = sorted(set(range(max(8, chosen - 2), min(16, chosen + 2) + 1))
                        | {11})
        dws = {w: sm.signed_digits(scalars, w) for w in widths}
        samples = {w: [] for w in widths}
        for _ in range(7):
            for w in widths:
                samples[w].append(cuda_ms(
                    lambda: msm.window_totals(pts, dws[w], w), 3))
        sweep = {w: (min(v), float(np.median(v))) for w, v in samples.items()}
        parts = {}
        for w in widths:
            dw, nbw = dws[w], 1 << (w - 1)
            kw, ow, sw = msm.sort_keys(dw, nbw)
            bw = msm.bucket_accumulate(kw, ow, pts, nbw, sw)
            parts[w] = [round(cuda_ms(f, 5), 4) for f in (
                lambda: msm.sort_keys(dw, nbw),
                lambda: msm.bucket_accumulate(kw, ow, pts, nbw, sw),
                lambda: msm.bucket_fold(bw, dw.shape[1], nbw))]
        print(f"window_totals ms by wbits {tag} (min, median; best_wbits "
              f"picks {chosen}): " + json.dumps(
                  {w: [round(a, 4), round(m, 4)] for w, (a, m) in sweep.items()})
              + f"; the choice's median against 11's: "
              f"{sweep[chosen][1] / sweep[11][1]:.3f}x"
              + "; sort, K2, K3 ms by wbits: " + json.dumps(parts)
              + f" [{smi}]", flush=True)

    width_sweep("nb=1024", points,
                bvd.batch_msm_scalars(params_t, bbB_t, n, m, lg), wbits)

    mark("2 (K1-K4, nb = 1024)")

    # ------------------------------------------------- phase 3: K9-K12
    t = time.perf_counter()
    params4, bbB4_pp, dyn4, _, lg4 = bvd.prepare_batch_inputs(*batch(4096))
    print(f"host inputs for nb=4096: {time.perf_counter() - t:.2f} s",
          flush=True)
    params4_t = to_device(params4, dev)
    bbB4_t = to_device(bvd.sum_bbB(bbB4_pp), dev)
    words4 = to_device(dyn4, dev)
    total4 = static.shape[2] + dyn4.shape[1]
    wbits4 = msm.best_wbits(total4)
    nbk4 = 1 << (wbits4 - 1)
    digits4 = sm.signed_digits(
        bvd.batch_msm_scalars(params4_t, bbB4_t, n, m, lg4), wbits4)
    points4 = torch.cat([words_to_points(static),
                         decompress.ristretto_decode(words4)[0]], dim=2)
    k2_4, k3_4, keys4, offsets4, shift4, buckets4 = k2_k3(
        "nb=4096", points4, digits4, wbits4)
    width_sweep("nb=4096", points4,
                bvd.batch_msm_scalars(params4_t, bbB4_t, n, m, lg4), wbits4)

    rs_keys = np.random.default_rng(2027)

    def k9(tag, raw, lo, hi):
        """K9 sorting raw by bits [lo, hi), against its plain version and
        torch.sort; returns its results and the sorted keys."""
        s_k, s_p = sort.radix_sort(raw, lo, hi), sort.radix_sort_plain(raw, lo,
                                                                       hi)
        s_lib = torch.sort(raw, dim=1).values
        torch.cuda.synchronize()
        require(torch.equal(s_k, s_p) and torch.equal(s_k, s_lib),
                f"K9 differs from its plain version or torch.sort ({tag})")
        v = dict(err=max_abs_err(s_k, s_p),
                 ms=cuda_ms(lambda: sort.radix_sort(raw, lo, hi), 10),
                 dev_ms=device_ms(lambda: sort.radix_sort(raw, lo, hi),
                                  radix_launches(lo, hi), 5),
                 plain_ms=cuda_ms(lambda: sort.radix_sort_plain(raw, lo, hi),
                                  2),
                 lib_ms=cuda_ms(lambda: torch.sort(raw, dim=1), 10),
                 bound=bound_ms(2 * raw.numel() * 8, 0))
        print(f"K9 {tag} ({tuple(raw.shape)} keys, bits [{lo}, {hi}), "
              f"{3 * len(sort.passes(lo, hi))} kernel launches): "
              f"kernel_ms={v['ms']:.4f} device_only_ms={fmt_ms(v['dev_ms'])} "
              f"plain_ms={v['plain_ms']:.3f} library_ms={v['lib_ms']:.4f} "
              f"bound_ms={v['bound'][0]:.5f} ({v['bound'][1]}) "
              f"max_abs_err={v['err']} [{smi}]", flush=True)
        return v, s_k

    def k9_k10(tag, dg, pts, w):
        """K9 and K10 on one MSM's key rows; returns their results."""
        raw, sh = msm.pack_keys(dg)
        k9_res, s_k = k9(tag, raw, sh, sh + 1 + w)
        src = msm.point_rows(pts)
        perm = s_k & ((1 << sh) - 1)
        g_k = gather.gather_words(src, perm)
        g_p = gather.gather_words_plain(src, perm)
        torch.cuda.synchronize()
        require(torch.equal(g_k, g_p), f"K10 differs from its plain version "
                                       f"({tag})")
        k10 = dict(err=max_abs_err(g_k, g_p),
                   ms=cuda_ms(lambda: gather.gather_words(src, perm), 10),
                   dev_ms=device_ms(lambda: gather.gather_words(src, perm),
                                    "gather_words_kernel", 10),
                   plain_ms=cuda_ms(lambda: gather.gather_words_plain(src,
                                                                      perm), 5),
                   lib_ms=cuda_ms(lambda: src[perm], 10),
                   bound=bound_ms(src.numel() * 4 + perm.numel() * 8
                                  + g_k.numel() * 4, 0))
        print(f"K10 {tag} ({tuple(raw.shape)} rows, w = {w}): "
              f"kernel_ms={k10['ms']:.4f} device_only_ms="
              f"{fmt_ms(k10['dev_ms'])} plain_ms={k10['plain_ms']:.3f} "
              f"library_ms={k10['lib_ms']:.4f} "
              f"bound_ms={k10['bound'][0]:.5f} ({k10['bound'][1]}) "
              f"max_abs_err={k10['err']} [{smi}]", flush=True)
        return k9_res, k10

    results["K9"], results["K10"] = k9_k10("nb=1024", digits, points, wbits)
    k9_k10("nb=4096", digits4, points4, wbits4)
    k9("full width", torch.tensor(
        rs_keys.integers(0, 2**63 - 1, size=tuple(digits4.T.shape),
                         dtype=np.int64), device=dev), 0, 63)

    # K11 and K12, K2's levels over K10's gathered word and affine rows:
    # bit for bit against their plain versions and equal to K2's bucket
    # sums as points, on the nb = 1024 MSM (random and equal scalars, w = 11
    # and 12) and the nb = 4096 one
    def k11_k12(tag, pts, ks, offs, sh, nbw, ref, plain=False):
        """K11 and K12 on one sorted MSM; ref are K2's bucket sums there.
        Returns {K11: results, K12: results}, plain_ms timed if plain."""
        perm = ks & ((1 << sh) - 1)
        levels = len(msm.accumulate_levels(pts.shape[2]))
        runs_w = offs[:, 1:] - offs[:, :-1]
        adds = int((runs_w - 1).clamp(min=0).sum())
        loads = int(runs_w.sum())
        res = {}
        for k, kern, twin, prelude, rec, products in (
                ("K11", msm.bucket_accumulate_words,
                 msm.bucket_accumulate_words_plain, msm.point_rows,
                 "WordRecords", adds * ADD),
                ("K12", msm.bucket_accumulate_affine,
                 msm.bucket_accumulate_affine_plain, msm.to_affine_words,
                 "AffineRecords", adds * 8 * MUL + loads * MUL)):
            rows_k = gather.gather_words(prelude(pts), perm)
            b_k = kern(ks, offs, rows_k, nbw, sh)
            b_p = twin(ks, offs, rows_k, nbw, sh)
            torch.cuda.synchronize()
            bw_k, bw_p = points_to_words(b_k), points_to_words(b_p)
            require(torch.equal(b_k, b_p) and torch.equal(bw_k, bw_p),
                    f"{k} differs from its plain version ({tag})")
            require(same_points(b_k, ref),
                    f"{k}'s bucket sums differ from K2's ({tag})")
            v = res[k] = dict(
                err=max_abs_err(bw_k, bw_p),
                ms=cuda_ms(lambda: kern(ks, offs, rows_k, nbw, sh), 20),
                dev_ms=device_ms(lambda: kern(ks, offs, rows_k, nbw, sh),
                                 {rec: 1, "Pieces": levels - 1}, 20),
                plain_ms=cuda_ms(lambda: twin(ks, offs, rows_k, nbw, sh), 2)
                if plain else None,
                lib_ms=None,
                bound=bound_ms(ks.numel() * 8 + offs.numel() * 8
                               + rows_k.numel() * 4 + b_k.numel() * 4,
                               products),
                rows=rows_k)
            print(f"{k} {tag} ({pts.shape[2]} points, {ks.shape[0]} windows "
                  f"x {nbw} buckets): kernel_ms={v['ms']:.4f} "
                  f"device_only_ms={fmt_ms(v['dev_ms'])} "
                  + (f"plain_ms={v['plain_ms']:.2f} " if plain else "")
                  + f"bound_ms={v['bound'][0]:.5f} ({v['bound'][1]}) "
                  f"kernel_launches_per_call={levels} max_abs_err={v['err']} "
                  f"[{smi}]", flush=True)
        return res

    k1112 = k11_k12("nb=1024", points, keys, offsets, shift, nbk, buckets_k,
                    plain=True)
    results["K11"], results["K12"] = k1112["K11"], k1112["K12"]
    k1112_eq = k11_k12("nb=1024 equal scalars", points, keys_eq, offsets_eq,
                       shift_eq, nbk, buckets_eq)
    for k in ("K11", "K12"):
        ratio = k1112_eq[k]["ms"] / results[k]["ms"]
        print(f"{k} skew: equal scalars {k1112_eq[k]['ms']:.4f} ms "
              f"(device-only {fmt_ms(k1112_eq[k]['dev_ms'])}) against random "
              f"{results[k]['ms']:.4f} ({fmt_ms(results[k]['dev_ms'])}): "
              f"{ratio:.3f}x [{smi}]", flush=True)
        require(ratio <= 3, f"{k} on equal scalars takes more than 3x its "
                            "random-digit time")
    k11_k12("nb=4096", points4, keys4, offsets4, shift4, nbk4, buckets4)
    # w = 12: the top window holds no scalar bits, only the carry out of
    # the one below, so half the points fall in its bucket 1
    digits12 = sm.signed_digits(
        bvd.batch_msm_scalars(params_t, bbB_t, n, m, lg), 12)
    keys12, offsets12, shift12 = msm.sort_keys(digits12, 2048)
    k11_k12("nb=1024 w=12", points, keys12, offsets12, shift12, 2048,
            msm.bucket_accumulate(keys12, offsets12, points, 2048, shift12))
    short_scratch(msm, [
        (k, "_level_scratch",
         lambda kern=kern, r=results[k]["rows"]: kern(keys, offsets, r, nbk,
                                                     shift), kern)
        for k, kern in (("K11", msm.bucket_accumulate_words),
                        ("K12", msm.bucket_accumulate_affine))])
    print("config preludes nb=1024 (ms): " + json.dumps({
        "point_rows": round(cuda_ms(lambda: msm.point_rows(points), 5), 4),
        "to_affine_words": round(cuda_ms(lambda: msm.to_affine_words(points),
                                         3), 4)}), flush=True)

    mark("3 (nb = 4096, K9-K12)")

    # ---------------------------------------------------------- phase 4
    kernels = [decompress.ristretto_decode, msm.bucket_accumulate,
               msm.bucket_fold, combine.horner_check, pointwise.seg_combine,
               pointwise.point_add, pointwise.mul, pointwise.add,
               sort.radix_sort, gather.gather_words,
               msm.bucket_accumulate_words, msm.bucket_accumulate_affine,
               msm.small_scan, micro.micro_mul, micro.micro_parts,
               micro.micro_add_chain, micro.micro_add_chain_lanes,
               fixed_base.fixed_base_ct, msm_ct.msm_ct]

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        return [k.launches for k in kernels]

    reset()
    verdicts = {}       # (nb, tamper) -> accepted, for phase 11
    for nb in (1024, 4096):
        timings = {}
        batch_verify(*batch(nb), device=dev, timings=timings)
        verdicts[(nb, None)] = True
        wall = timings["host_s"] + timings["device_s"]
        print(f"nb={nb} accept: host_s={timings['host_s']:.3f} ("
              + ", ".join(f"{k} {timings[k]:.4f}" for k in (
                  "replay_s", "weights_s", "params_s", "words_s"))
              + f") device_s={timings['device_s']:.4f} "
              f"msm_size={timings['msm_size']} "
              f"wbits={timings['wbits']} verifies_per_s={nb / wall:.1f} "
              f"device_only_verifies_per_s={nb / timings['device_s']:.1f} "
              f"[{smi}]", flush=True)
        for tamper in ("t_x", "encoding"):
            try:
                batch_verify(*batch(nb, tamper), device=dev)
                rejected = False
            except VerificationError:
                rejected = True
            require(rejected, f"nb={nb}: the batch with a bad {tamper} was accepted")
            verdicts[(nb, tamper)] = not rejected
            print(f"nb={nb} {tamper} tampered: rejected", flush=True)
    range_path = counts()
    require(all(c > 0 for c in range_path[:4]),
            f"the range-proof path skipped a kernel: {range_path}")
    print(f"range-proof path launches: {range_path}", flush=True)

    mark("4 (range-proof path)")

    # ---------------------------------------------------------- phase 5
    cloak_fx = fixture.load_r1cs(fixture.R1CS_CLOAK)
    range_fx = fixture.load_r1cs(fixture.R1CS_RANGE)
    t = time.perf_counter()
    r1cs_bp = BulletproofGens(range_fx.gens_capacity)   # serves both
    print(f"generators for 2^15 multipliers: {time.perf_counter() - t:.2f} s",
          flush=True)

    # the Cloak MSM exactly as its verify builds it
    dyn_s, dyn_enc, bb, bs, g_v, h_v, padded_n = fixture.r1cs_verifier(
        cloak_fx).verification_job_split_vec(
            R1CSProof.from_bytes(cloak_fx.wire), r1cs_bp, pc)
    static_sc = to_device(scalar_words([bb, bs] + g_v.to_ints()
                                       + h_v.to_ints()), dev)
    dyn_sc = to_device(scalar_words(dyn_s), dev)
    cn = static_sc.shape[0] + dyn_sc.shape[0]
    cw = msm.best_wbits(cn)
    cnb = 1 << (cw - 1)
    c_digits = sm.signed_digits(torch.cat([sm.decode_words_last(static_sc),
                                           sm.decode_words_last(dyn_sc)], 1), cw)
    c_points = torch.cat([
        words_to_points(bvd.static_gens_words(r1cs_bp, pc, padded_n, 1, dev)),
        decompress.ristretto_decode(to_device(encoding_words(dyn_enc), dev))[0]],
        dim=2)
    cnw = c_digits.shape[1]
    print(f"Cloak MSM: {cn} points, route {msm.route(cn)}, wbits {cw}, "
          f"{cnw} windows x {cnb} buckets", flush=True)

    def flat(x):
        return x.reshape(4, F.NL, -1).contiguous()

    # the elementwise K5 and K6 (entry points) at a scan step's and a fold
    # step's shapes: each window's points in sorted order, negated where
    # the digit is, and the flags of run starts
    c_keys, _, c_shift = msm.sort_keys(c_digits, cnb)
    runs = c_points[:, :, c_keys & ((1 << c_shift) - 1)]
    c_neg = ((c_keys >> c_shift) & 1) == 1
    for c in (0, 3):                                        # X and T
        v = runs[c].to(torch.int64)
        runs[c] = F.select(c_neg, F.neg(v), v).to(torch.int32)
    c_mag = c_keys >> (c_shift + 1)
    run_flags = torch.ones((cnw, cn), dtype=torch.int32, device=dev)
    run_flags[:, 1:] = (c_mag[:, 1:] != c_mag[:, :-1]).to(torch.int32)
    p5, q5 = flat(runs[..., :cn - 1]), flat(runs[..., 1:])
    f5 = run_flags[:, 1:].reshape(-1).contiguous()
    p6, q6 = flat(runs[..., :cnb]), flat(runs[..., cnb:2 * cnb])
    rs = np.random.default_rng(2026)
    b7 = 1 << 16
    a7, c7 = (torch.tensor(np.stack([rs.integers(0, 1 << w, b7) for w in F.W]),
                           dtype=torch.int32, device=dev) for _ in range(2))
    checks = {
        "K5": (lambda: pointwise.seg_combine(p5, q5, f5),
               lambda: pointwise.seg_combine_plain(p5, q5, f5),
               bound_ms(f5.numel() * (2 * 160 + 4 + 160),
                        int((f5 == 0).sum()) * ADD), points_to_words),
        "K6": (lambda: pointwise.point_add(p6, q6),
               lambda: pointwise.point_add_plain(p6, q6),
               bound_ms(p6.shape[2] * 3 * 160, p6.shape[2] * ADD),
               points_to_words),
        "K7": (lambda: pointwise.mul(a7, c7), lambda: pointwise.mul_plain(a7, c7),
               bound_ms(b7 * 3 * 40, b7 * MUL), F.freeze),
        "K8": (lambda: pointwise.add(a7, c7), lambda: pointwise.add_plain(a7, c7),
               bound_ms(b7 * 3 * 40, 0), F.freeze),
    }
    kernel_names = {"K5": "seg_combine_kernel", "K6": "point_add_kernel",
                    "K7": "fe_mul_kernel", "K8": "fe_add_kernel"}
    for k, (kern, plain, bound, canon) in checks.items():
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        require(torch.equal(out_k, out_p), f"{k} differs from its plain version")
        ck, cp = canon(out_k.to(torch.int64)), canon(out_p.to(torch.int64))
        require(torch.equal(ck, cp), f"{k} canonical words differ")
        results[k] = dict(err=max_abs_err(ck, cp), ms=cuda_ms(kern, 20),
                          plain_ms=cuda_ms(plain, 2), bound=bound)
        v = results[k]
        dms = device_ms(kern, kernel_names[k], 20)
        print(f"{k}: elements={out_k.shape[-1]} kernel_ms={v['ms']:.4f} "
              f"device_only_ms="
              f"{'not measured' if dms is None else f'{dms:.5f}'} "
              f"plain_ms={v['plain_ms']:.2f} bound_ms={v['bound'][0]:.5f} "
              f"({v['bound'][1]}) max_abs_err={v['err']}", flush=True)

    # K5s and K3, the small route, bit for bit against their plain versions
    def sorted_small(dg):
        keys_s, shift_s = msm.pack_keys(dg)
        return torch.sort(keys_s, dim=1).values.contiguous(), shift_s

    def small_check(tag, pts, dg, w=cw):
        """K5s and K3 against their plain versions on one MSM: limbs and
        canonical words equal; returns (keys, shift, bucket sums, totals,
        max_abs_err)."""
        nbs, nws = 1 << (w - 1), dg.shape[1]
        keys_s, shift_s = sorted_small(dg)
        b_k = msm.small_scan(keys_s, pts, nbs, shift_s)
        b_p = msm.small_scan_plain(keys_s, pts, nbs, shift_s)
        t_k = msm.bucket_fold(b_k, nws, nbs)
        t_p = msm.bucket_fold_plain(b_k, nws, nbs)
        torch.cuda.synchronize()
        words = [points_to_words(x) for x in (b_k, b_p, t_k, t_p)]
        require(torch.equal(b_k, b_p) and torch.equal(words[0], words[1]),
                f"K5s bucket sums differ from the plain version ({tag})")
        require(torch.equal(t_k, t_p) and torch.equal(words[2], words[3]),
                f"K3 totals differ from the plain version ({tag}, "
                f"nb = {nbs})")
        return (keys_s, shift_s, b_k, t_k,
                max(max_abs_err(words[0], words[1]),
                    max_abs_err(words[2], words[3])))

    gens_pts = words_to_points(bvd.static_gens_words(r1cs_bp, pc, 1024, 1, dev))
    small_inputs = {"Cloak": (c_points, c_digits)}
    for nx in (1, 17, 1282, 2048):
        ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(nx)]
        small_inputs[f"n={nx}"] = (gens_pts[:, :, :nx].contiguous(),
                                   sm.signed_digits(sm.ints_to_limbs(ks, dev),
                                                    cw))
    row = int(np.random.default_rng(2029).integers(0, cn))
    small_inputs["Cloak, equal scalars"] = (
        c_points, c_digits[row:row + 1].expand(cn, cnw).contiguous())
    zero_win = c_digits.clone()
    zero_win[:, 5] = 0
    small_inputs["Cloak, window 5 all zero"] = (c_points, zero_win)
    small_err = 0
    for tag, (pts_s, dg_s) in small_inputs.items():
        *_, t_s, err = small_check(tag, pts_s, dg_s)
        require(same_points(t_s, msm.window_totals_large(pts_s, dg_s, cw)),
                f"{tag}: the small route's totals differ from the large "
                "route's")
        small_err = max(small_err, err)
    print(f"K5s and K3 at {', '.join(small_inputs)}: limbs and canonical "
          f"words equal to the plain versions, totals equal to the large "
          f"route's as points [{smi}]", flush=True)

    c_sk, c_ss, c_buckets, c_totals, _ = small_check("Cloak", c_points,
                                                     c_digits)
    c_runs = (torch.searchsorted(c_sk, (torch.arange(1, cnb + 2, device=dev)
                                        << (c_ss + 1)).expand(cnw, cnb + 1)
                                 .contiguous()))
    c_adds = int((c_runs[:, 1:] - c_runs[:, :-1] - 1).clamp(min=0).sum())
    results["K5s"] = dict(
        err=small_err,
        ms=cuda_ms(lambda: msm.small_scan(c_sk, c_points, cnb, c_ss), 20),
        dev_ms=device_ms(lambda: msm.small_scan(c_sk, c_points, cnb, c_ss),
                         "small_scan_kernel", 20),
        plain_ms=cuda_ms(lambda: msm.small_scan_plain(c_sk, c_points, cnb,
                                                      c_ss), 2),
        bound=bound_ms(c_sk.numel() * 8 + c_points.numel() * 4
                       + c_buckets.numel() * 4, c_adds * ADD), lib_ms=None)
    # K3's one-launch fold at the Cloak's nb (a line of its own; the kernels
    # line keeps K3's range-proof shape)
    fold_small = dict(
        err=small_err,
        ms=cuda_ms(lambda: msm.bucket_fold(c_buckets, cnw, cnb), 20),
        dev_ms=device_ms(lambda: msm.bucket_fold(c_buckets, cnw, cnb),
                         "bucket_fold_block_kernel", 20),
        plain_ms=cuda_ms(lambda: msm.bucket_fold_plain(c_buckets, cnw, cnb),
                         2),
        bound=bound_ms(c_buckets.numel() * 4 + c_totals.numel() * 4,
                       cnw * 2 * (cnb - 1) * ADD))
    for k, v, lib in (("K5s", results["K5s"], "small_scan"),
                      ("K3 (one launch)", fold_small, "bucket_fold")):
        regs = [line.split(":", 1)[-1].strip() for line in _build.lib_path(
            lib).with_suffix(".log").read_text().splitlines()
            if "Used" in line]
        adds = c_adds if k == "K5s" else cnw * 2 * (cnb - 1)
        print(f"{k} Cloak ({cn} points, w = {cw}, {cnw} windows x {cnb} "
              f"buckets; {adds} additions): kernel_ms={v['ms']:.4f} "
              f"device_only_ms={fmt_ms(v['dev_ms'])} "
              f"plain_ms={v['plain_ms']:.2f} "
              f"bound_ms={v['bound'][0]:.7f} ({v['bound'][1]}) "
              f"max_abs_err={v['err']} ptxas {regs} [{smi}]", flush=True)

    # the small route's width: K5s + K3 after the sort, w = 6 to 10
    c_lim = torch.cat([sm.decode_words_last(static_sc),
                       sm.decode_words_last(dyn_sc)], 1)
    by_size = {cn: (c_points, c_lim)}
    for nx in (1282, 2048):
        ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(nx)]
        by_size[nx] = (gens_pts[:, :, :nx].contiguous(),
                       sm.ints_to_limbs(ks, dev))
    faster = {}
    for nx, (pts_s, lim_s) in by_size.items():
        dws = {w: sm.signed_digits(lim_s, w) for w in range(6, 11)}
        samples = {w: [] for w in dws}
        for _ in range(7):
            for w, dw in dws.items():
                samples[w].append(cuda_ms(
                    lambda: msm.window_totals_small(pts_s, dw, w), 3))
        sweep = {w: (min(v), float(np.median(v))) for w, v in samples.items()}
        faster[nx] = {w for w, (a, md) in sweep.items()
                      if a < 0.9 * sweep[8][0] and md < 0.9 * sweep[8][1]}
        print(f"small route window_totals ms by wbits at n={nx} (min, "
              f"median of 7 x 3 calls): " + json.dumps(
                  {w: [round(a, 4), round(md, 4)] for w, (a, md) in
                   sweep.items()}) + f" [{smi}]", flush=True)
    better = set.intersection(*faster.values())
    print(f"small route width: {sorted(better) or 'no width'} beats w = 8 by "
          f"more than 10 % in min and median at all three sizes; "
          f"best_wbits keeps {msm.SMALL_WBITS}", flush=True)

    # window_totals_small: K5s and K3 once each, nothing else after the
    # sort (the kernels it runs, less those of the same sort alone), and no
    # host sync (CUDA sync debug mode raises on one)
    reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        msm.window_totals_small(c_points, c_digits, cw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    once = [int(k in (msm.bucket_fold, msm.small_scan)) for k in kernels]
    require(counts() == once,
            f"window_totals_small launched {counts()}, not K5s and K3 once")
    whole, whole_read = launch_counts("whole")
    sort_n, sort_read = launch_counts("sort")
    after = {k: v - sort_n.get(k, 0) for k, v in whole.items()
             if v != sort_n.get(k, 0)}
    require(sum(after.values()) == 2
            and sum(v for k, v in after.items() if "small_scan_kernel" in k) == 1
            and sum(v for k, v in after.items()
                    if "bucket_fold_block_kernel" in k) == 1,
            f"window_totals_small ran other kernels after the sort: {after}")
    print(f"window_totals_small: after the sort {sum(after.values()):g} "
          f"kernel launches a call, K5s and K3 once each (the sort alone: "
          f"{sum(sort_n.values()):g} kernels and copies; traced in child "
          f"processes, the whole call {whole_read}, the sort {sort_read}); "
          f"no host sync (CUDA sync debug mode 'error')", flush=True)

    # the Cloak device half by stage
    c_static = bvd.static_gens_words(r1cs_bp, pc, padded_n, 1, dev)
    c_enc = to_device(encoding_words(dyn_enc), dev)
    stages = {
        "recode": lambda: sm.signed_digits(torch.cat([
            sm.decode_words_last(static_sc), sm.decode_words_last(dyn_sc)], 1),
            cw),
        "K1 decode": lambda: decompress.ristretto_decode(c_enc),
        "pack+sort": lambda: sorted_small(c_digits),
        "K5s": lambda: msm.small_scan(c_sk, c_points, cnb, c_ss),
        "K3 fold": lambda: msm.bucket_fold(c_buckets, cnw, cnb),
        "window_totals_small": lambda: msm.window_totals_small(c_points,
                                                               c_digits, cw),
        "K4": lambda: combine.horner_check(c_totals.unsqueeze(2).contiguous(),
                                           cw),
        "whole split_msm_check": lambda: bvd.split_msm_check(
            c_static, c_enc, static_sc, dyn_sc, cw),
    }
    print("Cloak device half stages (ms): " + json.dumps(
        {k: round(cuda_ms(f, 5), 4) for k, f in stages.items()})
        + f" [{smi}]", flush=True)

    # the route crossover: both routes on the same points and digits
    for nx, (pts_n, lim) in by_size.items():
        w = msm.best_wbits(nx)
        dg = sm.signed_digits(lim, w)
        small = msm.window_totals_small(pts_n, dg, w)
        large = msm.window_totals_large(pts_n, dg, w)
        require(same_points(small, large),
                f"n={nx}: the small and large routes' totals differ")
        dg11 = sm.signed_digits(lim, 11)
        msm_w = combine.horner_fold_plain(small.unsqueeze(2), w)
        msm_11 = combine.horner_fold_plain(
            msm.window_totals_large(pts_n, dg11, 11).unsqueeze(2), 11)
        require(same_points(F.pack_points(msm_w), F.pack_points(msm_11)),
                f"n={nx}: the MSM at w = {w} and w = 11 differ")
        print(f"route crossover n={nx}: small(w={w})_ms="
              f"{cuda_ms(lambda: msm.window_totals_small(pts_n, dg, w), 5):.4f} "
              f"large(w={w})_ms="
              f"{cuda_ms(lambda: msm.window_totals_large(pts_n, dg, w), 5):.4f} "
              f"large(w=11)_ms="
              f"{cuda_ms(lambda: msm.window_totals_large(pts_n, dg11, 11), 5):.4f}"
              f" totals equal [{smi}]", flush=True)

    mark("5 (small route)")

    # ---------------------------------------------------------- phase 6
    configs = {"default": msm.MsmConfig(),
               "gather+sort": msm.MsmConfig(sort=True, gather=True),
               "affine": msm.MsmConfig(affine=True)}

    def check_configs(tag, pts, dg, w, device_half):
        """The three configurations on one MSM: equal window totals (word
        for word for gather + sort, as points for affine), the same
        accepting verdict from device_half(config); prints ms per
        configuration of window_totals and of the whole device half."""
        tot = {c: msm.window_totals(pts, dg, w, cfg)
               for c, cfg in configs.items()}
        require(same_points(tot["gather+sort"], tot["default"]),
                f"{tag}: gather + sort totals differ from the default's")
        require(same_points(tot["affine"], tot["default"]),
                f"{tag}: affine totals differ from the default's")
        verdicts = {c: int(device_half(cfg)) for c, cfg in configs.items()}
        require(set(verdicts.values()) == {1}, f"{tag}: verdicts {verdicts}")
        wt = {c: round(cuda_ms(lambda: msm.window_totals(pts, dg, w, cfg), 3),
                       4) for c, cfg in configs.items()}
        half = {c: round(cuda_ms(lambda: device_half(cfg), 3), 4)
                for c, cfg in configs.items()}
        print(f"configs {tag} ({dg.shape[0]} points, w = {w}): totals equal, "
              f"verdicts {verdicts}; window_totals ms {json.dumps(wt)}; "
              f"device half ms {json.dumps(half)} [{smi}]", flush=True)

    check_configs("range nb=1024", points, digits, wbits,
                  lambda cfg: bvd.batch_msm_check(
                      static, to_device(dyn, dev), params_t, bbB_t, n, m, lg,
                      wbits, cfg))
    check_configs("range nb=4096", points4, digits4, wbits4,
                  lambda cfg: bvd.batch_msm_check(
                      static, words4, params4_t, bbB4_t, n, m, lg4, wbits4,
                      cfg))
    # a non-canonical encoding under every configuration: K1 flags it and
    # decodes the identity (Z = 1), so the affine batch inversion runs on
    for c, cfg in configs.items():
        flag = bvd.batch_msm_check(static, words, params_t, bbB_t, n, m, lg,
                                   wbits, cfg)
        require(int(flag) == 0, f"{c}: the batch with invalid encodings "
                                "was accepted")
    print("configs range nb=1024 with invalid encodings: rejected by all",
          flush=True)
    # the 2^15-multiplier R1CS mega-check as its verify builds it
    r_dyn_s, r_dyn_enc, r_bb, r_bs, r_g, r_h, r_pad = fixture.r1cs_verifier(
        range_fx).verification_job_split_vec(
            R1CSProof.from_bytes(range_fx.wire), r1cs_bp, pc)
    r_static_sc = to_device(np.frombuffer(
        r_bb.to_bytes(32, "little") + r_bs.to_bytes(32, "little") + r_g.buf
        + r_h.buf, np.uint32).reshape(-1, 8), dev)
    r_dyn_sc = to_device(scalar_words([int(x) % L for x in r_dyn_s]), dev)
    r_static = bvd.static_gens_words(r1cs_bp, pc, r_pad, 1, dev)
    r_enc = to_device(encoding_words(r_dyn_enc), dev)
    r_n = r_static_sc.shape[0] + r_dyn_sc.shape[0]
    r_w = msm.best_wbits(r_n)
    r_digits = sm.signed_digits(torch.cat([sm.decode_words_last(r_static_sc),
                                           sm.decode_words_last(r_dyn_sc)], 1),
                                r_w)
    r_points = torch.cat([words_to_points(r_static),
                          decompress.ristretto_decode(r_enc)[0]], dim=2)
    check_configs("r1cs 2^15", r_points, r_digits, r_w,
                  lambda cfg: bvd.split_msm_check(r_static, r_enc, r_static_sc,
                                                  r_dyn_sc, r_w, cfg))

    mark("6 (configurations)")

    # ---------------------------------------------------------- phase 7
    def tampered_encoding(enc: bytes) -> bytes:
        bad = (int.from_bytes(enc, "little") + P).to_bytes(32, "little")
        _, ok = decompress.ristretto_decode(to_device(encoding_words([bad]), dev))
        require(int(ok[0]) == 0, "K1 accepts the non-canonical encoding")
        return bad

    # tampered copies, made (and their encodings checked by K1) before the
    # counts are reset: a proof with t_x + 1, and one with a non-canonical
    # encoding (A_I2 of the Cloak; one value commitment V of the range
    # circuit)
    tampered = {}
    for name, fx in (("cloak4x4_64", cloak_fx), ("range512x64", range_fx)):
        bad_t = R1CSProof.from_bytes(fx.wire)
        bad_t.t_x = (bad_t.t_x + 1) % L
        bad_e = R1CSProof.from_bytes(fx.wire)
        bad_fx = fx
        if fx.circuit == "cloak":
            bad_e.A_I2 = tampered_encoding(bad_e.A_I2)
        else:
            coms = list(fx.commitments)
            coms[len(coms) // 2] = tampered_encoding(coms[len(coms) // 2])
            bad_fx = fixture.R1CSFixture(fx.label, fx.circuit, fx.gens_capacity,
                                         fx.params, coms, fx.wire)
        tampered[name] = (("t_x", bad_t, fx), ("encoding", bad_e, bad_fx))

    reset()
    for name, fx in (("cloak4x4_64", cloak_fx), ("range512x64", range_fx)):
        timings = {}
        # the Cloak through an engine (the seam R1CS verify resolves), the
        # range circuit through a device
        how = ({"engine": TorchEngine(dev)} if fx.circuit == "cloak"
               else {"device": dev})
        before = counts()
        fixture.r1cs_verifier(fx).verify(R1CSProof.from_bytes(fx.wire), pc,
                                         r1cs_bp, timings=timings, **how)
        per_verify = [a - b for a, b in zip(counts(), before)]
        print(f"r1cs {name} accept: host_s={timings['host_s']:.3f} "
              f"device_s={timings['device_s']:.4f} "
              f"msm_size={timings['msm_size']} wbits={timings['wbits']} "
              f"route={timings['route']} launches per verification "
              f"{per_verify} [{smi}]", flush=True)
        if name.startswith("cloak"):
            require(timings["route"] == "small"
                    and per_verify[12] == 1 and per_verify[2] == 1
                    and per_verify[4] == per_verify[5] == 0
                    and msm.bucket_accumulate.launches == 0,
                    "the Cloak verification did not run the small route "
                    f"through K5s and K3 once each: {per_verify}")
        for tamper, proof, f in tampered[name]:
            try:
                fixture.r1cs_verifier(f).verify(proof, pc, r1cs_bp, **how)
                rejected = False
            except VerificationError:
                rejected = True
            require(rejected, f"r1cs {name}: the proof with a bad {tamper} "
                              "was accepted")
            print(f"r1cs {name} {tamper} tampered: rejected", flush=True)
    r1cs_path = counts()
    require(all(r1cs_path[i] > 0 for i in (0, 1, 2, 3, 12))
            and r1cs_path[4] == r1cs_path[5] == 0,
            f"the R1CS path skipped a kernel: {r1cs_path}")
    print(f"R1CS path launches: {r1cs_path}", flush=True)

    mark("7 (R1CS path)")

    # ---------------------------------------------------------- phase 8
    reset()
    pointwise.seg_combine(p5, q5, f5)
    pointwise.point_add(p6, q6)
    pointwise.mul(a7, c7)
    pointwise.add(a7, c7)
    torch.cuda.synchronize()
    entry = counts()
    require(all(entry[i] > 0 for i in (4, 5, 6, 7)),
            f"the entry points did not launch K5-K8: {entry}")

    mark("8 (entry points)")

    # --------------------------------------------------------- phase 8b
    # K13-K16, the field and point micro-kernels: bit for bit against their
    # twins in every form and variant at depth 1 and 8, at B = 4,096 and
    # 4,099 (a partial five-lane group and a partial four-lane warp), on
    # the reference's inputs (random 13-bit limbs, reduced mod p)
    rs8 = np.random.default_rng(2027)

    def micro_inputs(nb8):
        fe = [from_jax_limbs13(micro_bench.rand_limbs(rs8, nb8), dev)
              for _ in range(10)]
        return fe[0], fe[1], torch.stack(fe[2:6]), torch.stack(fe[6:])

    micro_cases = {   # name: (kernel, plain, points?)
        f"K13 {form}": (
            lambda x, y, d, form=form: micro.micro_mul(x, y, d, form),
            micro.micro_mul_plain, False) for form in micro.MUL_FORMS}
    micro_cases.update({
        f"K14 {v}": (lambda x, y, d, v=v: micro.micro_parts(x, y, v, d),
                     lambda x, y, d, v=v: micro.micro_parts_plain(x, y, v, d),
                     False) for v in micro.PARTS})
    micro_cases["K15"] = (micro.micro_add_chain, micro.micro_add_chain_plain,
                          True)
    micro_cases["K16"] = (micro.micro_add_chain_lanes,
                          micro.micro_add_chain_lanes_plain, True)
    for nb8 in (4096, 4099):
        fa, fb, pp, pq = micro_inputs(nb8)
        for name, (kern, plain, pts) in micro_cases.items():
            x, y = (pp, pq) if pts else (fa, fb)
            for depth in (1, 8):
                got, want = kern(x, y, depth), plain(x, y, depth)
                torch.cuda.synchronize()
                require(got.dtype == want.dtype and torch.equal(got, want),
                        f"{name} differs from its plain version at B = "
                        f"{nb8}, depth {depth}")
    print(f"K13-K16: equal to their twins in {len(micro_cases)} forms and "
          "variants at depth 1 and 8, B = 4,096 and 4,099", flush=True)
    # the kernels line's shapes: the reference's B = 2^16, depth 1 (K14 as
    # prod, its products alone), against the twins on the same inputs
    b8 = 1 << 16
    fa, fb, pp, pq = micro_inputs(b8)
    line_cases = {
        "K13": ("K13 thread", fa, fb, bound_ms(b8 * 3 * 40, b8 * MUL)),
        "K14": ("K14 prod", fa, fb, bound_ms(b8 * (80 + 80), b8 * MUL)),
        "K15": ("K15", pp, pq, bound_ms(b8 * 3 * 160, b8 * ADD)),
        "K16": ("K16", pp, pq, bound_ms(b8 * 3 * 160, b8 * ADD))}
    for k, (name, x, y, bound) in line_cases.items():
        kern, plain, _ = micro_cases[name]
        got, want = kern(x, y, 1), plain(x, y, 1)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"{name} differs from its plain version at B = 2^16")
        results[k] = dict(err=max_abs_err(got, want),
                          ms=cuda_ms(lambda: kern(x, y, 1), 20),
                          plain_ms=cuda_ms(lambda: plain(x, y, 1), 2),
                          bound=bound)
        print(f"{k} ({name}, B = 2^16, depth 1): kernel_ms="
              f"{results[k]['ms']:.4f} plain_ms={results[k]['plain_ms']:.2f} "
              f"bound_ms={bound[0]:.5f} ({bound[1]}) "
              f"max_abs_err={results[k]['err']}", flush=True)
    imads = sass_multiplies(_build, "field_micro")
    print("field_micro SASS by function, [wide multiplies (IMAD.WIDE, "
          "IMAD.HI), other IMADs], beside the 100 products of one fe_mul "
          "(20 a lane in lf_mul's five-lane form; 9 multiplications a point "
          "addition): " + json.dumps(imads), flush=True)
    require(all(imads.get(f, [0])[0] >= MUL for f in ("prod_kernel",
                                                      "mul_thread_kernel")),
            f"nvcc dropped products of prod or fe_mul: {imads}")

    # the entry point python -m zkvm_tpu_torch.micro (every variant), with
    # every launch count set to 0: the reference's table at B = 2^16, the
    # saturated rates at B = 2^20, depth 64, one warp's dependent steps
    reset()
    micro_rows = micro_bench.run()
    micro_path = counts()
    require(all(micro_path[i] > 0 for i in (13, 14, 15, 16)),
            f"the micro-benchmark did not launch K13-K16: {micro_path}")

    def micro_row(name, n, depth):
        return next(r for r in micro_rows if r.get("name") == name
                    and r["B"] == n and r["depth"] == depth)

    prod_row = micro_row("parts prod", 1 << 20, 64)
    mul_row = micro_row("mul thread chain", 1 << 20, 64)
    lanes_row = micro_row("mul lanes chain", 1 << 20, 64)
    # the guide's peak of wide products at the SM clock logged after prod
    guide_peak = (WIDE_PRODUCTS_PER_CLOCK_SM * prod_row["sm_mhz"] * 1e6
                  * torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"saturated (B = 2^20, depth 64): products alone, achieved "
          f"{prod_row['rate'] * 1e9:.4g}/s (prod, {prod_row['rate_from']}) "
          f"against the guide's peak {guide_peak:.4g}/s at "
          f"{prod_row['sm_mhz']} MHz; "
          f"fe_mul {mul_row['rate'] * 1e6:.4g}/s, so "
          f"{mul_row['rate'] * 1e6 * MUL:.4g} products/s with their carries "
          f"({mul_row['rate_from']}); lf_mul {lanes_row['rate'] * 1e6:.4g}/s;"
          f" the model PRODUCTS_PER_S = {PRODUCTS_PER_S:.4g} [{smi}]",
          flush=True)
    print("one warp, ns a dependent step: " + json.dumps(
        {r["step"]: round(r["ns_per_step"], 1) for r in micro_rows
         if "step" in r}) + f" [{smi}]", flush=True)

    mark("8b (micro, K13-K16)")

    # ---------------------------------------------------------- phase 9
    # 1,024 proofs, 256 each of m = 1, 2, 4, 8, tiled from the fixtures
    mlabel, mn, mrecords = fixture.load_mixed()
    by_m = {1: [(label, w, v) for w, v in records]}
    for w, v in mrecords:
        by_m.setdefault(len(v), []).append((mlabel, w, v))
    mixed = [by_m[mm][i % len(by_m[mm])] for mm in (1, 2, 4, 8)
             for i in range(256)]
    t = time.perf_counter()
    bp32 = BulletproofGens(mn, 32)
    print(f"generators for m <= 32: {time.perf_counter() - t:.2f} s",
          flush=True)
    victim = 300                                     # an m = 2 proof

    def mixed_batch(tamper=None):
        """batch_verify's arguments for the mixed batch; tamper "t_x" adds
        1 to one t_x, "swap" replaces one T_1 by that proof's T_2 (a valid
        encoding of another point), "invalid" makes one S non-canonical."""
        proofs = [RangeProof.from_bytes(w) for _, w, _ in mixed]
        p = proofs[victim]
        if tamper == "t_x":
            p.t_x = (p.t_x + 1) % L
        elif tamper == "swap":
            p.T_1 = p.T_2
        elif tamper == "invalid":
            p.S = (int.from_bytes(p.S, "little") + P).to_bytes(32, "little")
        return (proofs, bp32, pc, [ProofTranscript(lb) for lb, _, _ in mixed],
                [v for _, _, v in mixed], mn)

    jobs = {}
    for tamper in (None, "t_x", "swap"):
        t = time.perf_counter()
        jobs[tamper] = batch_verification_job(*mixed_batch(tamper))
        print(f"mixed batch host half ({tamper or 'valid'}): "
              f"{time.perf_counter() - t:.2f} s, "
              f"{len(jobs[tamper][1])} points", flush=True)
    require(len(jobs[None][1]) == 24322, "the mixed MSM is not 24,322 points")
    pw, sw = pack_words([p.ep for p in jobs[None][1]], jobs[None][0])
    pw_t, sw_t = to_device(pw, dev), to_device(sw, dev)
    m_w = msm.best_wbits(pw.shape[2])
    config_env = {"default": {},
                  "gather+sort": {"ZKVM_MSM_GATHER": "pallas",
                                  "ZKVM_MSM_SORT": "pallas"},
                  "affine": {"ZKVM_MSM_AFFINE": "1"}}
    switches = ("ZKVM_MSM_SORT", "ZKVM_MSM_GATHER", "ZKVM_MSM_AFFINE")
    saved = {k: os.environ.pop(k) for k in switches if k in os.environ}
    rec32 = by_m[32][0]

    reset()
    timings = {}
    batch_verify(*mixed_batch(), device=dev, timings=timings)
    print(f"mixed batch of 1024 (m = 1, 2, 4, 8) accept: "
          f"host_s={timings['host_s']:.3f} device_s={timings['device_s']:.4f} "
          f"msm_size={timings['msm_size']} wbits={timings['wbits']} "
          f"verifies_per_s={1024 / (timings['host_s'] + timings['device_s']):.1f}"
          f" device_only_verifies_per_s={1024 / timings['device_s']:.1f}"
          f" [{smi}]", flush=True)
    try:
        batch_verify(*mixed_batch("invalid"), device=dev)
        raised = False
    except ValueError:
        raised = True
    require(raised, "the mixed batch with a non-canonical encoding passed "
                    "the host decode")
    print("mixed batch invalid encoding: rejected by the host decode",
          flush=True)
    m_totals = {}
    for c, env in config_env.items():
        os.environ.update(env)
        try:
            eng = TorchEngine(dev)                 # config from the switches
            require(msm.MsmConfig.from_env() == configs[c],
                    f"the switches {env} do not select {c}")
            m_totals[c] = eng.window_totals(*jobs[None])[0]
            split = {}
            t = time.perf_counter()
            require(eng.msm_is_identity(*jobs[None], split),
                    f"mixed batch rejected under {c}")
            dev_s = time.perf_counter() - t - split["pack_s"]
            for tamper in ("t_x", "swap"):
                require(not eng.msm_is_identity(*jobs[tamper]),
                        f"mixed batch with a bad {tamper} accepted under {c}")
        finally:
            for k in env:
                os.environ.pop(k, None)
        print(f"mixed batch under {c}: accept (engine call: pack "
              f"{split['pack_s']:.4f} s, device {dev_s:.4f} s), "
              f"t_x and swapped encoding rejected [{smi}]", flush=True)
    os.environ.update(saved)
    require(same_points(m_totals["gather+sort"], m_totals["default"])
            and same_points(m_totals["affine"], m_totals["default"]),
            "the mixed MSM's totals differ between configurations")
    print("configs mixed batch (24322 points): totals equal", flush=True)

    # one aggregated m = 32 proof (dalek's largest verify_aggregated bench)
    t = time.perf_counter()
    RangeProof.from_bytes(rec32[1]).verify_multiple(
        bp32, pc, ProofTranscript(rec32[0]), rec32[2], mn, device=dev)
    print(f"m = 32 aggregated proof (4156 points) accept: "
          f"{time.perf_counter() - t:.3f} s [{smi}]", flush=True)
    bad32 = RangeProof.from_bytes(rec32[1])
    bad32.t_x = (bad32.t_x + 1) % L
    try:
        bad32.verify_multiple(bp32, pc, ProofTranscript(rec32[0]), rec32[2],
                              mn, device=dev)
        rejected = False
    except VerificationError:
        rejected = True
    require(rejected, "the m = 32 proof with a bad t_x was accepted")
    print("m = 32 t_x tampered: rejected", flush=True)

    # TorchEngine.msm on 4,096 points: sum + (L - 1) sum is the identity
    eng = TorchEngine(dev)
    e_pts = r1cs_bp.G(4096, 1)
    e_ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(4096)]
    t = time.perf_counter()
    e_sum = eng.msm(e_ks, e_pts)
    e_s = time.perf_counter() - t
    require(isinstance(e_sum, RistrettoPoint) and not e_sum.is_identity()
            and eng.msm_is_identity(e_ks + [L - 1], e_pts + [e_sum]),
            "TorchEngine.msm on 4,096 points is wrong")
    print(f"TorchEngine.msm 4096 points: {e_s:.4f} s, checked by "
          f"msm_is_identity [{smi}]", flush=True)
    engine_path = counts()
    require(all(engine_path[i] > 0 for i in (1, 2, 3, 8, 9, 10, 11)),
            f"the engine path skipped a kernel: {engine_path}")
    print(f"engine (mixed/aggregated) path launches: {engine_path}",
          flush=True)
    e_pw, e_sw = (to_device(a, dev) for a in pack_words([p.ep for p in e_pts],
                                                        e_ks))
    width_sweep("engine n=4096", words_to_points(e_pw),
                sm.decode_words_first(e_sw), msm.best_wbits(4096))
    print("mixed batch window_totals ms by configuration (from words): "
          + json.dumps({c: round(cuda_ms(lambda: window_totals_from_words(
              pw_t, sw_t, m_w, cfg), 3), 4) for c, cfg in configs.items()})
          + f" [{smi}]", flush=True)
    mark("9 (engine path)")

    # ---------------------------------------------------------- phase 10
    # the ZkVM transaction path on the committed block
    # (zkvm_tpu_torch/data/txs_block256.bin, made and verified by the JAX
    # package's prover and verifier, whose txids it holds)
    t_phase = time.perf_counter()
    cap, tx_recs = fixture.load_txs()
    t = time.perf_counter()
    tx_bp = BulletproofGens(cap)
    bvd.static_gens_words(tx_bp, pc, cap, 1, dev)   # resident G/H columns
    print(f"tx generators (capacity {cap}) and their resident words: "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    block = tx_recs[:256]
    block_txs = [Tx.from_bytes(r.wire) for r in block]
    block_ids = [r.txid for r in block]

    def rejected(fn, what):
        """fn() must raise a verifier's rejection (a device error is not
        one, and fails the run); -> its type and message."""
        try:
            fn()
        except (ProofError, VMError, ValueError) as e:
            return f"{type(e).__name__}: {e}"
        raise RuntimeError(f"chip smoke failed: {what} was accepted")

    def tampered_block(i, part="proof"):
        bad = list(block_txs)
        bad[i] = Tx.from_bytes(fixture.tampered_tx(block[i].wire, part))
        return bad

    reset()
    # verify_tx on one issue, one payment and each coverage transaction,
    # each also with a flipped proof byte and a flipped signature byte
    for rec in [block[0], block[192]] + tx_recs[256:]:
        timings = {}
        vtx = verify_tx(Tx.from_bytes(rec.wire), tx_bp, device=dev,
                        timings=timings)
        require(vtx.id == rec.txid, f"verify_tx {rec.kind}: txid differs "
                                    "from the JAX verifier's")
        wall = (timings["host_s"] + timings["device_s"]
                + timings["aggregated_key_s"])
        print(f"verify_tx {rec.kind} accept: host_s={timings['host_s']:.4f} "
              f"device_s={timings['device_s']:.4f} "
              f"aggregated_key_s={timings['aggregated_key_s']:.4f} "
              f"msm_size={timings['msm_size']} tx_per_s={1 / wall:.1f} "
              f"[{smi}]", flush=True)
        for part in ("proof", "signature"):
            why = rejected(lambda: verify_tx(
                Tx.from_bytes(fixture.tampered_tx(rec.wire, part)), tx_bp,
                device=dev), f"verify_tx {rec.kind} with a flipped {part} byte")
            print(f"verify_tx {rec.kind} {part} tampered: {why}", flush=True)

    # the fused block: one MSM for the 256 transactions
    timings = {}
    ids = [v.id for v in fused_verify_tx_batch(block_txs, tx_bp, device=dev,
                                               timings=timings)]
    require(ids == block_ids, "the fused block's txids differ from the "
                              "JAX verifier's")
    wall = timings["host_s"] + timings["device_s"] + timings["aggregated_key_s"]
    require(timings["aggregated_keys"] == 256 and timings["route"] == "large",
            f"the fused block's shape: {timings}")
    print(f"fused block of 256 accept: host_s={timings['host_s']:.3f} "
          f"device_s={timings['device_s']:.4f} aggregated_key_s="
          f"{timings['aggregated_key_s']:.3f} ({timings['aggregated_keys']} "
          f"MSMs, {1e3 * timings['aggregated_key_s'] / 256:.3f} ms each) "
          f"msm_size={timings['msm_size']} wbits={timings['wbits']} "
          f"route={timings['route']} tx_per_s={256 / wall:.1f} "
          f"device_only_tx_per_s={256 / timings['device_s']:.1f} [{smi}]",
          flush=True)
    why = rejected(lambda: fused_verify_tx_batch(tampered_block(3), tx_bp,
                                                 device=dev),
                   "the fused block with tx 3's proof tampered")
    require("(tx 3)" in why, f"the attribution did not name tx 3: {why}")
    print(f"fused block, tx 3 tampered, attribution on: {why}", flush=True)
    why = rejected(lambda: fused_verify_tx_batch(
        tampered_block(255), tx_bp, attribute_failures=False, device=dev),
        "the fused block with tx 255's proof tampered")
    print(f"fused block, tx 255 tampered, attribution off: {why}", flush=True)

    # job by job: one MSM per transaction and one for every point op
    t = time.perf_counter()
    ids = [v.id for v in verify_tx_batch(block_txs, tx_bp, device=dev)]
    require(ids == block_ids, "verify_tx_batch's txids differ")
    print(f"verify_tx_batch of 256 accept: {time.perf_counter() - t:.3f} s "
          f"[{smi}]", flush=True)
    for i in (3, 255):
        why = rejected(lambda: verify_tx_batch(tampered_block(i), tx_bp,
                                               device=dev),
                       f"verify_tx_batch with tx {i}'s proof tampered")
        require(f"(job {i})" in why, f"verify_tx_batch did not name job {i}")
        print(f"verify_tx_batch, tx {i} tampered: {why}", flush=True)

    # the fused block under the other two MSM configurations: one replay
    # of the block (_chunk_precompute), then its split check under each
    t = time.perf_counter()
    vts, head, g_buf, h_buf, dyn_s, dyn_enc = _chunk_precompute(
        [tx.to_bytes() for tx in block_txs], tx_bp, os.urandom(32),
        TorchEngine(dev))
    require([v.id for v in vts] == block_ids, "the block's replay: txids")
    static_buf = (head[0].to_bytes(32, "little")
                  + head[1].to_bytes(32, "little") + g_buf + h_buf)
    print(f"the block's replay for the configurations: "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    for c in ("gather+sort", "affine"):
        tm = {}
        require(bvd.fused_split_check(static_buf, dyn_s, dyn_enc, tx_bp, pc,
                                      dev, tm, configs[c]),
                f"the fused block under {c} rejected")
        print(f"fused block under {c}: accept, host_s={tm['host_s']:.3f} "
              f"device_s={tm['device_s']:.4f} [{smi}]", flush=True)
    tx_path = counts()
    require(all(tx_path[i] > 0 for i in (0, 1, 2, 3, 12)),
            f"the tx path skipped a kernel: {tx_path}")
    print(f"tx path launches: {tx_path}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    # one aggregated_key round trip (TorchEngine.msm, two keys) by stage,
    # outside the counted run: the window totals on the card
    # (synchronised), then their fetch and Horner's rule in host Python
    # (frontend.combine_window_totals)
    ak_eng, ak_pts = TorchEngine(dev), tx_bp.G(2, 1)
    ak_ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in ak_pts]
    t = time.perf_counter()
    for _ in range(20):
        ak_totals, ak_w = ak_eng.window_totals(ak_ks, ak_pts)
        torch.cuda.synchronize()
    ak_card = (time.perf_counter() - t) / 20
    t = time.perf_counter()
    for _ in range(20):
        combine_window_totals(ak_totals, ak_w)
    ak_host = (time.perf_counter() - t) / 20
    print(f"aggregated_key MSM (2 points, w = {ak_w}) by stage, mean of 20: "
          f"window totals on the card {1e3 * ak_card:.3f} ms, fetch + host "
          f"Horner {1e3 * ak_host:.3f} ms [{smi}]", flush=True)
    mark("10 (tx path)")

    # --------------------------------------------------------- phase 10b
    prove_path = prove_phase(smi, dev, bp32, pc, reset, counts)
    mark("10b (prove path)")

    # --------------------------------------------------------- phase 10c
    r1cs_prove_path = r1cs_prove_phase(smi, dev, r1cs_bp, pc, reset, counts)
    mark("10c (R1CS prove path)")

    # --------------------------------------------------------- phase 10d
    ct_results, ct_path = ct_phase(smi, dev, r1cs_bp, pc, reset, counts)
    results.update(ct_results)
    mark("10d (constant-time routes, K17 and K18)")

    # --------------------------------------------------------- phase 10e
    keys_path = keys_phase(smi, dev, bp32, pc, reset, counts)
    mark("10e (keytree, taproot, multi-host MPC)")

    # ---------------------------------------------------------- phase 11
    pipe_path = pipeline_phase(smi, dev, bp, pc, n, batch, verdicts, r1cs_bp,
                               reset, counts)
    mark("11 (pipelined serving path)")

    # ---------------------------------------------------------- phase 12
    node_path = node_phase(smi, dev, tx_bp, reset, counts)
    launches = [sum(c) for c in zip(range_path, r1cs_path, entry, micro_path,
                                    engine_path, tx_path, prove_path,
                                    r1cs_prove_path, ct_path, keys_path,
                                    pipe_path, node_path)]
    require(all(c > 0 for c in launches), f"a kernel never launched: {launches}")
    mark("12 (node, chain, CLI)")

    # ---------------------------------------------------------- phase 13
    table = [  # key, name, source, replaced TPU kernel(s)
        ("K1", "ristretto_decode", "decompress.cu",
         "zkvm_tpu/kernels/pallas_decompress.py:207"),
        ("K2", "bucket_accumulate", "bucket_accumulate.cu",
         "zkvm_tpu/kernels/pallas_msm.py:361; zkvm_tpu/kernels/pallas_msm.py:411;"
         " zkvm_tpu/kernels/pallas_msm.py:103"),
        ("K3", "bucket_fold", "bucket_fold.cu",
         "zkvm_tpu/kernels/pallas_msm.py:471; zkvm_tpu/kernels/pallas_msm.py:497"),
        ("K4", "horner_check", "horner_check.cu",
         "zkvm_tpu/kernels/pallas_msm.py:1411"),
        ("K5", "seg_combine", "seg_combine.cu",
         "zkvm_tpu/kernels/pallas_msm.py:89"),
        ("K6", "point_add", "point_add.cu",
         "zkvm_tpu/kernels/pallas_field.py:155; zkvm_tpu/kernels/pallas_msm.py:103"
         " (point_add_lm)"),
        ("K7", "fe_mul", "fe_mul.cu",
         "zkvm_tpu/kernels/pallas_field.py:104 (entry point, on no verify path)"),
        ("K8", "fe_add", "fe_add.cu",
         "zkvm_tpu/kernels/pallas_field.py:129 (entry point, on no verify path)"),
        ("K9", "radix_sort", "radix_sort.cu",
         "zkvm_tpu/kernels/pallas_msm.py:629"),
        ("K10", "gather_words", "gather_words.cu",
         "zkvm_tpu/kernels/pallas_msm.py:773; zkvm_tpu/kernels/pallas_msm.py:794"),
        ("K11", "bucket_accumulate_words", "bucket_accumulate.cu",
         "zkvm_tpu/kernels/pallas_msm.py:824"),
        ("K12", "bucket_accumulate_affine", "bucket_accumulate.cu",
         "zkvm_tpu/kernels/pallas_msm.py:952"),
        ("K5s", "small_scan", "small_scan.cu",
         "zkvm_tpu/kernels/pallas_msm.py:89 (seg_combine_lm in _bucket_totals'"
         " associative_scan, :252-307)"),
        ("K13", "micro_mul", "field_micro.cu",
         "bench/pallas_micro.py:97 (_pallas_binop: pf._mul_kernel, "
         "_mul_kernel_roll, _chain_kernel_factory)"),
        ("K14", "micro_parts", "field_micro.cu",
         "bench/pallas_micro.py:202 (_pallas_binop_planes: the raw, prod, "
         "carry, mul and chain planes kernels)"),
        ("K15", "micro_add_chain", "field_micro.cu",
         "bench/pallas_micro.py:290 (_make_add_chain_planes)"),
        ("K16", "micro_add_chain_lanes", "field_micro.cu",
         "bench/pallas_micro.py:338 (_make_add_chain)"),
        ("K17", "fixed_base_ct", "fixed_base.cu",
         "zkvm_tpu/native/edwards255.cpp:462-514 (ed_fixed_init, "
         "ed_fixed_mul, ed_fixed_commit_batch; no Pallas kernel)"),
        ("K18", "msm_ct", "msm_ct.cu",
         "zkvm_tpu/native/edwards255.cpp:287 (ed_msm with ct = 1) and "
         ":413-460 (ed_bit_commit); no Pallas kernel"),
    ]
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"zkvm_tpu_torch/kernels/csrc/{src}", "replaces": rep,
         "launches": cnt, "max_abs_err": results[key]["err"],
         "ms": results[key]["ms"], "plain_ms": results[key]["plain_ms"],
         "bound_ms": results[key]["bound"][0],
         "bound_by": results[key]["bound"][1],
         "library_ms": results[key].get("lib_ms")}
        for (key, name, src, rep), cnt in zip(table, launches)]}
    # each kernel's share of its bound (bound ms / event ms) under the
    # modelled products rate and under the guide's peak at the logged clock
    # (phase 8b; K14 prod's achieved rate is not a peak)
    print(f"shares of the bound, modelled {PRODUCTS_PER_S:.4g} / guide's "
          f"peak {guide_peak:.4g} products/s [{smi}]: " + json.dumps({
              key: [round(results[key]["ms"], 5),
                    round(results[key]["bound"][0] / results[key]["ms"], 4),
                    round(bound_ms(*results[key]["bound"][2:], guide_peak)[0]
                          / results[key]["ms"], 4)]
              for key, *_ in table}), flush=True)
    print("phase seconds: " + json.dumps(phase_s)
          + f"; in all {sum(phase_s.values()):.1f} s", flush=True)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
