"""Drives the PyTorch/CUDA port on one NVIDIA card end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the thirteen CUDA
   kernels (K1 ristretto_decode, K2 bucket_accumulate, K3 bucket_fold, K4
   horner_check, K5 seg_combine, K6 point_add, K7 fe_mul, K8 fe_add, K9
   radix_sort, K10 gather_words, K11 bucket_accumulate_words, K12
   bucket_accumulate_affine, and the small route's K5s small_scan) from
   kernels/csrc, one nvcc per source in parallel (K11 and K12 are entries
   of K2's source), and prints the build time and each kernel function's
   ptxas registers and spills;
2. holds K1-K4 against their plain PyTorch versions on the card at the
   range-proof path's shapes (nb = 1024 proofs of 64 bits, m = 1), words
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
   no other kernel after the sort (torch.profiler, in a child process:
   python3 chip_smoke.py --launch-check), with no host sync (CUDA sync
   debug mode); and prints the route crossover (both routes on the same
   inputs at 1,055, 1,282 and 2,048 points, totals equal);
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
   off; verify_tx_batch job by job with the same verdicts; and the fused
   block under the sort + gather and affine configurations; prints
   host_s, device_s, tx/s and the MSM's size, width and route;
11. prints the kernels line (every launch count must be > 0) and, last,
   the device line.

Range proofs come from the committed fixtures in zkvm_tpu_torch/data,
tiled to the batch size; each copy gets its own random weight, so the MSM
is full size with real points and distinct digits.  Exits non-zero on any
failure, and without a CUDA device.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
# 32x32->64 integer products per second.  The H100 SXM has no published
# integer rate outside the tensor cores; its fp32 rate (67 TFLOP/s,
# 33.5e12 multiply-adds/s) bounds 32-bit multiply-adds, and a 64-bit
# product takes two (its low and high halves).
PRODUCTS_PER_S = 67e12 / 2 / 2
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


def bound_ms(nbytes, products):
    by_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    by_ops = products / PRODUCTS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


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


def kernel_counts(fn, reps=5, traces=4):
    """Kernels (and copies) fn() runs on the card per call, by name, from
    traces of reps calls each.  A trace can drop kernel events, at its
    start as well as at its end, so each trace is bracketed by two marker
    kernels (torch.cuda._sleep's spin_kernel) and kept only if both are in
    it, and each name keeps its largest count over the kept traces: a trace
    drops events but never adds one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best, kept = {}, 0
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        rows = {e.key: e.count for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0}
        if sum(v for k, v in rows.items() if "spin_kernel" in k) != 2:
            continue
        kept += 1
        for k, v in rows.items():
            if "spin_kernel" not in k:
                best[k] = max(best.get(k, 0), v)
    if not kept:
        raise RuntimeError(f"chip smoke failed: {traces} traces, none with "
                           "both its marker kernels")
    return {k: v / reps for k, v in best.items()}


def launch_check():
    """python3 chip_smoke.py --launch-check, run by main() as a child
    process: the kernels window_totals_small runs per call after its sort
    (its trace less that of the sort alone) on a 1,055-point MSM at w = 8,
    the Cloak's shape, printed as one JSON line with the sort's count.  A
    fresh process, because the traces of a long one drop kernel events."""
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

    whole = kernel_counts(lambda: msm.window_totals_small(pts, digits, 8))
    sort_n = kernel_counts(sort_only)
    after = {k: v - sort_n.get(k, 0) for k, v in whole.items()
             if v != sort_n.get(k, 0)}
    print(json.dumps([after, sum(sort_n.values())]))
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:] == ["--launch-check"]:
        return launch_check()
    from zkvm_tpu_torch import fixture
    from zkvm_tpu_torch.kernels import (_build, combine, decompress, gather,
                                        msm, pointwise, sort)
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
    from zkvm_tpu_torch.parallel.tx_batch import (fused_verify_tx_batch,
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
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} kernels "
          f"{sorted(built)} (parallel nvcc)", flush=True)
    for src in dict.fromkeys(map(_build.source, _build.SIGNATURES)):
        for fn, regs in ptxas_report(_build, src):
            print(f"  ptxas {src} {fn}: {regs}")
    dev = torch.device("cuda")

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
    params, bbB_pp, dyn, m, lg = bvd.prepare_batch_inputs(*batch(nb))
    print(f"host inputs for nb={nb}: {time.perf_counter() - t:.2f} s", flush=True)
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
    def short_scratch(cases):
        """cases: (name, the msm scratch size helper, call, wrapper).  Each
        call runs with its helper made one element short; each must raise
        that the scratch is short, its wrapper counting no launch."""
        refused = []
        for name, attr, call, fn in cases:
            real, before = getattr(msm, attr), fn.launches
            setattr(msm, attr, lambda *a, real=real: real(*a) - 1)
            try:
                call()
                torch.cuda.synchronize()
            except RuntimeError as e:
                if "scratch" in str(e) and fn.launches == before:
                    refused.append(name)
            finally:
                setattr(msm, attr, real)
        names = [c[0] for c in cases]
        require(refused == names, f"a scratch one element short was not "
                                  f"refused: {refused} of {names}")
        print(f"{', '.join(names)} with a scratch one element short: "
              f"refused, nothing launched", flush=True)

    short_scratch([
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
    short_scratch([
        (k, "_level_scratch",
         lambda kern=kern, r=results[k]["rows"]: kern(keys, offsets, r, nbk,
                                                     shift), kern)
        for k, kern in (("K11", msm.bucket_accumulate_words),
                        ("K12", msm.bucket_accumulate_affine))])
    print("config preludes nb=1024 (ms): " + json.dumps({
        "point_rows": round(cuda_ms(lambda: msm.point_rows(points), 5), 4),
        "to_affine_words": round(cuda_ms(lambda: msm.to_affine_words(points),
                                         3), 4)}), flush=True)

    # ---------------------------------------------------------- phase 4
    kernels = [decompress.ristretto_decode, msm.bucket_accumulate,
               msm.bucket_fold, combine.horner_check, pointwise.seg_combine,
               pointwise.point_add, pointwise.mul, pointwise.add,
               sort.radix_sort, gather.gather_words,
               msm.bucket_accumulate_words, msm.bucket_accumulate_affine,
               msm.small_scan]

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        return [k.launches for k in kernels]

    reset()
    for nb in (1024, 4096):
        timings = {}
        batch_verify(*batch(nb), device=dev, timings=timings)
        wall = timings["host_s"] + timings["device_s"]
        print(f"nb={nb} accept: host_s={timings['host_s']:.3f} "
              f"device_s={timings['device_s']:.4f} msm_size={timings['msm_size']} "
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
            print(f"nb={nb} {tamper} tampered: rejected", flush=True)
    range_path = counts()
    require(all(c > 0 for c in range_path[:4]),
            f"the range-proof path skipped a kernel: {range_path}")
    print(f"range-proof path launches: {range_path}", flush=True)

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
    require(counts() == [0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1],
            f"window_totals_small launched {counts()}, not K5s and K3 once")
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--launch-check"], capture_output=True, text=True,
                           timeout=600)
    require(child.returncode == 0,
            f"the launch check failed: {child.stderr[-2000:]}")
    after, sort_n = json.loads(child.stdout.strip().splitlines()[-1])
    require(sum(after.values()) == 2
            and sum(v for k, v in after.items() if "small_scan_kernel" in k) == 1
            and sum(v for k, v in after.items()
                    if "bucket_fold_block_kernel" in k) == 1,
            f"window_totals_small ran other kernels after the sort: {after}")
    print(f"window_totals_small: after the sort {sum(after.values()):g} "
          f"kernel launches a call, K5s and K3 once each (the sort alone: "
          f"{sort_n:g} kernels and copies; traced in a child process); no "
          f"host sync (CUDA sync debug mode 'error')", flush=True)

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

    # the fused block under the other two MSM configurations
    for c in ("gather+sort", "affine"):
        tm = {}
        ids = [v.id for v in fused_verify_tx_batch(
            block_txs, tx_bp, engine=TorchEngine(dev, config=configs[c]),
            timings=tm)]
        require(ids == block_ids, f"the fused block under {c} rejected")
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
    launches = [sum(c) for c in zip(range_path, r1cs_path, entry, engine_path,
                                    tx_path)]
    require(all(c > 0 for c in launches), f"a kernel never launched: {launches}")

    # ---------------------------------------------------------- phase 11
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
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
