"""Drives the PyTorch/CUDA port on one NVIDIA card end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the twelve CUDA kernels
   (K1 ristretto_decode, K2 bucket_accumulate, K3 bucket_fold, K4
   horner_check, K5 seg_combine, K6 point_add, K7 fe_mul, K8 fe_add, K9
   radix_sort, K10 gather_words, K11 bucket_accumulate_words, K12
   bucket_accumulate_affine) from kernels/csrc, one nvcc each in parallel,
   and prints the build time and each kernel's ptxas registers and spills;
2. holds K1-K4 against their plain PyTorch versions on the card at the
   range-proof path's shapes (nb = 1024 proofs of 64 bits, m = 1), words
   and flags exactly equal, and times both (CUDA events and the
   profiler's device time); K4's verdict and folded point (also in
   canonical words) on the batch's totals, which sum to the identity, and
   on those of the same MSM with one digit raised by one, which sum to
   that digit's point;
3. holds K9 and K10 against their plain versions on the key rows of the
   nb = 1024 and nb = 4096 batches' MSMs (K9 sorting the (|digit|, sign)
   bits, equal also to torch.sort), K9 at full width on random 63-bit
   keys of the nb = 4096 shape, and K11 and K12 on the nb = 1024 MSM (K11
   also word for word against K2, K12 as points), and times them beside
   torch.sort (K9) and torch indexing (K10);
4. with every launch count set to 0, runs the range-proof path through its
   entry point zkvm_tpu_torch.proofs.rangeproof.batch_verify at nb = 1024
   and nb = 4096: a valid batch must accept, a batch with one t_x changed
   and one with a non-canonical point encoding must reject;
5. holds K5 and K6 against their plain versions at the shapes of the
   Cloak verification's small-route MSM (its first scan step and its
   bucket fold), K7 and K8 at 2^16 elements, and window_totals_small
   against window_totals_large at n = 1,282 and 2,048 (the route
   crossover), and times them;
6. runs the bucket pipeline's three configurations (msm.MsmConfig: the
   default, sort + gather, affine) on the fused nb = 1024 and nb = 4096
   device halves and the 2^15-multiplier R1CS split check: equal window
   totals as points and the same verdict, with a non-canonical encoding
   rejected under the affine configuration too;
7. with every launch count set to 0, runs R1CS verification through
   zkvm_tpu_torch.proofs.r1cs.Verifier.verify on the two committed
   fixtures (a Cloak 4x4 with 64-bit values, on the small route, and 512
   64-bit range gadgets, 2^15 multipliers, on K2/K3): the valid proof must
   accept, a proof with t_x + 1 and one with a non-canonical encoding
   (which K1 must flag) must raise VerificationError;
8. with every launch count set to 0, calls the field entry points
   pointwise.mul and pointwise.add (K7, K8; on no verify path);
9. with every launch count set to 0, runs the engine path
   (kernels/engine.py TorchEngine): a batch of 1,024 proofs of mixed
   aggregation (256 each of m = 1, 2, 4, 8) through batch_verify, then
   the same host-assembled MSM (24,322 points) under each configuration,
   selected by the JAX package's switches (ZKVM_MSM_SORT, ZKVM_MSM_GATHER,
   ZKVM_MSM_AFFINE): equal totals, accept, and reject a batch with one t_x
   changed and one with an encoding swapped for another point's; a
   non-canonical encoding must raise on the host decode; one aggregated
   m = 32 proof through verify_multiple (accepted, its t_x + 1 copy
   rejected); TorchEngine.msm on 4,096 points, checked by msm_is_identity;
10. prints the kernels line (every launch count must be > 0) and, last,
   the device line.

Range proofs come from the committed fixtures in zkvm_tpu_torch/data,
tiled to the batch size; each copy gets its own random weight, so the MSM
is full size with real points and distinct digits.  Exits non-zero on any
failure, and without a CUDA device.
"""

import json
import math
import os
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


def main():
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zkvm_tpu_torch import fixture
    from zkvm_tpu_torch.kernels import (_build, combine, decompress, gather,
                                        msm, pointwise, sort)
    from zkvm_tpu_torch.kernels import batch_verify_device as bvd
    from zkvm_tpu_torch.kernels import field as F
    from zkvm_tpu_torch.kernels import scalarmod as sm
    from zkvm_tpu_torch.kernels.engine import TorchEngine
    from zkvm_tpu_torch.kernels.frontend import (pack_words,
                                                 window_totals_from_words)
    from zkvm_tpu_torch.kernels.words import (encoding_words, points_to_words,
                                              scalar_words, to_device,
                                              words_to_points)
    from zkvm_tpu_torch.constants import L, P
    from zkvm_tpu_torch.oracle.ristretto import RistrettoPoint
    from zkvm_tpu_torch.proofs.errors import VerificationError
    from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
    from zkvm_tpu_torch.proofs.r1cs import R1CSProof
    from zkvm_tpu_torch.proofs.rangeproof import (RangeProof, batch_verify,
                                                  batch_verification_job)
    from zkvm_tpu_torch.proofs.transcript import ProofTranscript

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} kernels "
          f"{sorted(built)} (parallel nvcc)", flush=True)
    for name in _build.SIGNATURES:
        for line in _build.lib_path(name).with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
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
    pts_k, ok_k = decompress.ristretto_decode(words)
    pts_p, ok_p = decompress.ristretto_decode_plain(words)
    torch.cuda.synchronize()
    require(torch.equal(ok_k, ok_p), "K1 ok flags differ from the plain version")
    require(torch.equal(points_to_words(pts_k), points_to_words(pts_p)),
            "K1 points differ from the plain version")
    require(int(ok_k.sum()) == words.shape[1] - len(bad_cols)
            and all(int(ok_k[c]) == 0 for c in bad_cols),
            "K1 flags the wrong encodings")
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
    keys, offsets, shift = msm.sort_keys(digits, nbk)
    nw = digits.shape[1]
    buckets_k = msm.bucket_accumulate(keys, offsets, points, nbk, shift)
    buckets_p = msm.bucket_accumulate_plain(keys, offsets, points, nbk, shift)
    torch.cuda.synchronize()
    bw_k, bw_p = points_to_words(buckets_k), points_to_words(buckets_p)
    require(torch.equal(bw_k, bw_p), "K2 buckets differ from the plain version")
    runs = offsets[:, 1:] - offsets[:, :-1]
    k2_adds = int((runs - 1).clamp(min=0).sum())
    results["K2"] = dict(
        err=max_abs_err(bw_k, bw_p),
        ms=cuda_ms(lambda: msm.bucket_accumulate(keys, offsets, points, nbk,
                                                 shift), 20),
        plain_ms=cuda_ms(lambda: msm.bucket_accumulate_plain(
            keys, offsets, points, nbk, shift), 2),
        bound=bound_ms(keys.numel() * 8 + offsets.numel() * 8
                       + points.numel() * 4 + buckets_k.numel() * 4,
                       k2_adds * ADD))

    totals_k = msm.bucket_fold(buckets_k, nw, nbk)
    totals_p = msm.bucket_fold_plain(buckets_k, nw, nbk)
    torch.cuda.synchronize()
    tw_k, tw_p = points_to_words(totals_k), points_to_words(totals_p)
    require(torch.equal(tw_k, tw_p), "K3 totals differ from the plain version")
    lanes = msm.fold_lanes(nbk)
    r = nbk // lanes
    k3_adds = nw * (2 * nbk + sum(lanes - (1 << j)
                                  for j in range(int(math.log2(lanes))))
                    + 2 * (lanes - 1) + 1)
    results["K3"] = dict(
        err=max_abs_err(tw_k, tw_p),
        ms=cuda_ms(lambda: msm.bucket_fold(buckets_k, nw, nbk), 20),
        plain_ms=cuda_ms(lambda: msm.bucket_fold_plain(buckets_k, nw, nbk), 2),
        bound=bound_ms(buckets_k.numel() * 4 + totals_k.numel() * 4,
                       k3_adds * ADD + nw * int(math.log2(r)) * DBL))

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
            "K2": (lambda: msm.bucket_accumulate(keys, offsets, points, nbk,
                                                 shift),
                   "bucket_accumulate_kernel"),
            "K3": (lambda: msm.bucket_fold(buckets_k, nw, nbk),
                   "bucket_fold_kernel"),
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
    k4_dev = results["K4"]["dev_ms"]
    print(f"K4 chain: {k4_levels} dependent field multiplications (a "
          f"one-thread chain runs {k4_muls} in a row); per level "
          f"{results['K4']['ms'] / k4_levels * 1e3:.5f} us by events, "
          f"{fmt_ms(None if k4_dev is None else k4_dev / k4_levels * 1e3)} us "
          f"device-only [{smi}]", flush=True)

    # stages of the device half at this shape, and window widths around
    # the cost model's choice (sort + K2 + K3 per width)
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
    sweep = {}
    for w in range(max(8, wbits - 2), min(16, wbits + 2) + 1):
        dw = sm.signed_digits(bvd.batch_msm_scalars(params_t, bbB_t, n, m, lg), w)
        sweep[w] = round(cuda_ms(lambda: msm.window_totals(points, dw, w), 5), 4)
    print(f"window_totals ms by wbits (model picks {wbits}): "
          + json.dumps(sweep), flush=True)

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
    digits4 = sm.signed_digits(
        bvd.batch_msm_scalars(params4_t, bbB4_t, n, m, lg4), wbits4)
    points4 = torch.cat([words_to_points(static),
                         decompress.ristretto_decode(words4)[0]], dim=2)

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

    # K11 and K12 on the nb = 1024 MSM, against their plain versions and K2
    perm = keys & ((1 << shift) - 1)
    rows = gather.gather_words(msm.point_rows(points), perm)
    arows = gather.gather_words(msm.to_affine_words(points), perm)
    b11 = msm.bucket_accumulate_words(keys, offsets, rows, nbk, shift)
    b11_p = msm.bucket_accumulate_words_plain(keys, offsets, rows, nbk, shift)
    b12 = msm.bucket_accumulate_affine(keys, offsets, arows, nbk, shift)
    b12_p = msm.bucket_accumulate_affine_plain(keys, offsets, arows, nbk, shift)
    torch.cuda.synchronize()
    w11, w11_p = points_to_words(b11), points_to_words(b11_p)
    w12, w12_p = points_to_words(b12), points_to_words(b12_p)
    require(torch.equal(w11, w11_p), "K11 differs from its plain version")
    require(torch.equal(w11, bw_k), "K11's bucket sums differ from K2's")
    require(torch.equal(w12, w12_p), "K12 differs from its plain version")
    require(same_points(b12, buckets_k), "K12's bucket sums differ from K2's")
    loads = int(runs.sum())
    results["K11"] = dict(
        err=max_abs_err(w11, w11_p),
        ms=cuda_ms(lambda: msm.bucket_accumulate_words(keys, offsets, rows,
                                                       nbk, shift), 20),
        dev_ms=device_ms(lambda: msm.bucket_accumulate_words(
            keys, offsets, rows, nbk, shift),
            "bucket_accumulate_words_kernel", 20),
        plain_ms=cuda_ms(lambda: msm.bucket_accumulate_words_plain(
            keys, offsets, rows, nbk, shift), 2),
        lib_ms=None,
        bound=bound_ms(keys.numel() * 8 + offsets.numel() * 8
                       + rows.numel() * 4 + b11.numel() * 4, k2_adds * ADD))
    results["K12"] = dict(
        err=max_abs_err(w12, w12_p),
        ms=cuda_ms(lambda: msm.bucket_accumulate_affine(keys, offsets, arows,
                                                        nbk, shift), 20),
        dev_ms=device_ms(lambda: msm.bucket_accumulate_affine(
            keys, offsets, arows, nbk, shift),
            "bucket_accumulate_affine_kernel", 20),
        plain_ms=cuda_ms(lambda: msm.bucket_accumulate_affine_plain(
            keys, offsets, arows, nbk, shift), 2),
        lib_ms=None,
        bound=bound_ms(keys.numel() * 8 + offsets.numel() * 8
                       + arows.numel() * 4 + b12.numel() * 4,
                       k2_adds * 8 * MUL + loads * MUL))
    for k in ("K11", "K12"):
        v = results[k]
        print(f"{k} nb=1024 ({total} points, w = {wbits}): "
              f"kernel_ms={v['ms']:.4f} device_only_ms={fmt_ms(v['dev_ms'])} "
              f"plain_ms={v['plain_ms']:.2f} bound_ms={v['bound'][0]:.5f} "
              f"({v['bound'][1]}) max_abs_err={v['err']} [{smi}]", flush=True)
    print("config preludes nb=1024 (ms): " + json.dumps({
        "point_rows": round(cuda_ms(lambda: msm.point_rows(points), 5), 4),
        "to_affine_words": round(cuda_ms(lambda: msm.to_affine_words(points),
                                         3), 4)}), flush=True)

    # ---------------------------------------------------------- phase 4
    kernels = [decompress.ristretto_decode, msm.bucket_accumulate,
               msm.bucket_fold, combine.horner_check, pointwise.seg_combine,
               pointwise.point_add, pointwise.mul, pointwise.add,
               sort.radix_sort, gather.gather_words,
               msm.bucket_accumulate_words, msm.bucket_accumulate_affine]

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
    runs, run_flags, _ = msm.sorted_runs(c_points, c_digits, cw)
    print(f"Cloak MSM: {cn} points, route {msm.route(cn)}, wbits {cw}, "
          f"{cnw} windows x {cnb} buckets", flush=True)

    def flat(x):
        return x.reshape(4, F.NL, -1).contiguous()

    # K5 at the scan's first step (offset 1), K6 at the fold's width
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

    # the Cloak device half by stage
    c_static = bvd.static_gens_words(r1cs_bp, pc, padded_n, 1, dev)
    c_enc = to_device(encoding_words(dyn_enc), dev)
    c_totals = msm.window_totals(c_points, c_digits, cw)
    stages = {
        "recode": lambda: sm.signed_digits(torch.cat([
            sm.decode_words_last(static_sc), sm.decode_words_last(dyn_sc)], 1),
            cw),
        "K1 decode": lambda: decompress.ristretto_decode(c_enc),
        "sort+gather+sign": lambda: msm.sorted_runs(c_points, c_digits, cw),
        "window_totals_small": lambda: msm.window_totals_small(c_points,
                                                               c_digits, cw),
        "K4": lambda: combine.horner_check(c_totals.unsqueeze(2).contiguous(),
                                           cw),
        "whole split_msm_check": lambda: bvd.split_msm_check(
            c_static, c_enc, static_sc, dyn_sc, cw),
    }
    print("Cloak device half stages (ms): " + json.dumps(
        {k: round(cuda_ms(f, 5), 4) for k, f in stages.items()}), flush=True)

    # the route crossover: both routes on the same points and digits
    gens_pts = words_to_points(bvd.static_gens_words(r1cs_bp, pc, 1024, 1, dev))
    for nx in (1282, 2048):
        pts_n = gens_pts[:, :, :nx].contiguous()
        ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(nx)]
        lim = sm.ints_to_limbs(ks, dev)
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
        require(torch.equal(points_to_words(tot["gather+sort"]),
                            points_to_words(tot["default"])),
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
        fixture.r1cs_verifier(fx).verify(R1CSProof.from_bytes(fx.wire), pc,
                                         r1cs_bp, device=dev, timings=timings)
        print(f"r1cs {name} accept: host_s={timings['host_s']:.3f} "
              f"device_s={timings['device_s']:.4f} "
              f"msm_size={timings['msm_size']} wbits={timings['wbits']} "
              f"route={timings['route']} [{smi}]", flush=True)
        if name.startswith("cloak"):
            require(timings["route"] == "small"
                    and pointwise.seg_combine.launches > 0
                    and pointwise.point_add.launches > 0
                    and msm.bucket_accumulate.launches == 0,
                    "the Cloak verification did not run the small route")
        for tamper, proof, f in tampered[name]:
            try:
                fixture.r1cs_verifier(f).verify(proof, pc, r1cs_bp, device=dev)
                rejected = False
            except VerificationError:
                rejected = True
            require(rejected, f"r1cs {name}: the proof with a bad {tamper} "
                              "was accepted")
            print(f"r1cs {name} {tamper} tampered: rejected", flush=True)
    r1cs_path = counts()
    require(all(c > 0 for c in r1cs_path[:6]),
            f"the R1CS path skipped a kernel: {r1cs_path}")
    print(f"R1CS path launches: {r1cs_path}", flush=True)

    # ---------------------------------------------------------- phase 8
    reset()
    pointwise.mul(a7, c7)
    pointwise.add(a7, c7)
    torch.cuda.synchronize()
    entry = counts()
    require(entry[6] > 0 and entry[7] > 0,
            f"the field entry points did not launch K7/K8: {entry}")

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
    require(torch.equal(points_to_words(m_totals["gather+sort"]),
                        points_to_words(m_totals["default"]))
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
    print("mixed batch window_totals ms by configuration (from words): "
          + json.dumps({c: round(cuda_ms(lambda: window_totals_from_words(
              pw_t, sw_t, m_w, cfg), 3), 4) for c, cfg in configs.items()})
          + f" [{smi}]", flush=True)
    launches = [sum(c) for c in zip(range_path, r1cs_path, entry, engine_path)]
    require(all(c > 0 for c in launches), f"a kernel never launched: {launches}")

    # ---------------------------------------------------------- phase 10
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
        ("K11", "bucket_accumulate_words", "bucket_accumulate_words.cu",
         "zkvm_tpu/kernels/pallas_msm.py:824"),
        ("K12", "bucket_accumulate_affine", "bucket_accumulate_affine.cu",
         "zkvm_tpu/kernels/pallas_msm.py:952"),
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
