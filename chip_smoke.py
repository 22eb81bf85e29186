"""Drives the PyTorch/CUDA port on one NVIDIA card end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the eight CUDA kernels
   (K1 ristretto_decode, K2 bucket_accumulate, K3 bucket_fold, K4
   horner_check, K5 seg_combine, K6 point_add, K7 fe_mul, K8 fe_add) from
   kernels/csrc, and prints the build time;
2. holds K1-K4 against their plain PyTorch versions on the card at the
   range-proof path's shapes (nb = 1024 proofs of 64 bits, m = 1), words
   and flags exactly equal, and times both;
3. with every launch count set to 0, runs the range-proof path through its
   entry point zkvm_tpu_torch.proofs.rangeproof.batch_verify at nb = 1024
   and nb = 4096: a valid batch must accept, a batch with one t_x changed
   and one with a non-canonical point encoding must reject;
4. holds K5 and K6 against their plain versions at the shapes of the
   Cloak verification's small-route MSM (its first scan step and its
   bucket fold), K7 and K8 at 2^16 elements, and window_totals_small
   against window_totals_large at n = 1,282 and 2,048 (the route
   crossover), and times them;
5. with every launch count set to 0, runs R1CS verification through
   zkvm_tpu_torch.proofs.r1cs.Verifier.verify on the two committed
   fixtures (a Cloak 4x4 with 64-bit values, on the small route, and 512
   64-bit range gadgets, 2^15 multipliers, on K2/K3): the valid proof must
   accept, a proof with t_x + 1 and one with a non-canonical encoding
   (which K1 must flag) must raise VerificationError;
6. with every launch count set to 0, calls the field entry points
   pointwise.mul and pointwise.add (K7, K8; on no verify path);
7. prints the kernels line (every launch count must be > 0) and, last,
   the device line.

Range proofs come from the committed fixture zkvm_tpu_torch/data, tiled to
the batch size; each copy gets its own random weight, so the MSM is full
size with real points and distinct digits.  Exits non-zero on any
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


def device_ms(fn, kernel_name, reps):
    """Mean device time in ms of the CUDA kernel `kernel_name` per launch,
    read from torch.profiler's trace over reps calls of fn(): the card's
    own time, without the host's launch cost that the events include.
    None when the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel_name in e.key]
    total = sum(getattr(e, "device_time_total", 0) for e in rows)
    count = sum(e.count for e in rows)
    return total / count / 1e3 if count and total else None


def bound_ms(nbytes, products):
    by_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    by_ops = products / PRODUCTS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def main():
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zkvm_tpu_torch import fixture
    from zkvm_tpu_torch.kernels import (_build, combine, decompress, msm,
                                        pointwise)
    from zkvm_tpu_torch.kernels import batch_verify_device as bvd
    from zkvm_tpu_torch.kernels import field as F
    from zkvm_tpu_torch.kernels import scalarmod as sm
    from zkvm_tpu_torch.kernels.words import (encoding_words, points_to_words,
                                              scalar_words, to_device,
                                              words_to_points)
    from zkvm_tpu_torch.constants import L, P
    from zkvm_tpu_torch.proofs.errors import VerificationError
    from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
    from zkvm_tpu_torch.proofs.r1cs import R1CSProof
    from zkvm_tpu_torch.proofs.rangeproof import RangeProof, batch_verify
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

    totals4 = totals_k.unsqueeze(2).contiguous()
    check_k = combine.horner_check(totals4, wbits)
    check_p = combine.horner_check_plain(totals4, wbits)
    torch.cuda.synchronize()
    require(torch.equal(check_k, check_p), "K4 verdict differs from the plain version")
    require(int(check_k[0]) == 1, "the valid batch's MSM is not the identity")
    results["K4"] = dict(
        err=max_abs_err(check_k, check_p),
        ms=cuda_ms(lambda: combine.horner_check(totals4, wbits), 20),
        plain_ms=cuda_ms(lambda: combine.horner_check_plain(totals4, wbits), 2),
        bound=bound_ms(totals4.numel() * 4 + 4,
                       (nw - 1) * (wbits * DBL + ADD)))
    for k, v in results.items():
        print(f"{k}: kernel_ms={v['ms']:.4f} plain_ms={v['plain_ms']:.2f} "
              f"bound_ms={v['bound'][0]:.5f} ({v['bound'][1]}) "
              f"max_abs_err={v['err']} launches_per_verify=1", flush=True)

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

    # ---------------------------------------------------------- phase 3
    kernels = [decompress.ristretto_decode, msm.bucket_accumulate,
               msm.bucket_fold, combine.horner_check, pointwise.seg_combine,
               pointwise.point_add, pointwise.mul, pointwise.add]

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

    # ---------------------------------------------------------- phase 4
    def same_points(a, b):
        """(4, 10, k) points equal as projective points, X1 Z2 = X2 Z1 and
        so on: two routes add in different orders, so their coordinates
        differ by a factor while the points agree."""
        A, B = F.unpack_points(a), F.unpack_points(b)
        return all(bool(F.is_zero(F.sub(F.mul(A[i], B[2]),
                                        F.mul(B[i], A[2]))).all())
                   for i in (0, 1, 3))

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
    for n in (1282, 2048):
        pts_n = gens_pts[:, :, :n].contiguous()
        ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(n)]
        lim = sm.ints_to_limbs(ks, dev)
        w = msm.best_wbits(n)
        dg = sm.signed_digits(lim, w)
        small = msm.window_totals_small(pts_n, dg, w)
        large = msm.window_totals_large(pts_n, dg, w)
        require(same_points(small, large),
                f"n={n}: the small and large routes' totals differ")
        dg11 = sm.signed_digits(lim, 11)
        msm_w = combine.horner_fold_plain(small.unsqueeze(2), w)
        msm_11 = combine.horner_fold_plain(
            msm.window_totals_large(pts_n, dg11, 11).unsqueeze(2), 11)
        require(same_points(F.pack_points(msm_w), F.pack_points(msm_11)),
                f"n={n}: the MSM at w = {w} and w = 11 differ")
        print(f"route crossover n={n}: small(w={w})_ms="
              f"{cuda_ms(lambda: msm.window_totals_small(pts_n, dg, w), 5):.4f} "
              f"large(w={w})_ms="
              f"{cuda_ms(lambda: msm.window_totals_large(pts_n, dg, w), 5):.4f} "
              f"large(w=11)_ms="
              f"{cuda_ms(lambda: msm.window_totals_large(pts_n, dg11, 11), 5):.4f}"
              f" totals equal [{smi}]", flush=True)

    # ---------------------------------------------------------- phase 5
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

    # ---------------------------------------------------------- phase 6
    reset()
    pointwise.mul(a7, c7)
    pointwise.add(a7, c7)
    torch.cuda.synchronize()
    entry = counts()
    require(entry[6] > 0 and entry[7] > 0,
            f"the field entry points did not launch K7/K8: {entry}")
    launches = [a + b + c for a, b, c in zip(range_path, r1cs_path, entry)]
    require(all(c > 0 for c in launches), f"a kernel never launched: {launches}")

    sources = ["decompress.cu", "bucket_accumulate.cu", "bucket_fold.cu",
               "horner_check.cu", "seg_combine.cu", "point_add.cu",
               "fe_mul.cu", "fe_add.cu"]
    replaces = [
        "zkvm_tpu/kernels/pallas_decompress.py:207",
        "zkvm_tpu/kernels/pallas_msm.py:361; zkvm_tpu/kernels/pallas_msm.py:411;"
        " zkvm_tpu/kernels/pallas_msm.py:103",
        "zkvm_tpu/kernels/pallas_msm.py:471; zkvm_tpu/kernels/pallas_msm.py:497",
        "zkvm_tpu/kernels/pallas_msm.py:1411",
        "zkvm_tpu/kernels/pallas_msm.py:89",
        "zkvm_tpu/kernels/pallas_field.py:155; zkvm_tpu/kernels/pallas_msm.py:103"
        " (point_add_lm)",
        "zkvm_tpu/kernels/pallas_field.py:104 (entry point, on no verify path)",
        "zkvm_tpu/kernels/pallas_field.py:129 (entry point, on no verify path)",
    ]
    names = ["ristretto_decode", "bucket_accumulate", "bucket_fold",
             "horner_check", "seg_combine", "point_add", "fe_mul", "fe_add"]
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"zkvm_tpu_torch/kernels/csrc/{src}", "replaces": rep,
         "launches": cnt, "max_abs_err": res["err"], "ms": res["ms"],
         "plain_ms": res["plain_ms"], "bound_ms": res["bound"][0],
         "bound_by": res["bound"][1], "library_ms": None}
        for name, src, rep, cnt, res in zip(names, sources, replaces, launches,
                                            results.values())]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
