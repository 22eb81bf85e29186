"""Drives the PyTorch/CUDA port on one NVIDIA card end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the four CUDA kernels
   (K1 ristretto_decode, K2 bucket_accumulate, K3 bucket_fold, K4
   horner_check) from kernels/csrc, and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (nb = 1024 proofs of 64 bits, m = 1), words and
   flags exactly equal, and times both;
3. with every launch count set to 0, runs the main path through its entry
   point zkvm_tpu_torch.proofs.rangeproof.batch_verify at nb = 1024 and
   nb = 4096: a valid batch must accept, a batch with one t_x changed and
   one with a non-canonical point encoding must reject;
4. prints the kernels line (every launch count must be > 0) and, last,
   the device line.

Proofs come from the committed fixture zkvm_tpu_torch/data, tiled to the
batch size; each copy gets its own random weight, so the MSM is full size
with real points and distinct digits.  Exits non-zero on any failure, and
without a CUDA device.
"""

import json
import math
import os
import subprocess
import sys
import time

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
    from zkvm_tpu_torch.kernels import _build, combine, decompress, msm
    from zkvm_tpu_torch.kernels import batch_verify_device as bvd
    from zkvm_tpu_torch.kernels import scalarmod as sm
    from zkvm_tpu_torch.kernels.words import (encoding_words, points_to_words,
                                              to_device, words_to_points)
    from zkvm_tpu_torch.constants import L, P
    from zkvm_tpu_torch.proofs.errors import VerificationError
    from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
    from zkvm_tpu_torch.proofs.rangeproof import RangeProof, batch_verify
    from zkvm_tpu_torch.proofs.transcript import ProofTranscript

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)} "
          f"(parallel nvcc)", flush=True)
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
               msm.bucket_fold, combine.horner_check]
    for k in kernels:
        k.launches = 0
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
    launches = [k.launches for k in kernels]
    require(all(c > 0 for c in launches), f"a kernel never launched: {launches}")

    sources = ["decompress.cu", "bucket_accumulate.cu", "bucket_fold.cu",
               "horner_check.cu"]
    replaces = [
        "zkvm_tpu/kernels/pallas_decompress.py:207",
        "zkvm_tpu/kernels/pallas_msm.py:361; zkvm_tpu/kernels/pallas_msm.py:411;"
        " zkvm_tpu/kernels/pallas_msm.py:103",
        "zkvm_tpu/kernels/pallas_msm.py:471; zkvm_tpu/kernels/pallas_msm.py:497",
        "zkvm_tpu/kernels/pallas_msm.py:1411",
    ]
    names = ["ristretto_decode", "bucket_accumulate", "bucket_fold",
             "horner_check"]
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
