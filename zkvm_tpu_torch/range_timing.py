"""Times the fused range-proof verification path and the small MSM route
of one checkout of the port on a CUDA card, so that two checkouts can be
compared on one card:

    python3 zkvm_tpu_torch/range_timing.py [TREE] [--nb 1024] [--reps 3]

TREE (default: the checkout that holds this file) goes first on sys.path,
so the zkvm_tpu_torch it times is TREE's own; the script uses only entry
points that every checkout of the port has had since its second slice.  It
builds TREE's kernels, then prints one JSON line: the tree, the card's name
and power limit, batch_verify's host_s and device_s for each of `reps`
calls on nb tiled fixture proofs (64 bits, m = 1), and the device half's
stages in ms; and under "small_route" R1CS Verifier.verify's host_s and
device_s on the committed Cloak 4x4 fixture for each of `reps` calls, the
Cloak's window_totals_small and whole split_msm_check in ms, and
window_totals_small against window_totals_large on the same points and
digits at 1,282 and 2,048 points (w = 8); and under "bucket_sums" the
bucket sums of the gather and affine configurations (K11
bucket_accumulate_words, K12 bucket_accumulate_affine) on the batch's MSM,
on its random digits and with every scalar equal (each window one run of
all the points).  Every ms is by CUDA events, the mean of 10 calls after
one (3 on equal scalars, where an accumulator that gives each bucket one
thread walks a window's run in a row).  To compare a parent with a change,
run parent, change, change, parent in one session.  Exits non-zero without
a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def cuda_ms(fn, reps=10):
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--nb", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("range timing: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import zkvm_tpu_torch
    from zkvm_tpu_torch import fixture
    from zkvm_tpu_torch.kernels import _build, combine, decompress, msm
    from zkvm_tpu_torch.kernels import batch_verify_device as bvd
    from zkvm_tpu_torch.kernels import scalarmod as sm
    from zkvm_tpu_torch.kernels.words import to_device, words_to_points
    from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
    from zkvm_tpu_torch.proofs.rangeproof import RangeProof, batch_verify
    from zkvm_tpu_torch.proofs.transcript import ProofTranscript
    if not zkvm_tpu_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {zkvm_tpu_torch.__file__}, not {tree}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    dev = torch.device("cuda")
    label, n, m, records = fixture.load()
    bp, pc = BulletproofGens(n, m), PedersenGens()
    nb = args.nb

    def batch():
        proofs = [RangeProof.from_bytes(records[i % len(records)][0])
                  for i in range(nb)]
        vcs = [records[i % len(records)][1] for i in range(nb)]
        return (proofs, bp, pc, [ProofTranscript(label) for _ in range(nb)],
                vcs, n)

    calls = []
    for _ in range(args.reps):
        t = {}
        batch_verify(*batch(), device=dev, timings=t)
        calls.append({k: t[k] for k in ("host_s", "device_s")})

    params, bbB_pp, dyn, m, lg = bvd.prepare_batch_inputs(*batch())
    static = bvd.static_gens_words(bp, pc, n, m, dev)
    params_t = to_device(params, dev)
    bbB_t = to_device(bvd.sum_bbB(bbB_pp), dev)
    words = to_device(dyn, dev)
    wbits = msm.best_wbits(static.shape[2] + dyn.shape[1])
    nbk = 1 << (wbits - 1)
    digits = sm.signed_digits(bvd.batch_msm_scalars(params_t, bbB_t, n, m, lg),
                              wbits)
    points = torch.cat([words_to_points(static),
                        decompress.ristretto_decode(words)[0]], dim=2)
    keys, offsets, shift = msm.sort_keys(digits, nbk)
    buckets = msm.bucket_accumulate(keys, offsets, points, nbk, shift)
    totals4 = msm.bucket_fold(buckets, digits.shape[1], nbk).unsqueeze(2)
    stages = {
        "synthesis+recode": lambda: sm.signed_digits(
            bvd.batch_msm_scalars(params_t, bbB_t, n, m, lg), wbits),
        "K1 decode": lambda: decompress.ristretto_decode(words),
        "sort+offsets": lambda: msm.sort_keys(digits, nbk),
        "K2": lambda: msm.bucket_accumulate(keys, offsets, points, nbk, shift),
        "K3": lambda: msm.bucket_fold(buckets, digits.shape[1], nbk),
        "K4": lambda: combine.horner_check(totals4.contiguous(), wbits),
        "whole device half": lambda: bvd.batch_msm_check(
            static, words, params_t, bbB_t, n, m, lg, wbits),
    }
    stages_ms = {k: cuda_ms(f) for k, f in stages.items()}
    print(json.dumps({"tree": tree, "card": smi, "nb": nb, "wbits": wbits,
                      "batch_verify": calls, "stages_ms": stages_ms,
                      "small_route": small_route(dev, args.reps),
                      "bucket_sums": bucket_sums(points, digits, nbk)}),
          flush=True)
    return 0


def bucket_sums(points, digits, nb):
    """K11's and K12's ms on the MSM's random digits and on equal scalars
    (module note), through their entry points."""
    from zkvm_tpu_torch.kernels import gather, msm
    n, nw = digits.shape
    row = int(np.random.default_rng(2028).integers(0, n))
    out = {}
    for tag, dg, reps in (
            ("random", digits, 10),
            ("equal scalars", digits[row:row + 1].expand(n, nw).contiguous(),
             3)):
        keys, offsets, shift = msm.sort_keys(dg, nb)
        perm = keys & ((1 << shift) - 1)
        for k, fn, prelude in (
                ("K11", msm.bucket_accumulate_words, msm.point_rows),
                ("K12", msm.bucket_accumulate_affine, msm.to_affine_words)):
            rows = gather.gather_words(prelude(points), perm)
            out[f"{k} {tag}"] = cuda_ms(
                lambda: fn(keys, offsets, rows, nb, shift), reps)
    return out


def small_route(dev, reps):
    """The Cloak's verify, its small-route MSM and the route against the
    bucket pipeline at 1,282 and 2,048 points (module note)."""
    import torch
    from zkvm_tpu_torch import fixture
    from zkvm_tpu_torch.constants import L
    from zkvm_tpu_torch.kernels import decompress, msm
    from zkvm_tpu_torch.kernels import batch_verify_device as bvd
    from zkvm_tpu_torch.kernels import scalarmod as sm
    from zkvm_tpu_torch.kernels.words import (encoding_words, scalar_words,
                                              to_device, words_to_points)
    from zkvm_tpu_torch.proofs.generators import BulletproofGens, PedersenGens
    from zkvm_tpu_torch.proofs.r1cs import R1CSProof
    fx = fixture.load_r1cs(fixture.R1CS_CLOAK)
    pc = PedersenGens()
    bp = BulletproofGens(max(fx.gens_capacity, 1024))
    calls = []
    for _ in range(reps):
        t = {}
        fixture.r1cs_verifier(fx).verify(R1CSProof.from_bytes(fx.wire), pc, bp,
                                         device=dev, timings=t)
        calls.append({k: t[k] for k in ("host_s", "device_s")})

    # the Cloak MSM as its verify builds it
    dyn_s, dyn_enc, bb, bs, g_v, h_v, padded_n = fixture.r1cs_verifier(
        fx).verification_job_split_vec(R1CSProof.from_bytes(fx.wire), bp, pc)
    static_sc = to_device(scalar_words([bb, bs] + g_v.to_ints()
                                       + h_v.to_ints()), dev)
    dyn_sc = to_device(scalar_words(dyn_s), dev)
    static = bvd.static_gens_words(bp, pc, padded_n, 1, dev)
    enc = to_device(encoding_words(dyn_enc), dev)
    n = static_sc.shape[0] + dyn_sc.shape[0]
    w = msm.best_wbits(n)
    digits = sm.signed_digits(torch.cat([sm.decode_words_last(static_sc),
                                         sm.decode_words_last(dyn_sc)], 1), w)
    points = torch.cat([words_to_points(static),
                        decompress.ristretto_decode(enc)[0]], dim=2)
    ms = {"cloak window_totals_small": cuda_ms(
              lambda: msm.window_totals_small(points, digits, w)),
          "cloak split_msm_check": cuda_ms(
              lambda: bvd.split_msm_check(static, enc, static_sc, dyn_sc, w))}

    gens = words_to_points(bvd.static_gens_words(bp, pc, 1024, 1, dev))
    rs = np.random.default_rng(2031)
    for nx in (1282, 2048):
        pts = gens[:, :, :nx].contiguous()
        ks = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(nx)]
        dg = sm.signed_digits(sm.ints_to_limbs(ks, dev), 8)
        ms[f"n={nx} small"] = cuda_ms(lambda: msm.window_totals_small(pts, dg,
                                                                      8))
        ms[f"n={nx} large"] = cuda_ms(lambda: msm.window_totals_large(pts, dg,
                                                                      8))
    return {"msm_size": n, "wbits": w, "verify": calls, "ms": ms}


if __name__ == "__main__":
    sys.exit(main())
