"""Times the fused range-proof verification path of one checkout of the
port on a CUDA card, so that two checkouts can be compared on one card:

    python3 zkvm_tpu_torch/range_timing.py [TREE] [--nb 1024] [--reps 3]

TREE (default: the checkout that holds this file) goes first on sys.path,
so the zkvm_tpu_torch it times is TREE's own; the script uses only entry
points that every checkout of the port has had since its first slice.  It
builds TREE's kernels, then prints one JSON line: the tree, the card's name
and power limit, batch_verify's host_s and device_s for each of `reps`
calls on nb tiled fixture proofs (64 bits, m = 1), and the device half's
stages in ms (CUDA events, mean of 10 calls after one).  To compare a
parent with a change, run parent, change, change, parent in one session.
Exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys


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
    print(json.dumps({"tree": tree, "card": smi, "nb": nb, "wbits": wbits,
                      "batch_verify": calls,
                      "stages_ms": {k: cuda_ms(f) for k, f in stages.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
