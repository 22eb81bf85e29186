// K2 bucket_accumulate: every Pippenger bucket sum of every window.
//
// Replaces three Pallas kernels of the JAX package's bucket pipeline:
// pallas_msm.py::_seq_scan_kernel (per-lane sequential segmented scan),
// ::_lane_scan_kernel (cross-lane scan of the lane tails) and the fix-up
// ::_add_kernel via point_add_lm.  The TPU needed that split because its
// grid runs in order and Mosaic could not lower a wide in-kernel gather;
// here one thread per (window, bucket) walks its own run of the sorted
// keys, gathers each point directly and applies the sign on load.  Plain
// twin: msm.py bucket_accumulate_plain.
//
// Input: keys (nw, n) int64 sorted per window, key = |digit| << (shift+1)
// | sign << shift | index; offsets (nw, nb + 1) int64, bucket b (digit
// magnitude b + 1) owning the run [offsets[b], offsets[b+1]); points
// (4, 10, n) int32.  Output (4, 10, nw * nb) int32; an empty bucket holds
// the identity (0, 1, 1, 0).
//
// Bound: operations (9 field multiplications per point added, about n
// adds per window), against 8 bytes of key and 160 of point gathered per
// add.  Worst case: equal digits put a whole window's n points in one
// run, which one thread then adds serially (n adds in sequence while the
// other threads idle); random scalars give runs of n / nb on average.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

__global__ void bucket_accumulate_kernel(const int64_t* __restrict__ keys,
                                         const int64_t* __restrict__ offsets,
                                         const int32_t* __restrict__ pts,
                                         int32_t* __restrict__ out,
                                         int64_t n, int nw, int nb,
                                         int shift) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t total = (int64_t)nw * nb;
    if (t >= total) return;
    const int64_t w = t / nb, b = t % nb;
    const int64_t start = offsets[w * (nb + 1) + b];
    const int64_t end = offsets[w * (nb + 1) + b + 1];
    const int64_t idx_mask = ((int64_t)1 << shift) - 1;
    Pt acc = pt_identity();
    for (int64_t i = start; i < end; i++) {
        const int64_t key = keys[w * n + i];
        Pt p = pt_load(pts, key & idx_mask, n);
        if ((key >> shift) & 1) {
            p.X = fe_neg(p.X);
            p.T = fe_neg(p.T);
        }
        acc = (i == start) ? p : pt_add(acc, p);
    }
    pt_store(out, t, total, acc);
}

extern "C" int zkvm_bucket_accumulate(const void* keys, const void* offsets,
                                      const void* pts, void* out, int64_t n,
                                      int nw, int nb, int shift,
                                      void* stream) {
    const int threads = 128;
    const int64_t total = (int64_t)nw * nb;
    const int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 0)
        bucket_accumulate_kernel<<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
            (const int64_t*)keys, (const int64_t*)offsets,
            (const int32_t*)pts, (int32_t*)out, n, nw, nb, shift);
    return (int)cudaGetLastError();
}
