// K5 seg_combine: one step of the small-MSM route's segmented scan,
// out[i] = flags[i] ? q[i] : p[i] + q[i].
//
// Replaces the JAX package's pallas_msm.py::_seg_combine_kernel (through
// seg_combine_lm), the combine of the associative scan in _bucket_totals,
// the route the JAX package takes for MSMs of 2,048 points or fewer.
// There XLA's associative_scan builds the tree and each level is one
// Pallas call over 512-lane tiles; here one launch is one thread per
// element with its operands in registers.  The port's small route scans
// with K5s (small_scan.cu), and this kernel is the entry point
// pointwise.seg_combine.  Plain twin: pointwise.py seg_combine_plain.
//
// Input p, q (4, 10, B) int32 points (coordinate, limb, element), flags
// (B,) int32; output (4, 10, B).  Neighbouring threads touch neighbouring
// words of every limb row, so each load and store is coalesced.
//
// Bound: bytes.  An element with its flag clear costs one point addition
// (9 field multiplications, ~900 32x32->64 products), an element with its
// flag set only copies q; every element moves 324 bytes in and 160 out.
// At the card's 3.35 TB/s and ~16.75e12 products/s the bytes take about
// twice as long as the products.  A launch of tens of thousands of
// elements is under one wave, so in practice it is latency-bound: about
// one point addition.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

__global__ void seg_combine_kernel(const int32_t* __restrict__ p,
                                   const int32_t* __restrict__ q,
                                   const int32_t* __restrict__ flags,
                                   int32_t* __restrict__ out, int64_t B) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B) return;
    Pt r = pt_load(q, t, B);
    if (flags[t] == 0) r = pt_add(pt_load(p, t, B), r);
    pt_store(out, t, B, r);
}

extern "C" int zkvm_seg_combine(const void* p, const void* q,
                                const void* flags, void* out, int64_t B,
                                void* stream) {
    const int threads = 128;
    const int64_t blocks = (B + threads - 1) / threads;
    if (blocks > 0)
        seg_combine_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
            (const int32_t*)p, (const int32_t*)q, (const int32_t*)flags,
            (int32_t*)out, B);
    return (int)cudaGetLastError();
}
