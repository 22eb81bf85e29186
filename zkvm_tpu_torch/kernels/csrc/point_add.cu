// K6 point_add: out[i] = p[i] + q[i], batched Edwards point addition.
//
// Replaces the JAX package's pallas_field.py::_point_add_kernel (the
// pallas_field.point_add entry point) and the standalone uses of
// pallas_msm.py::_add_kernel through point_add_lm: the small-MSM route's
// bucket fold (the suffix scan and the tree over the suffix sums,
// _bucket_totals) and the chunk fold of window_totals.  The port's small
// route folds with K3 (bucket_fold.cu), and this kernel is the entry point
// pointwise.point_add.  The TPU kernels work on 512-lane tiles and their
// callers pad every batch to that; here one thread per element takes any
// B.  Plain twin: pointwise.py point_add_plain.
//
// Input p, q (4, 10, B) int32 points; output (4, 10, B).  Loads and
// stores are coalesced (neighbouring threads, neighbouring words).
//
// Bound: bytes.  One point addition (9 field multiplications, ~900
// 32x32->64 products) per element against 320 bytes read and 160
// written; at the card's 3.35 TB/s and ~16.75e12 products/s the bytes
// take about twice as long.  A launch under one wave is latency-bound at
// about one point addition.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

__global__ void point_add_kernel(const int32_t* __restrict__ p,
                                 const int32_t* __restrict__ q,
                                 int32_t* __restrict__ out, int64_t B) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B) return;
    pt_store(out, t, B, pt_add(pt_load(p, t, B), pt_load(q, t, B)));
}

extern "C" int zkvm_point_add(const void* p, const void* q, void* out,
                              int64_t B, void* stream) {
    const int threads = 128;
    const int64_t blocks = (B + threads - 1) / threads;
    if (blocks > 0)
        point_add_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
            (const int32_t*)p, (const int32_t*)q, (int32_t*)out, B);
    return (int)cudaGetLastError();
}
