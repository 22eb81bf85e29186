// K5 seg_combine: one step of the small-MSM route's segmented scan,
// out[i] = flags[i] ? q[i] : p[i] + q[i].
//
// Replaces the JAX package's pallas_msm.py::_seg_combine_kernel (through
// seg_combine_lm), the combine of the associative scan in _bucket_totals,
// the route the JAX package takes for MSMs of 2,048 points or fewer.
// There XLA's associative_scan builds the tree and each level is one
// Pallas call over 512-lane tiles.  The port's small route scans with K5s
// (small_scan.cu), and this kernel is the entry point
// pointwise.seg_combine.  Plain twin: pointwise.py seg_combine_plain.
//
// Input p, q (4, 10, B) int32 points (coordinate, limb, element), flags
// (B,) int32; output (4, 10, B).
//
// Form: point_add.cu's.  A group of four consecutive lanes holds one
// element, lane j coordinate j, and every group forms p + q with
// lanes.cuh's lane_add_pt (three products deep), then keeps q where the
// flag is set: a select, not a branch, because the shuffles name the
// whole warp.  Lane 0 of a group reads the flag and passes it on by one
// shuffle.  Lane j of neighbouring groups reads neighbouring words of
// coordinate j's limb rows, so loads and stores coalesce; the tail lanes
// past B add the last element again and skip their stores.
//
// Bound: bytes, 324 in and 160 out an element, against the products of
// the elements whose flag is clear (nine fe_mul each, ~900 products) at
// the card's modelled ~16.75e12 products/s.  The kernel does more than
// that: twelve fe_mul an element in four lanes (lane_cached's product on
// all four), flag set or not.  A launch of a few thousand elements is
// bound by one dependent lane_add_pt; at tens of thousands it runs at the
// card's rate of point additions, which the one-thread form reaches too
// (K15 and K16 measure both), so there the form gains nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"
#include "lanes.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 128;       // 32 groups of four lanes a block

__global__ void __launch_bounds__(kThreads)
seg_combine_kernel(const int32_t* __restrict__ p,
                   const int32_t* __restrict__ q,
                   const int32_t* __restrict__ flags,
                   int32_t* __restrict__ out, int64_t B) {
    const int64_t e = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 2;
    const int j = threadIdx.x & 3;
    const int64_t at = e < B ? e : B - 1;
    const bool keep =
        __shfl_sync(0xffffffffu, j == 0 ? flags[at] : 0, 0, 4) != 0;
    const Fe b = fe_load(q, j, at, B);
    const Fe s = lane_add_pt(j, fe_load(p, j, at, B), b);
    Fe r;
#pragma unroll
    for (int l = 0; l < 10; l++) r.v[l] = keep ? b.v[l] : s.v[l];
    if (e < B) fe_store(out, j, e, B, r);
}

}  // namespace

extern "C" int zkvm_seg_combine(const void* p, const void* q,
                                const void* flags, void* out, int64_t B,
                                void* stream) {
    const int64_t blocks = (4 * B + kThreads - 1) / kThreads;
    if (blocks > 0)
        seg_combine_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
            (const int32_t*)p, (const int32_t*)q, (const int32_t*)flags,
            (int32_t*)out, B);
    return (int)cudaGetLastError();
}
