// K13-K16: the field and point micro-kernels, which time the port's own
// field and point code (field25519.cuh, lanes.cuh) on the card.
//
// Replace the JAX package's micro-benchmark kernels, bench/pallas_micro.py:
//   K13 micro_mul: _pallas_binop (:97) with pf._mul_kernel,
//       _mul_kernel_roll and _chain_kernel_factory: a <- a b, `depth`
//       times, over (10, B) limbs, in the two forms the port's kernels
//       use: one thread per element (fe_mul, K7's form), or a group of
//       five lanes per element (lf_mul, K1's column split, six groups a
//       warp and an idle tail group of lanes 30 and 31).  The TPU's pad
//       and roll variants were two layouts of one multiplication for its
//       vector unit; these two forms take their place.  Both give fe_mul's
//       limbs (lanes.cuh), so one plain twin serves both.
//   K14 micro_parts: _pallas_binop_planes (:202) with _raw_kernel_planes,
//       _prod_kernel_planes, _carry_kernel_planes, _mul_kernel_planes and
//       _chain_kernel_planes: a multiplication's cost split into its
//       parts, one thread per element:
//         raw    x <- x b, one wrapping int32 multiply a limb, depth times
//                (one thread per limb);
//         prod   fe_mul's 100 products into its ten int64 columns
//                (fe_mul_cols), no carry pass; at depth > 1 the next
//                step's f is this step's columns cut to their limb widths
//                (a mask, no carry), so every product feeds the output;
//         carry  h = a + b, then 8 carry passes, depth times;
//         chain  fe_mul depth times (the mul of row 18 at depth 1): K13's
//                one-thread kernel.
//   K15 micro_add_chain: _make_add_chain_planes (:290): q <- p + q, depth
//       times, one thread per point (pt_add: add-2008-hwcd-3 with k = 2d,
//       as _add_planes).
//   K16 micro_add_chain_lanes: _make_add_chain (:338): the same chain in
//       the four-lane form of K2, K3, K4 and K5s: p in cached form once
//       (lane_cached), then q <- lane_add(q, p), depth times.
// Plain twins: kernels/micro.py, limb for limb.
//
// Bound.  At depth 1 every kernel streams, and bytes bound it (K13: 120
// bytes against 100 products an element).  Deep chains are bound by
// operations: the products (IMAD.WIDE, on the integer multiply pipe) and
// the carries' 64-bit shifts and adds.  Measuring those rates is what
// these kernels are for, so each is the plainest loop over the shared
// device functions, and nothing is tuned.
//
// Dead code: every variant stores a value that depends on all of its
// work (prod stores its int64 columns), so nvcc deletes no product;
// chip_smoke.py counts the wide multiplies in this library's SASS.  Along
// K15's chain p does not change, yet nvcc leaves p's half of each
// addition (Y1 - X1, Y1 + X1, T1 2d) in the loop: a step is nine
// multiplications, as in the reference's planes chain.  K16 makes p's
// cached form once (lane_cached), as K2-K4 do.  A chain is a loop that is
// not unrolled, so a depth is a run-time argument (raw's loop is unrolled
// by 16: one multiply a step).
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"
#include "lanes.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = 6;          // groups of five lanes a warp (K1's)
constexpr int kStride = 69;         // shared words a group (decompress.cu)

__device__ __forceinline__ int64_t thread_index() {
    return (int64_t)blockIdx.x * kThreads + threadIdx.x;
}

int64_t blocks_for(int64_t threads) {
    return (threads + kThreads - 1) / kThreads;
}

// K13, one thread per element; also K14's chain
__global__ void __launch_bounds__(kThreads)
mul_thread_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                  int32_t* __restrict__ out, int64_t B, int depth) {
    const int64_t t = thread_index();
    if (t >= B) return;
    Fe x = fe_load(a, 0, t, B);
    const Fe y = fe_load(b, 0, t, B);
#pragma unroll 1
    for (int d = 0; d < depth; d++) x = fe_mul(x, y);
    fe_store(out, 0, t, B, x);
}

// K13, a group of five lanes per element: lane q holds limbs 2q, 2q + 1.
// A warp with no element returns whole, so that a warp's chain runs on
// one warp alone; in the others no lane returns before a shuffle: a group
// past B and the tail group multiply zeros and only skip their stores.
__global__ void __launch_bounds__(kThreads)
mul_lanes_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, int64_t B, int depth) {
    __shared__ int32_t scratch[(kThreads / 32) * (kGroups + 1) * kStride];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (((int64_t)blockIdx.x * (kThreads / 32) + warp) * kGroups >= B) return;
    const int grp = lane / 5;            // kGroups for lanes 30 and 31
    const Lane5 g(5 * grp, lane - 5 * grp,
                  scratch + (warp * (kGroups + 1) + grp) * kStride);
    const int64_t e =
        ((int64_t)blockIdx.x * (kThreads / 32) + warp) * kGroups + grp;
    const bool valid = grp < kGroups && e < B;
    Fe2 x, y;
#pragma unroll
    for (int t = 0; t < 2; t++) {
        const int64_t at = (int64_t)(2 * g.q + t) * B + e;
        x.v[t] = valid ? a[at] : 0;
        y.v[t] = valid ? b[at] : 0;
    }
#pragma unroll 1
    for (int d = 0; d < depth; d++) x = lf_mul(g, x, y);
    if (!valid) return;                  // after the group's last shuffle
#pragma unroll
    for (int t = 0; t < 2; t++) out[(int64_t)(2 * g.q + t) * B + e] = x.v[t];
}

// K14 raw: one thread per limb, x <- x b in wrapping 32-bit arithmetic
__global__ void __launch_bounds__(kThreads)
raw_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
           int32_t* __restrict__ out, int64_t n, int depth) {
    const int64_t t = thread_index();
    if (t >= n) return;
    uint32_t x = (uint32_t)a[t];
    const uint32_t y = (uint32_t)b[t];
    // unrolled, so that the loop's own count, test and branch do not
    // outnumber the multiplies it times
#pragma unroll 16
    for (int d = 0; d < depth; d++) x *= y;
    out[t] = (int32_t)x;
}

// K14 prod: the columns of f b, f <- the columns cut to the limb widths
__global__ void __launch_bounds__(kThreads)
prod_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
            int64_t* __restrict__ out, int64_t B, int depth) {
    const int64_t t = thread_index();
    if (t >= B) return;
    Fe f = fe_load(a, 0, t, B);
    const Fe g = fe_load(b, 0, t, B);
    int64_t h[10];
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
        fe_mul_cols(f, g, h);
#pragma unroll
        for (int i = 0; i < 10; i++)
            f.v[i] = (int32_t)(h[i] & (((int64_t)1 << limb_width(i)) - 1));
    }
#pragma unroll
    for (int i = 0; i < 10; i++) out[i * B + t] = h[i];
}

// K14 carry: a + b, then 8 carry passes, depth times
__global__ void __launch_bounds__(kThreads)
carry_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
             int32_t* __restrict__ out, int64_t B, int depth) {
    const int64_t t = thread_index();
    if (t >= B) return;
    int64_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = (int64_t)a[i * B + t] + b[i * B + t];
#pragma unroll 1
    for (int d = 0; d < depth; d++) {
#pragma unroll
        for (int k = 0; k < 8; k++) carry_pass(h);
    }
    fe_store(out, 0, t, B, fe_from64(h));
}

// K15: q <- p + q, one thread per point
__global__ void __launch_bounds__(kThreads)
add_chain_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                 int32_t* __restrict__ out, int64_t B, int depth) {
    const int64_t t = thread_index();
    if (t >= B) return;
    const Pt a = pt_load(p, t, B);
    Pt r = pt_load(q, t, B);
#pragma unroll 1
    for (int d = 0; d < depth; d++) r = pt_add(a, r);
    pt_store(out, t, B, r);
}

// K16: four lanes per point, lane j coordinate j.  A warp with no point
// returns whole; in a partial last warp the lanes past B run on point 0
// and skip their stores: every lane takes part in every shuffle.
__global__ void __launch_bounds__(kThreads)
add_chain_lanes_kernel(const int32_t* __restrict__ p,
                       const int32_t* __restrict__ q,
                       int32_t* __restrict__ out, int64_t B, int depth) {
    if ((thread_index() & ~(int64_t)31) >> 2 >= B) return;
    const int64_t e = thread_index() >> 2;
    const int j = threadIdx.x & 3;
    const bool valid = e < B;
    const int64_t at = valid ? e : 0;
    const Fe c = lane_cached(j, fe_load(p, j, at, B));
    Fe r = fe_load(q, j, at, B);
#pragma unroll 1
    for (int d = 0; d < depth; d++) r = lane_add(j, r, c);
    if (valid) fe_store(out, j, e, B, r);
}

}  // namespace

// form 0: one thread per element; 1: five lanes per element
extern "C" int zkvm_micro_mul(const void* a, const void* b, void* out,
                              int64_t B, int depth, int form, void* stream) {
    if (depth < 1 || form < 0 || form > 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)a;
    const int32_t* y = (const int32_t*)b;
    if (form == 0) {
        const int64_t blocks = blocks_for(B);
        if (blocks > 0)
            mul_thread_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
                x, y, (int32_t*)out, B, depth);
    } else {
        const int64_t per_block = (kThreads / 32) * kGroups;
        const int64_t blocks = (B + per_block - 1) / per_block;
        if (blocks > 0)
            mul_lanes_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
                x, y, (int32_t*)out, B, depth);
    }
    return (int)cudaGetLastError();
}

// variant 0: raw; 1: prod (out is int64); 2: carry; 3: chain
extern "C" int zkvm_micro_parts(const void* a, const void* b, void* out,
                                int64_t B, int depth, int variant,
                                void* stream) {
    if (depth < 1 || variant < 0 || variant > 3)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)a;
    const int32_t* y = (const int32_t*)b;
    const int64_t blocks = blocks_for(variant == 0 ? 10 * B : B);
    if (blocks > 0) {
        if (variant == 0)
            raw_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
                x, y, (int32_t*)out, 10 * B, depth);
        else if (variant == 1)
            prod_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
                x, y, (int64_t*)out, B, depth);
        else if (variant == 2)
            carry_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
                x, y, (int32_t*)out, B, depth);
        else
            mul_thread_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
                x, y, (int32_t*)out, B, depth);
    }
    return (int)cudaGetLastError();
}

extern "C" int zkvm_micro_add_chain(const void* p, const void* q, void* out,
                                    int64_t B, int depth, void* stream) {
    if (depth < 1) return (int)cudaErrorInvalidValue;
    const int64_t blocks = blocks_for(B);
    if (blocks > 0)
        add_chain_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
            (const int32_t*)p, (const int32_t*)q, (int32_t*)out, B, depth);
    return (int)cudaGetLastError();
}

extern "C" int zkvm_micro_add_chain_lanes(const void* p, const void* q,
                                          void* out, int64_t B, int depth,
                                          void* stream) {
    if (depth < 1) return (int)cudaErrorInvalidValue;
    const int64_t blocks = blocks_for(4 * B);
    if (blocks > 0)
        add_chain_lanes_kernel<<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
            (const int32_t*)p, (const int32_t*)q, (int32_t*)out, B, depth);
    return (int)cudaGetLastError();
}
