// K6 point_add: out[i] = p[i] + q[i], batched Edwards point addition; and
// its tree entry point_tree_fold: the sum of an (R, 4, 10, B) stack over
// R, in one launch.
//
// Replaces the JAX package's pallas_field.py::_point_add_kernel (the
// pallas_field.point_add entry point) and the standalone uses of
// pallas_msm.py::_add_kernel through point_add_lm: the small-MSM route's
// bucket fold (the suffix scan and the tree over the suffix sums,
// _bucket_totals) and the chunk fold of window_totals.  The port's small
// route folds with K3 (bucket_fold.cu), and point_add is the entry point
// pointwise.point_add.  The tree entry is the multi-device paths' fold of
// the ranks' all-gathered window totals (parallel/sharded_msm.py
// tree_fold): the reference's _combine_gathered (zkvm_tpu/parallel/
// sharded_msm.py:25-48: pad to a power of two with identities, then
// kernels/point.py tree_reduce) and its pipeline's level loop over
// pallas_msm._add_formula (:183-190).  Plain twins: pointwise.py
// point_add_plain and point_tree_fold_plain.
//
// Form.  A group of four consecutive lanes holds one point, lane j
// coordinate j (X, Y, Z, T), and adds with lanes.cuh's lane_add_pt:
// lane_cached (q's cached form, one product deep), then lane_add (two
// deep), the form of K3, K4 and K5s, whose limb audit holds as it stands.
// Lane j of neighbouring groups reads neighbouring words of coordinate j's
// limb rows, so loads and stores coalesce.  The shuffles name the whole
// warp, so no lane returns early: where 4 B is no multiple of the block,
// the tail lanes add the last point again and skip their stores.  The TPU
// kernels work on 512-lane tiles and their callers pad every batch to
// that; these take any B >= 1.
//
// Tree.  Column b of the stack is folded by one block's groups: level h
// (h = size / 2 down to 1, size = R rounded up to a power of two) adds
// row i + h to row i for every i < h, the reference's association.  The
// first level reads the stack as it lies and makes the pad rows i >= R
// the identity in registers (lane_identity); the levels meet in shared
// memory across __syncthreads; the last writes (4, 10, B).  A column gets
// size / 2 groups, one a pair of the first level; at later levels the
// groups past the level's pairs add row 0 again and store nothing, so
// every lane runs every level; 32 / (size / 2) columns share a block, and
// the block's shared rows are always 32.  size is at most kTreeMaxRows =
// 64, the rows that one block's 32 groups fold in one step a level: far
// above any rank count the port's meshes have.
//
// Bound.  Bytes: point_add reads 320 and writes 160 bytes a point, the
// tree 160 R and 160 a column; the products (four lanes do twelve
// fe_mul a point, lane_cached's product on all four, where one thread
// does nine) take less at the card's modelled ~16.75e12 products/s.  A
// launch of a few thousand points or fewer is latency-bound: one
// dependent lane_add_pt (three products deep), and the tree log2(size) of
// them in a row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"
#include "lanes.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 128;       // 32 groups of four lanes a block
constexpr int kTreeMaxRows = 64;    // the tree's rows after padding: its
                                    // first level's pairs fill one block
constexpr int kRowWords = 44;       // shared words a row: four 11-word
                                    // coordinates (11 is odd: no bank
                                    // conflict between a warp's lanes)

__device__ __forceinline__ Fe sh_load(const int32_t* rows, int i, int j) {
    Fe r;
#pragma unroll
    for (int l = 0; l < 10; l++) r.v[l] = rows[i * kRowWords + j * 11 + l];
    return r;
}

__device__ __forceinline__ void sh_store(int32_t* rows, int i, int j,
                                         const Fe& f) {
#pragma unroll
    for (int l = 0; l < 10; l++) rows[i * kRowWords + j * 11 + l] = f.v[l];
}

__global__ void __launch_bounds__(kThreads)
point_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                 int32_t* __restrict__ out, int64_t B) {
    const int64_t e = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 2;
    const int j = threadIdx.x & 3;
    const int64_t at = e < B ? e : B - 1;
    const Fe r = lane_add_pt(j, fe_load(p, j, at, B), fe_load(q, j, at, B));
    if (e < B) fe_store(out, j, e, B, r);
}

__global__ void __launch_bounds__(kThreads)
point_tree_fold_kernel(const int32_t* __restrict__ stack,
                       int32_t* __restrict__ out, int64_t R, int64_t B,
                       int size) {
    __shared__ int32_t shared_rows[kThreads / 4 * kRowWords];
    const int j = threadIdx.x & 3, groups = size / 2;
    const int col = (threadIdx.x >> 2) / groups, g = (threadIdx.x >> 2) % groups;
    const int64_t b = (int64_t)blockIdx.x * (kThreads / 4 / groups) + col;
    const int64_t at = b < B ? b : B - 1;
    int32_t* rows = shared_rows + col * groups * kRowWords;
    const int64_t plane = 4 * 10 * B;               // words a stack row
    for (int h = groups; h >= 1; h >>= 1) {
        const int i = g < h ? g : 0;
        Fe a, c;
        if (h == groups) {
            // row i < size / 2 < R is the stack's; row i + h is the
            // identity where it pads the stack
            a = fe_load(stack + i * plane, j, at, B);
            c = i + h < R ? fe_load(stack + (i + h) * plane, j, at, B)
                          : lane_identity(j);
        } else {
            a = sh_load(rows, i, j);
            c = sh_load(rows, i + h, j);
        }
        const Fe s = lane_add_pt(j, a, c);
        if (g < h) {
            if (h > 1)          // row i: read at this level by its writer only
                sh_store(rows, i, j, s);
            else if (b < B)
                fe_store(out, j, b, B, s);
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int zkvm_point_add(const void* p, const void* q, void* out,
                              int64_t B, void* stream) {
    const int64_t blocks = (4 * B + kThreads - 1) / kThreads;
    if (blocks > 0)
        point_add_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
            (const int32_t*)p, (const int32_t*)q, (int32_t*)out, B);
    return (int)cudaGetLastError();
}

extern "C" int zkvm_point_tree_fold(const void* stack, void* out, int64_t R,
                                    int64_t B, void* stream) {
    if (R < 2 || R > kTreeMaxRows || B < 1) return (int)cudaErrorInvalidValue;
    int size = 1;
    while (size < R) size *= 2;
    const int cols = kThreads / 4 / (size / 2);
    const int64_t blocks = (B + cols - 1) / cols;
    point_tree_fold_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const int32_t*)stack, (int32_t*)out, R, B, size);
    return (int)cudaGetLastError();
}
