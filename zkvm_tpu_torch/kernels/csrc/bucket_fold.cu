// K3 bucket_fold: the weighted bucket sum Σ_b b · B_b of every window.
//
// Replaces the JAX package's two-stage weighted fold:
// pallas_msm.py::_fold_kernel_factory (stage 1: per-lane running sums
// over the lane's buckets, highest first) and ::_fold_combine_kernel
// (stage 2: Σ_l W_l + R · Σ_{l>=1} SufT_l).  The TPU carried stage 1
// across an ordered grid axis.  It also serves the small route
// (msm.window_totals_small, nb = 128 at w = 8), in place of that route's
// suffix scan and tree of point_add_lm (pallas_msm.py::_bucket_totals,
// :311-321).  Plain twin: msm.py bucket_fold_plain (the same additions in
// the same association, so the limbs agree bit for bit).
//
// Bound: latency.  The work is small (2 point additions per bucket, 9 field
// multiplications each, against 160 bytes read per bucket: 24 windows x
// 1,024 buckets is ~50 k additions), so what sets the time is the chain of
// dependent point operations and how many SMs run it.  The first design
// ran one block of 128 threads per window: 24 blocks on 132 SMs,
// one whole point operation per thread at 255 registers with spills, ~34
// dependent operations of ~18 us each.  This design spreads each window
// over nb / 256 blocks (96 at w = 11) and splits every point operation over
// four lanes (lanes.cuh: one coordinate per lane), so a dependent addition
// is three multiplications deep instead of nine serial ones, at 96 and 162
// registers without spills; the tree sums of a block's two or three
// sequences are spread over all its groups, one addition per step.
//
// The identity used twice: for consecutive items x_0 .. x_{GR-1} owned by G
// groups of R,
//   Σ_i (i + 1) x_i = Σ_g W_g + R · Σ_{g>=1} SufT_g,
// where group g walks its items highest first keeping T_g (their sum) and
// W_g = Σ_r (r + 1) x_{gR+r}, and SufT_g = Σ_{h>=g} T_h: a suffix scan over
// the groups, tree sums, and log2(R) doublings (lanes.cuh block_combine).
//
// One or two launches from one C call:
//   1. bucket_fold_block_kernel, one block of G = min(32, nb / R) groups of
//      four lanes per run of BB = R G consecutive buckets (R = nb / 32
//      within 1 to 8, so a block holds 32 groups from nb = 32 on), padded
//      to one warp with idle groups that add identities.  Each group walks
//      its R buckets from the highest, starting from the first one loaded.
//      Where a window is one run (nblk = nb / BB = 1: nb <= 256), the
//      block's W = Σ_i (i + 1) B_i is the window's total and is written to
//      `out`: one launch, no scratch.  Otherwise it writes the block's
//      T_k = Σ B and W_k = Σ_i (i + 1) B_{k BB + i} to the scratch `part`
//      (2, 4, 10, nw * nblk); the C entry takes its length and returns
//      kScratchTooShort, launching nothing, when it is shorter (msm.py
//      sizes it from its own copies of kRun and kMaxGroups).
//   2. (nblk > 1) bucket_fold_window_kernel, one block per window over its nblk
//      (T_k, W_k): Σ_b b B_b = Σ_k W_k + BB · Σ_k k T_k, with
//      Σ_k k T_k = Σ_g V_g + R2 · Σ_{g>=1} SufT_g over G2 = min(32, nblk)
//      groups of R2 = nblk / G2 blocks, V_g = Σ_r r T_{g R2 + r}, and
//      log2(BB) doublings.
// The second pass is a launch of its own (not the last block of the first
// to finish), so its order of additions is fixed.  Every addition is
// acc + q with q's cached form made from the point (lanes.cuh
// lane_add_pt).  nb must be a power of two from 1 to 2^16.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"
#include "lanes.cuh"

using namespace zk;

namespace {

constexpr int kRun = 8;          // most buckets per group in the first launch
constexpr int kMaxGroups = 32;   // groups per block

// Σ over the block's groups (module note).  In: group g's T, V and, with
// kW, W, for g < G; the block has NG >= G groups.  Out, on group 0: tsum =
// Σ_g T_g, vout = Σ_g V_g ⊕ R · Σ_{g>=1} SufT_g, and wout = Σ_g W_g.  The
// tree sums of the two or three sequences run side by side: each step's
// additions (half of them per sequence) are spread over all NG groups, so
// a step is one addition deep.  Groups without a task add and discard.
template <bool kW>
__device__ void block_combine(int j, int g, int NG, int G, int log2_r, Fe T,
                              Fe V, Fe W, Fe (*sa)[4], Fe (*sb)[4],
                              Fe (*sc)[4], Fe& tsum, Fe& vout, Fe& wout) {
    // suffix scan: T_g <- Σ_{h>=g} T_h
    for (int off = 1; off < G; off *= 2) {
        sa[g][j] = T;
        __syncthreads();
        const bool in = g + off < G;
        const Fe o = sa[in ? g + off : g][j];
        __syncthreads();
        T = fe_select(in, lane_add_pt(j, T, o), T);
    }
    sa[g][j] = T;
    __syncthreads();
    tsum = sa[0][j];
    __syncthreads();
    // tree sums of SufT_1.. (SufT_0 replaced by the identity), V and W
    sa[g][j] = g == 0 ? lane_identity(j) : T;
    sb[g][j] = V;
    if (kW) sc[g][j] = W;
    constexpr int kTrees = kW ? 3 : 2;
    for (int half = G / 2; half >= 1; half /= 2) {
        for (int t0 = 0; t0 < kTrees * half; t0 += NG) {
            const int t = t0 + g, tree = t / half, slot = t % half;
            const bool task = t < kTrees * half;
            Fe (*arr)[4] = tree == 0 ? sa : tree == 1 ? sb : sc;
            __syncthreads();
            const Fe x = task ? arr[slot][j] : lane_identity(j);
            const Fe y = task ? arr[slot + half][j] : lane_identity(j);
            const Fe sum = lane_add_pt(j, x, y);
            __syncthreads();
            if (task) arr[slot][j] = sum;
        }
    }
    __syncthreads();
    Fe U = sa[0][j];
    vout = sb[0][j];
    wout = kW ? sc[0][j] : vout;
    for (int d = 0; d < log2_r; d++) U = lane_dbl(j, U);
    vout = lane_add_pt(j, vout, U);
}

// kR buckets a group (1, 2, 4 or 8), a compile-time constant so that the
// walk is unrolled.  out is null where the window takes several blocks.
template <int kR>
__global__ void bucket_fold_block_kernel(const int32_t* __restrict__ buckets,
                                         int32_t* __restrict__ part,
                                         int32_t* __restrict__ out, int nw,
                                         int nb, int G) {
    constexpr int kLog2R = kR == 8 ? 3 : kR == 4 ? 2 : kR == 2 ? 1 : 0;
    __shared__ Fe sa[kMaxGroups][4], sb[kMaxGroups][4];
    const int g = threadIdx.x >> 2, j = threadIdx.x & 3;
    const int64_t M = (int64_t)gridDim.x;             // nw * nblk
    const int64_t stride = (int64_t)nw * nb;
    // block blockIdx.x = w * nblk + k owns buckets w nb + k BB .. + BB - 1,
    // which are the contiguous range starting at blockIdx.x * BB; groups
    // from G on (a block padded to one warp) own none and add identities,
    // since every lane of a warp takes part in the shuffles
    const int64_t first = (int64_t)blockIdx.x * G * kR + g * kR;
    auto load = [&](int r) {
        return g < G ? fe_load(buckets, j, first + r, stride)
                     : lane_identity(j);
    };
    Fe T = load(kR - 1);
    Fe V = T;
    for (int r = kR - 2; r >= 0; r--) {
        T = lane_add_pt(j, T, load(r));
        V = lane_add_pt(j, V, T);
    }
    Fe tsum, vout, wout;
    block_combine<false>(j, g, blockDim.x / 4, G, kLog2R, T, V, V, sa, sb,
                         sb, tsum, vout, wout);
    if (g == 0 && out != nullptr) {
        fe_store(out, j, blockIdx.x, nw, vout);     // nblk = 1: block = window
    } else if (g == 0) {
        fe_store(part, j, blockIdx.x, M, tsum);
        fe_store(part + 40 * M, j, blockIdx.x, M, vout);
    }
}

__global__ void bucket_fold_window_kernel(const int32_t* __restrict__ part,
                                          int32_t* __restrict__ out, int nw,
                                          int nblk, int G2, int log2_r2,
                                          int log2_bb) {
    __shared__ Fe sa[kMaxGroups][4], sb[kMaxGroups][4], sc[kMaxGroups][4];
    const int g = threadIdx.x >> 2, j = threadIdx.x & 3;
    const int w = blockIdx.x;
    const int64_t M = (int64_t)nw * nblk;
    const int R2 = nblk / G2;
    const bool active = g < G2;
    Fe T = lane_identity(j), V = lane_identity(j), W = lane_identity(j);
    for (int r = R2 - 1; r >= 0; r--) {
        const int64_t k = (int64_t)w * nblk + g * R2 + r;
        Fe tk = lane_identity(j), wk = lane_identity(j);
        if (active) {
            tk = fe_load(part, j, k, M);
            wk = fe_load(part + 40 * M, j, k, M);
        }
        V = lane_add_pt(j, V, T);
        T = lane_add_pt(j, T, tk);
        W = lane_add_pt(j, W, wk);
    }
    Fe tsum, vout, wout;
    block_combine<true>(j, g, blockDim.x / 4, G2, log2_r2, T, V, W, sa, sb,
                        sc, tsum, vout, wout);
    for (int d = 0; d < log2_bb; d++) vout = lane_dbl(j, vout);
    const Fe total = lane_add_pt(j, wout, vout);
    if (g == 0) fe_store(out, j, w, nw, total);
}

int log2_exact(int x) {
    int k = 0;
    while ((1 << k) < x) k++;
    return k;
}

}  // namespace

constexpr int kScratchTooShort = -1;   // _build.py SCRATCH_TOO_SHORT

extern "C" int zkvm_bucket_fold(const void* buckets, void* part,
                                int64_t part_len, void* out, int nw, int nb,
                                void* stream) {
    if (nw < 0 || nb < 1 || nb > (1 << 16) || (nb & (nb - 1)))
        return (int)cudaErrorInvalidValue;
    if (nw == 0) return 0;
    const int per = nb / kMaxGroups;
    const int R = per < 1 ? 1 : per < kRun ? per : kRun;
    const int G = nb / R < kMaxGroups ? nb / R : kMaxGroups;
    const int bb = G * R, nblk = nb / bb;
    if (part_len < (nblk > 1 ? 80 * (int64_t)nw * nblk : 0))
        return kScratchTooShort;
    const int G2 = nblk < kMaxGroups ? nblk : kMaxGroups;
    const unsigned threads = 4 * G < 32 ? 32 : 4 * G;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* b = (const int32_t*)buckets;
    int32_t* p = (int32_t*)part;
    int32_t* o = nblk == 1 ? (int32_t*)out : nullptr;
    if (R == 8)
        bucket_fold_block_kernel<8><<<nw * nblk, threads, 0, st>>>(b, p, o, nw, nb, G);
    else if (R == 4)
        bucket_fold_block_kernel<4><<<nw * nblk, threads, 0, st>>>(b, p, o, nw, nb, G);
    else if (R == 2)
        bucket_fold_block_kernel<2><<<nw * nblk, threads, 0, st>>>(b, p, o, nw, nb, G);
    else
        bucket_fold_block_kernel<1><<<nw * nblk, threads, 0, st>>>(b, p, o, nw, nb, G);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || nblk == 1) return (int)e;
    bucket_fold_window_kernel<<<nw, 4 * G2 < 32 ? 32 : 4 * G2, 0, st>>>(
        (const int32_t*)part, (int32_t*)out, nw, nblk, G2,
        log2_exact(nblk / G2), log2_exact(bb));
    return (int)cudaGetLastError();
}
