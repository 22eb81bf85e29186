// K17 fixed_base_ct: constant-time fixed-base multiplication and Pedersen
// commitments, v_i·P + b_i·Q (or v_i·P alone) for a batch, one launch.
//
// Replaces the reference's native fixed-base path, which keeps every
// secret scalar constant-time on the host: ed_fixed_init, ed_fixed_mul
// and ed_fixed_commit_batch (zkvm_tpu/native/edwards255.cpp:462-514),
// reached by Engine.basepoint_mul, commit and commit_batch
// (zkvm_tpu/proofs/engine.py:48-80), with add_digit's ct branch and
// ge_cmov (:104-160).  Plain twins: fixed_base.py table_plain and
// fixed_base_plain (the same field operations in the same order, so the
// limbs agree bit for bit).
//
// Table (fixed_base_table_kernel, set-up, once a base): 64 windows of 8
// entries, entry k of window w the cached form (lanes.cuh) of
// (k + 1)·16^w·P, as (64, 8, 4, 10) int32 (window, entry, coordinate,
// limb): 80 KB a base.  One warp: p = P; per window, entry 0 is p's cached
// form and entry k the cached form of p + k·p (seven additions); then p
// <- 16 p (four doublings).  Every group of the warp runs the chain; group
// 0 writes.
//
// Multiplication (fixed_base_kernel): S = 64 groups of four lanes per
// output (one window a group, 8 warps an output), lane j of a group its
// coordinate j, split by window:
// v·P + b·Q = Σ_w (d_w(v)·16^w·P + d_w(b)·16^w·Q), and every term is one
// masked pick from the resident tables, so the sum need not be one chain.
// The scalars arrive canonical, as (8, n) int32 little-endian words.
// Group s of an output owns window s; it finds its digit's carry with
// radix16_seek and recodes it with radix16_next (the reference's
// to_radix_16: signed digits in [-8, 8]).  From the identity it adds the
// select of P's row by v's digit, then (two bases) of Q's by b's: one or
// two additions.  The S partial sums then meet in a fixed binary tree
// through shared memory, log2 S = 6 levels: at each, pair p of an output
// becomes part[2p] + part[2p + 1] (lane_cached, lane_add_lazy), the pairs
// of all the block's outputs dealt to its first groups.  The dependent
// path of one output is one or two select + add steps and six tree
// levels, where one chain took 64 (or 128).  Timed on an H100 (700 W) at
// S = 8, 16, 32 and 64 and 1, 512 and 4,096 outputs, S = 64 was the
// fastest up to 512 outputs and S = 16 at 4,096 (the tree's 63 additions
// an output against 15 then count); every caller batches at most 128
// outputs, so only S = 64 is built (fixed_base.py SPLIT).  The output is
// (4, 10, n) int32 in the extended coordinates lane_add_lazy leaves.
//
// Constant-time audit (ct_select.cuh audits the select and the recode):
//   * every group runs its one window with one or two selects and
//     additions, then every tree level: trip counts from S and the base
//     count, the call's shape, never a digit;
//   * a window's row is read whole (all eight entries) at addresses made
//     from the window (the group's place s), the entry index and the lane,
//     so the memory traffic is the same for every scalar; each lane reads
//     its scalars' eight words at k * n + i and keeps its window's word by
//     mask (radix16_seek), then recodes by shifts, masks and adds;
//   * the tree's groups, pairs, shared addresses and which warps add at a
//     level come from S, the level and the group's index; a warp adds at a
//     level when its first group has a pair there (a branch on public
//     counts), the groups past the last pair add a copy and do not store;
//   * lane_add_lazy and lane_cached (lanes.cuh) and the fe_mul / carry_pass
//     they run (field25519.cuh) are straight-line: their selects are on the
//     lane's coordinate j, their loops have compile-time trip counts, and
//     no limb value reaches a branch or an address;
//   * the outputs past the batch's end (a partial block) compute on the
//     last output and do not store: a branch on n, which is public.
// Bound: operations.  64 (or 128) additions of 8 products an output, read
// from an 80 KB table a base that every group of the card shares through
// L1 and L2; the tree adds S - 1 = 63 an output, the price of the short
// path.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ct_select.cuh"
#include "field25519.cuh"
#include "lanes.cuh"

using namespace zk;

namespace {

constexpr int kWindows = 64;   // radix-16 digits of a canonical scalar
constexpr int kEntries = 8;    // (k + 1)·16^w·P, k = 0..7
constexpr int kThreads = 256;  // lanes a multiplication block: 64 groups
constexpr int kSplit = 64;     // groups an output (fixed_base.py SPLIT)
constexpr int kEntryInts = 4 * 10;

__device__ __forceinline__ void fe_store_row(int32_t* __restrict__ p,
                                             const Fe& f) {
#pragma unroll
    for (int i = 0; i < 10; i++) p[i] = f.v[i];
}

__global__ void __launch_bounds__(32, 1) fixed_base_table_kernel(
    const int32_t* __restrict__ point, int32_t* __restrict__ table) {
    const int lane = threadIdx.x, j = lane & 3;
    Fe p = fe_load(point, j, 0, 1);
    for (int w = 0; w < kWindows; w++) {
        int32_t* row = table + (size_t)w * kEntries * kEntryInts + j * 10;
        const Fe cp = lane_cached(j, p);
        if (lane < 4) fe_store_row(row, cp);
        Fe mine = p;
        for (int k = 1; k < kEntries; k++) {
            mine = lane_add(j, mine, cp);
            const Fe c = lane_cached(j, mine);
            if (lane < 4) fe_store_row(row + k * kEntryInts, c);
        }
#pragma unroll
        for (int d = 0; d < 4; d++) p = lane_dbl(j, p);
    }
}

// acc + digit·(window w of table), coordinate j
__device__ __forceinline__ Fe add_window(int j, const Fe& acc,
                                         const int32_t* __restrict__ table,
                                         int w, int32_t digit) {
    const int32_t* row = table + (size_t)w * kEntries * kEntryInts + j * 10;
    const Fe s = lane_select_signed(
        j, [&](int k) { return fe_load_row(row + k * kEntryInts); }, digit);
    return lane_add_lazy(j, acc, s);
}

__global__ void __launch_bounds__(kThreads) fixed_base_kernel(
    const int32_t* __restrict__ tab_p, const int32_t* __restrict__ tab_q,
    const int32_t* __restrict__ sp, const int32_t* __restrict__ sq,
    int32_t* __restrict__ out, int64_t n, int nbases) {
    constexpr int S = kSplit;
    constexpr int kGroups = kThreads / 4;
    constexpr int kOutputs = kGroups / S;     // outputs a block
    constexpr int kPer = kWindows / S;        // windows a group
    static_assert(kOutputs * S == kGroups && kPer * S == kWindows &&
                  kPer <= 8, "a group's windows lie in one word");
    // [group][coord][limb], 8-byte aligned for fe_load_row
    __shared__ __align__(16) int32_t part[kGroups][kEntryInts];
    const int g = threadIdx.x >> 2, j = threadIdx.x & 3;
    const int64_t first = (int64_t)blockIdx.x * kOutputs;
    const int64_t mine = first + g / S;
    const int64_t i = mine < n ? mine : n - 1;
    const int w0 = (g % S) * kPer;
    uint32_t cur_p, cur_q;
    int32_t carry_p, carry_q;
    radix16_seek(sp, n, i, w0, cur_p, carry_p);
    radix16_seek(sq, n, i, w0, cur_q, carry_q);
    Fe acc = lane_identity(j);
#pragma unroll
    for (int t = 0; t < kPer; t++) {
        acc = add_window(j, acc, tab_p, w0 + t, radix16_next(cur_p, carry_p));
        const int32_t dq = radix16_next(cur_q, carry_q);
        if (nbases == 2) acc = add_window(j, acc, tab_q, w0 + t, dq);
    }
    // the tree: part[o S + p] holds output o's partial sum p
    fe_store_row(part[g] + j * 10, acc);
    __syncthreads();
#pragma unroll
    for (int pairs = S / 2; pairs >= 1; pairs >>= 1) {
        constexpr int kWarpGroups = 8;
        const int live = kOutputs * pairs;       // pairs at this level
        const int me = g < live ? g : live - 1;
        const int o = me / pairs, p = me % pairs;
        if ((g & ~(kWarpGroups - 1)) < live)     // the warp has a pair
            acc = lane_add_lazy(
                j, fe_load_row(part[o * S + 2 * p] + j * 10),
                lane_cached(j, fe_load_row(part[o * S + 2 * p + 1] + j * 10)));
        __syncthreads();
        if (g < live) fe_store_row(part[o * S + p] + j * 10, acc);
        __syncthreads();
    }
    if (g < kOutputs && first + g < n) fe_store(out, j, first + g, n, acc);
}

}  // namespace

extern "C" int zkvm_fixed_base_table(const void* point, void* table,
                                     void* stream) {
    fixed_base_table_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)point, (int32_t*)table);
    return (int)cudaGetLastError();
}

extern "C" int zkvm_fixed_base_ct(const void* tab_p, const void* tab_q,
                                  const void* sp, const void* sq, void* out,
                                  int64_t n, int nbases, void* stream) {
    if (n <= 0) return 0;
    if (nbases != 1 && nbases != 2) return (int)cudaErrorInvalidValue;
    constexpr int kOutputs = kThreads / 4 / kSplit;
    const unsigned blocks = (unsigned)((n + kOutputs - 1) / kOutputs);
    fixed_base_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tab_p, (const int32_t*)tab_q, (const int32_t*)sp,
        (const int32_t*)sq, (int32_t*)out, n, nbases);
    return (int)cudaGetLastError();
}
