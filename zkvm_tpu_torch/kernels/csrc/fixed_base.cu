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
// Multiplication (fixed_base_kernel): one group of four lanes per output,
// lane j its coordinate j.  The scalars arrive canonical, as (8, n) int32
// little-endian words; each lane recodes its output's scalars as it goes
// (radix16_next, the reference's to_radix_16: 64 signed digits in
// [-8, 8], least significant first, the order the windows are added in).
// acc starts at the identity; for w = 0..63 it adds the select of P's
// window w by v's digit w, then (two bases) of Q's by b's: 64 or 128
// additions, no doubling.  The output is (4, 10, n) int32 in the extended
// coordinates lane_add leaves.
//
// Constant-time audit (ct_select.cuh audits the select):
//   * the loop runs 64 windows for every output, with one or two selects
//     and additions each; its trip count and the base count are the call's
//     shape, never a digit;
//   * a window's row is read whole (all eight entries) at addresses made
//     from w, the entry index and the lane, so the memory traffic is the
//     same for every scalar; scalar word k is read at k * n + i before
//     window 8 k, and recoded by shifts, masks and adds;
//   * lane_add (lanes.cuh) and the fe_mul / carry_pass it runs
//     (field25519.cuh) are straight-line: their selects are on the lane's
//     coordinate j, their loops have compile-time trip counts, and no
//     limb value reaches a branch or an address;
//   * the groups past the batch's end (a partial block) compute on the
//     last output and do not store: a branch on n, which is public.
// Bound: operations.  64 (or 128) additions of 8 products an output, read
// from an 80 KB table a base that every group of the card shares through
// L1 and L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ct_select.cuh"
#include "field25519.cuh"
#include "lanes.cuh"

using namespace zk;

namespace {

constexpr int kWindows = 64;   // radix-16 digits of a canonical scalar
constexpr int kEntries = 8;    // (k + 1)·16^w·P, k = 0..7
constexpr int kGroups = 32;    // outputs (groups of four lanes) per block
constexpr int kEntryInts = 4 * 10;

__device__ __forceinline__ Fe fe_load_row(const int32_t* __restrict__ p) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = p[i];
    return r;
}

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
    return lane_add(j, acc, s);
}

__global__ void __launch_bounds__(4 * kGroups) fixed_base_kernel(
    const int32_t* __restrict__ tab_p, const int32_t* __restrict__ tab_q,
    const int32_t* __restrict__ sp, const int32_t* __restrict__ sq,
    int32_t* __restrict__ out, int64_t n, int nbases) {
    const int64_t mine = (int64_t)blockIdx.x * kGroups + (threadIdx.x >> 2);
    const int j = threadIdx.x & 3;
    const int64_t i = mine < n ? mine : n - 1;
    uint32_t cur_p = 0, cur_q = 0;
    int32_t carry_p = 0, carry_q = 0;
    Fe acc = lane_identity(j);
    for (int w = 0; w < kWindows; w++) {
        if ((w & 7) == 0) {               // the next word, every 8 windows
            cur_p = (uint32_t)sp[(w >> 3) * n + i];
            cur_q = (uint32_t)sq[(w >> 3) * n + i];
        }
        acc = add_window(j, acc, tab_p, w, radix16_next(cur_p, carry_p));
        const int32_t dq = radix16_next(cur_q, carry_q);
        if (nbases == 2) acc = add_window(j, acc, tab_q, w, dq);
    }
    if (mine < n) fe_store(out, j, i, n, acc);
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
    const unsigned blocks = (unsigned)((n + kGroups - 1) / kGroups);
    fixed_base_kernel<<<blocks, 4 * kGroups, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tab_p, (const int32_t*)tab_q, (const int32_t*)sp,
        (const int32_t*)sq, (int32_t*)out, n, nbases);
    return (int)cudaGetLastError();
}
