// K18 msm_ct: constant-time multiscalar multiplication, the window totals
// of Σ_i s_i·P_i for every group of a batch, with a schedule that does not
// depend on the scalars.
//
// Replaces the reference's native constant-time Straus MSM, ed_msm with
// ct = 1 (zkvm_tpu/native/edwards255.cpp:287, over build_table8,
// to_radix_16 and add_digit's ct branch, :104-160), reached by
// Engine.msm_secret (zkvm_tpu/proofs/engine.py:36-46; the JAX engine keeps
// secret MSMs under 4,096 points there, zkvm_tpu/kernels/engine.py:
// 134-145), and the range proof's A commitment, ed_bit_commit (:413-460).
// Plain twin: msm_ct.py msm_ct_plain (the same field operations in the
// same order, so the limbs agree bit for bit).
//
// A fixed-window ladder with full-table selects and no sort.  The scalars
// arrive canonical, as (8, n) int32 little-endian words, and are recoded
// on the card into 64 signed radix-16 digits each in [-8, 8]
// (radix16_next, the reference's to_radix_16).  Window total w of a group
// is T_w = Σ_i d_(i,w)·P_i; K4 (horner_check.cu) then folds Σ_w 16^w T_w.
//   1. msm_ct_chunk_kernel: one block per chunk, a run of up to kChunk
//      consecutive points of one group (the segment table's start and
//      count), kGroups = 64 groups of four lanes.  The chunk runs `slots`
//      slots, its count rounded up to kSlotStep: a public size, read from
//      the segment table, never from a digit.  Group g < slots builds the
//      table of the chunk's point g, its cached forms of 1·P .. 8·P (seven
//      additions), in shared memory, and lane 0 of the group recodes the
//      point's scalar into the chunk's digit table there (64 bytes a
//      point); a slot past the chunk's count takes the chunk's last point
//      and digit 0 (the identity).  Then group g is window g: from the
//      identity it adds, for each of the chunk's slots in order, the
//      select of the slot's table by the slot's digit g.  The tables stay
//      in shared memory across the 64 windows (1.28 KB a point), where
//      re-reading them from device memory would move 1.28 KB a point and
//      window.  It writes the chunk's 64 partial totals;
//   2. msm_ct_reduce_kernel, a fixed tree over the chunks: one block per
//      segment of up to msm_ct.FANIN consecutive rows of the level below
//      (a row = 64 window points), group g summing window g of its rows in
//      order (lane_add of each row's cached form).  Levels repeat until
//      each group has one row; a group already down to one row is copied.
// The chunk and segment tables are made on the host from the groups' sizes
// alone (msm_ct.py plan), which are public, and kept on the device by that
// tuple of sizes, so a repeated shape uploads nothing.
//
// The shape.  A window chain step is a select and a lane_add_lazy
// (lanes.cuh: no carry pass in its sums, none in the select's negation),
// and the fewer instructions a step are what made the kernel faster: the
// steps of 8 warps already share an SM's integer pipes, so more warps an
// SM bought little.  Timed on an H100 (700 W) with chunks of 64 points
// (84 KB of shared memory, 2 blocks an SM), 32 (42 KB; 2, 3 or 4 blocks
// by the register cap) and 16 (4 blocks), at 1, 2, 32 x 129 points and
// the 2^15 circuit's three phases: kChunk = 32 with kMinBlocks = 3 (80
// registers, 36 bytes spilled) was the fastest at 2^15 points (by 0.5-2 %
// over the other 32- and 64-point chunks, 8 % over 16) and within 4 % of
// them at the small shapes; chunks of 16 were 13 % faster at 32 x 129,
// where their chains are half as long and 288 blocks spread better over
// 132 SMs.  A select reads its eight entries with 8-byte loads (five a
// coordinate, not ten).
//
// Constant-time audit (ct_select.cuh audits the select):
//   * every chunk runs its `slots` slots of 64 windows, and every reduce
//     block its segment's count of rows: trip counts from the sizes, never
//     from a digit; which warps build a table (g < slots, whole warps,
//     since kSlotStep is a warp's eight groups) also comes from the count;
//   * a select reads all eight entries of its slot's table at shared
//     addresses made from the slot, the entry, the coordinate and the
//     limb; the digit is read at slot * 64 + g of the digit table, which
//     lane 0 of group g fills in order w = 0..63 by shifts, masks and adds
//     from the scalar's words, read at k * n + start + g;
//   * the slots past a chunk's count get digit 0 by an and with a mask
//     made from the public count, not a branch;
//   * lane_cached, lane_add_lazy, lane_add_pt (lanes.cuh) and the fe_mul,
//     fe_sq and carry_pass they run (field25519.cuh) are straight-line: selects on
//     the lane's coordinate j, loops of compile-time trip counts, no limb
//     value reaching a branch or an address.
// Scratch: the levels' rows below the last, one buffer the wrapper sizes
// (msm_ct.py scratch_len); the entry refuses one shorter than its plan
// needs (SCRATCH_TOO_SHORT), launching nothing.
// Bound: operations.  71 additions a point (7 for its table, 64 for its
// windows) and the tree's 64 a row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ct_select.cuh"
#include "field25519.cuh"
#include "lanes.cuh"

using namespace zk;

namespace {

constexpr int kWindows = 64;   // radix-16 digits a scalar
constexpr int kEntries = 8;    // 1·P .. 8·P
constexpr int kChunk = 32;     // points a chunk (one table a group)
constexpr int kSlotStep = 8;   // a chunk's slots: its count rounded up
constexpr int kMinBlocks = 3;  // chunk blocks an SM (the register cap)
constexpr int kGroups = kWindows;
constexpr int kEntryInts = 4 * 10;
constexpr int kTableInts = kEntries * kEntryInts;
constexpr int kScratchTooShort = -1;   // kernels/_build.py SCRATCH_TOO_SHORT
static_assert(kChunk % kSlotStep == 0 && kChunk <= kGroups &&
              kSlotStep % 8 == 0, "slots come in whole warps of groups");

__global__ void __launch_bounds__(4 * kGroups, kMinBlocks) msm_ct_chunk_kernel(
    const int32_t* __restrict__ pts, const int32_t* __restrict__ words,
    const int32_t* __restrict__ start, const int32_t* __restrict__ count,
    int32_t* __restrict__ out, int64_t n, int64_t rows) {
    extern __shared__ int32_t tab[];       // [kChunk][kEntries][4][10]
    int8_t* dig = reinterpret_cast<int8_t*>(tab + kChunk * kTableInts);
    const int c = blockIdx.x;
    const int g = threadIdx.x >> 2, j = threadIdx.x & 3;
    const int64_t s = start[c];
    const int cnt = count[c];
    const int slots = (cnt + kSlotStep - 1) / kSlotStep * kSlotStep;
    if (g < slots) {   // the table and digits of slot g (the chunk's last
                       // point past its count, its digits masked to 0)
        const int64_t idx = s + (g < cnt ? g : cnt - 1);
        if (j == 0) {
            const int32_t live = -(int32_t)(g < cnt);
            uint32_t cur = 0;
            int32_t carry = 0;
            for (int w = 0; w < kWindows; w++) {
                if ((w & 7) == 0) cur = (uint32_t)words[(w >> 3) * n + idx];
                dig[g * kWindows + w] =
                    (int8_t)(radix16_next(cur, carry) & live);
            }
        }
        Fe mine = fe_load(pts, j, idx, n);
        const Fe cp = lane_cached(j, mine);
        int32_t* t = tab + g * kTableInts + j * 10;
#pragma unroll
        for (int i = 0; i < 10; i++) t[i] = cp.v[i];
        for (int k = 1; k < kEntries; k++) {
            mine = lane_add_lazy(j, mine, cp);
            const Fe e = lane_cached(j, mine);
#pragma unroll
            for (int i = 0; i < 10; i++) t[k * kEntryInts + i] = e.v[i];
        }
    }
    __syncthreads();
    Fe acc = lane_identity(j);
    for (int slot = 0; slot < slots; slot++) {
        const int32_t d = dig[slot * kWindows + g];
        const int32_t* t = tab + slot * kTableInts + j * 10;
        const Fe sel = lane_select_signed(
            j, [&](int k) { return fe_load_row(t + k * kEntryInts); }, d);
        acc = lane_add_lazy(j, acc, sel);
    }
    fe_store(out, j, (int64_t)c * kWindows + g, rows * kWindows, acc);
}

__global__ void __launch_bounds__(4 * kGroups) msm_ct_reduce_kernel(
    const int32_t* __restrict__ in, int64_t rows_in,
    const int32_t* __restrict__ start, const int32_t* __restrict__ count,
    int32_t* __restrict__ out, int64_t rows_out) {
    const int r = blockIdx.x;
    const int g = threadIdx.x >> 2, j = threadIdx.x & 3;
    const int64_t s = start[r];
    const int cnt = count[r];
    const int64_t stride = rows_in * kWindows;
    Fe acc = fe_load(in, j, s * kWindows + g, stride);
    for (int k = 1; k < cnt; k++)
        acc = lane_add_pt(j, acc, fe_load(in, j, (s + k) * kWindows + g,
                                          stride));
    fe_store(out, j, (int64_t)r * kWindows + g, rows_out * kWindows, acc);
}

}  // namespace

// segs (device): per level l, start[rows_l] then count[rows_l], levels in
// order; level_rows (host): rows_l, level 0 the chunks, the last the
// groups.  Level l < nlevels - 1 writes its rows to scratch (4, 10,
// rows_l * 64) at the running offset; the last writes out (4, 10,
// groups * 64).
extern "C" int zkvm_msm_ct(const void* pts, const void* words,
                           const void* segs, const void* level_rows,
                           int nlevels, void* scratch, int64_t scratch_len,
                           void* out, int64_t n, void* stream) {
    const int64_t* rows = (const int64_t*)level_rows;
    if (nlevels <= 0 || n <= 0) return 0;
    int64_t need = 0;
    for (int l = 0; l + 1 < nlevels; l++) need += rows[l] * kWindows * 40;
    if (scratch_len < need) return kScratchTooShort;
    const cudaStream_t st = (cudaStream_t)stream;
    const size_t smem = (size_t)kChunk * kTableInts * sizeof(int32_t)
                        + (size_t)kChunk * kWindows;
    cudaError_t e = cudaFuncSetAttribute(
        msm_ct_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int32_t* seg = (const int32_t*)segs;
    int32_t* level_out = nlevels == 1 ? (int32_t*)out : (int32_t*)scratch;
    msm_ct_chunk_kernel<<<(unsigned)rows[0], 4 * kGroups, smem, st>>>(
        (const int32_t*)pts, (const int32_t*)words, seg, seg + rows[0],
        level_out, n, rows[0]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    seg += 2 * rows[0];
    for (int l = 1; l < nlevels; l++) {
        const int32_t* in = level_out;
        level_out = l + 1 == nlevels
                        ? (int32_t*)out
                        : level_out + rows[l - 1] * kWindows * 40;
        msm_ct_reduce_kernel<<<(unsigned)rows[l], 4 * kGroups, 0, st>>>(
            in, rows[l - 1], seg, seg + rows[l], level_out, rows[l]);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        seg += 2 * rows[l];
    }
    return 0;
}
