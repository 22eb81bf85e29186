// K4 horner_check: window combine by Horner's rule and the Ristretto
// identity test, one warp per check, the four coordinates on four lanes.
//
// Replaces the JAX package's pallas_msm.py::_horner_kernel (called from
// horner_fold_device) together with the identity test that
// _combine_check_core runs after it: acc = T_{nw-1}, then for each lower
// window wbits doublings and acc += T_w; the check passes iff the
// canonical X or Y of acc is zero — the identity coset of the cofactor-8
// quotient, not equality with (0, 1, 1, 0).  It writes the folded point,
// as horner_fold_device returns it, and the verdict.  Plain twin:
// combine.py horner_fold_plain (the same formulas in the same order).
//
// Bound: latency.  One check is a chain of (nw - 1) * (wbits + 1)
// dependent point operations and the card has nothing else to run, so
// what counts is the length of the chain of field multiplications.  The
// TPU kernel replicated the totals over 128 lanes because Mosaic could not
// do better; here each level of a point operation puts its four
// independent multiplications on four lanes, which run one instruction
// stream on their own operands:
//   * doubling (dbl-2008-hwcd, a = -1): lane j squares X, Y, Z or X + Y;
//     then every lane forms E, F, G, H and lane j multiplies the pair of
//     output coordinate j (E F, G H, F G, E H);
//   * addition (add-2008-hwcd-3, a = -1, k = 2d) of a window total in
//     cached form (Y - X, Y + X, 2d T, 2 Z), which the warp's lanes compute
//     for all windows before the chain, into shared memory: lane j forms
//     A = (Y1 - X1)(Y - X), B = (Y1 + X1)(Y + X), C = T1 (2d T) or
//     D = Z1 (2 Z); then E, F, G, H and the products as above.
// Two multiplications deep per point operation instead of the one
// thread's eight or nine: (nw - 1) (2 wbits + 2) levels, 552 at nw = 24,
// w = 11.  Operands cross lanes by __shfl_sync within each group of four;
// the warp's eight groups all run the check (no lane diverges) and group 0
// writes.  fe_mul and fe_sq are field25519.cuh's, so its limb audit holds.
//
// Input (4, 10, C * nw) int32 window totals, check c's window w at lane
// c * nw + w; output the folded points (4, 10, C) int32 and the verdicts
// (C,) int32.  Dynamic shared memory: nw * 160 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

namespace {

// coordinate `src` of the point held across the caller's group of four
__device__ __forceinline__ Fe shfl_fe(const Fe& f, int src) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = __shfl_sync(0xffffffffu, f.v[i], src, 4);
    return r;
}

// a0, a1, a2 or a3 by the lane's coordinate j, limb by limb (selects, so
// that no operand leaves the registers)
__device__ __forceinline__ Fe sel4(int j, const Fe& a0, const Fe& a1,
                                   const Fe& a2, const Fe& a3) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++)
        r.v[i] = j == 0 ? a0.v[i] : j == 1 ? a1.v[i] : j == 2 ? a2.v[i] : a3.v[i];
    return r;
}

// Lane j's output coordinate from E, F, G, H held on every lane:
// X = E F, Y = G H, Z = F G, T = E H.
__device__ __forceinline__ Fe finish(int j, const Fe& E, const Fe& F,
                                     const Fe& G, const Fe& H) {
    return fe_mul(sel4(j, E, G, F, E), sel4(j, F, H, G, H));
}

// one doubling; lane j holds coordinate j of the point before and after
__device__ __forceinline__ Fe lane_dbl(int j, const Fe& mine) {
    const Fe x = shfl_fe(mine, 0), y = shfl_fe(mine, 1);
    const Fe xy = fe_add(x, y);
    const Fe s = fe_sq(sel4(j, mine, mine, mine, xy));  // A, B, Zz, (X+Y)^2
    const Fe A = shfl_fe(s, 0), B = shfl_fe(s, 1);
    const Fe Zz = shfl_fe(s, 2), S = shfl_fe(s, 3);
    const Fe C = fe_add(Zz, Zz);
    const Fe E = fe_sub(fe_sub(S, A), B);
    const Fe G = fe_sub(B, A);
    const Fe F = fe_sub(G, C);
    const Fe H = fe_sub(fe_neg(A), B);
    return finish(j, E, F, G, H);
}

// acc + q with q's cached coordinate j in `cached`
__device__ __forceinline__ Fe lane_add(int j, const Fe& mine,
                                       const Fe& cached) {
    const Fe X = shfl_fe(mine, 0), Y = shfl_fe(mine, 1);
    const Fe Z = shfl_fe(mine, 2), T = shfl_fe(mine, 3);
    const Fe ym = fe_sub(Y, X), yp = fe_add(Y, X);
    const Fe v = fe_mul(sel4(j, ym, yp, T, Z), cached);   // A, B, C, D
    const Fe A = shfl_fe(v, 0), B = shfl_fe(v, 1);
    const Fe C = shfl_fe(v, 2), D = shfl_fe(v, 3);
    return finish(j, fe_sub(B, A), fe_sub(D, C), fe_add(D, C), fe_add(B, A));
}

__global__ void horner_check_kernel(const int32_t* __restrict__ totals,
                                    int32_t* __restrict__ folded,
                                    int32_t* __restrict__ out, int nchecks,
                                    int nw, int wbits) {
    extern __shared__ int32_t cached[];             // [nw][4][10]
    const int c = blockIdx.x;
    const int lane = threadIdx.x, j = lane & 3;
    const int64_t stride = (int64_t)nchecks * nw;
    const int64_t first = (int64_t)c * nw;
    for (int w = lane; w < nw; w += 32) {             // cached forms
        const Pt q = pt_load(totals, first + w, stride);
        Fe f[4] = {fe_sub(q.Y, q.X), fe_add(q.Y, q.X),
                   fe_mul(q.T, fe_const(kD2)), fe_add(q.Z, q.Z)};
#pragma unroll
        for (int k = 0; k < 4; k++)
#pragma unroll
            for (int i = 0; i < 10; i++) cached[(w * 4 + k) * 10 + i] = f[k].v[i];
    }
    Fe acc = fe_load(totals, j, first + nw - 1, stride);
    __syncwarp();
    for (int w = nw - 2; w >= 0; w--) {
        for (int d = 0; d < wbits; d++) acc = lane_dbl(j, acc);
        Fe q;
#pragma unroll
        for (int i = 0; i < 10; i++) q.v[i] = cached[(w * 4 + j) * 10 + i];
        acc = lane_add(j, acc, q);
    }
    const bool zero = fe_is_zero(acc);
    const bool ident = __shfl_sync(0xffffffffu, zero, 0, 4)
                       || __shfl_sync(0xffffffffu, zero, 1, 4);
    if (lane < 4) fe_store(folded, j, c, nchecks, acc);
    if (lane == 0) out[c] = ident ? 1 : 0;
}

}  // namespace

extern "C" int zkvm_horner_check(const void* totals, void* folded, void* out,
                                 int nchecks, int nw, int wbits,
                                 void* stream) {
    if (nchecks <= 0 || nw <= 0) return 0;
    const size_t smem = (size_t)nw * 4 * 10 * sizeof(int32_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            horner_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    horner_check_kernel<<<nchecks, 32, smem, (cudaStream_t)stream>>>(
        (const int32_t*)totals, (int32_t*)folded, (int32_t*)out, nchecks, nw,
        wbits);
    return (int)cudaGetLastError();
}
