// K4 horner_check: window combine by Horner's rule and the Ristretto
// identity test, one thread per check.
//
// Replaces the JAX package's pallas_msm.py::_horner_kernel (called from
// horner_fold_device) together with the identity test that
// _combine_check_core runs after it: acc = T_{nw-1}, then for each lower
// window wbits doublings and acc += T_w; the check passes iff the
// canonical X or Y of acc is zero — the identity coset of the cofactor-8
// quotient, not equality with (0, 1, 1, 0).  Plain twin: combine.py
// horner_check_plain.
//
// Input (4, 10, C * nw) int32 window totals, check c's window w at lane
// c * nw + w; output (C,) int32.  Bound: latency.  One check is a chain of
// (nw - 1) * (wbits + 1) dependent point operations (~250 at nw = 20)
// on a single thread; the card has nothing else to run in parallel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

__global__ void horner_check_kernel(const int32_t* __restrict__ totals,
                                    int32_t* __restrict__ out, int nchecks,
                                    int nw, int wbits) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= nchecks) return;
    const int64_t stride = (int64_t)nchecks * nw;
    Pt acc = pt_load(totals, (int64_t)c * nw + nw - 1, stride);
    for (int w = nw - 2; w >= 0; w--) {
        for (int d = 0; d < wbits; d++) acc = pt_dbl(acc);
        acc = pt_add(acc, pt_load(totals, (int64_t)c * nw + w, stride));
    }
    out[c] = (fe_is_zero(acc.X) || fe_is_zero(acc.Y)) ? 1 : 0;
}

extern "C" int zkvm_horner_check(const void* totals, void* out, int nchecks,
                                 int nw, int wbits, void* stream) {
    const int threads = 32;
    if (nchecks > 0 && nw > 0)
        horner_check_kernel<<<(nchecks + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(
            (const int32_t*)totals, (int32_t*)out, nchecks, nw, wbits);
    return (int)cudaGetLastError();
}
