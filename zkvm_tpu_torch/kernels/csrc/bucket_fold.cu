// K3 bucket_fold: the weighted bucket sum Σ_b b · B_b of every window.
//
// Replaces the JAX package's two-stage weighted fold:
// pallas_msm.py::_fold_kernel_factory (stage 1: per-lane running sums
// over the lane's buckets, highest first) and ::_fold_combine_kernel
// (stage 2: Σ_l W_l + R · Σ_{l>=1} SufT_l).  The TPU carried stage 1
// across an ordered grid axis; here one block owns one window, a loop
// inside each thread replaces that axis, and stage 2 is one pass over the
// block's shared memory.  Plain twin: msm.py bucket_fold_plain.
//
// Thread l of `lanes` owns the R = nb / lanes consecutive buckets with
// magnitudes lR + 1 .. lR + R and walks them highest first, keeping
// T_l (their sum) and W_l = Σ_r (r + 1) B_{lR+r+1}.  Then
//   Σ_b b B_b = Σ_l W_l + R · Σ_l l T_l = Σ_l W_l + R · Σ_{l>=1} SufT_l
// with SufT_l = Σ_{k>=l} T_k: a suffix scan (log2(lanes) steps), a tree
// sum of SufT_1.. and W_0.. (log2(lanes) steps), and log2(R) doublings.
//
// Bound: operations (2 point adds per bucket, 9 field multiplications
// each), against 160 bytes read per bucket.  The block-level pass is
// serial in log2(lanes) steps and runs on one block per window, so with
// nw ~ 20 windows the card is mostly idle: latency, not throughput, sets
// this kernel's time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

constexpr int kMaxLanes = 128;

__global__ void bucket_fold_kernel(const int32_t* __restrict__ buckets,
                                   int32_t* __restrict__ out, int nw, int nb,
                                   int lanes, int log2_r) {
    __shared__ Pt sT[kMaxLanes];
    __shared__ Pt sW[kMaxLanes];
    const int w = blockIdx.x;
    const int l = threadIdx.x;
    const int R = nb / lanes;
    const int64_t stride = (int64_t)nw * nb;

    Pt T = pt_identity(), W = pt_identity();
    for (int r = R - 1; r >= 0; r--) {
        T = pt_add(T, pt_load(buckets, (int64_t)w * nb + l * R + r, stride));
        W = pt_add(W, T);
    }
    sT[l] = T;
    sW[l] = W;
    __syncthreads();

    // suffix scan: sT[l] <- Σ_{k>=l} T_k
    for (int off = 1; off < lanes; off *= 2) {
        Pt v = sT[l];
        if (l + off < lanes) v = pt_add(v, sT[l + off]);
        __syncthreads();
        sT[l] = v;
        __syncthreads();
    }
    if (l == 0) sT[0] = pt_identity();
    __syncthreads();

    // tree sums of SufT_1.. and of W_0..
    for (int half = lanes / 2; half >= 1; half /= 2) {
        if (l < half) {
            sT[l] = pt_add(sT[l], sT[l + half]);
            sW[l] = pt_add(sW[l], sW[l + half]);
        }
        __syncthreads();
    }
    if (l == 0) {
        Pt acc = sT[0];
        for (int d = 0; d < log2_r; d++) acc = pt_dbl(acc);
        pt_store(out, w, nw, pt_add(sW[0], acc));
    }
}

extern "C" int zkvm_bucket_fold(const void* buckets, void* out, int nw,
                                int nb, int lanes, int log2_r, void* stream) {
    if (lanes > kMaxLanes || lanes <= 0 || (lanes & (lanes - 1)) ||
        nb != lanes << log2_r)
        return (int)cudaErrorInvalidValue;
    if (nw > 0)
        bucket_fold_kernel<<<nw, lanes, 0, (cudaStream_t)stream>>>(
            (const int32_t*)buckets, (int32_t*)out, nw, nb, lanes, log2_r);
    return (int)cudaGetLastError();
}
