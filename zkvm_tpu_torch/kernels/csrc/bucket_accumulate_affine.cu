// K12 bucket_accumulate_affine: every Pippenger bucket sum of every window,
// from affine (x, y) words gathered into sorted order.
//
// Replaces the JAX package's pallas_msm.py::_seq_scan_awords_kernel: the
// points are normalized to affine once (kernels/msm.py to_affine_words, a
// Montgomery batch inversion in torch ops), so a gathered row is 16 words
// (64 bytes) instead of 32.  The add is the JAX kernel's mixed
// add-2008-hwcd-3 with Z2 = 1: T2 = x y is rebuilt from the decoded words
// and doubles as the reset value's T, a negative digit negates x and xy,
// and D = 2 Z1 needs no multiplication:
//   A = (Y1 - X1)(y - x), B = (Y1 + X1)(y + x), C = T1 2d xy, D = Z1 + Z1,
//   E = B - A, F = D - C, G = D + C, H = B + A,
//   (X3, Y3, Z3, T3) = (E F, G H, F G, E H);
// a run starts from (x, y, 1, xy).  One thread per (window, bucket) walks
// its run of K10's (nw, n, 16) rows, as K2 and K11 do.  The result is the
// same point as K2's in other projective coordinates: compare by
// cross-multiplication.  Z never vanishes: K1 decodes an invalid encoding
// to the identity (Z = 1), so the batch inversion has no zero factor.
// Plain twin: kernels/msm.py bucket_accumulate_affine_plain.
//
// Bound: operations (one multiplication for xy and 9 for the mixed add
// per point added, 8 of them in the add itself).
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

__global__ void bucket_accumulate_affine_kernel(
        const int64_t* __restrict__ keys, const int64_t* __restrict__ offsets,
        const uint32_t* __restrict__ rows, int32_t* __restrict__ out,
        int64_t n, int nw, int nb, int shift) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t total = (int64_t)nw * nb;
    if (t >= total) return;
    const int64_t w = t / nb, b = t % nb;
    const int64_t start = offsets[w * (nb + 1) + b];
    const int64_t end = offsets[w * (nb + 1) + b + 1];
    Pt acc = pt_identity();
    for (int64_t i = start; i < end; i++) {
        const uint32_t* row = rows + (w * n + i) * 16;
        Fe x = fe_from_words(row);
        const Fe y = fe_from_words(row + 8);
        Fe xy = fe_mul(x, y);
        if ((keys[w * n + i] >> shift) & 1) {
            x = fe_neg(x);
            xy = fe_neg(xy);
        }
        if (i == start) {
            acc.X = x;
            acc.Y = y;
            acc.Z = fe_small(1);
            acc.T = xy;
            continue;
        }
        const Fe A = fe_mul(fe_sub(acc.Y, acc.X), fe_sub(y, x));
        const Fe B = fe_mul(fe_add(acc.Y, acc.X), fe_add(y, x));
        const Fe C = fe_mul(fe_mul(acc.T, fe_const(kD2)), xy);
        const Fe D = fe_add(acc.Z, acc.Z);
        const Fe E = fe_sub(B, A);
        const Fe F = fe_sub(D, C);
        const Fe G = fe_add(D, C);
        const Fe H = fe_add(B, A);
        acc.X = fe_mul(E, F);
        acc.Y = fe_mul(G, H);
        acc.Z = fe_mul(F, G);
        acc.T = fe_mul(E, H);
    }
    pt_store(out, t, total, acc);
}

extern "C" int zkvm_bucket_accumulate_affine(const void* keys,
                                             const void* offsets,
                                             const void* rows, void* out,
                                             int64_t n, int nw, int nb,
                                             int shift, void* stream) {
    const int threads = 128;
    const int64_t total = (int64_t)nw * nb;
    const int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 0)
        bucket_accumulate_affine_kernel<<<(unsigned)blocks, threads, 0,
                                          (cudaStream_t)stream>>>(
            (const int64_t*)keys, (const int64_t*)offsets,
            (const uint32_t*)rows, (int32_t*)out, n, nw, nb, shift);
    return (int)cudaGetLastError();
}
