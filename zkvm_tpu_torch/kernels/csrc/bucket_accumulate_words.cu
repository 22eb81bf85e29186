// K11 bucket_accumulate_words: every Pippenger bucket sum of every window,
// from canonical point words gathered into sorted order.
//
// Replaces the JAX package's pallas_msm.py::_seq_scan_words_kernel (with
// the lane scan and fix-up around it, as K2 replaces _seq_scan_kernel's):
// a segmented scan over gathered canonical u32 words that decodes words to
// limbs and applies the digit sign inside the kernel, so no decoded,
// negated copy of the gathered points is written to device memory.  Here,
// as in K2, one thread per (window, bucket) walks its run: rows
// [offsets[b], offsets[b+1]) of its window's gathered rows (K10's
// (nw, n, 32) layout, one 128-byte row per point), decodes each
// coordinate's 8 words into ten radix-2^25.5 limbs (fe_from_words), takes
// the sign from the sorted key's bit `shift`, and adds.  The rows must be
// canonical words: dynamic points leave K1 as loose limbs and are frozen
// and encoded first (kernels/msm.py point_rows).  Output as K2's,
// (4, 10, nw * nb) int32; an empty bucket holds the identity.  The same
// additions in the same order as K2 give the same field elements, so the
// canonical words of the two outputs are equal.  Plain twin: kernels/msm.py
// bucket_accumulate_words_plain.
//
// Bound: operations (9 field multiplications per point added), as K2's;
// the thread reads 128 contiguous bytes a point where K2 gathers 160
// strided ones.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

__global__ void bucket_accumulate_words_kernel(
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
        const uint32_t* row = rows + (w * n + i) * 32;
        Pt p;
        p.X = fe_from_words(row);
        p.Y = fe_from_words(row + 8);
        p.Z = fe_from_words(row + 16);
        p.T = fe_from_words(row + 24);
        if ((keys[w * n + i] >> shift) & 1) {
            p.X = fe_neg(p.X);
            p.T = fe_neg(p.T);
        }
        acc = (i == start) ? p : pt_add(acc, p);
    }
    pt_store(out, t, total, acc);
}

extern "C" int zkvm_bucket_accumulate_words(const void* keys,
                                            const void* offsets,
                                            const void* rows, void* out,
                                            int64_t n, int nw, int nb,
                                            int shift, void* stream) {
    const int threads = 128;
    const int64_t total = (int64_t)nw * nb;
    const int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 0)
        bucket_accumulate_words_kernel<<<(unsigned)blocks, threads, 0,
                                         (cudaStream_t)stream>>>(
            (const int64_t*)keys, (const int64_t*)offsets,
            (const uint32_t*)rows, (int32_t*)out, n, nw, nb, shift);
    return (int)cudaGetLastError();
}
