// K10 gather_words: per-window permutation gather of canonical point rows.
//
// out[w, j, :] = src[perm[w, j], :] for src (n, S) int32 word rows (S = 32:
// the canonical X, Y, Z, T words of a point; S = 16: affine x, y) and perm
// (nw, n) int64, giving out (nw, n, S).
//
// Replaces both block shapes of the JAX package's pallas_msm.py::
// gather_rows_words (`kernel`, 8 source planes a block, and `kernel1`, one
// plane a block for n > 2^16): they compute one function, and the TPU
// needed two only to keep its VMEM-resident source chunk under its scope.
// The layout differs on purpose: the JAX kernel writes (nw, 32, n) word
// planes for its lane-tiled scan, the port writes one 128-byte row per
// point, (nw, n, S), so that a bucket's run is one contiguous stretch of
// rows for K11/K12, whose threads walk runs.  One thread copies 16 bytes;
// S / 4 neighbouring threads copy one row, so reads of a row and writes
// are coalesced and only the row's address is random.
//
// Bound: bytes (perm 8 B and an S-word row read, an S-word row written per
// gathered position, plus the source once).
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_words_kernel(const int4* __restrict__ src,
                                    const int64_t* __restrict__ perm,
                                    int4* __restrict__ out, int64_t rows_out,
                                    int q) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows_out * q) return;
    const int64_t r = t / q;
    const int c = (int)(t - r * q);
    out[t] = src[perm[r] * q + c];
}

extern "C" int zkvm_gather_words(const void* src, const void* perm, void* out,
                                 int64_t rows_out, int q, void* stream) {
    const int threads = 256;
    const int64_t total = rows_out * q;
    const int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 0)
        gather_words_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
            (const int4*)src, (const int64_t*)perm, (int4*)out, rows_out, q);
    return (int)cudaGetLastError();
}
