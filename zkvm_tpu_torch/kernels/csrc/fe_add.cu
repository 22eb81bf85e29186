// K8 fe_add: out[i] = a[i] + b[i] in GF(2^255 - 19), batched, with one
// carry pass.
//
// Replaces the JAX package's pallas_field.py::_add_kernel (the
// pallas_field.add entry point), which no verify path calls: it is the
// field layer's unit entry point.  The TPU kernel takes batches that are
// multiples of 512 lanes; here one thread per element takes any B.  The
// addition is csrc/field25519.cuh's fe_add.  Plain twin: pointwise.py
// add_plain (kernels/field.py add).
//
// Input a, b (10, B) int32 carried limbs; output (10, B) carried limbs.
// Loads and stores are coalesced.
//
// Bound: bytes, 80 read and 40 written per element against ten adds and
// one carry pass.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

__global__ void fe_add_kernel(const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, int64_t B) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B) return;
    fe_store(out, 0, t, B, fe_add(fe_load(a, 0, t, B), fe_load(b, 0, t, B)));
}

extern "C" int zkvm_fe_add(const void* a, const void* b, void* out,
                           int64_t B, void* stream) {
    const int threads = 256;
    const int64_t blocks = (B + threads - 1) / threads;
    if (blocks > 0)
        fe_add_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
            (const int32_t*)a, (const int32_t*)b, (int32_t*)out, B);
    return (int)cudaGetLastError();
}
