// K7 fe_mul: out[i] = a[i] * b[i] in GF(2^255 - 19), batched.
//
// Replaces the JAX package's pallas_field.py::_mul_kernel (the
// pallas_field.mul entry point), which no verify path calls: it is the
// field layer's unit entry point.  The TPU kernel takes batches that are
// multiples of 512 lanes; here one thread per element takes any B.  The
// multiplication is csrc/field25519.cuh's fe_mul, the one every other
// kernel uses.  Plain twin: pointwise.py mul_plain (kernels/field.py mul).
//
// Input a, b (10, B) int32 limbs with |limb_i| <= 1.65 * 2^W_i (carried
// limbs are); output (10, B) carried limbs.  Loads and stores are
// coalesced.
//
// Bound: bytes.  One multiplication is 100 32x32->64 products and a few
// dozen adds and shifts against 80 bytes read and 40 written, so at the
// card's 3.35 TB/s the memory, not the arithmetic, sets the pace.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

__global__ void fe_mul_kernel(const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, int64_t B) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B) return;
    fe_store(out, 0, t, B, fe_mul(fe_load(a, 0, t, B), fe_load(b, 0, t, B)));
}

extern "C" int zkvm_fe_mul(const void* a, const void* b, void* out,
                           int64_t B, void* stream) {
    const int threads = 256;
    const int64_t blocks = (B + threads - 1) / threads;
    if (blocks > 0)
        fe_mul_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
            (const int32_t*)a, (const int32_t*)b, (int32_t*)out, B);
    return (int)cudaGetLastError();
}
