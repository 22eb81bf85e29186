// K1 ristretto_decode: RFC 9496 §4.3.1 DECODE, one thread per encoding.
//
// Replaces the JAX package's pallas_decompress.py::_decompress_kernel
// (called from decompress_points).  Semantics are that kernel's: s = 0
// decodes to the identity and is valid; a non-canonical s, a negative s,
// a non-square, a negative t or y = 0 gives ok = 0 and the identity; zero
// padding decodes to the identity.  Plain twin: decompress.py
// ristretto_decode_plain.
//
// Bound: operations.  Each encoding costs ~270 field multiplications
// (the 254-squaring pow_p58 chain dominates) of 55-100 32x32->64 products
// each, against 32 bytes read and 164 written.  Design: one thread per
// encoding keeps the whole chain in registers (no shared memory, no
// device-memory round trips between steps); word loads are coalesced
// because the input is (8, n) word-major.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

using namespace zk;

__device__ __forceinline__ Fe pow2k(Fe a, int k) {
    for (int i = 0; i < k; i++) a = fe_sq(a);
    return a;
}

// a^((p-5)/8) = a^(2^252 - 3)
__device__ __forceinline__ Fe pow_p58(const Fe& a) {
    const Fe z2 = fe_sq(a);
    const Fe z9 = fe_mul(a, pow2k(z2, 2));
    const Fe z11 = fe_mul(z2, z9);
    const Fe z_5_0 = fe_mul(z9, fe_sq(z11));
    const Fe z_10_0 = fe_mul(pow2k(z_5_0, 5), z_5_0);
    const Fe z_20_0 = fe_mul(pow2k(z_10_0, 10), z_10_0);
    const Fe z_40_0 = fe_mul(pow2k(z_20_0, 20), z_20_0);
    const Fe z_50_0 = fe_mul(pow2k(z_40_0, 10), z_10_0);
    const Fe z_100_0 = fe_mul(pow2k(z_50_0, 50), z_50_0);
    const Fe z_200_0 = fe_mul(pow2k(z_100_0, 100), z_100_0);
    const Fe z_250_0 = fe_mul(pow2k(z_200_0, 50), z_50_0);
    return fe_mul(pow2k(z_250_0, 2), a);
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
    return fe_is_zero(fe_sub(a, b));
}

__global__ void ristretto_decode_kernel(const uint32_t* __restrict__ words,
                                        int32_t* __restrict__ out,
                                        int32_t* __restrict__ ok_out,
                                        int64_t n) {
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    uint32_t w[9];
#pragma unroll
    for (int k = 0; k < 8; k++) w[k] = words[k * n + lane];
    w[8] = 0;

    // limbs of the low 255 bits (bit 255 only enters the canonical test)
    Fe s;
    int off = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int width = limb_width(i);
        const int k = off >> 5, sh = off & 31;
        uint64_t v = ((uint64_t)w[k + 1] << 32 | w[k]) >> sh;
        s.v[i] = (int32_t)(v & ((1u << width) - 1));
        off += width;
    }
    const Fe sc = fe_freeze(s);
    bool s_canonical = (w[7] >> 31) == 0;
#pragma unroll
    for (int i = 0; i < 10; i++) s_canonical &= sc.v[i] == s.v[i];
    const bool s_nonneg = (s.v[0] & 1) == 0;

    const Fe one = fe_small(1);
    const Fe ss = fe_sq(s);
    const Fe u1 = fe_sub(one, ss);
    const Fe u2 = fe_add(one, ss);
    const Fe u2_sqr = fe_sq(u2);
    const Fe v = fe_sub(fe_neg(fe_mul(fe_const(kD), fe_sq(u1))), u2_sqr);

    // invsqrt(v * u2^2) = sqrt_ratio(1, a): r = a^3 (a^7)^((p-5)/8)
    const Fe a = fe_mul(v, u2_sqr);
    const Fe a3 = fe_mul(fe_sq(a), a);
    const Fe a7 = fe_mul(fe_sq(a3), a);
    Fe r = fe_mul(a3, pow_p58(a7));
    const Fe check = fe_mul(a, fe_sq(r));
    const Fe sqrt_m1 = fe_const(kSqrtM1);
    const bool correct = fe_eq(check, one);
    const bool flipped = fe_eq(check, fe_neg(one));
    const bool flipped_i = fe_eq(check, fe_neg(sqrt_m1));
    r = fe_select(flipped || flipped_i, fe_mul(r, sqrt_m1), r);
    r = fe_select(fe_is_negative(r), fe_neg(r), r);
    const bool was_square = correct || flipped;

    const Fe den_x = fe_mul(r, u2);
    const Fe den_y = fe_mul(fe_mul(r, den_x), v);
    Fe x = fe_mul(fe_add(s, s), den_x);
    x = fe_select(fe_is_negative(x), fe_neg(x), x);
    const Fe y = fe_mul(u1, den_y);
    const Fe t = fe_mul(x, y);

    const bool ok = was_square && !fe_is_negative(t) && !fe_is_zero(y) &&
                    s_canonical && s_nonneg;
    const Fe zero = fe_small(0);
    fe_store(out, 0, lane, n, fe_select(ok, x, zero));
    fe_store(out, 1, lane, n, fe_select(ok, y, one));
    fe_store(out, 2, lane, n, one);
    fe_store(out, 3, lane, n, fe_select(ok, t, zero));
    ok_out[lane] = ok ? 1 : 0;
}

extern "C" int zkvm_ristretto_decode(const void* words, void* out, void* ok,
                                     int64_t n, void* stream) {
    const int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 0)
        ristretto_decode_kernel<<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
            (const uint32_t*)words, (int32_t*)out, (int32_t*)ok, n);
    return (int)cudaGetLastError();
}
