// K1 ristretto_decode: RFC 9496 §4.3.1 DECODE, one group of five lanes
// per encoding.
//
// Replaces the JAX package's pallas_decompress.py::_decompress_kernel
// (called from decompress_points).  Semantics are that kernel's: s = 0
// decodes to the identity and is valid; a non-canonical s, a negative s,
// a non-square, a negative t or y = 0 gives ok = 0 and the identity; zero
// padding decodes to the identity.  Plain twin: decompress.py
// ristretto_decode_plain.
//
// Bound: operations.  Each encoding is a chain of ~281 dependent field
// operations (257 squarings, mostly the pow_p58 inverse square root, and
// 24 multiplications) of 55-100 32x32->64 products each, against 32 bytes
// read and 164 written; the chain cannot be shared between encodings.
// The first design ran one thread per encoding at 255 registers: at the
// range path's 17,408 encodings that is 544 warps, about one a warp
// scheduler, so nothing hid a product's latency (0.79 us a dependent
// operation).  This design gives each encoding a group of five lanes and
// splits every product by output column (lanes.cuh, column-split
// elements): lane q holds limbs 2q, 2q + 1, a product writes its operands
// to the group's shared arrays, each lane reads the limbs its two columns
// need and forms them (a squaring 11 products, fe_sq's unordered pairs; a
// multiplication 20), and runs the two carry passes, one shuffle each.  A
// warp holds six encodings (lanes 30 and 31 form a seventh, idle group):
// 2,902 warps at 17,408 encodings, 22 a SM, in one wave at 72 registers.
// What bounds it now is the integer multiply pipe that the products and
// carries share, not latency.  Ten columns split evenly over 2 or 5 lanes
// only; two lanes a group (five columns a lane) measured slower.
//
// Exactness: every product forms fe_mul's or fe_sq's int64 column sums
// from their int32 pre-scaled operands and runs their two carry passes,
// and every addition runs fe_add's pass, so each lane holds the limbs one
// thread would; the tests and selects (fe_freeze, fe_is_negative,
// fe_is_zero) run on the element gathered to every lane.  The limb audit
// of field25519.cuh holds unchanged.
//
// Tail: no lane returns before a shuffle.  A group past n (and the idle
// group) decodes a zero encoding through every product and only skips its
// stores.  Each lane stores its own two limbs of each coordinate: one
// store writes six encodings' limbs of five rows, 24 bytes a row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"
#include "lanes.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = 6;          // groups of five lanes a warp
// shared words a group: two 20-word arrays; an odd stride, 5 mod 32, puts
// the six groups' reads at one offset on six disjoint runs of five banks
constexpr int kStride = 69;

__device__ __forceinline__ Fe2 pow2k(const Lane5& g, Fe2 a, int k) {
#pragma unroll 1
    for (int i = 0; i < k; i++) a = lf_sq(g, a);
    return a;
}

// a^((p-5)/8) = a^(2^252 - 3)
__device__ __forceinline__ Fe2 pow_p58(const Lane5& g, const Fe2& a) {
    const Fe2 z2 = lf_sq(g, a);
    const Fe2 z9 = lf_mul(g, a, pow2k(g, z2, 2));
    const Fe2 z11 = lf_mul(g, z2, z9);
    const Fe2 z_5_0 = lf_mul(g, z9, lf_sq(g, z11));
    const Fe2 z_10_0 = lf_mul(g, pow2k(g, z_5_0, 5), z_5_0);
    const Fe2 z_20_0 = lf_mul(g, pow2k(g, z_10_0, 10), z_10_0);
    const Fe2 z_40_0 = lf_mul(g, pow2k(g, z_20_0, 20), z_20_0);
    const Fe2 z_50_0 = lf_mul(g, pow2k(g, z_40_0, 10), z_10_0);
    const Fe2 z_100_0 = lf_mul(g, pow2k(g, z_50_0, 50), z_50_0);
    const Fe2 z_200_0 = lf_mul(g, pow2k(g, z_100_0, 100), z_100_0);
    const Fe2 z_250_0 = lf_mul(g, pow2k(g, z_200_0, 50), z_50_0);
    return lf_mul(g, pow2k(g, z_250_0, 2), a);
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
    return fe_is_zero(fe_sub(a, b));
}

__global__ void __launch_bounds__(kThreads)
ristretto_decode_kernel(const uint32_t* __restrict__ words,
                        int32_t* __restrict__ out,
                        int32_t* __restrict__ ok_out, int64_t n) {
    __shared__ int32_t scratch[(kThreads / 32) * (kGroups + 1) * kStride];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int grp = lane / 5;            // kGroups for lanes 30 and 31
    const Lane5 g(5 * grp, lane - 5 * grp,
                  scratch + (warp * (kGroups + 1) + grp) * kStride);
    const int64_t enc =
        ((int64_t)blockIdx.x * (kThreads / 32) + warp) * kGroups + grp;
    const bool valid = grp < kGroups && enc < n;

    // the lane's limbs 2q, 2q + 1 of the low 255 bits (bit 255 only enters
    // the canonical test); limb k holds bits [ceil(25.5 k), + width)
    Fe2 s;
#pragma unroll
    for (int t = 0; t < 2; t++) {
        const int k = 2 * g.q + t, off = (51 * k + 1) >> 1;
        const int kw = off >> 5, sh = off & 31;
        const uint32_t lo = valid ? words[kw * n + enc] : 0u;
        const uint32_t hi = valid && kw < 7 ? words[(kw + 1) * n + enc] : 0u;
        const uint64_t v = ((uint64_t)hi << 32 | lo) >> sh;
        s.v[t] = (int32_t)(v & ((1u << limb_width(k)) - 1));
    }
    const uint32_t w7 = valid ? words[7 * n + enc] : 0u;
    const Fe s_all = lf_gather(g, s);
    const Fe sc = fe_freeze(s_all);
    bool s_canonical = (w7 >> 31) == 0;
#pragma unroll
    for (int i = 0; i < 10; i++) s_canonical &= sc.v[i] == s_all.v[i];
    const bool s_nonneg = (s_all.v[0] & 1) == 0;

    const Fe2 one = lf_small(g, 1);
    const Fe2 ss = lf_sq(g, s);
    const Fe2 u1 = lf_sub(g, one, ss);
    const Fe2 u2 = lf_add(g, one, ss);
    const Fe2 u2_sqr = lf_sq(g, u2);
    const Fe2 v = lf_sub(
        g, lf_neg(g, lf_mul(g, lf_const(g, kD), lf_sq(g, u1))), u2_sqr);

    // invsqrt(v * u2^2) = sqrt_ratio(1, a): r = a^3 (a^7)^((p-5)/8)
    const Fe2 a = lf_mul(g, v, u2_sqr);
    const Fe2 a3 = lf_mul(g, lf_sq(g, a), a);
    const Fe2 a7 = lf_mul(g, lf_sq(g, a3), a);
    Fe2 r = lf_mul(g, a3, pow_p58(g, a7));
    const Fe check = lf_gather(g, lf_mul(g, a, lf_sq(g, r)));
    const Fe one_all = fe_small(1);
    const bool correct = fe_eq(check, one_all);
    const bool flipped = fe_eq(check, fe_neg(one_all));
    const bool flipped_i = fe_eq(check, fe_neg(fe_const(kSqrtM1)));
    r = lf_select(flipped || flipped_i, lf_mul(g, r, lf_const(g, kSqrtM1)),
                  r);
    r = lf_select(fe_is_negative(lf_gather(g, r)), lf_neg(g, r), r);
    const bool was_square = correct || flipped;

    const Fe2 den_x = lf_mul(g, r, u2);
    const Fe2 den_y = lf_mul(g, lf_mul(g, r, den_x), v);
    Fe2 x = lf_mul(g, lf_add(g, s, s), den_x);
    x = lf_select(fe_is_negative(lf_gather(g, x)), lf_neg(g, x), x);
    const Fe2 y = lf_mul(g, u1, den_y);
    const Fe2 t = lf_mul(g, x, y);

    // gathered before the test: && must not skip a shuffle on some lanes
    const Fe t_all = lf_gather(g, t), y_all = lf_gather(g, y);
    const bool ok = was_square && !fe_is_negative(t_all) &&
                    !fe_is_zero(y_all) && s_canonical && s_nonneg;
    if (!valid) return;                  // after the group's last shuffle
    const Fe2 zero = lf_small(g, 0);
    const Fe2 outs[4] = {lf_select(ok, x, zero), lf_select(ok, y, one), one,
                         lf_select(ok, t, zero)};
#pragma unroll
    for (int c = 0; c < 4; c++)
#pragma unroll
        for (int i = 0; i < 2; i++)
            out[(c * 10 + 2 * g.q + i) * n + enc] = outs[c].v[i];
    if (g.q == 0) ok_out[enc] = ok ? 1 : 0;
}

}  // namespace

extern "C" int zkvm_ristretto_decode(const void* words, void* out, void* ok,
                                     int64_t n, void* stream) {
    const int64_t per_block = (kThreads / 32) * kGroups;
    const int64_t blocks = (n + per_block - 1) / per_block;
    if (blocks > 0)
        ristretto_decode_kernel<<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
            (const uint32_t*)words, (int32_t*)out, (int32_t*)ok, n);
    return (int)cudaGetLastError();
}
