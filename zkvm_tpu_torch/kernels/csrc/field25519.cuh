// GF(2^255 - 19) and Edwards point arithmetic for the port's kernels.
//
// Counterparts of the JAX package's Pallas device functions
// pallas_field._vmem_mul / _vmem_sqr and pallas_msm._add_formula /
// _dbl_formula, in the representation of kernels/field.py: ten signed
// limbs of radix 2^25.5 (widths 26, 25, 26, 25, ...), stored as int32,
// multiplied 32x32 -> 64 bit.  Every function here computes exactly what
// its plain PyTorch twin in kernels/field.py computes, limb for limb.
//
// Overflow audit (the same as kernels/field.py's):
//   * carried limbs satisfy |h_i| <= 0.52 * 2^W_i; every function below
//     returns carried limbs;
//   * fe_mul/fe_sq take |f_i| <= 1.65 * 2^W_i; the int32 pre-scalings
//     19 * g_j and 4 * f_i (sq) stay below 2^31; the worst int64 column,
//     h_0 = f0 g0 + 19 * (4 even*even + 5 doubled odd*odd products), is at
//     most 1.65^2 * 2^52 * 124.5 = 2^60.4;
//   * add/sub/neg of two carried values stay below 2^(W+1) before their
//     carry pass, which then moves at most 4 (x19 into limb 0).
#pragma once
#include <stdint.h>

namespace zk {

struct Fe {
    int32_t v[10];
};

struct Pt {
    Fe X, Y, Z, T;
};

__device__ __forceinline__ int limb_width(int i) { return (i & 1) ? 25 : 26; }

// canonical limbs of d, 2d and sqrt(-1) (kernels/field.py int_to_limbs;
// tests/test_torch_field.py checks them against constants.py)
__device__ __constant__ int32_t kD[10] = {
    56195235, 13857412, 51736253, 6949390, 114729,
    24766616, 60832955, 30306712, 48412415, 21499315};
__device__ __constant__ int32_t kD2[10] = {
    45281625, 27714825, 36363642, 13898781, 229458,
    15978800, 54557047, 27058993, 29715967, 9444199};
__device__ __constant__ int32_t kSqrtM1[10] = {
    34513072, 25610706, 9377949, 3500415, 12389472,
    33281959, 41962654, 31548777, 326685, 11406482};

__device__ __forceinline__ Fe fe_const(const int32_t* c) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = c[i];
    return r;
}

__device__ __forceinline__ Fe fe_small(int32_t x) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = 0;
    r.v[0] = x;
    return r;
}

// One parallel rounding carry pass (kernels/field.py carry_pass).
__device__ __forceinline__ void carry_pass(int64_t h[10]) {
    int64_t c[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int w = limb_width(i);
        c[i] = (h[i] + ((int64_t)1 << (w - 1))) >> w;
        h[i] -= c[i] << w;
    }
    h[0] += 19 * c[9];
#pragma unroll
    for (int i = 1; i < 10; i++) h[i] += c[i - 1];
}

__device__ __forceinline__ Fe fe_from64(int64_t h[10]) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = (int32_t)h[i];
    return r;
}

__device__ __forceinline__ Fe fe_mul(const Fe& f, const Fe& g) {
    int32_t g19[10], f2[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        g19[i] = 19 * g.v[i];
        f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
    }
    int64_t h[10];
#pragma unroll
    for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = 0; j < 10; j++) {
            const int32_t a = (j & 1) ? f2[i] : f.v[i];
            if (i + j < 10)
                h[i + j] += (int64_t)a * g.v[j];
            else
                h[i + j - 10] += (int64_t)a * g19[j];
        }
    }
    carry_pass(h);
    carry_pass(h);
    return fe_from64(h);
}

__device__ __forceinline__ Fe fe_sq(const Fe& f) {
    int64_t h[10];
#pragma unroll
    for (int k = 0; k < 10; k++) h[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = i; j < 10; j++) {
            // f_i f_j appears twice off the diagonal, and doubles again
            // when both limbs are odd; wrapped columns take 19
            int32_t a = f.v[i] * ((i == j ? 1 : 2) * ((i & j & 1) ? 2 : 1));
            if (i + j < 10)
                h[i + j] += (int64_t)a * f.v[j];
            else
                h[i + j - 10] += (int64_t)a * (19 * f.v[j]);
        }
    }
    carry_pass(h);
    carry_pass(h);
    return fe_from64(h);
}

__device__ __forceinline__ Fe fe_add(const Fe& f, const Fe& g) {
    int64_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = (int64_t)f.v[i] + g.v[i];
    carry_pass(h);
    return fe_from64(h);
}

__device__ __forceinline__ Fe fe_sub(const Fe& f, const Fe& g) {
    int64_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = (int64_t)f.v[i] - g.v[i];
    carry_pass(h);
    return fe_from64(h);
}

__device__ __forceinline__ Fe fe_neg(const Fe& f) {
    int64_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = -(int64_t)f.v[i];
    carry_pass(h);
    return fe_from64(h);
}

// Canonical limbs of f mod p (kernels/field.py freeze, ref10 fe_tobytes).
__device__ __forceinline__ Fe fe_freeze(const Fe& f) {
    int64_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++) h[i] = f.v[i];
    carry_pass(h);
    carry_pass(h);
    int64_t q = (19 * h[9] + ((int64_t)1 << 24)) >> 25;
#pragma unroll
    for (int i = 0; i < 10; i++) q = (h[i] + q) >> limb_width(i);
    h[0] += 19 * q;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        const int64_t c = h[i] >> limb_width(i);
        h[i + 1] += c;
        h[i] -= c << limb_width(i);
    }
    h[9] -= (h[9] >> 25) << 25;
    return fe_from64(h);
}

__device__ __forceinline__ bool fe_is_zero(const Fe& f) {
    const Fe c = fe_freeze(f);
    int32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) acc |= c.v[i];
    return acc == 0;
}

__device__ __forceinline__ bool fe_is_negative(const Fe& f) {
    return (fe_freeze(f).v[0] & 1) != 0;
}

__device__ __forceinline__ Fe fe_select(bool m, const Fe& a, const Fe& b) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = m ? a.v[i] : b.v[i];
    return r;
}

// ------------------------------------------------------------ Edwards points

__device__ __forceinline__ Pt pt_identity() {
    Pt p;
    p.X = fe_small(0);
    p.Y = fe_small(1);
    p.Z = fe_small(1);
    p.T = fe_small(0);
    return p;
}

// Unified extended addition add-2008-hwcd-3 (a = -1, k = 2d): 9 mul.
__device__ __forceinline__ Pt pt_add(const Pt& p, const Pt& q) {
    const Fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
    const Fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
    const Fe C = fe_mul(fe_mul(p.T, fe_const(kD2)), q.T);
    const Fe D = fe_mul(p.Z, fe_add(q.Z, q.Z));
    const Fe E = fe_sub(B, A);
    const Fe F = fe_sub(D, C);
    const Fe G = fe_add(D, C);
    const Fe H = fe_add(B, A);
    Pt r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

// dbl-2008-hwcd with a = -1: 4 sqr + 4 mul.
__device__ __forceinline__ Pt pt_dbl(const Pt& p) {
    const Fe A = fe_sq(p.X);
    const Fe B = fe_sq(p.Y);
    const Fe Zz = fe_sq(p.Z);
    const Fe C = fe_add(Zz, Zz);
    const Fe E = fe_sub(fe_sub(fe_sq(fe_add(p.X, p.Y)), A), B);
    const Fe G = fe_sub(B, A);
    const Fe F = fe_sub(G, C);
    const Fe H = fe_sub(fe_neg(A), B);
    Pt r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

// Points in device memory are (4, 10, stride) int32: coordinate, limb, lane.
__device__ __forceinline__ Fe fe_load(const int32_t* __restrict__ base,
                                      int coord, int64_t lane, int64_t stride) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = base[(coord * 10 + i) * stride + lane];
    return r;
}

__device__ __forceinline__ void fe_store(int32_t* __restrict__ base, int coord,
                                         int64_t lane, int64_t stride,
                                         const Fe& f) {
#pragma unroll
    for (int i = 0; i < 10; i++) base[(coord * 10 + i) * stride + lane] = f.v[i];
}

__device__ __forceinline__ Pt pt_load(const int32_t* __restrict__ base,
                                      int64_t lane, int64_t stride) {
    Pt p;
    p.X = fe_load(base, 0, lane, stride);
    p.Y = fe_load(base, 1, lane, stride);
    p.Z = fe_load(base, 2, lane, stride);
    p.T = fe_load(base, 3, lane, stride);
    return p;
}

__device__ __forceinline__ void pt_store(int32_t* __restrict__ base,
                                         int64_t lane, int64_t stride,
                                         const Pt& p) {
    fe_store(base, 0, lane, stride, p.X);
    fe_store(base, 1, lane, stride, p.Y);
    fe_store(base, 2, lane, stride, p.Z);
    fe_store(base, 3, lane, stride, p.T);
}

}  // namespace zk
