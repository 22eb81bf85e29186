// Point operations split over four lanes, one coordinate per lane, and
// field products split over a group of five lanes by output column.
//
// Point operations.  Shared by K2 (bucket_accumulate.cu), K3
// (bucket_fold.cu), K4 (horner_check.cu) and the small route's K5s
// (small_scan.cu).  A group of four consecutive lanes of a warp holds one
// point: lane j = lane & 3 holds coordinate j (X, Y, Z, T).  Each level of
// a point operation puts its four independent multiplications on the four
// lanes, which run one instruction stream on their own operands (selects,
// not branches), and the operands cross by __shfl_sync within the group.
// Every lane of the warp must call these functions together: the shuffles
// name the whole warp.
//
//   * lane_dbl: dbl-2008-hwcd (a = -1), two multiplications deep: lane j
//     squares X, Y, Z or X + Y; then lane j multiplies the pair of output
//     coordinate j (E F, G H, F G, E H).
//   * lane_cached: the addend's half of add-2008-hwcd-3 (a = -1, k = 2d),
//     (Y - X, Y + X, 2d T, 2 Z): one multiplication deep.
//   * lane_add: acc + q with q in cached form: lane j forms A = (Y1 - X1)
//     (Y - X), B = (Y1 + X1)(Y + X), C = T1 (2d T) or D = Z1 (2 Z); then
//     the two of E, F, G, H that its output coordinate multiplies.  Two
//     deep.  Each lane fetches only the operands it uses (a shuffle's
//     source lane differs from lane to lane), which keeps few values live.
// Plain twins: kernels/field.py point_double, kernels/combine.py cached and
// add_cached (the same field operations in the same order, so the limbs
// agree bit for bit).  fe_mul and fe_sq are field25519.cuh's, so its limb
// audit holds.
//
// Column-split field elements (K1, decompress.cu).  A group of five lanes
// holds one field element as Fe2: lane q holds limbs 2q and 2q + 1, its
// "columns".  A product writes both operands to the group's shared arrays
// in S layout (S[c] = 19 f_c, S[10 + c] = f_c, by the lane that holds
// limb c), and each lane reads the limbs its columns need at addresses
// that depend on q: S[10 + j] for j in [-10, 9] is the factor fe_mul takes
// for limb j mod 10, 19 times it exactly when the pair wraps past limb 9.
// lf_mul forms fe_mul's two column sums (20 products a lane); lf_sq forms
// fe_sq's from its unordered pairs (column 2q pairs limb q + d with q - d,
// column 2q + 1 limb q + 1 + d with q - d: 11 products a lane, against 55
// on one thread), with fe_sq's int32 pre-scalings.  Then each lane runs
// the two carry passes on its columns, taking the carry into limb 2q from
// the lane before by one shuffle.  The int64 column sums are fe_mul's and
// fe_sq's, so the limbs are theirs, and the limb audit of field25519.cuh
// holds as it stands.  Additions run fe_add's carry pass the same way.
// Every lane of the warp must call these together (the shuffles name the
// whole warp, and __syncwarp fences the shared arrays); lanes past the
// warp's last whole group form a group of their own that only skips its
// stores.
#pragma once
#include "field25519.cuh"

namespace zk {

// coordinate `src` of the point held across the caller's group of four
__device__ __forceinline__ Fe shfl_fe(const Fe& f, int src) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] = __shfl_sync(0xffffffffu, f.v[i], src, 4);
    return r;
}

// a0, a1, a2 or a3 by the lane's coordinate j, limb by limb (selects, so
// that no operand leaves the registers)
__device__ __forceinline__ Fe sel4(int j, const Fe& a0, const Fe& a1,
                                   const Fe& a2, const Fe& a3) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++)
        r.v[i] = j == 0 ? a0.v[i] : j == 1 ? a1.v[i] : j == 2 ? a2.v[i] : a3.v[i];
    return r;
}

// Lane j's output coordinate from E, F, G, H held on every lane:
// X = E F, Y = G H, Z = F G, T = E H.
__device__ __forceinline__ Fe lane_finish(int j, const Fe& E, const Fe& F,
                                          const Fe& G, const Fe& H) {
    return fe_mul(sel4(j, E, G, F, E), sel4(j, F, H, G, H));
}

// Coordinate j of the identity (0, 1, 1, 0).
__device__ __forceinline__ Fe lane_identity(int j) {
    return fe_small(j == 1 || j == 2 ? 1 : 0);
}

// one doubling; lane j holds coordinate j of the point before and after
__device__ __forceinline__ Fe lane_dbl(int j, const Fe& mine) {
    const Fe x = shfl_fe(mine, 0), y = shfl_fe(mine, 1);
    const Fe xy = fe_add(x, y);
    const Fe s = fe_sq(sel4(j, mine, mine, mine, xy));  // A, B, Zz, (X+Y)^2
    const Fe A = shfl_fe(s, 0), B = shfl_fe(s, 1);
    const Fe Zz = shfl_fe(s, 2), S = shfl_fe(s, 3);
    const Fe C = fe_add(Zz, Zz);
    const Fe E = fe_sub(fe_sub(S, A), B);
    const Fe G = fe_sub(B, A);
    const Fe F = fe_sub(G, C);
    const Fe H = fe_sub(fe_neg(A), B);
    return lane_finish(j, E, F, G, H);
}

// a + b, or a - b where `minus`: fe_add or fe_sub, as each lane needs
__device__ __forceinline__ Fe fe_add_sub(const Fe& a, const Fe& b,
                                         bool minus) {
    int64_t h[10];
#pragma unroll
    for (int i = 0; i < 10; i++)
        h[i] = minus ? (int64_t)a.v[i] - b.v[i] : (int64_t)a.v[i] + b.v[i];
    carry_pass(h);
    return fe_from64(h);
}

// coordinate j of the cached form (Y - X, Y + X, 2d T, 2 Z) of the point
// held across the group: lane j fetches only its operands (Y and X, T, or
// Z twice) and forms one sum, difference or product
__device__ __forceinline__ Fe lane_cached(int j, const Fe& mine) {
    const Fe a = shfl_fe(mine, j < 2 ? 1 : 5 - j);        // Y, Y, T, Z
    const Fe b = shfl_fe(mine, j < 2 ? 0 : 2);            // X, X, -, Z
    const Fe m = fe_mul(a, fe_const(kD2));
    return j == 2 ? m : fe_add_sub(a, b, j == 0);
}

// acc + q with q's cached coordinate j in `cached`: lane j forms its
// factor (Y1 - X1, Y1 + X1, T1 or Z1), one product (A, B, C or D), then
// the two of E = B - A, F = D - C, G = D + C, H = B + A that its output
// coordinate multiplies
__device__ __forceinline__ Fe lane_add(int j, const Fe& mine,
                                       const Fe& cached) {
    const Fe a = shfl_fe(mine, j < 2 ? 1 : 5 - j);        // Y1, Y1, T1, Z1
    const Fe x = shfl_fe(mine, 0);
    const Fe v = fe_mul(j < 2 ? fe_add_sub(a, x, j == 0) : a, cached);
    // X = E F, Y = G H, Z = F G, T = E H
    const bool e1 = j == 0 || j == 3, h2 = j == 1 || j == 3;
    const Fe p = shfl_fe(v, e1 ? 1 : 3), q = shfl_fe(v, e1 ? 0 : 2);
    const Fe r = shfl_fe(v, h2 ? 1 : 3), t = shfl_fe(v, h2 ? 0 : 2);
    return fe_mul(fe_add_sub(p, q, j != 1), fe_add_sub(r, t, j == 0));
}

// acc + q for q held across the group as a point: lane_add(lane_cached(q))
__device__ __forceinline__ Fe lane_add_pt(int j, const Fe& mine,
                                          const Fe& q) {
    return lane_add(j, mine, lane_cached(j, q));
}

// a + b, or a - b where `minus`, limb by limb with no carry pass
__device__ __forceinline__ Fe fe_add_sub_lazy(const Fe& a, const Fe& b,
                                              bool minus) {
    Fe r;
#pragma unroll
    for (int i = 0; i < 10; i++)
        r.v[i] = minus ? a.v[i] - b.v[i] : a.v[i] + b.v[i];
    return r;
}

// lane_add with its sums left uncarried (K17, K18); three carry passes a
// lane fewer.  Limb audit, against field25519.cuh's (fe_mul takes |f_i|,
// |g_i| <= 1.65 * 2^W_i; its int32 pre-scalings are 2 f_i for odd i and
// 19 g_j; its worst int64 column, 1.65^2 * 124.5 * 2^52 = 2^60.4, still
// leaves carried limbs after its two passes):
//   * the second products take E, F, G, H, sums of two products (carried,
//     |limb| <= 0.52 * 2^W), so within 1.04 * 2^W on both sides;
//   * the first takes Y1 -+ X1, T1 or Z1 as f and the cached operand as g:
//     a carried entry or its limb-wise negation (within 0.52 * 2^W).  f is
//     within 1.04 * 2^W when acc is carried (a product, or the identity);
//     when acc is a point loaded from memory (K18's first table addition)
//     with any |limb| < 2^W, canonical or carried, |Y1 -+ X1| < 2 * 2^W:
//     then f_i and 2 f_i (odd i) stay below 2^27 and 19 g_j below 2^30 in
//     int32, and every column is at most 2 * 0.52 * 124.5 * 2^52 =
//     129.5 * 2^52 ~ 2^59.02, inside the audited 2^60.4.
// Every output coordinate is a product, carried.  Plain twin:
// fixed_base.py add_cached_lazy.
__device__ __forceinline__ Fe lane_add_lazy(int j, const Fe& mine,
                                            const Fe& cached) {
    const Fe a = shfl_fe(mine, j < 2 ? 1 : 5 - j);        // Y1, Y1, T1, Z1
    const Fe x = shfl_fe(mine, 0);
    const Fe v = fe_mul(j < 2 ? fe_add_sub_lazy(a, x, j == 0) : a, cached);
    const bool e1 = j == 0 || j == 3, h2 = j == 1 || j == 3;
    const Fe p = shfl_fe(v, e1 ? 1 : 3), q = shfl_fe(v, e1 ? 0 : 2);
    const Fe r = shfl_fe(v, h2 ? 1 : 3), t = shfl_fe(v, h2 ? 0 : 2);
    return fe_mul(fe_add_sub_lazy(p, q, j != 1),
                  fe_add_sub_lazy(r, t, j == 0));
}

// ------------------------------------------------- column-split elements

// Lane q of a group of five holds limbs 2q and 2q + 1 of an element.
struct Fe2 {
    int32_t v[2];
};

// The caller's place in its group of five lanes, and the group's two
// 20-word shared arrays (S layout: S[c] = 19 f_c, S[10 + c] = f_c).
struct Lane5 {
    int q;          // index in the group
    int base;       // the group's first lane
    int prev;       // the lane holding limbs 2q - 2, 2q - 1 (mod 10)
    int32_t* s0;
    int32_t* s1;

    __device__ __forceinline__ Lane5(int base_, int q_, int32_t* s)
        : q(q_), base(base_), prev(base_ + (q_ == 0 ? 4 : q_ - 1)), s0(s),
          s1(s + 20) {}
};

// the whole element on every lane of the group, limb c at index c
__device__ __forceinline__ Fe lf_gather(const Lane5& g, const Fe2& a) {
    Fe r;
#pragma unroll
    for (int c = 0; c < 10; c++)
        r.v[c] = __shfl_sync(0xffffffffu, a.v[c & 1], g.base + (c >> 1));
    return r;
}

// one carry_pass over the group's columns: limb 2q + 1 takes limb 2q's
// carry, limb 2q the carry of limb 2q - 1 from the lane before (19 times
// limb 9's into limb 0)
__device__ __forceinline__ void lf_carry_pass(const Lane5& g, int64_t h[2]) {
    const int64_t c0 = (h[0] + ((int64_t)1 << 25)) >> 26;
    const int64_t c1 = (h[1] + ((int64_t)1 << 24)) >> 25;
    h[0] -= c0 << 26;
    h[1] -= c1 << 25;
    const int64_t in = __shfl_sync(0xffffffffu, (long long)c1, g.prev);
    h[0] += g.q == 0 ? 19 * in : in;
    h[1] += c0;
}

__device__ __forceinline__ Fe2 lf_carried(const Lane5& g, int64_t h[2]) {
    lf_carry_pass(g, h);
    lf_carry_pass(g, h);
    return Fe2{{(int32_t)h[0], (int32_t)h[1]}};
}

// the lane's limbs into S layout; the caller fences with __syncwarp
__device__ __forceinline__ void lf_put(const Lane5& g, int32_t* S,
                                       const Fe2& a) {
    S[2 * g.q] = 19 * a.v[0];
    S[2 * g.q + 1] = 19 * a.v[1];
    S[10 + 2 * g.q] = a.v[0];
    S[11 + 2 * g.q] = a.v[1];
}

// fe_mul(a, b) on the lane's columns k = 2q + t: Σ_i a_i b_(k-i), where
// b's S layout read at 10 + k - i gives 19 b_(k-i+10) exactly when the
// pair wraps (i > k); a_i doubles for odd i when k - i is odd too (t = 0)
__device__ __forceinline__ Fe2 lf_mul(const Lane5& g, const Fe2& a,
                                      const Fe2& b) {
    __syncwarp();
    lf_put(g, g.s0, a);
    lf_put(g, g.s1, b);
    __syncwarp();
    const int32_t* A = g.s0 + 10;
    const int32_t* B = g.s1 + 10 + 2 * g.q;
    int64_t h[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int32_t f = A[i];
        h[0] += (int64_t)((i & 1) ? 2 * f : f) * B[-i];
        h[1] += (int64_t)f * B[1 - i];
    }
    return lf_carried(g, h);
}

// fe_sq(a) on the lane's columns, from fe_sq's unordered pairs: column 2q
// pairs limb q + d with limb q - d (d = 0 and 5 are squares; an odd pair
// doubles), column 2q + 1 pairs q + 1 + d with q - d; S layout read at
// 10 + q - d gives 19 f_(q-d+10) exactly when the pair wraps (d > q)
__device__ __forceinline__ Fe2 lf_sq(const Lane5& g, const Fe2& a) {
    __syncwarp();
    lf_put(g, g.s0, a);
    __syncwarp();
    const int32_t* S = g.s0 + 10 + g.q;
    int32_t up[6], down[6];
#pragma unroll
    for (int d = 0; d < 6; d++) {
        up[d] = S[d];
        down[d] = S[-d];
    }
    int64_t h[2] = {0, 0};
#pragma unroll
    for (int d = 0; d < 6; d++) {
        // fe_sq's pre-scaling: 2 off the diagonal, 2 again for an odd pair
        const int sh = ((g.q + d) & 1) + (d >= 1 && d <= 4);
        h[0] += (int64_t)(int32_t)((uint32_t)up[d] << sh) * down[d];
        if (d < 5) h[1] += (int64_t)(2 * up[d + 1]) * down[d];
    }
    return lf_carried(g, h);
}

// fe_add, fe_sub (minus) or fe_neg (a = 0, minus) on the lane's columns
__device__ __forceinline__ Fe2 lf_add_sub(const Lane5& g, const Fe2& a,
                                          const Fe2& b, bool minus) {
    int64_t h[2];
#pragma unroll
    for (int t = 0; t < 2; t++)
        h[t] = minus ? (int64_t)a.v[t] - b.v[t] : (int64_t)a.v[t] + b.v[t];
    lf_carry_pass(g, h);
    return Fe2{{(int32_t)h[0], (int32_t)h[1]}};
}

__device__ __forceinline__ Fe2 lf_add(const Lane5& g, const Fe2& a,
                                      const Fe2& b) {
    return lf_add_sub(g, a, b, false);
}

__device__ __forceinline__ Fe2 lf_sub(const Lane5& g, const Fe2& a,
                                      const Fe2& b) {
    return lf_add_sub(g, a, b, true);
}

__device__ __forceinline__ Fe2 lf_neg(const Lane5& g, const Fe2& a) {
    return lf_add_sub(g, Fe2{{0, 0}}, a, true);
}

// the lane's limbs of a constant (c in __constant__ memory)
__device__ __forceinline__ Fe2 lf_const(const Lane5& g, const int32_t* c) {
    return Fe2{{c[2 * g.q], c[2 * g.q + 1]}};
}

__device__ __forceinline__ Fe2 lf_small(const Lane5& g, int32_t x) {
    return Fe2{{g.q == 0 ? x : 0, 0}};
}

__device__ __forceinline__ Fe2 lf_select(bool m, const Fe2& a,
                                         const Fe2& b) {
    return Fe2{{m ? a.v[0] : b.v[0], m ? a.v[1] : b.v[1]}};
}

}  // namespace zk
