// Point operations split over four lanes, one coordinate per lane.
//
// Shared by K2 (bucket_accumulate.cu), K3 (bucket_fold.cu) and K4
// (horner_check.cu).  A group of four consecutive lanes of a warp holds one
// point: lane j = lane & 3 holds coordinate j (X, Y, Z, T).  Each level of a
// point operation puts its four independent multiplications on the four
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

}  // namespace zk
