// Constant-time table selects for K17 (fixed_base.cu) and K18 (msm_ct.cu).
//
// Counterparts of the reference's native ge_cmov and add_digit's ct branch
// (zkvm_tpu/native/edwards255.cpp:104-160): a signed radix-16 digit d in
// [-8, 8] picks |d|·P from a row of the eight cached-form entries
// (k + 1)·P, k = 0..7, by scanning every entry with a mask, then negates
// the pick by mask.  A group of four lanes holds one point, lane j its
// coordinate j (lanes.cuh); entries are in the cached form lanes.cuh's
// lane_add takes, (Y - X, Y + X, 2d T, 2 Z), whose negation is
// (Y + X, Y - X, -2d T, 2 Z).
//
// Constant-time audit.  Nothing here branches on a digit or forms an
// address from one:
//   * ct_eq_mask is integer arithmetic (xor, subtract, shift, negate);
//   * fe_cmov moves every limb through the mask (xor, and, xor);
//   * every one of the eight entries is read, at an address the caller
//     computes from the window and the entry index k, never from d;
//   * the negation computes both the swapped pair (one shuffle, whose
//     source lane is j ^ 1, fixed by the lane) and the limb-wise negation
//     on every lane, then moves the result in by the sign's mask; the
//     selects on j are on the lane's coordinate, the same for every digit;
//   * the negation takes no carry pass: a carried entry's negated limbs
//     stay within 0.52 * 2^W, which lane_add_lazy (lanes.cuh) takes;
//     fe_small is field25519.cuh's, straight-line.
// The digits come from radix16_next, the reference's to_radix_16 (:121-135)
// one digit at a time: nibble plus carry v, carry (v + 8) >> 4, digit
// v - 16 carry, in [-8, 7] for a canonical scalar (below ℓ < 2^253, whose
// top nibble is at most 1, so the last digit takes no carry out): shifts,
// masks and adds, no branch.  radix16_seek starts that walk at any window:
// the carry into digit w is the carry into bit 4 w of s + 0x88..8 (eight
// added to every nibble: v + 8 >= 16 exactly when the digit carries), an
// eight-word addition that reads every word of the scalar and keeps the
// window's word by mask.
// Plain twins: fixed_base.py select_cached and radix16_plain (the same
// picks and digits, exact).
#pragma once
#include "field25519.cuh"
#include "lanes.cuh"

namespace zk {

// the next signed radix-16 digit of a scalar: cur holds its unread
// nibbles, least significant first (the caller loads word w / 8 into it
// before digit w when w % 8 == 0), carry the carry out of the digit before
__device__ __forceinline__ int32_t radix16_next(uint32_t& cur,
                                                int32_t& carry) {
    const int32_t v = (int32_t)(cur & 15u) + carry;
    cur >>= 4;
    carry = (v + 8) >> 4;
    return v - (carry << 4);
}

// all ones where x == y, else 0 (x ^ y in [0, 2^31))
__device__ __forceinline__ int32_t ct_eq_mask(int32_t x, int32_t y) {
    return -(int32_t)(((uint32_t)(x ^ y) - 1u) >> 31);
}

// radix16_next's state before digit w0 of scalar i, whose words lie at
// words[k * n + i]: cur the nibbles of word w0 / 8 from nibble w0 % 8 on,
// carry the carry into digit w0.  Digits w0 .. 8 (w0 / 8) + 7 then follow
// by radix16_next; w0 is public (the caller's window), never a digit.
__device__ __forceinline__ void radix16_seek(const int32_t* __restrict__ words,
                                             int64_t n, int64_t i, int w0,
                                             uint32_t& cur, int32_t& carry) {
    const int word = w0 >> 3, sh = 4 * (w0 & 7);
    uint32_t x = 0, y = 0, c = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const uint32_t xk = (uint32_t)words[k * n + i];
        const uint64_t t = (uint64_t)xk + 0x88888888u + c;
        const uint32_t m = (uint32_t)ct_eq_mask(k, word);
        x ^= m & (x ^ xk);
        y ^= m & (y ^ (uint32_t)t);
        c = (uint32_t)(t >> 32);
    }
    carry = (int32_t)(((x ^ y ^ 0x88888888u) >> sh) & 1u);
    cur = x >> sh;
}

// r = mask ? a : r, limb by limb, for mask 0 or all ones
__device__ __forceinline__ void fe_cmov(Fe& r, const Fe& a, int32_t mask) {
#pragma unroll
    for (int i = 0; i < 10; i++) r.v[i] ^= mask & (r.v[i] ^ a.v[i]);
}

// ten limbs from p, 8-byte aligned (a table row: coordinate j of an entry
// starts at a multiple of 40 bytes), as five 8-byte loads
__device__ __forceinline__ Fe fe_load_row(const int32_t* p) {
    const int2* q = reinterpret_cast<const int2*>(p);
    Fe r;
#pragma unroll
    for (int i = 0; i < 5; i++) {
        const int2 v = q[i];
        r.v[2 * i] = v.x;
        r.v[2 * i + 1] = v.y;
    }
    return r;
}

// coordinate j of the identity's cached form (1, 1, 0, 2)
__device__ __forceinline__ Fe lane_cached_identity(int j) {
    return fe_small(j == 3 ? 2 : (j < 2 ? 1 : 0));
}

// coordinate j of digit·P in cached form, digit in [-8, 8]; row(k) returns
// coordinate j of entry k, (k + 1)·P in cached form.  Every lane of the
// warp must call this together (one shuffle names the whole warp).
template <class Row>
__device__ __forceinline__ Fe lane_select_signed(int j, const Row& row,
                                                 int32_t digit) {
    const int32_t sign = digit >> 31;              // all ones if negative
    const int32_t mag = (digit ^ sign) - sign;     // |digit|
    Fe r = lane_cached_identity(j);
#pragma unroll
    for (int k = 0; k < 8; k++) fe_cmov(r, row(k), ct_eq_mask(mag, k + 1));
    const Fe swapped = shfl_fe(r, j ^ 1);
    Fe negated;
#pragma unroll
    for (int i = 0; i < 10; i++) negated.v[i] = -r.v[i];
    fe_cmov(r, j < 2 ? swapped : (j == 2 ? negated : r), sign);
    return r;
}

}  // namespace zk
