// Ristretto255 batch compress/decompress on 5x51-bit limbs.
//
// Upstream counterpart: curve25519-dalek src/ristretto.rs (compress/
// decompress) over backend/serial/u64/field.rs (FieldElement51).  The
// pure-Python twin (zkvm_tpu_torch/oracle/ristretto.py) remains the semantic
// ground truth; this module exists because the verify hot path decompresses
// dozens of points per proof and Python pow() dominates that host work.
//
// Curve constants (d, sqrt(-1), 1/sqrt(a-d)) are injected at load time from
// zkvm_tpu_torch/constants.py, where they are derived from first principles —
// no magic values are transcribed here.

#include "field51.h"

using namespace f51;

namespace {

// injected constants (see ristretto_set_constants)
fe D_FE, SQRT_M1_FE, INVSQRT_A_MINUS_D_FE;
bool CONSTANTS_SET = false;

// sqrt_ratio per RFC 9496 / the twin's field.sqrt_ratio: returns was_square;
// out = nonnegative sqrt(u/v) when square, sqrt(SQRT_M1*u/v) otherwise.
bool fe_sqrt_ratio(fe& out, const fe& u, const fe& v) {
    fe v3, v7, r, check, t;
    fe_sq(t, v); fe_mul(v3, t, v);
    fe_sq(t, v3); fe_mul(v7, t, v);
    fe_mul(t, u, v7);
    fe_pow_p58(r, t);
    fe_mul(t, u, v3);
    fe_mul(r, t, r);
    fe_sq(t, r); fe_mul(check, v, t);

    fe neg_u, neg_u_i;
    fe_neg(neg_u, u);
    fe_mul(neg_u_i, neg_u, SQRT_M1_FE);
    bool correct_sign = fe_eq(check, u);
    bool flipped_sign = fe_eq(check, neg_u);
    bool flipped_sign_i = fe_eq(check, neg_u_i);
    if (flipped_sign || flipped_sign_i) {
        fe_mul(r, r, SQRT_M1_FE);
    }
    fe_abs(out, r);
    return correct_sign || flipped_sign;
}

// canonical little-endian encoding check: value must be < p = 2^255 - 19
bool bytes_canonical(const uint8_t* s) {
    if (s[31] & 0x80) return false;            // >= 2^255
    // compare with p: only values >= 2^255 - 19 can be non-canonical
    if (s[31] != 0x7F) return true;
    for (int i = 30; i >= 1; i--) {
        if (s[i] != 0xFF) return true;
    }
    return s[0] < 0xED;
}

}  // namespace

extern "C" {

// constants as canonical 32-byte LE field encodings
void ristretto_set_constants(const uint8_t* d, const uint8_t* sqrt_m1,
                             const uint8_t* invsqrt_a_minus_d) {
    fe_frombytes(D_FE, d);
    fe_frombytes(SQRT_M1_FE, sqrt_m1);
    fe_frombytes(INVSQRT_A_MINUS_D_FE, invsqrt_a_minus_d);
    CONSTANTS_SET = true;
}

// in: n 32-byte encodings; out: n * 128 bytes (X,Y,Z,T canonical 32-byte LE);
// ok[i] = 1 when the encoding is valid.  Mirrors the twin's decompress exactly.
void ristretto_decompress_batch(const uint8_t* in, int n, uint8_t* out,
                                uint8_t* ok) {
    parallel_ranges(n, 64, [&](int lo, int hi) {
    for (int i = lo; i < hi; i++) {
        const uint8_t* b = in + 32 * i;
        uint8_t* o = out + 128 * i;
        ok[i] = 0;
        memset(o, 0, 128);
        if (!bytes_canonical(b)) continue;
        fe s;
        fe_frombytes(s, b);
        if (fe_is_negative(s)) continue;
        fe ss, u1, u2, u2_sqr, v, t, one;
        fe_one(one);
        fe_sq(ss, s);
        fe_sub(u1, one, ss);
        fe_add(u2, one, ss);
        fe_sq(u2_sqr, u2);
        // v = -d*u1^2 - u2^2
        fe du1sq, nd;
        fe_sq(t, u1);
        fe_neg(nd, D_FE);
        fe_mul(du1sq, nd, t);
        fe_sub(v, du1sq, u2_sqr);
        fe invsqrt;
        fe_mul(t, v, u2_sqr);
        bool was_square = fe_sqrt_ratio(invsqrt, one, t);
        fe den_x, den_y, x, y, xy;
        fe_mul(den_x, invsqrt, u2);
        fe_mul(t, invsqrt, den_x);
        fe_mul(den_y, t, v);
        fe two_s;
        fe_add(two_s, s, s);
        fe_mul(t, two_s, den_x);
        fe_abs(x, t);
        fe_mul(y, u1, den_y);
        fe_mul(xy, x, y);
        if (!was_square || fe_is_negative(xy) || fe_is_zero(y)) continue;
        ok[i] = 1;
        fe_tobytes(o, x);
        fe_tobytes(o + 32, y);
        fe_tobytes(o + 64, one);
        fe_tobytes(o + 96, xy);
    }
    });
}

// in: n * 128 bytes extended coords (X,Y,Z,T canonical 32-byte LE);
// out: n 32-byte encodings.  Mirrors the twin's compress exactly.
void ristretto_compress_batch(const uint8_t* in, int n, uint8_t* out) {
    for (int i = 0; i < n; i++) {
        const uint8_t* c = in + 128 * i;
        fe X, Y, Z, T;
        fe_frombytes(X, c);
        fe_frombytes(Y, c + 32);
        fe_frombytes(Z, c + 64);
        fe_frombytes(T, c + 96);
        fe u1, u2, t, a, b;
        fe_add(a, Z, Y);
        fe_sub(b, Z, Y);
        fe_mul(u1, a, b);
        fe_mul(u2, X, Y);
        fe invsqrt, one;
        fe_one(one);
        fe_sq(t, u2);
        fe_mul(t, u1, t);
        fe_sqrt_ratio(invsqrt, one, t);
        fe den1, den2, z_inv;
        fe_mul(den1, invsqrt, u1);
        fe_mul(den2, invsqrt, u2);
        fe_mul(t, den1, den2);
        fe_mul(z_inv, t, T);
        fe ix0, iy0, ench;
        fe_mul(ix0, X, SQRT_M1_FE);
        fe_mul(iy0, Y, SQRT_M1_FE);
        fe_mul(ench, den1, INVSQRT_A_MINUS_D_FE);
        fe_mul(t, T, z_inv);
        bool rotate = fe_is_negative(t);
        fe x, y, den_inv;
        if (rotate) { x = iy0; y = ix0; den_inv = ench; }
        else        { x = X;   y = Y;   den_inv = den2; }
        fe_mul(t, x, z_inv);
        if (fe_is_negative(t)) fe_neg(y, y);
        fe s;
        fe_sub(t, Z, y);
        fe_mul(s, den_inv, t);
        fe_abs(s, s);
        fe_tobytes(out + 32 * i, s);
    }
}

int ristretto_constants_ready() { return CONSTANTS_SET ? 1 : 0; }

}  // extern "C"
