// Vectorized arithmetic mod the group order l = 2^252 + 27742...493.
//
// Upstream counterpart: curve25519-dalek src/scalar.rs + backend/serial/
// u64/scalar.rs (Scalar52 Montgomery machinery), reshaped as batch
// operations over packed 32-byte little-endian arrays: the verifier's
// s-vector / g/h-scalar assembly and the prover's vector algebra do O(n)
// scalar muls per proof, and CPython big-int ops dominate that host
// profile.  4x64-limb CIOS Montgomery multiplication.
//
// Constants (l, R^2 mod l, l-2) are injected from zkvm_tpu_torch/constants.py at
// load time — no magic values transcribed here.  All inputs must be
// canonical (< l); the Python wrapper (proofs/scalarvec.py ScalarVec)
// guarantees this.

#include <cstdint>
#include <cstring>

#include "field51.h"  // WorkerPool / parallel_ranges (also typedefs u64/u128)

namespace {

u64 L_[4];         // modulus limbs
u64 RR_[4];        // R^2 mod l  (R = 2^256)
u64 ONE_M[4];      // R mod l = to_mont(1)
uint8_t LM2[32];   // l - 2, little-endian (inversion exponent)
u64 N0INV;         // -l^{-1} mod 2^64

void load4(u64 r[4], const uint8_t* b) { memcpy(r, b, 32); }
void store4(uint8_t* b, const u64 r[4]) { memcpy(b, r, 32); }

bool geq4(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] != b[i]) return a[i] > b[i];
    }
    return true;
}

void sub4(u64 r[4], const u64 a[4], const u64 b[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - borrow;
        r[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

void mont_mul(u64 out[4], const u64 a[4], const u64 b[4]) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            u128 s = (u128)t[j] + (u128)a[j] * b[i] + c;
            t[j] = (u64)s;
            c = s >> 64;
        }
        u128 s = (u128)t[4] + c;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);
        u64 m = t[0] * N0INV;
        c = ((u128)t[0] + (u128)m * L_[0]) >> 64;
        for (int j = 1; j < 4; j++) {
            u128 s2 = (u128)t[j] + (u128)m * L_[j] + c;
            t[j - 1] = (u64)s2;
            c = s2 >> 64;
        }
        s = (u128)t[4] + c;
        t[3] = (u64)s;
        t[4] = t[5] + (u64)(s >> 64);
    }
    u64 r[4] = {t[0], t[1], t[2], t[3]};
    if (t[4] || geq4(r, L_)) sub4(r, r, L_);
    memcpy(out, r, 32);
}

void addmod(u64 r[4], const u64 a[4], const u64 b[4]) {
    u128 c = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a[i] + b[i] + c;
        t[i] = (u64)s;
        c = s >> 64;
    }
    if (c || geq4(t, L_)) sub4(t, t, L_);
    memcpy(r, t, 32);
}

void submod(u64 r[4], const u64 a[4], const u64 b[4]) {
    u64 t[4];
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - borrow;
        t[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 c = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)t[i] + L_[i] + c;
            t[i] = (u64)s;
            c = s >> 64;
        }
    }
    memcpy(r, t, 32);
}

void to_mont(u64 r[4], const u64 a[4]) { mont_mul(r, a, RR_); }

// a^(l-2) in the Montgomery domain: am must already be Montgomery form
void mont_pow_lm2(u64 out[4], const u64 am[4]) {
    u64 acc[4];
    memcpy(acc, ONE_M, 32);
    for (int bit = 255; bit >= 0; bit--) {
        mont_mul(acc, acc, acc);
        if ((LM2[bit >> 3] >> (bit & 7)) & 1) mont_mul(acc, acc, am);
    }
    memcpy(out, acc, 32);
}

bool is_zero4(const u64 a[4]) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

}  // namespace

extern "C" {

// 64 uniform little-endian bytes -> canonical scalar mod l (the
// challenge_scalar / TranscriptRng::random_scalar reduction).  Safe for
// lo,hi < 2^256: CIOS with one operand < l keeps t < 2l.
void sv_from_wide(const uint8_t* in64, uint8_t* out32) {
    u64 lo[4], hi[4], a[4], b[4];
    const u64 one[4] = {1, 0, 0, 0};
    load4(lo, in64);
    load4(hi, in64 + 32);
    mont_mul(a, lo, RR_);   // lo * R
    mont_mul(a, a, one);    // lo mod l
    mont_mul(b, hi, RR_);   // hi * 2^256 mod l
    addmod(a, a, b);
    store4(out32, a);
}


// batched sv_from_wide: n 64-byte uniform blocks -> n canonical scalars
// (one call covers a whole blinding vector; pooled for large n)
void scl_from_wide(const uint8_t* in64, int n, uint8_t* out32) {
    f51::parallel_ranges(n, 4096, [&](int lo, int hi) {
        for (int i = lo; i < hi; i++)
            sv_from_wide(in64 + 64 * (size_t)i, out32 + 32 * (size_t)i);
    });
}


void scl_set_constants(const uint8_t* l_le, const uint8_t* rr_le,
                       const uint8_t* lm2_le) {
    load4(L_, l_le);
    load4(RR_, rr_le);
    memcpy(LM2, lm2_le, 32);
    // -l^{-1} mod 2^64 by Newton iteration
    u64 x = 1;
    for (int i = 0; i < 6; i++) x *= 2 - L_[0] * x;
    N0INV = (u64)0 - x;
    // R mod l = to_mont(1)
    u64 one[4] = {1, 0, 0, 0};
    mont_mul(ONE_M, one, RR_);
}

// elementwise out[i] = a[i] * b[i]
void scl_mul(const uint8_t* a, const uint8_t* b, int n, uint8_t* out) {
    for (int i = 0; i < n; i++) {
        u64 av[4], bv[4], bm[4], r[4];
        load4(av, a + 32 * i);
        load4(bv, b + 32 * i);
        to_mont(bm, bv);
        mont_mul(r, av, bm);
        store4(out + 32 * i, r);
    }
}

// out[i] = a[i] * b   (b a single scalar)
void scl_mul_scalar(const uint8_t* a, const uint8_t* b, int n, uint8_t* out) {
    u64 bv[4], bm[4];
    load4(bv, b);
    to_mont(bm, bv);
    for (int i = 0; i < n; i++) {
        u64 av[4], r[4];
        load4(av, a + 32 * i);
        mont_mul(r, av, bm);
        store4(out + 32 * i, r);
    }
}

void scl_add(const uint8_t* a, const uint8_t* b, int n, uint8_t* out) {
    for (int i = 0; i < n; i++) {
        u64 av[4], bv[4], r[4];
        load4(av, a + 32 * i);
        load4(bv, b + 32 * i);
        addmod(r, av, bv);
        store4(out + 32 * i, r);
    }
}

void scl_sub(const uint8_t* a, const uint8_t* b, int n, uint8_t* out) {
    for (int i = 0; i < n; i++) {
        u64 av[4], bv[4], r[4];
        load4(av, a + 32 * i);
        load4(bv, b + 32 * i);
        submod(r, av, bv);
        store4(out + 32 * i, r);
    }
}

void scl_neg(const uint8_t* a, int n, uint8_t* out) {
    u64 zero[4] = {0, 0, 0, 0};
    for (int i = 0; i < n; i++) {
        u64 av[4], r[4];
        load4(av, a + 32 * i);
        submod(r, zero, av);
        store4(out + 32 * i, r);
    }
}

// out[i] = a[i]*x + b  (x, b single scalars)
void scl_axpb(const uint8_t* a, const uint8_t* x, const uint8_t* b, int n,
              uint8_t* out) {
    u64 xv[4], xm[4], bv[4];
    load4(xv, x);
    load4(bv, b);
    to_mont(xm, xv);
    for (int i = 0; i < n; i++) {
        u64 av[4], r[4];
        load4(av, a + 32 * i);
        mont_mul(r, av, xm);
        addmod(r, r, bv);
        store4(out + 32 * i, r);
    }
}

// out[i] = a[i]*b[i] + c[i]
void scl_muladd(const uint8_t* a, const uint8_t* b, const uint8_t* c, int n,
                uint8_t* out) {
    for (int i = 0; i < n; i++) {
        u64 av[4], bv[4], bm[4], cv[4], r[4];
        load4(av, a + 32 * i);
        load4(bv, b + 32 * i);
        load4(cv, c + 32 * i);
        to_mont(bm, bv);
        mont_mul(r, av, bm);
        addmod(r, r, cv);
        store4(out + 32 * i, r);
    }
}

// out = [1, x, x^2, ..., x^(n-1)]
void scl_powers(const uint8_t* x, int n, uint8_t* out) {
    if (n <= 0) return;
    u64 xv[4], xm[4], acc[4] = {1, 0, 0, 0};
    load4(xv, x);
    to_mont(xm, xv);
    store4(out, acc);
    for (int i = 1; i < n; i++) {
        mont_mul(acc, acc, xm);
        store4(out + 32 * i, acc);
    }
}

void scl_sum(const uint8_t* a, int n, uint8_t* out) {
    u64 acc[4] = {0, 0, 0, 0};
    for (int i = 0; i < n; i++) {
        u64 av[4];
        load4(av, a + 32 * i);
        addmod(acc, acc, av);
    }
    store4(out, acc);
}

// <a, b> mod l
void scl_inner(const uint8_t* a, const uint8_t* b, int n, uint8_t* out) {
    // accumulate a[i]*b[i]*R^-1, fix the R^-1 once at the end
    u64 acc[4] = {0, 0, 0, 0};
    for (int i = 0; i < n; i++) {
        u64 av[4], bv[4], r[4];
        load4(av, a + 32 * i);
        load4(bv, b + 32 * i);
        mont_mul(r, av, bv);
        addmod(acc, acc, r);
    }
    mont_mul(acc, acc, RR_);
    store4(out, acc);
}

// Fold R1CS constraint terms with powers of z into per-wire weight vectors
// (upstream bulletproofs r1cs/verifier.rs flattened_constraints; the
// twin is proofs/r1cs/constraint_system.py::flatten_constraints).
// Terms arrive as parallel arrays in constraint order:
//   qs[t]    constraint index (ascending, may repeat/skip)
//   kinds[t] bits 0..2: 0=mult-left 1=mult-right 2=mult-out 3=committed
//            4=constant; bit 7: coeff is negated; bit 6: coeff is a full
//            32-byte scalar in `big` (consumed in order), else coeffs64[t]
//   idxs[t]  wire index within its kind
// Weights use z^{q+1}; committed/constant terms subtract (upstream sign
// convention).  outL/outR/outO are zeroed for n entries, outV for m; the
// caller may allocate them longer (padding stays zero).
void scl_flatten(const int32_t* qs, const uint8_t* kinds,
                 const int32_t* idxs, const uint64_t* coeffs64,
                 const uint8_t* big, long n_terms, const uint8_t* z_le,
                 int n, int m, uint8_t* outL, uint8_t* outR, uint8_t* outO,
                 uint8_t* outV, uint8_t* out_wc) {
    memset(outL, 0, 32 * (size_t)n);
    memset(outR, 0, 32 * (size_t)n);
    memset(outO, 0, 32 * (size_t)n);
    memset(outV, 0, 32 * (size_t)m);
    memset(out_wc, 0, 32);
    u64 zv[4], zm[4], zq[4];
    load4(zv, z_le);
    to_mont(zm, zv);
    memcpy(zq, zm, 32);            // z^1 in Montgomery form
    int cur_q = 0;
    long big_i = 0;
    u64 wc[4] = {0, 0, 0, 0};
    for (long t = 0; t < n_terms; t++) {
        while (cur_q < qs[t]) {
            mont_mul(zq, zq, zm);
            cur_q++;
        }
        u64 c[4];
        uint8_t k = kinds[t];
        if (k & 0x40) {
            load4(c, big + 32 * big_i++);
        } else {
            c[0] = coeffs64[t]; c[1] = c[2] = c[3] = 0;
        }
        u64 w[4];
        mont_mul(w, zq, c);        // zq(mont) * c(plain) = zq*c (plain)
        bool neg = (k & 0x80) != 0;
        uint8_t* slot = nullptr;
        switch (k & 0x07) {
            case 0: slot = outL + 32 * (size_t)idxs[t]; break;
            case 1: slot = outR + 32 * (size_t)idxs[t]; break;
            case 2: slot = outO + 32 * (size_t)idxs[t]; break;
            case 3: slot = outV + 32 * (size_t)idxs[t]; neg = !neg; break;
            default: slot = nullptr; break;    // constant term -> wc
        }
        if (slot) {
            u64 acc[4];
            load4(acc, slot);
            if (neg) submod(acc, acc, w); else addmod(acc, acc, w);
            store4(slot, acc);
        } else {
            if (neg) addmod(wc, wc, w); else submod(wc, wc, w);
        }
    }
    store4(out_wc, wc);
}

// Montgomery-trick batch inversion; zero entries invert to zero
void scl_batch_invert(const uint8_t* a, int n, uint8_t* out) {
    if (n <= 0) return;
    // prefix[i] = product of nonzero a[0..i-1] in Montgomery form
    u64* prefix = new u64[4 * (n + 1)];
    memcpy(prefix, ONE_M, 32);
    for (int i = 0; i < n; i++) {
        u64 av[4], am[4];
        load4(av, a + 32 * i);
        if (is_zero4(av)) {
            memcpy(prefix + 4 * (i + 1), prefix + 4 * i, 32);
        } else {
            to_mont(am, av);
            mont_mul(prefix + 4 * (i + 1), prefix + 4 * i, am);
        }
    }
    u64 inv[4];
    mont_pow_lm2(inv, prefix + 4 * n);  // (prod)^-1 in Montgomery form
    for (int i = n - 1; i >= 0; i--) {
        u64 av[4], am[4], r[4];
        load4(av, a + 32 * i);
        if (is_zero4(av)) {
            memset(out + 32 * i, 0, 32);
            continue;
        }
        mont_mul(r, inv, prefix + 4 * i);       // mont form of 1/a[i]
        u64 one[4] = {1, 0, 0, 0};
        u64 plain[4];
        mont_mul(plain, r, one);                // from_mont
        store4(out + 32 * i, plain);
        to_mont(am, av);
        mont_mul(inv, inv, am);
    }
    delete[] prefix;
}

}  // extern "C"


// ---------------------------------------------------------------------------
// Fused rangeproof verifier scalar assembly: the per-proof ScalarVec chain
// of proofs/rangeproof.py::_job_parts in ONE call.  From the IPP round
// challenges and (y, z, a, b) it emits u^2, u^-2, the g/h scalar columns,
// and delta(n, m, y, z):
//   s_i    = prod_j u_j^{+-1}        (doubling expansion)
//   g_i    = -z - a*s_i
//   h_i    = z + y^-i * (z^2 * z2_i - b / s_i),  1/s_i = s_{nm-1-i}
//   z2_i   = z^(i div n) * 2^(i mod n)
//   delta  = (z - z^2) * sum_{i<nm} y^i - sum_{j<m} z^(j+3) * sum_{i<n} 2^i
// All arithmetic stays in the Montgomery domain; outputs are canonical.
// Layout of out: u_sq (lg*32) | u_inv_sq (lg*32) | g (nm*32) | h (nm*32)
// | delta (32).  A zero challenge inverts to zero, as in the twin's
// scalar.batch_invert_plain.  Returns 0, or -1 on bad sizes.

#include <vector>

extern "C" int rangeproof_scalar_assembly(
    const uint8_t* u_bytes, int lg, uint64_t n, uint64_t m,
    const uint8_t* y_b, const uint8_t* z_b,
    const uint8_t* a_b, const uint8_t* b_b,
    uint8_t* out) {
    if (lg < 0 || lg > 20) return -1;
    const uint64_t nm = n * m;
    if (nm != (1ull << lg) || nm > (1u << 20)) return -1;
    const u64 one[4] = {1, 0, 0, 0};
    u64 um[20][4], uinv[20][4], usq[20][4], uisq[20][4];
    u64 prefix[21][4];
    memcpy(prefix[0], ONE_M, 32);
    bool any_zero = false;
    for (int i = 0; i < lg; i++) {
        u64 t[4];
        load4(t, u_bytes + 32 * i);
        to_mont(um[i], t);
        if (is_zero4(t)) {  // a zero challenge inverts to zero (the twin's)
            any_zero = true;
            memcpy(prefix[i + 1], prefix[i], 32);
        } else {
            mont_mul(prefix[i + 1], prefix[i], um[i]);
        }
    }
    // Montgomery-trick batch inversion: ONE l-2 pow chain for all u_i
    u64 allinv[4], run[4];
    mont_pow_lm2(allinv, prefix[lg]);
    memcpy(run, allinv, 32);
    for (int i = lg - 1; i >= 0; i--) {
        if (is_zero4(um[i])) {
            memset(uinv[i], 0, 32);
            continue;
        }
        mont_mul(uinv[i], run, prefix[i]);
        mont_mul(run, run, um[i]);
    }
    // allinv = the product of the inverses, zero with a zero challenge
    if (any_zero) memset(allinv, 0, 32);
    for (int i = 0; i < lg; i++) {
        mont_mul(usq[i], um[i], um[i]);
        mont_mul(uisq[i], uinv[i], uinv[i]);
        u64 o[4];
        mont_mul(o, usq[i], one);
        store4(out + 32 * i, o);
        mont_mul(o, uisq[i], one);
        store4(out + 32 * (lg + i), o);
    }

    // s expansion by doubling (Montgomery domain)
    std::vector<u64> s(4 * nm);
    memcpy(&s[0], allinv, 32);
    uint64_t len = 1;
    for (int j = 0; j < lg; j++) {
        const u64* w = usq[lg - 1 - j];
        for (uint64_t i = 0; i < len; i++) {
            mont_mul(&s[4 * (len + i)], &s[4 * i], w);
        }
        len *= 2;
    }

    u64 ym[4], zm[4], am[4], bm[4], t4[4];
    load4(t4, y_b); to_mont(ym, t4);
    load4(t4, z_b); to_mont(zm, t4);
    load4(t4, a_b); to_mont(am, t4);
    load4(t4, b_b); to_mont(bm, t4);
    u64 yinv[4], zz[4], twom[4];
    mont_pow_lm2(yinv, ym);
    mont_mul(zz, zm, zm);
    const u64 two[4] = {2, 0, 0, 0};
    to_mont(twom, two);
    const u64 zero4[4] = {0, 0, 0, 0};

    uint8_t* g_out = out + 32 * (2 * lg);
    uint8_t* h_out = g_out + 32 * nm;
    u64 yinv_pow[4], zj[4], two_pow[4];
    memcpy(yinv_pow, ONE_M, 32);
    memcpy(zj, ONE_M, 32);
    for (uint64_t i = 0; i < nm; i++) {
        if (i % n == 0) {
            memcpy(two_pow, ONE_M, 32);
            if (i) mont_mul(zj, zj, zm);
        }
        // g_i = -(z + a*s_i)
        u64 g[4], h[4], t[4];
        mont_mul(t, am, &s[4 * i]);
        addmod(t, t, zm);
        submod(g, zero4, t);
        mont_mul(g, g, one);
        store4(g_out + 32 * i, g);
        // h_i = z + y^-i * (zz * z2_i - b * s_inv_i)
        u64 z2i[4], bs[4];
        mont_mul(z2i, zj, two_pow);
        mont_mul(z2i, z2i, zz);
        mont_mul(bs, bm, &s[4 * (nm - 1 - i)]);
        submod(t, z2i, bs);
        mont_mul(t, t, yinv_pow);
        addmod(t, t, zm);
        mont_mul(h, t, one);
        store4(h_out + 32 * i, h);

        mont_mul(yinv_pow, yinv_pow, yinv);
        mont_mul(two_pow, two_pow, twom);
    }

    // delta(n, m, y, z)
    u64 sum_y[4], sum_2[4], ypow[4], tpow[4];
    memcpy(sum_y, zero4, 32); memcpy(ypow, ONE_M, 32);
    for (uint64_t i = 0; i < nm; i++) {
        addmod(sum_y, sum_y, ypow);
        mont_mul(ypow, ypow, ym);
    }
    memcpy(sum_2, zero4, 32); memcpy(tpow, ONE_M, 32);
    for (uint64_t i = 0; i < n; i++) {
        addmod(sum_2, sum_2, tpow);
        mont_mul(tpow, tpow, twom);
    }
    u64 acc[4], zexp[4];
    submod(acc, zm, zz);
    mont_mul(acc, acc, sum_y);
    mont_mul(zexp, zz, zm);          // z^3
    for (uint64_t j = 0; j < m; j++) {
        u64 term[4];
        mont_mul(term, zexp, sum_2);
        submod(acc, acc, term);
        mont_mul(zexp, zexp, zm);
    }
    mont_mul(acc, acc, one);
    store4(out + 32 * (2 * lg + 2 * nm), acc);
    return 0;
}


// ---------------------------------------------------------------------------
// Fused BATCH verification-params assembly for the device batch-verify path
// (kernels/batch_verify_device.py::prepare_batch_inputs).  The per-proof
// Python big-int chain (~25 mod-l muls + the delta series per proof) is
// its twin (prepare_batch_inputs_plain); this emits every channel
// scalar for the whole batch in ONE call, with a single Montgomery-trick
// batch inversion across all proofs' (u_j, y, y-1) — bit-identical to the
// twin's shared scalar.batch_invert_plain.  Upstream seam: the same
// per-proof scalars assembled inside `RangeProof::verify_multiple`
// (bulletproofs/src/range_proof/mod.rs [U]).
//
// chal:    nb*(5+lg)*32  canonical LE per proof: y, z, x, w, c, u[0..lg)
// prf:     nb*5*32       per proof: t_x, t_x_blinding, e_blinding, a, b
// wt_wide: nb*64         per-proof random-weight hash (reduced wide here)
// params_out: nb*(9+lg)*32 channel scalars, canonical, in the compact
//             layout below (pack_verification_params_compact)
// bbB_out:    nb*2*32  per-proof weighted [B_blinding, B] scalars:
//             wt * -(e_blinding + c*t_x_blinding),
//             wt * (w*(t_x - a*b) + c*(delta - t_x))
// A zero u or y challenge inverts to zero, as in the twin's shared
// scalar.batch_invert_plain.  Returns 0, or -1 on bad sizes.

extern "C" int fused_params_assembly(
    const uint8_t* chal, const uint8_t* prf, const uint8_t* wt_wide,
    int nb, int lg, uint64_t n, uint64_t m,
    uint8_t* params_out, uint8_t* bbB_out) {
    if (nb <= 0 || lg < 0 || lg > 20) return -1;
    const uint64_t nm = n * m;
    if (nm != (1ull << lg)) return -1;
    const int CH = 5 + lg;
    const int C = 9 + lg;  // compact layout (see below)
    const u64 one[4] = {1, 0, 0, 0};
    const u64 zero4[4] = {0, 0, 0, 0};

    // Montgomery forms + ONE global batch inversion over nb*(lg+2) elements
    const int per = lg + 2;  // u[0..lg), y, (y-1 or 1)
    const size_t cnt = (size_t)nb * per;
    std::vector<u64> mont(4 * (size_t)nb * CH), el(4 * cnt),
        pre(4 * (cnt + 1)), invs(4 * cnt);
    for (int i = 0; i < nb; i++) {
        for (int j = 0; j < CH; j++) {
            u64 t[4];
            load4(t, chal + 32 * ((size_t)i * CH + j));
            to_mont(&mont[4 * ((size_t)i * CH + j)], t);
        }
        const u64* ym = &mont[4 * ((size_t)i * CH)];
        u64* e0 = &el[4 * (size_t)i * per];
        for (int j = 0; j < lg; j++) {
            const u64* uj = &mont[4 * ((size_t)i * CH + 5 + j)];
            memcpy(&e0[4 * j], uj, 32);
        }
        memcpy(&e0[4 * lg], ym, 32);
        u64 ym1[4];
        submod(ym1, ym, ONE_M);
        if (is_zero4(ym1)) memcpy(ym1, ONE_M, 32);  // y==1: invert 1 (parity
        // with the Python path's `(y - 1) % L or 1` guard)
        memcpy(&e0[4 * (lg + 1)], ym1, 32);
    }
    // zero elements (a zero u or y) are skipped and invert to zero
    memcpy(&pre[0], ONE_M, 32);
    for (size_t i = 0; i < cnt; i++) {
        if (is_zero4(&el[4 * i]))
            memcpy(&pre[4 * (i + 1)], &pre[4 * i], 32);
        else
            mont_mul(&pre[4 * (i + 1)], &pre[4 * i], &el[4 * i]);
    }
    u64 run[4];
    mont_pow_lm2(run, &pre[4 * cnt]);
    for (size_t i = cnt; i-- > 0;) {
        if (is_zero4(&el[4 * i])) {
            memset(&invs[4 * i], 0, 32);
            continue;
        }
        mont_mul(&invs[4 * i], run, &pre[4 * i]);
        mont_mul(run, run, &el[4 * i]);
    }

    // batch-constant: 2^n - 1 and the Montgomery form of 2
    u64 twom[4], sum2m[4];
    { const u64 two[4] = {2, 0, 0, 0}; to_mont(twom, two); }
    memcpy(sum2m, ONE_M, 32);
    for (uint64_t i = 0; i < n; i++) mont_mul(sum2m, sum2m, twom);
    submod(sum2m, sum2m, ONE_M);

    for (int i = 0; i < nb; i++) {
        const u64* ym = &mont[4 * ((size_t)i * CH + 0)];
        const u64* zm = &mont[4 * ((size_t)i * CH + 1)];
        const u64* xm = &mont[4 * ((size_t)i * CH + 2)];
        const u64* wm = &mont[4 * ((size_t)i * CH + 3)];
        const u64* cm = &mont[4 * ((size_t)i * CH + 4)];
        const u64* um = &mont[4 * ((size_t)i * CH + 5)];
        const u64* uinv = &invs[4 * (size_t)i * per];
        const u64* yinv = &invs[4 * ((size_t)i * per + lg)];
        const u64* ym1inv = &invs[4 * ((size_t)i * per + lg + 1)];

        u64 txm[4], txbm[4], ebm[4], am[4], bm[4], t[4], t2[4];
        load4(t, prf + 32 * (5 * (size_t)i + 0)); to_mont(txm, t);
        load4(t, prf + 32 * (5 * (size_t)i + 1)); to_mont(txbm, t);
        load4(t, prf + 32 * (5 * (size_t)i + 2)); to_mont(ebm, t);
        load4(t, prf + 32 * (5 * (size_t)i + 3)); to_mont(am, t);
        load4(t, prf + 32 * (5 * (size_t)i + 4)); to_mont(bm, t);
        u64 wtm[4];
        uint8_t wtb[32];
        sv_from_wide(wt_wide + 64 * (size_t)i, wtb);
        load4(t, wtb); to_mont(wtm, t);

        // COMPACT channel layout (9 + lg columns; the derived wz/wzz/
        // wa_neg/... products and u_inv_sq are synthesized on the card
        // from these — kernels/batch_verify_device._synthesize_lm):
        //   [0] wt  [1] z  [2] y_inv  [3] allinv  [4] a  [5] b  [6] x
        //   [7] cx (c·x)  [8] czz (c·z²)  [9..9+lg) u_sq
        uint8_t* row = params_out + 32 * (size_t)i * C;
        u64 zz[4], v[4], o[4];
        mont_mul(zz, zm, zm);
        mont_mul(o, wtm, one); store4(row, o);                 // wt
        mont_mul(o, zm, one); store4(row + 32, o);             // z
        mont_mul(o, yinv, one); store4(row + 64, o);           // y_inv
        u64 ai[4];
        memcpy(ai, ONE_M, 32);
        for (int j = 0; j < lg; j++) mont_mul(ai, ai, &uinv[4 * j]);
        mont_mul(o, ai, one); store4(row + 96, o);             // allinv
        mont_mul(o, am, one); store4(row + 128, o);            // a
        mont_mul(o, bm, one); store4(row + 160, o);            // b
        mont_mul(o, xm, one); store4(row + 192, o);            // x
        mont_mul(v, cm, xm);
        mont_mul(o, v, one); store4(row + 224, o);             // cx
        mont_mul(v, cm, zz);
        mont_mul(o, v, one); store4(row + 256, o);             // czz
        for (int j = 0; j < lg; j++) {
            mont_mul(v, &um[4 * j], &um[4 * j]);
            mont_mul(o, v, one); store4(row + 32 * (9 + j), o);  // u_sq
        }

        // delta(n, m, y, z): geometric sum_y via the shared (y-1) inverse
        u64 ynm[4], sumy[4];
        memcpy(ynm, ym, 32);
        for (int j = 0; j < lg; j++) mont_mul(ynm, ynm, ynm);
        if (memcmp(ym, ONE_M, 32) == 0) {
            // y==1: the series is nm (unreachable for transcript
            // challenges; kept for Python-path parity)
            const u64 nm4[4] = {nm, 0, 0, 0};
            to_mont(sumy, nm4);
        } else {
            submod(t, ynm, ONE_M);
            mont_mul(sumy, t, ym1inv);
        }
        u64 acc[4], zexp[4];
        submod(acc, zm, zz);
        mont_mul(acc, acc, sumy);
        mont_mul(zexp, zz, zm);
        for (uint64_t j = 0; j < m; j++) {
            mont_mul(t, zexp, sum2m);
            submod(acc, acc, t);
            mont_mul(zexp, zexp, zm);
        }
        // bbB: wt*bb_s, wt*b_s
        u64 bs[4], bbs[4];
        mont_mul(t, am, bm);
        submod(t, txm, t);           // t_x - a*b
        mont_mul(bs, wm, t);
        submod(t, acc, txm);         // delta - t_x
        mont_mul(t2, cm, t);
        addmod(bs, bs, t2);
        mont_mul(t, cm, txbm);
        addmod(t, t, ebm);
        submod(bbs, zero4, t);       // -(e_blinding + c*t_x_blinding)
        uint8_t* brow = bbB_out + 64 * (size_t)i;
        mont_mul(v, wtm, bbs); mont_mul(o, v, one); store4(brow, o);
        mont_mul(v, wtm, bs); mont_mul(o, v, one); store4(brow + 32, o);
    }
    return 0;
}
