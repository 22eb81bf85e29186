// Native host path for Keccak-f[1600] + STROBE-128.
//
// Upstream counterpart: the `keccak` crate + merlin/src/strobe.rs — the
// byte-granular sequential primitive under every Merlin transcript.  The
// Python twin (zkvm_tpu_torch/oracle/{keccak,strobe}.py) is the bit-exact
// reference; this module is the fast path used by transcript-heavy flows
// (tx verification replays, generator derivation, Merkle hashing).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

#include "field51.h"  // f51::parallel_ranges (shared worker pool)

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static inline uint64_t rotl(uint64_t x, int n) {
    return (x << n) | (x >> (64 - n));
}

extern "C" void keccak_f1600(uint8_t state[200]) {
    uint64_t a[25];
    std::memcpy(a, state, 200);
    for (int rnd = 0; rnd < 24; rnd++) {
        // theta
        uint64_t c[5], d[5];
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
        // rho + pi
        static const int ROT[5][5] = {
            {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
            {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14}};
        uint64_t b[25];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], ROT[x][y]);
        // chi
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                a[x + 5 * y] =
                    b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
        // iota
        a[0] ^= RC[rnd];
    }
    std::memcpy(state, a, 200);
}

// ---------------------------------------------------------------- STROBE-128

static const int STROBE_R = 166;
enum {
    FLAG_I = 1, FLAG_A = 2, FLAG_C = 4, FLAG_T = 8, FLAG_M = 16, FLAG_K = 32
};

struct Strobe {
    uint8_t state[200];
    uint8_t pos;
    uint8_t pos_begin;
    uint8_t cur_flags;
};

static void run_f(Strobe* s) {
    s->state[s->pos] ^= s->pos_begin;
    s->state[s->pos + 1] ^= 0x04;
    s->state[STROBE_R + 1] ^= 0x80;
    keccak_f1600(s->state);
    s->pos = 0;
    s->pos_begin = 0;
}

static void absorb(Strobe* s, const uint8_t* data, size_t len) {
    for (size_t i = 0; i < len; i++) {
        s->state[s->pos] ^= data[i];
        if (++s->pos == STROBE_R) run_f(s);
    }
}

static void overwrite(Strobe* s, const uint8_t* data, size_t len) {
    for (size_t i = 0; i < len; i++) {
        s->state[s->pos] = data[i];
        if (++s->pos == STROBE_R) run_f(s);
    }
}

static void squeeze(Strobe* s, uint8_t* out, size_t len) {
    for (size_t i = 0; i < len; i++) {
        out[i] = s->state[s->pos];
        s->state[s->pos] = 0;
        if (++s->pos == STROBE_R) run_f(s);
    }
}

static void begin_op(Strobe* s, uint8_t flags, int more) {
    if (more) return;  // caller guarantees flag continuity (as upstream)
    uint8_t old_begin = s->pos_begin;
    s->pos_begin = s->pos + 1;
    s->cur_flags = flags;
    uint8_t hdr[2] = {old_begin, flags};
    absorb(s, hdr, 2);
    if ((flags & (FLAG_C | FLAG_K)) && s->pos != 0) run_f(s);
}

extern "C" {

int strobe_sizeof() { return (int)sizeof(Strobe); }

void strobe_init(Strobe* s, const uint8_t* label, size_t label_len) {
    std::memset(s, 0, sizeof(Strobe));
    const uint8_t iv[6] = {1, STROBE_R + 2, 1, 0, 1, 96};
    std::memcpy(s->state, iv, 6);
    std::memcpy(s->state + 6, "STROBEv1.0.2", 12);
    keccak_f1600(s->state);
    begin_op(s, FLAG_M | FLAG_A, 0);
    absorb(s, label, label_len);
}

void strobe_meta_ad(Strobe* s, const uint8_t* data, size_t len, int more) {
    begin_op(s, FLAG_M | FLAG_A, more);
    absorb(s, data, len);
}

void strobe_ad(Strobe* s, const uint8_t* data, size_t len, int more) {
    begin_op(s, FLAG_A, more);
    absorb(s, data, len);
}

void strobe_prf(Strobe* s, uint8_t* out, size_t len, int more) {
    begin_op(s, FLAG_I | FLAG_A | FLAG_C, more);
    squeeze(s, out, len);
}

void strobe_key(Strobe* s, const uint8_t* data, size_t len, int more) {
    begin_op(s, FLAG_A | FLAG_C, more);
    overwrite(s, data, len);
}

// Fused Merlin ops: one ctypes crossing instead of three (the transcript
// spine is ~70 Python->C calls per proof verification otherwise).

// append_message = meta_ad(label, 0) + meta_ad(le32(len), 1) + ad(data, 0)
void strobe_append_message(Strobe* s, const uint8_t* label, size_t label_len,
                           const uint8_t* data, size_t data_len) {
    begin_op(s, FLAG_M | FLAG_A, 0);
    absorb(s, label, label_len);
    uint8_t le[4] = {
        (uint8_t)data_len, (uint8_t)(data_len >> 8),
        (uint8_t)(data_len >> 16), (uint8_t)(data_len >> 24),
    };
    absorb(s, le, 4);
    begin_op(s, FLAG_A, 0);
    absorb(s, data, data_len);
}

// challenge_bytes = meta_ad(label, 0) + meta_ad(le32(n), 1) + prf(n, 0)
void strobe_challenge_bytes(Strobe* s, const uint8_t* label, size_t label_len,
                            uint8_t* out, size_t n) {
    begin_op(s, FLAG_M | FLAG_A, 0);
    absorb(s, label, label_len);
    uint8_t le[4] = {
        (uint8_t)n, (uint8_t)(n >> 8), (uint8_t)(n >> 16), (uint8_t)(n >> 24),
    };
    absorb(s, le, 4);
    begin_op(s, FLAG_I | FLAG_A | FLAG_C, 0);
    squeeze(s, out, n);
}

}  // extern "C"


// ------------------------------------------------------------------------
// Fused rangeproof verification-transcript replay: ONE ctypes crossing for
// the whole challenge sequence of the twin proofs/rangeproof.py::
// RangeProof._replay_challenges_plain (bit-identical; parity-tested).
// Labels mirror the Python protocol code; the domain-separation labels
// come from zkvm_tpu_torch/constants.py via arguments (repo convention: no transcribed
// protocol constants in C++).

extern "C" void sv_from_wide(const uint8_t* in64, uint8_t* out32);

namespace {

void append_u64_op(Strobe* s, const char* label, size_t ll, uint64_t v) {
    uint8_t le[8];
    for (int i = 0; i < 8; i++) le[i] = (uint8_t)(v >> (8 * i));
    strobe_append_message(s, (const uint8_t*)label, ll, le, 8);
}

void challenge_scalar_op(Strobe* s, const char* label, size_t ll,
                         uint8_t out[32]) {
    uint8_t wide[64];
    strobe_challenge_bytes(s, (const uint8_t*)label, ll, wide, 64);
    sv_from_wide(wide, out);
}

int is_zero32(const uint8_t* p) {
    uint8_t a = 0;
    for (int i = 0; i < 32; i++) a |= p[i];
    return a == 0;
}

}  // namespace

extern "C" {

// Returns 0 on success; k>0 = the k-th validated point (A,S,T1,T2,L0,R0,..)
// was the identity encoding (caller raises; transcript state is then dead).
// out = y,z,x,w,c,u[0..lg_n) as 32-byte canonical scalars.
int rangeproof_replay(Strobe* s,
                      const uint8_t* rp_label, size_t rp_label_len,
                      const uint8_t* ipp_label, size_t ipp_label_len,
                      uint64_t n, uint64_t m,
                      const uint8_t* V,        // m * 32
                      const uint8_t* header,   // A,S,T1,T2,t_x,t_xb,e_b
                      const uint8_t* LR, int lg_n,  // L0,R0,L1,R1,...
                      uint8_t* out) {
    strobe_append_message(s, (const uint8_t*)"dom-sep", 7,
                          rp_label, rp_label_len);
    append_u64_op(s, "n", 1, n);
    append_u64_op(s, "m", 1, m);
    for (uint64_t j = 0; j < m; j++)
        strobe_append_message(s, (const uint8_t*)"V", 1, V + 32 * j, 32);
    const uint8_t* A = header;
    const uint8_t* Sp = header + 32;
    const uint8_t* T1 = header + 64;
    const uint8_t* T2 = header + 96;
    if (is_zero32(A)) return 1;
    strobe_append_message(s, (const uint8_t*)"A", 1, A, 32);
    if (is_zero32(Sp)) return 2;
    strobe_append_message(s, (const uint8_t*)"S", 1, Sp, 32);
    challenge_scalar_op(s, "y", 1, out);
    challenge_scalar_op(s, "z", 1, out + 32);
    if (is_zero32(T1)) return 3;
    strobe_append_message(s, (const uint8_t*)"T_1", 3, T1, 32);
    if (is_zero32(T2)) return 4;
    strobe_append_message(s, (const uint8_t*)"T_2", 3, T2, 32);
    challenge_scalar_op(s, "x", 1, out + 64);
    strobe_append_message(s, (const uint8_t*)"t_x", 3, header + 128, 32);
    strobe_append_message(s, (const uint8_t*)"t_x_blinding", 12,
                          header + 160, 32);
    strobe_append_message(s, (const uint8_t*)"e_blinding", 10,
                          header + 192, 32);
    challenge_scalar_op(s, "w", 1, out + 96);

    // verifier weight c: TranscriptRngBuilder(clone).finalize(zeros32)
    // .random_scalar() — clone, meta_ad("rng"), KEY(zero entropy),
    // meta_ad(le32(64)), prf(64), wide-reduce
    Strobe rng;
    std::memcpy(&rng, s, sizeof(Strobe));
    strobe_meta_ad(&rng, (const uint8_t*)"rng", 3, 0);
    uint8_t zero32[32] = {0};
    strobe_key(&rng, zero32, 32, 0);
    uint8_t le4[4] = {64, 0, 0, 0};
    strobe_meta_ad(&rng, le4, 4, 0);
    uint8_t wide[64];
    strobe_prf(&rng, wide, 64, 0);
    sv_from_wide(wide, out + 128);

    strobe_append_message(s, (const uint8_t*)"dom-sep", 7,
                          ipp_label, ipp_label_len);
    append_u64_op(s, "n", 1, n * m);
    for (int r = 0; r < lg_n; r++) {
        const uint8_t* Lb = LR + 64 * r;
        const uint8_t* Rb = LR + 64 * r + 32;
        if (is_zero32(Lb)) return 5 + 2 * r;
        strobe_append_message(s, (const uint8_t*)"L", 1, Lb, 32);
        if (is_zero32(Rb)) return 6 + 2 * r;
        strobe_append_message(s, (const uint8_t*)"R", 1, Rb, 32);
        challenge_scalar_op(s, "u", 1, out + 32 * (5 + r));
    }
    return 0;
}

// Whole-batch verification replay: nb independent transcripts advanced
// through rangeproof_replay in ONE crossing, proofs parallel across the
// worker pool (each replay is pure per-strobe work), which saves the
// per-proof Python wrapper and ctypes glue around the single call.
//   states: nb * strobe_size bytes, mutated in place
//   V:      nb * m * 32 value commitments
//   wire:   nb * wire_len proof wire bytes
//           (layout A S T1 T2 t_x t_xb e_b | (L R)*lg | a b — the replay
//            header is wire[0:224], LR is wire[224:224+64*lg])
//   out:    nb * (5+lg)*32 canonical challenge blobs
//   rcs:    nb int32 per-proof return codes (see rangeproof_replay)
void rangeproof_replay_batch(uint8_t* states, int strobe_size,
                             const uint8_t* rp_label, size_t rp_label_len,
                             const uint8_t* ipp_label, size_t ipp_label_len,
                             uint64_t n, uint64_t m,
                             const uint8_t* V, const uint8_t* wire,
                             size_t wire_len, int lg_n, int nb,
                             uint8_t* out, int32_t* rcs) {
    const size_t blob = (size_t)(5 + lg_n) * 32;
    f51::parallel_ranges(nb, 8, [&](int lo, int hi) {
        for (int i = lo; i < hi; i++) {
            Strobe* s = (Strobe*)(states + (size_t)i * strobe_size);
            const uint8_t* w = wire + (size_t)i * wire_len;
            rcs[i] = rangeproof_replay(
                s, rp_label, rp_label_len, ipp_label, ipp_label_len, n, m,
                V + (size_t)i * m * 32, w, w + 224, lg_n,
                out + (size_t)i * blob);
        }
    });
}

}  // extern "C"
