// 5x51-bit limb arithmetic over GF(2^255-19) for the native Ristretto
// decode and encode, and the worker pool that the STROBE replay and the
// scalar module share.
//
// Upstream counterpart: curve25519-dalek backend/serial/u64/field.rs
// (FieldElement51).  Header-only so each .cpp stays self-contained; the
// pure-Python twin (zkvm_tpu_torch/oracle/field.py) is the semantic ground
// truth and every function here is parity-tested against it.

#pragma once

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace f51 {

const u64 MASK51 = ((u64)1 << 51) - 1;

struct fe {
    u64 v[5];
};

inline u64 load8(const uint8_t* p) {
    u64 x;
    memcpy(&x, p, 8);
    return x;  // little-endian hosts only (true for every target here)
}

inline void fe_frombytes(fe& h, const uint8_t* s) {
    h.v[0] = load8(s) & MASK51;
    h.v[1] = (load8(s + 6) >> 3) & MASK51;
    h.v[2] = (load8(s + 12) >> 6) & MASK51;
    h.v[3] = (load8(s + 19) >> 1) & MASK51;
    h.v[4] = (load8(s + 24) >> 12) & MASK51;  // drops bit 255
}

inline void fe_carry(fe& h) {
    u64 c;
    c = h.v[0] >> 51; h.v[0] &= MASK51; h.v[1] += c;
    c = h.v[1] >> 51; h.v[1] &= MASK51; h.v[2] += c;
    c = h.v[2] >> 51; h.v[2] &= MASK51; h.v[3] += c;
    c = h.v[3] >> 51; h.v[3] &= MASK51; h.v[4] += c;
    c = h.v[4] >> 51; h.v[4] &= MASK51; h.v[0] += 19 * c;
    c = h.v[0] >> 51; h.v[0] &= MASK51; h.v[1] += c;
}

inline void fe_tobytes(uint8_t* s, const fe& a) {
    fe h = a;
    fe_carry(h);
    // canonical subtraction of p via the +19 / top-bit trick
    u64 q = (h.v[0] + 19) >> 51;
    q = (h.v[1] + q) >> 51;
    q = (h.v[2] + q) >> 51;
    q = (h.v[3] + q) >> 51;
    q = (h.v[4] + q) >> 51;
    h.v[0] += 19 * q;
    u64 c;
    c = h.v[0] >> 51; h.v[0] &= MASK51; h.v[1] += c;
    c = h.v[1] >> 51; h.v[1] &= MASK51; h.v[2] += c;
    c = h.v[2] >> 51; h.v[2] &= MASK51; h.v[3] += c;
    c = h.v[3] >> 51; h.v[3] &= MASK51; h.v[4] += c;
    h.v[4] &= MASK51;

    memset(s, 0, 32);
    u64 limbs[4];
    limbs[0] = h.v[0] | (h.v[1] << 51);
    limbs[1] = (h.v[1] >> 13) | (h.v[2] << 38);
    limbs[2] = (h.v[2] >> 26) | (h.v[3] << 25);
    limbs[3] = (h.v[3] >> 39) | (h.v[4] << 12);
    memcpy(s, limbs, 32);
}

inline void fe_mul(fe& out, const fe& f, const fe& g) {
    u128 r0 = (u128)f.v[0] * g.v[0]
            + (u128)(19 * f.v[1]) * g.v[4] + (u128)(19 * f.v[2]) * g.v[3]
            + (u128)(19 * f.v[3]) * g.v[2] + (u128)(19 * f.v[4]) * g.v[1];
    u128 r1 = (u128)f.v[0] * g.v[1] + (u128)f.v[1] * g.v[0]
            + (u128)(19 * f.v[2]) * g.v[4] + (u128)(19 * f.v[3]) * g.v[3]
            + (u128)(19 * f.v[4]) * g.v[2];
    u128 r2 = (u128)f.v[0] * g.v[2] + (u128)f.v[1] * g.v[1]
            + (u128)f.v[2] * g.v[0]
            + (u128)(19 * f.v[3]) * g.v[4] + (u128)(19 * f.v[4]) * g.v[3];
    u128 r3 = (u128)f.v[0] * g.v[3] + (u128)f.v[1] * g.v[2]
            + (u128)f.v[2] * g.v[1] + (u128)f.v[3] * g.v[0]
            + (u128)(19 * f.v[4]) * g.v[4];
    u128 r4 = (u128)f.v[0] * g.v[4] + (u128)f.v[1] * g.v[3]
            + (u128)f.v[2] * g.v[2] + (u128)f.v[3] * g.v[1]
            + (u128)f.v[4] * g.v[0];
    u64 c;
    u64 o0 = (u64)r0 & MASK51; c = (u64)(r0 >> 51);
    r1 += c;
    u64 o1 = (u64)r1 & MASK51; c = (u64)(r1 >> 51);
    r2 += c;
    u64 o2 = (u64)r2 & MASK51; c = (u64)(r2 >> 51);
    r3 += c;
    u64 o3 = (u64)r3 & MASK51; c = (u64)(r3 >> 51);
    r4 += c;
    u64 o4 = (u64)r4 & MASK51; c = (u64)(r4 >> 51);
    o0 += 19 * c;
    c = o0 >> 51; o0 &= MASK51; o1 += c;
    out.v[0] = o0; out.v[1] = o1; out.v[2] = o2;
    out.v[3] = o3; out.v[4] = o4;
}

inline void fe_sq(fe& out, const fe& f) { fe_mul(out, f, f); }

inline void fe_add(fe& out, const fe& a, const fe& b) {
    for (int i = 0; i < 5; i++) out.v[i] = a.v[i] + b.v[i];
    fe_carry(out);
}

// 2p in 5x51 canonical-ish limbs so subtraction never underflows
const u64 TWO_P0 = 0xFFFFFFFFFFFDA;
const u64 TWO_PX = 0xFFFFFFFFFFFFE;

inline void fe_sub(fe& out, const fe& a, const fe& b) {
    out.v[0] = a.v[0] + TWO_P0 - b.v[0];
    out.v[1] = a.v[1] + TWO_PX - b.v[1];
    out.v[2] = a.v[2] + TWO_PX - b.v[2];
    out.v[3] = a.v[3] + TWO_PX - b.v[3];
    out.v[4] = a.v[4] + TWO_PX - b.v[4];
    fe_carry(out);
}

inline void fe_neg(fe& out, const fe& a) {
    fe zero;
    memset(&zero, 0, sizeof zero);
    fe_sub(out, zero, a);
}

inline void fe_pow2k(fe& out, const fe& a, int k) {
    out = a;
    for (int i = 0; i < k; i++) fe_sq(out, out);
}

// a^(2^252 - 3): the sqrt_ratio exponent (curve25519-dalek pow_p58 chain)
inline void fe_pow_p58(fe& out, const fe& a) {
    fe z2, z8, z9, z11, z22, z_5_0, z_10_0, z_20_0, z_40_0, z_50_0;
    fe z_100_0, z_200_0, z_250_0, t;
    fe_sq(z2, a);
    fe_pow2k(z8, z2, 2);
    fe_mul(z9, a, z8);
    fe_mul(z11, z2, z9);
    fe_sq(z22, z11);
    fe_mul(z_5_0, z9, z22);
    fe_pow2k(t, z_5_0, 5);  fe_mul(z_10_0, t, z_5_0);
    fe_pow2k(t, z_10_0, 10); fe_mul(z_20_0, t, z_10_0);
    fe_pow2k(t, z_20_0, 20); fe_mul(z_40_0, t, z_20_0);
    fe_pow2k(t, z_40_0, 10); fe_mul(z_50_0, t, z_10_0);
    fe_pow2k(t, z_50_0, 50); fe_mul(z_100_0, t, z_50_0);
    fe_pow2k(t, z_100_0, 100); fe_mul(z_200_0, t, z_100_0);
    fe_pow2k(t, z_200_0, 50); fe_mul(z_250_0, t, z_50_0);
    fe_pow2k(t, z_250_0, 2);
    fe_mul(out, t, a);
}

// a^(p-2) = 1/a: dalek's invert chain (pow_22523 shape with tail 2^5 * z11)
inline void fe_invert(fe& out, const fe& a) {
    fe z2, z8, z9, z11, z22, z_5_0, z_10_0, z_20_0, z_40_0, z_50_0;
    fe z_100_0, z_200_0, z_250_0, t;
    fe_sq(z2, a);
    fe_pow2k(z8, z2, 2);
    fe_mul(z9, a, z8);
    fe_mul(z11, z2, z9);
    fe_sq(z22, z11);
    fe_mul(z_5_0, z9, z22);
    fe_pow2k(t, z_5_0, 5);  fe_mul(z_10_0, t, z_5_0);
    fe_pow2k(t, z_10_0, 10); fe_mul(z_20_0, t, z_10_0);
    fe_pow2k(t, z_20_0, 20); fe_mul(z_40_0, t, z_20_0);
    fe_pow2k(t, z_40_0, 10); fe_mul(z_50_0, t, z_10_0);
    fe_pow2k(t, z_50_0, 50); fe_mul(z_100_0, t, z_50_0);
    fe_pow2k(t, z_100_0, 100); fe_mul(z_200_0, t, z_100_0);
    fe_pow2k(t, z_200_0, 50); fe_mul(z_250_0, t, z_50_0);
    fe_pow2k(t, z_250_0, 5);
    fe_mul(out, t, z11);
}

inline bool fe_eq(const fe& a, const fe& b) {
    uint8_t sa[32], sb[32];
    fe_tobytes(sa, a);
    fe_tobytes(sb, b);
    return memcmp(sa, sb, 32) == 0;
}

inline bool fe_is_negative(const fe& a) {
    uint8_t s[32];
    fe_tobytes(s, a);
    return s[0] & 1;
}

inline bool fe_is_zero(const fe& a) {
    uint8_t s[32];
    static const uint8_t zero[32] = {0};
    fe_tobytes(s, a);
    return memcmp(s, zero, 32) == 0;
}

inline void fe_abs(fe& out, const fe& a) {
    if (fe_is_negative(a)) fe_neg(out, a); else out = a;
}

inline void fe_one(fe& out) {
    memset(&out, 0, sizeof out);
    out.v[0] = 1;
}

// Persistent worker pool: a std::thread spawn per call would cost more
// than the small batches it splits.  Workers park on a condition variable between calls; the
// calling thread executes slice 0 itself.  Calls must not nest (none do:
// parallel_ranges call sites are leaf-level batch loops).
class WorkerPool {
  public:
    static WorkerPool& get() {
        static WorkerPool p;
        return p;
    }

    // body(t) for t in [0, k); caller runs t=0, workers run 1..k-1.
    // Safe for concurrent callers (Python threads): calls serialize on run_mutex_, each using the full pool.
    // Nested calls (a pooled body that transitively reaches another
    // parallel_ranges) would deadlock on run_mutex_; the thread-local
    // in_pool flag makes them run inline instead.
    void run(int k, const std::function<void(int)>& body) {
        if (k <= 1 || in_pool_flag()) {
            body(0);
            return;
        }
        std::lock_guard<std::mutex> run_lk(run_mutex_);
        in_pool_flag() = true;
        {
            std::unique_lock<std::mutex> lk(m_);
            body_ = &body;
            k_ = k;
            // EVERY worker observes every generation and decrements once
            // (even when it has no slice, w+1 >= k) — counting only k-1
            // here would let stale decrements from skipped workers corrupt
            // the next generation's countdown
            pending_ = (int)workers_.size();
            gen_++;
        }
        cv_.notify_all();
        body(0);
        std::unique_lock<std::mutex> lk(m_);
        done_cv_.wait(lk, [&] { return pending_ == 0; });
        body_ = nullptr;
        in_pool_flag() = false;
    }

    int max_threads() const { return (int)workers_.size() + 1; }

  private:
    WorkerPool() {
        unsigned hw = std::thread::hardware_concurrency();
        int nw = (int)(hw ? hw : 1) - 1;
        for (int w = 0; w < nw; w++) {
            workers_.emplace_back([this, w] { loop(w); });
        }
    }
    ~WorkerPool() {
        {
            std::unique_lock<std::mutex> lk(m_);
            stop_ = true;
            gen_++;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
    }
    // one flag per thread: true while this thread is executing pool work
    // (always true for workers), making nested run() calls execute inline
    static bool& in_pool_flag() {
        static thread_local bool f = false;
        return f;
    }

    void loop(int w) {
        in_pool_flag() = true;
        uint64_t seen = 0;
        for (;;) {
            const std::function<void(int)>* body = nullptr;
            int k = 0;
            {
                std::unique_lock<std::mutex> lk(m_);
                cv_.wait(lk, [&] { return gen_ != seen; });
                seen = gen_;
                if (stop_) return;
                body = body_;
                k = k_;
            }
            if (body && w + 1 < k) (*body)(w + 1);
            {
                std::unique_lock<std::mutex> lk(m_);
                if (--pending_ == 0) done_cv_.notify_all();
            }
        }
    }

    std::vector<std::thread> workers_;
    std::mutex run_mutex_;
    std::mutex m_;
    std::condition_variable cv_, done_cv_;
    const std::function<void(int)>* body_ = nullptr;
    int k_ = 0;
    int pending_ = 0;
    uint64_t gen_ = 0;
    bool stop_ = false;
};

// split [0, n) across pool workers when the per-item cost justifies the
// dispatch; body(lo, hi) must touch disjoint output ranges
template <typename F>
inline void parallel_ranges(int n, int min_per_thread, F body) {
    int nthreads = WorkerPool::get().max_threads();
    if (nthreads > 1 && n / nthreads < min_per_thread) {
        nthreads = n / min_per_thread;
    }
    if (nthreads <= 1) {
        body(0, n);
        return;
    }
    int chunk = (n + nthreads - 1) / nthreads;
    std::function<void(int)> slice = [&](int t) {
        int lo = t * chunk;
        int hi = lo + chunk < n ? lo + chunk : n;
        if (lo < hi) body(lo, hi);
    };
    WorkerPool::get().run(nthreads, slice);
}

}  // namespace f51
