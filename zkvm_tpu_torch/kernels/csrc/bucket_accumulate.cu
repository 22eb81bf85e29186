// K2 bucket_accumulate: every Pippenger bucket sum of every window.
//
// Replaces three Pallas kernels of the JAX package's bucket pipeline:
// pallas_msm.py::_seq_scan_kernel (per-lane sequential segmented scan over
// fixed chunks of sorted positions), ::_lane_scan_kernel (cross-lane scan
// of the chunk tails) and the fix-up ::_add_kernel via point_add_lm.  Plain
// twin: msm.py bucket_accumulate_plain (the same additions in the same
// association, so the limbs agree bit for bit).
//
// Input: keys (nw, n) int64 sorted per window, key = |digit| << (shift+1)
// | sign << shift | index; offsets (nw, nb + 1) int64, bucket b (digit
// magnitude b + 1) owning the run [offsets[b], offsets[b+1]); points
// (4, 10, n) int32.  Output (4, 10, nw * nb) int32; an empty bucket holds
// the identity (0, 1, 1, 0).
//
// Bound: operations (9 field multiplications per point added, about n
// adds per window), against 8 bytes of key and 160 of point gathered per
// add.  The first design gave each (window, bucket) one thread
// that walked its run: at 255 registers a warp waited for the longest of
// its 32 runs, and equal digits put a window's n points on one thread, n
// additions in a row.  This design is load-balanced whatever the digits:
//   * cached_points_kernel makes every point's cached form (Y - X, Y + X,
//     2d T, 2 Z) once, so that an addition is two multiplications deep
//     (lanes.cuh lane_add) and no level spends one making an addend;
//   * each worker, a group of four lanes (one coordinate per lane), owns a
//     fixed chunk of C consecutive sorted records of one window and adds
//     them in order, starting again from the identity at every change of
//     key, so its work is C additions however the runs fall;
//   * a run that starts and ends inside the chunk is written straight to
//     its bucket;
//   * the pieces of runs that cross a chunk edge, in cached form, go to
//     the next level's records: slot 2c the chunk's first piece if its run
//     began before the chunk, slot 2c + 1 its last piece if its run goes
//     on after the chunk (when one piece does both, slot 2c + 1 holds the
//     identity under the same key), key 0 ("none") in a slot left empty.
//     The pieces of one bucket stay contiguous and in order, so the next
//     level is again a sorted keyed sequence, 2 ceil(N / C) records where
//     the last had N;
//   * the same kernel runs on those records, level after level, until a
//     level fits in one chunk.  C = kChunk (32) on the first level, which
//     does nearly all the work and is bound by the card's integer
//     multiply rate; C = kChunk1 (8) after it, where the records are few
//     and each level costs its depth: 6 levels at n = 17,538 (17,538 ->
//     1,098 -> 276 -> 70 -> 18 -> 6), 7 at 69,762, all launched from one
//     C call after cached_points_kernel.
// Zero digits (key 0) join no bucket: their records are skipped.  The
// first level also writes the identity into every empty bucket.  The
// scratch is the caller's: the cached points (40 n int32), then two
// buffers of records (keys int32 and points (4, 10, .)), 41 nw N_1 and
// 41 nw N_2 int32, used in turn.  The C entry takes its length and
// returns kScratchTooShort, launching nothing, when it is shorter than
// these constants need (msm.py sizes it from its own copies of them).
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"
#include "lanes.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 128;
// Records per worker on the first level and on the later ones (msm.py
// ACCUMULATE_CHUNK, ACCUMULATE_CHUNK1).  The kernel takes its chunk as an
// argument: with the loop's bound a compile-time constant ptxas spills 4-8
// bytes at the 128 registers of __launch_bounds__ (PERF.md, K2's row).
constexpr int kChunk = 32;
constexpr int kChunk1 = 8;

// The addends' cached forms (Y - X, Y + X, 2d T, 2 Z) of the n points, once
// (kernels/combine.py cached), so that no level computes one per addition.
__global__ void cached_points_kernel(const int32_t* __restrict__ pts,
                                     int32_t* __restrict__ cpts, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Pt p = pt_load(pts, i, n);
    fe_store(cpts, 0, i, n, fe_sub(p.Y, p.X));
    fe_store(cpts, 1, i, n, fe_add(p.Y, p.X));
    fe_store(cpts, 2, i, n, fe_mul(p.T, fe_const(kD2)));
    fe_store(cpts, 3, i, n, fe_add(p.Z, p.Z));
}

// One level over a window's N records, each a point in cached form.
// kFirst: the records are the sorted keys (keys64, bucket = key >> (shift
// + 1)) with the points' cached forms gathered from cpts (4, 10, n) by
// index, negated on load where the sign bit is set (-P has the cached form
// (Y + X, Y - X, -2d T, 2 Z)); else keys32 (nw, N) and cpts (4, 10, nw * N).
// Pieces of crossing runs go to nkeys (nw, Nn) and npts (4, 10, nw * Nn),
// in cached form; Nn = 0 on the last level.
template <bool kFirst>
__global__ void __launch_bounds__(kThreads, 4) bucket_accumulate_kernel(
    const int64_t* __restrict__ keys64, const int32_t* __restrict__ keys32,
    const int32_t* __restrict__ cpts, const int64_t* __restrict__ offsets,
    int32_t* __restrict__ out, int32_t* __restrict__ nkeys,
    int32_t* __restrict__ npts, int64_t N, int64_t Nn, int64_t n, int nw,
    int nb, int shift, int chunk) {
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int j = threadIdx.x & 3;
    const int64_t total = (int64_t)nw * nb;
    if (kFirst) {                       // empty buckets hold the identity
        for (int64_t t = tid; t < total; t += (int64_t)gridDim.x * blockDim.x) {
            const int64_t o = t / nb * (nb + 1) + t % nb;
            if (offsets[o] == offsets[o + 1]) pt_store(out, t, total, pt_identity());
        }
    }
    const int64_t K = (N + chunk - 1) / chunk;
    const int64_t gid = tid >> 2;
    const bool active = gid < (int64_t)nw * K;
    const int64_t w = active ? gid / K : 0, c = active ? gid % K : 0;
    const int64_t s = c * chunk, e = s + chunk < N ? s + chunk : N;
    const int64_t pstride = kFirst ? n : (int64_t)nw * N;
    const int64_t nstride = (int64_t)nw * Nn;
    const int64_t idx_mask = ((int64_t)1 << shift) - 1;

    // the bucket key of record r of this window (0: none)
    auto key_at = [&](int64_t r) -> int64_t {
        return kFirst ? keys64[w * N + r] >> (shift + 1) : keys32[w * N + r];
    };
    // record r's cached form (the identity's for none)
    auto load = [&](int64_t r, int64_t kr) -> Fe {
        Fe q = fe_small(j == 2 ? 0 : j == 3 ? 2 : 1);
        if (kr > 0) {
            if (kFirst) {
                const int64_t key = keys64[w * N + r];
                const bool neg = (key >> shift) & 1;
                q = fe_load(cpts, neg && j < 2 ? 1 - j : j, key & idx_mask,
                            pstride);
                if (neg && j == 2) q = fe_neg(q);
            } else {
                q = fe_load(cpts, j, w * N + r, pstride);
            }
        }
        return q;
    };
    const int64_t prev = active && s > 0 ? key_at(s - 1) : -1;
    const int64_t next = active && e < N ? key_at(e) : -1;

    const Fe ident = lane_identity(j);
    Fe acc = ident, first = ident;
    int64_t cur = active ? key_at(s) : -1, before = -1, run_start = s;
    int32_t lo = 0, hi = 0;
    bool through = false;
    Fe q = load(s, cur);
    for (int i = 0; i < chunk; i++) {
        const int64_t r = s + i;
        const bool valid = active && r < e;
        const int64_t kr = valid ? cur : -1;
        const int64_t kn = valid && r + 1 < e ? key_at(r + 1) : -1;
        const Fe q_next = load(r + 1, kn);     // off the chain of acc
        const bool restart = i == 0 || kr != before;
        acc = lane_add(j, fe_select(restart, ident, acc), q);
        if (restart) run_start = r;
        if (kr > 0 && (r == e - 1 || kn != kr)) {   // a run piece ends at r
            const bool in = run_start == s && kr == prev;
            const bool on = r == e - 1 && kr == next;
            if (!in && !on) fe_store(out, j, w * nb + kr - 1, total, acc);
            if (in) {
                first = acc;
                lo = (int32_t)kr;
            }
            if (on) {
                hi = (int32_t)kr;
                through = in;
            }
        }
        before = kr;
        cur = kn;
        q = q_next;
    }
    // the crossing pieces, in cached form: the first piece in slot 2c, the
    // last in 2c + 1 (the identity's when one piece was both)
    const Fe c_first = lane_cached(j, first), c_last = lane_cached(j, acc);
    if (active && lo > 0) fe_store(npts, j, w * Nn + 2 * c, nstride, c_first);
    if (active && hi > 0)
        fe_store(npts, j, w * Nn + 2 * c + 1, nstride,
                 through ? fe_small(j == 2 ? 0 : j == 3 ? 2 : 1) : c_last);
    if (active && Nn > 0 && j == 0) {
        nkeys[w * Nn + 2 * c] = lo;
        nkeys[w * Nn + 2 * c + 1] = hi;
    }
}

int64_t next_level(int64_t N, int chunk) {
    return N > chunk ? 2 * ((N + chunk - 1) / chunk) : 0;
}

unsigned blocks_for(int64_t N, int nw, int chunk) {
    const int64_t threads = 4 * (int64_t)nw * ((N + chunk - 1) / chunk);
    const int64_t b = (threads + kThreads - 1) / kThreads;
    return (unsigned)(b > 0 ? b : 1);
}

}  // namespace

constexpr int kScratchTooShort = -1;   // _build.py SCRATCH_TOO_SHORT

extern "C" int zkvm_bucket_accumulate(const void* keys, const void* offsets,
                                      const void* pts, void* out,
                                      void* scratch, int64_t scratch_len,
                                      int64_t n, int nw, int nb, int shift,
                                      void* stream) {
    if (n < 0 || nw < 0 || nb <= 0)
        return (int)cudaErrorInvalidValue;
    if (nw == 0) return 0;
    const int64_t n1 = next_level(n, kChunk), n2 = next_level(n1, kChunk1);
    if (scratch_len < 40 * n + 41 * (int64_t)nw * (n1 + n2))
        return kScratchTooShort;
    cudaStream_t st = (cudaStream_t)stream;
    int32_t* cpts = (int32_t*)scratch;
    if (n > 0)
        cached_points_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                               kThreads, 0, st>>>((const int32_t*)pts, cpts, n);
    cudaError_t e = cudaGetLastError();
    int64_t N = n, Nn = next_level(n, kChunk);
    int32_t* buf[2] = {cpts + 40 * n, cpts + 40 * n + 41 * (int64_t)nw * Nn};
    if (e == cudaSuccess) {
        bucket_accumulate_kernel<true><<<blocks_for(N, nw, kChunk), kThreads,
                                         0, st>>>(
            (const int64_t*)keys, nullptr, cpts, (const int64_t*)offsets,
            (int32_t*)out, buf[0], buf[0] + (int64_t)nw * Nn, N, Nn, n, nw,
            nb, shift, kChunk);
        e = cudaGetLastError();
    }
    for (int level = 1; e == cudaSuccess && Nn > 0; level++) {
        N = Nn;
        Nn = next_level(N, kChunk1);
        const int32_t* cur = buf[(level - 1) & 1];
        int32_t* nxt = buf[level & 1];
        bucket_accumulate_kernel<false><<<blocks_for(N, nw, kChunk1), kThreads,
                                          0, st>>>(
            nullptr, cur, cur + (int64_t)nw * N, nullptr, (int32_t*)out, nxt,
            nxt + (int64_t)nw * Nn, N, Nn, n, nw, nb, shift, kChunk1);
        e = cudaGetLastError();
    }
    return (int)e;
}
