// K2 bucket_accumulate, K11 bucket_accumulate_words and K12
// bucket_accumulate_affine: every Pippenger bucket sum of every window, by
// one level kernel that differs only in how its first level reads a record.
//
// Replace the Pallas kernels of the JAX package's bucket pipeline:
// K2 pallas_msm.py::_seq_scan_kernel (per-lane sequential segmented scan
// over fixed chunks of sorted positions), ::_lane_scan_kernel (cross-lane
// scan of the chunk tails) and the fix-up ::_add_kernel via point_add_lm;
// K11 ::_seq_scan_words_kernel and K12 ::_seq_scan_awords_kernel, the same
// scan over canonical words gathered into sorted order (K10), decoded and
// signed inside the kernel, so that no decoded, negated copy of the
// gathered rows is written to device memory.  Plain twins: msm.py
// bucket_accumulate_plain, bucket_accumulate_words_plain and
// bucket_accumulate_affine_plain (the same levels with the same loaders
// and the same additions in the same association, so the limbs agree bit
// for bit).
//
// Input: keys (nw, n) int64 sorted per window, key = |digit| << (shift+1)
// | sign << shift | index; offsets (nw, nb + 1) int64, bucket b (digit
// magnitude b + 1) owning the run [offsets[b], offsets[b+1]); and the
// points, one of
//   * K2: (4, 10, n) int32 limbs, by index;
//   * K11: rows (nw, n, 32) int32, row (w, r) the canonical words of X, Y,
//     Z, T of the point at sorted position r of window w (128 bytes);
//   * K12: rows (nw, n, 16) int32, row (w, r) the canonical words of its
//     affine x, y (Z = 1; kernels/msm.py to_affine_words).
// Output (4, 10, nw * nb) int32; an empty bucket holds the identity
// (0, 1, 1, 0).  The rows must be canonical words (fe_from_words drops bit
// 255); the three outputs are the same points in other limbs.
//
// Bound: operations (9 field multiplications per point added, about n
// adds per window), against 8 bytes of key and 160 of point gathered (or
// 128 or 64 read in order) per add.  The first designs gave each
// (window, bucket) one thread that walked its run: a warp waited for the
// longest of its 32 runs, and equal digits, or a width whose top window
// only receives the carry, put a window's n points on one thread, n
// additions in a row.  This design is load-balanced whatever the digits:
//   * the records are points in cached form (Y - X, Y + X, 2d T, 2 Z), so
//     that an addition is two multiplications deep (lanes.cuh lane_add)
//     and no level spends one on its accumulator's chain making an addend;
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
//   * the same kernel runs on those records (the Pieces loader), level
//     after level, until a level fits in one chunk.  C = kChunk (32) on
//     the first level, which does nearly all the work and is bound by the
//     card's integer multiply rate; C = kChunk1 (8) after it, where the
//     records are few and each level costs its depth: 6 levels at
//     n = 17,538 (17,538 -> 1,098 -> 276 -> 70 -> 18 -> 6), 7 at 69,762,
//     all launched from one C call (after cached_points_kernel for K2).
// The first level's loader is a template policy.  Each forms the record's
// cached form on lane j; -P's is (Y + X, Y - X, -2d T, 2 Z): lanes 0 and 1
// swap and lane 2 negates where the key's sign bit is set.  Its work sits
// in the prefetch of the next record (q_next), off the accumulator's chain:
//   * LimbRecords (K2): gathered by the key's index from the cached forms
//     that cached_points_kernel made once per point;
//   * WordRecords (K11): lane j decodes the coordinates it needs from the
//     window's row r (fe_from_words; Y and X, T, or Z) and forms Y - X,
//     Y + X, 2d T (one product) or 2 Z.  No cached copy of the gathered
//     rows is written (24 x 17,538 x 160 B = 67 MB at nb = 1024);
//   * AffineRecords (K12): the cached form of (x, y, 1, x y) is
//     (y - x, y + x, 2d x y, 2): two products on lane 2.  The addition is
//     lane_add's, with D = Z1 (2 Z2) = Z1 * 2 a product on lane 3, not the
//     JAX kernel's mixed add (D = Z1 + Z1): the four lanes multiply in
//     step, so lane 3's product costs no time, and every level runs one
//     addition.
// Zero digits (key 0) join no bucket: their records are skipped.  The
// first level also writes the identity into every empty bucket.  The
// scratch is the caller's: for K2 the cached points (40 n int32) first;
// then two buffers of records (keys int32 and points (4, 10, .)), 41 nw N_1
// and 41 nw N_2 int32, used in turn.  Each C entry takes its length and
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

// Lane j's coordinate of the cached form whose Y - X and Y + X lanes 0 and
// 1 form from (a, b) = (Y, X) and whose 2d T lane 2 holds in m: -P's
// where neg (lanes 0 and 1 swap, lane 2 negates).  Lane 3 passes its a + b.
__device__ __forceinline__ Fe signed_cached(int j, bool neg, const Fe& a,
                                            const Fe& b, const Fe& m) {
    if (j == 2) return neg ? fe_neg(m) : m;
    return fe_add_sub(a, b, j == 0 ? !neg : (j == 1 && neg));
}

// The first level's records: record i = w n + r, the window's sorted keys
// (a bucket, |digit| <= 2^15, fits an int).
struct SortedKeys {
    static constexpr bool kFirst = true;
    const int64_t* __restrict__ keys;
    int shift;

    __device__ __forceinline__ int bucket(int64_t i) const {
        return (int)(keys[i] >> (shift + 1));
    }
    __device__ __forceinline__ bool negative(int64_t i) const {
        return (keys[i] >> shift) & 1;
    }
};

// K2: the point's cached form from cpts (4, 10, n), by the key's index.
struct LimbRecords : SortedKeys {
    const int32_t* __restrict__ cpts;
    int64_t n;

    __device__ __forceinline__ Fe load(int j, int64_t i) const {
        const int64_t key = keys[i];
        const bool neg = (key >> shift) & 1;
        const Fe q = fe_load(cpts, neg && j < 2 ? 1 - j : j,
                             key & (((int64_t)1 << shift) - 1), n);
        return neg && j == 2 ? fe_neg(q) : q;
    }
};

// K11: row i of rows (nw, n, 32), the point's X, Y, Z, T words; lane j
// decodes Y and X, T, or Z (twice) and forms its coordinate as
// cached_points_kernel does.
struct WordRecords : SortedKeys {
    const uint32_t* __restrict__ rows;

    __device__ __forceinline__ Fe load(int j, int64_t i) const {
        const uint32_t* row = rows + i * 32;
        const int ia = j < 2 ? 8 : j == 2 ? 24 : 16;    // Y, Y, T, Z
        const Fe a = fe_from_words(row + ia);
        const Fe b = fe_from_words(row + (j < 2 ? 0 : ia));
        return signed_cached(j, negative(i), a, b,
                             j == 2 ? fe_mul(a, fe_const(kD2)) : a);
    }
};

// K12: row i of rows (nw, n, 16), the affine point's x, y words; its
// cached form is (y - x, y + x, 2d (x y), 2).
struct AffineRecords : SortedKeys {
    const uint32_t* __restrict__ rows;

    __device__ __forceinline__ Fe load(int j, int64_t i) const {
        if (j == 3) return fe_small(2);
        const uint32_t* row = rows + i * 16;
        const Fe x = fe_from_words(row), y = fe_from_words(row + 8);
        return signed_cached(
            j, negative(i), y, x,
            j == 2 ? fe_mul(fe_mul(x, y), fe_const(kD2)) : x);
    }
};

// A later level's records: the pieces of crossing runs the level before
// wrote, keys (nw, N) int32 and points in cached form (4, 10, nw N).
struct Pieces {
    static constexpr bool kFirst = false;
    const int32_t* __restrict__ keys;
    const int32_t* __restrict__ cpts;
    int64_t stride;                     // nw N

    __device__ __forceinline__ int bucket(int64_t i) const {
        return keys[i];
    }
    __device__ __forceinline__ Fe load(int j, int64_t i) const {
        return fe_load(cpts, j, i, stride);
    }
};

// One level over each window's N records, read through `rec`.  Pieces of
// crossing runs go to nkeys (nw, Nn) and npts (4, 10, nw * Nn), in cached
// form; Nn = 0 on the last level.
template <class Rec>
__global__ void __launch_bounds__(kThreads, 4) bucket_accumulate_kernel(
    const Rec rec, const int64_t* __restrict__ offsets,
    int32_t* __restrict__ out, int32_t* __restrict__ nkeys,
    int32_t* __restrict__ npts, int64_t N, int64_t Nn, int nw, int nb,
    int chunk) {
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int j = threadIdx.x & 3;
    const int64_t total = (int64_t)nw * nb;
    if (Rec::kFirst) {                  // empty buckets hold the identity
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
    const int64_t base = w * N;
    const int64_t nstride = (int64_t)nw * Nn;

    // record r's cached form (the identity's for none)
    auto load = [&](int64_t r, int kr) -> Fe {
        Fe q = fe_small(j == 2 ? 0 : j == 3 ? 2 : 1);
        if (kr > 0) q = rec.load(j, base + r);
        return q;
    };
    const int prev = active && s > 0 ? rec.bucket(base + s - 1) : -1;
    const int next = active && e < N ? rec.bucket(base + e) : -1;

    const Fe ident = lane_identity(j);
    Fe acc = ident, first = ident;
    int cur = active ? rec.bucket(base + s) : -1, before = -1;
    int64_t run_start = s;
    int32_t lo = 0, hi = 0;
    bool through = false;
    Fe q = load(s, cur);
    for (int i = 0; i < chunk; i++) {
        const int64_t r = s + i;
        const bool valid = active && r < e;
        const int kr = valid ? cur : -1;
        const int kn = valid && r + 1 < e ? rec.bucket(base + r + 1) : -1;
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
                lo = kr;
            }
            if (on) {
                hi = kr;
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

// int32 words of the two level buffers (msm.py _level_scratch)
int64_t level_scratch(int64_t n, int nw) {
    const int64_t n1 = next_level(n, kChunk), n2 = next_level(n1, kChunk1);
    return 41 * (int64_t)nw * (n1 + n2);
}

// Every level over n records a window: the first reads `first`, each later
// one the pieces the level before wrote, the two buffers of buf in turn.
template <class First>
cudaError_t accumulate(const First& first, const int64_t* offsets,
                       int32_t* out, int32_t* buf, int64_t n, int nw, int nb,
                       cudaStream_t st) {
    int64_t N = n, Nn = next_level(n, kChunk);
    int32_t* lvl[2] = {buf, buf + 41 * (int64_t)nw * Nn};
    bucket_accumulate_kernel<First><<<blocks_for(N, nw, kChunk), kThreads, 0,
                                      st>>>(
        first, offsets, out, lvl[0], lvl[0] + (int64_t)nw * Nn, N, Nn, nw, nb,
        kChunk);
    cudaError_t e = cudaGetLastError();
    for (int level = 1; e == cudaSuccess && Nn > 0; level++) {
        N = Nn;
        Nn = next_level(N, kChunk1);
        const int32_t* cur = lvl[(level - 1) & 1];
        int32_t* nxt = lvl[level & 1];
        bucket_accumulate_kernel<Pieces><<<blocks_for(N, nw, kChunk1),
                                           kThreads, 0, st>>>(
            Pieces{cur, cur + (int64_t)nw * N, (int64_t)nw * N}, nullptr, out,
            nxt, nxt + (int64_t)nw * Nn, N, Nn, nw, nb, kChunk1);
        e = cudaGetLastError();
    }
    return e;
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
    if (scratch_len < 40 * n + level_scratch(n, nw)) return kScratchTooShort;
    cudaStream_t st = (cudaStream_t)stream;
    int32_t* cpts = (int32_t*)scratch;
    if (n > 0)
        cached_points_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                               kThreads, 0, st>>>((const int32_t*)pts, cpts, n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)accumulate(
        LimbRecords{{(const int64_t*)keys, shift}, cpts, n},
        (const int64_t*)offsets, (int32_t*)out, cpts + 40 * n, n, nw, nb, st);
}

extern "C" int zkvm_bucket_accumulate_words(const void* keys,
                                            const void* offsets,
                                            const void* rows, void* out,
                                            void* scratch, int64_t scratch_len,
                                            int64_t n, int nw, int nb,
                                            int shift, void* stream) {
    if (n < 0 || nw < 0 || nb <= 0)
        return (int)cudaErrorInvalidValue;
    if (nw == 0) return 0;
    if (scratch_len < level_scratch(n, nw)) return kScratchTooShort;
    return (int)accumulate(
        WordRecords{{(const int64_t*)keys, shift}, (const uint32_t*)rows},
        (const int64_t*)offsets, (int32_t*)out, (int32_t*)scratch, n, nw, nb,
        (cudaStream_t)stream);
}

extern "C" int zkvm_bucket_accumulate_affine(const void* keys,
                                             const void* offsets,
                                             const void* rows, void* out,
                                             void* scratch,
                                             int64_t scratch_len, int64_t n,
                                             int nw, int nb, int shift,
                                             void* stream) {
    if (n < 0 || nw < 0 || nb <= 0)
        return (int)cudaErrorInvalidValue;
    if (nw == 0) return 0;
    if (scratch_len < level_scratch(n, nw)) return kScratchTooShort;
    return (int)accumulate(
        AffineRecords{{(const int64_t*)keys, shift}, (const uint32_t*)rows},
        (const int64_t*)offsets, (int32_t*)out, (int32_t*)scratch, n, nw, nb,
        (cudaStream_t)stream);
}
