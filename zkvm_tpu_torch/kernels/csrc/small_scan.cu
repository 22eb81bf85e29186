// K5s small_scan: every bucket sum of every window of a small MSM, in one
// launch.
//
// Replaces the scan half of the JAX package's small route,
// pallas_msm.py::_bucket_totals (:252-326): jax.lax.associative_scan over
// seg_combine_lm (the Pallas _seg_combine_kernel, :89, called at :162)
// and the read of each bucket at its run's end.  Plain twin: msm.py
// small_scan_plain (the same additions in the same association, so the
// limbs agree bit for bit).
//
// Input: keys (nw, n) int64 sorted per window, key = |digit| << (shift+1)
// | sign << shift | index (msm.pack_keys); points (4, 10, n) int32.  The
// kernel gathers and signs each record itself.  Output (4, 10, nw * nb)
// int32: bucket b of window w (digit magnitude b + 1) at w * nb + b; an
// empty bucket holds the identity.  Zero digits (key magnitude 0) sort
// first and join no bucket.
//
// Bound: latency and one SM's issue rate.  A window holds at most 2,048
// records (the small route's limit), 9 field multiplications each, so the
// whole route is some 34 k additions at the Cloak's 1,055 points:
// microseconds of the card's multiply rate.  What sets the time is the
// chain of dependent additions, and how many additions each SM must issue
// per step of it.  Design: a thread-block cluster of K blocks per window
// (Hopper's distributed shared memory), each of B groups of four lanes
// (one point coordinate per lane, lanes.cuh), so an addition is two
// multiplications deep; B = kGroups and K = kCluster are compile-time
// constants (msm.SMALL_GROUPS, SMALL_CLUSTER):
//   1. chunk c = rank * B + g of the window, C = ceil(n / (K B))
//      consecutive sorted records from c C, is added in order by its
//      group, starting again from the identity at every change of key
//      (each record in cached form, made while the previous one is added).
//      A run that starts and ends in the chunk is written to its bucket at
//      once; the buckets between two consecutive keys, and above the last,
//      get the identity from the group that sees the change.  The chunk
//      keeps its head (the sum of its first run, when that run began in an
//      earlier chunk and ends in this one) and its tail A_c (the running
//      sum at its last record) with a flag F_c, set when a run starts in
//      it;
//   2. an inclusive segmented scan of (A_c, F_c) over the window's K B
//      chunks, Hillis-Steele, X_c <- X_(c-d) + X_c where F_c is clear, each
//      block's chunks in its shared memory and read across the cluster.  A
//      step with offset d is needed only while some chunk c >= d still has
//      F_c clear, so the cluster votes before each step and stops: the
//      depth follows this window's own longest run (in chunks), found on
//      the card, with no host sync; the steps it skips would change no
//      value.  A warp none of whose chunks waits adds nothing;
//   3. each chunk with a head adds the scan's value of the chunk before
//      (the sum of the run's earlier pieces) and writes the bucket.
// The records never sit in shared memory: each group gathers its own from
// device memory, so one window's 320 KB at 2,048 points does not meet the
// SM's 228 KB; only the chunks' tails (5 KB a block) do.  B = 32, K = 4:
// the 32 windows of a 253-bit scalar at w = 8 are 128 blocks of four warps
// on 128 SMs, in one wave (the card holds 124 such clusters at once), and
// a chunk is 9 records at the Cloak's 1,055 points.  A block of 128 groups
// per window (32 SMs) ran every step at one SM's full issue rate, ~8 us,
// where four warps take ~3; clusters of four such blocks did not fit in
// one wave (PERF.md records the shapes measured before these were fixed).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"
#include "lanes.cuh"

using namespace zk;

namespace {

namespace cg = cooperative_groups;

constexpr int kGroups = 32;    // groups of four lanes per block
constexpr int kCluster = 4;    // blocks (a thread-block cluster) per window

__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(4 * kGroups, 1) small_scan_kernel(
    const int64_t* __restrict__ keys, const int32_t* __restrict__ pts,
    int32_t* __restrict__ out, int64_t n, int nw, int nb, int shift,
    int chunk) {
    cg::cluster_group cluster = cg::this_cluster();
    constexpr int K = kCluster, B = kGroups;
    __shared__ Fe sx[kGroups][4];
    __shared__ int sflag[kGroups];
    __shared__ int svote;
    const int g = threadIdx.x >> 2, j = threadIdx.x & 3;
    const int c = (int)cluster.block_rank() * B + g;  // the chunk
    const int64_t w = blockIdx.x / K;
    const int64_t total = (int64_t)nw * nb;
    const Fe ident = lane_identity(j);
    // the identity into the buckets of magnitudes lo..hi, which no run holds
    auto fill = [&](int64_t lo, int64_t hi) {
        for (int64_t m = lo; m <= hi; m++)
            fe_store(out, j, w * nb + m - 1, total, ident);
    };
    if (n == 0) {                                     // every bucket empty
        if (c == 0) fill(1, nb);
        return;
    }

    const int64_t* wk = keys + w * n;
    const int64_t idx_mask = ((int64_t)1 << shift) - 1;
    const int64_t s = (int64_t)c * chunk;
    const int64_t e = s + chunk < n ? s + chunk : n;   // s >= e: no records
    auto mag = [&](int64_t r) -> int64_t { return wk[r] >> (shift + 1); };
    // lane j's coordinate of record r's point, negated where its digit is
    // (X and T), in cached form; the identity's past the chunk.  Every lane
    // of the warp calls it (lane_cached shuffles).
    auto load = [&](int64_t r) -> Fe {
        Fe p = ident;
        if (r < e) {
            const int64_t key = wk[r];
            p = fe_load(pts, j, key & idx_mask, n);
            if (((key >> shift) & 1) && (j == 0 || j == 3)) p = fe_neg(p);
        }
        return lane_cached(j, p);
    };

    // 1. the chunk, in order (a warp without records skips it: its
    // chunks keep the identity and a set flag)
    int64_t before = s > 0 && s < n ? mag(s - 1) : -1;
    Fe acc = ident, head = ident;
    bool started = s >= n;        // F_c: a run starts in the chunk
    bool in_run = true;           // the current run began before the chunk
    bool has_head = false;
    int64_t head_key = 0;
    if (__any_sync(0xffffffffu, s < n)) {
        Fe q = load(s);
        for (int i = 0; i < chunk; i++) {
            const int64_t r = s + i;
            const bool valid = r < e;
            const int64_t kr = valid ? mag(r) : -1;
            const int64_t kn = valid && r + 1 < n ? mag(r + 1) : -1;
            const Fe q_next = load(r + 1);         // off the chain of acc
            const bool restart = kr != before;
            const Fe sum = lane_add(j, fe_select(restart, ident, acc), q);
            if (valid) {
                acc = sum;
                if (restart) {
                    started = true;
                    in_run = false;
                    fill((before > 0 ? before : 0) + 1, kr - 1);
                }
                if (r == n - 1) fill(kr + 1, nb);
                if (kr > 0 && kn != kr) {          // a run ends at r
                    if (in_run) {
                        head = acc;
                        head_key = kr;
                        has_head = true;
                    } else {
                        fe_store(out, j, w * nb + kr - 1, total, acc);
                    }
                }
            }
            before = kr;
            q = q_next;
        }
    }

    // 2. the segmented scan of the chunks' tails across the cluster; each
    // step's vote for the next is taken once the flags are read
    Fe X = acc;
    bool f = started;
    auto vote = [&](int d) {
        const int v = __syncthreads_or(c >= d && !f);
        if (threadIdx.x == 0) svote = v;
    };
    vote(1);
    cluster.sync();
    for (int d = 1; d < K * B; d *= 2) {
        int any = 0;
        for (int b = 0; b < K; b++) any |= *cluster.map_shared_rank(&svote, b);
        if (!any) break;                              // the same on every block
        sx[g][j] = X;
        if (j == 0) sflag[g] = f;
        cluster.sync();
        const bool in = c >= d;
        const int src = in ? c - d : c;
        const Fe o = cluster.map_shared_rank(&sx[0][0], src / B)[(src % B) * 4 + j];
        const bool fo = cluster.map_shared_rank(&sflag[0], src / B)[src % B] != 0;
        const bool upd = in && !f;
        f = f || (in && fo);
        vote(2 * d);
        cluster.sync();                               // the reads are done
        if (__any_sync(0xffffffffu, upd)) {
            const Fe sum = lane_add_pt(j, o, X);      // X_(c-d) + X_c
            if (upd) X = sum;
        }
    }

    // 3. heads: the run's earlier pieces, then the head
    sx[g][j] = X;
    cluster.sync();
    const int src = c > 0 ? c - 1 : 0;
    const Fe carry = cluster.map_shared_rank(&sx[0][0], src / B)[(src % B) * 4 + j];
    if (__any_sync(0xffffffffu, has_head)) {
        const Fe val = lane_add_pt(j, carry, head);
        if (has_head) fe_store(out, j, w * nb + head_key - 1, total, val);
    }
    cluster.sync();      // no block leaves while another reads its memory
}

}  // namespace

extern "C" int zkvm_small_scan(const void* keys, const void* pts, void* out,
                               int64_t n, int nw, int nb, int shift,
                               void* stream) {
    if (n < 0 || nw < 0 || nb < 1 || shift < 1 || shift > 62)
        return (int)cudaErrorInvalidValue;
    constexpr int64_t chunks = (int64_t)kCluster * kGroups;
    const int64_t chunk = n > chunks ? (n + chunks - 1) / chunks : 1;
    if (chunk > (1 << 24)) return (int)cudaErrorInvalidValue;
    if (nw == 0) return 0;
    small_scan_kernel<<<nw * kCluster, 4 * kGroups, 0, (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const int32_t*)pts, (int32_t*)out, n, nw, nb,
        shift, (int)chunk);
    return (int)cudaGetLastError();
}
