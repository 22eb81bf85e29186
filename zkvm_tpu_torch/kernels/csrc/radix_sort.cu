// K9 radix_sort: stable ascending sort of every row of (R, n) nonnegative
// int64 keys by their bits [lo_bit, hi_bit), any n.
//
// Replaces the JAX package's pallas_msm.py::_bitonic_kernel (via
// sort_rows_device), a bitonic network over a whole window row held in
// VMEM.  A Hopper block has 227 KB of shared memory, and a network moves
// every key O(log^2 n) times, so this is a least-significant-digit radix
// sort instead: the sorted bits split into passes of at most 8 (two of 6
// for the MSM's 12-bit (|digit|, sign) field at w = 11, eight for a full
// 63-bit sort), and each pass is three launches over tiles of `tile` keys
// of a row:
//   1. radix_hist_kernel: one block per (tile, row) counts the pass's
//      digits in shared memory (warp-aggregated: one atomic per distinct
//      digit of a warp), then writes its counts to hist[row][digit][tile];
//   2. radix_scan_kernel: one block per row turns hist[row] into exclusive
//      prefix sums in (digit, tile) order: the first place of each tile's
//      keys of each digit in the row's output;
//   3. radix_scatter_kernel: one block per (tile, row) re-reads its tile in
//      chunks of 256 keys, in order; a key's rank among the keys of its
//      digit is its rank in its warp (__match_any_sync, __popc of the lower
//      peers) plus the counts of the lower warps of the chunk and of the
//      earlier chunks, so equal digits keep their input order (stable).
// Passes ping-pong between the output and a scratch buffer, arranged so
// that the last pass writes the output; the input is never written.
// Plain twin: kernels/sort.py radix_sort_plain (the same passes, a stable
// argsort per pass).
//
// Bound: bytes.  Each pass reads the keys twice and writes them once
// (about 3 x 13.4 MB at 24 x 69,762 keys, mostly within the 50 MB L2); the
// scatter's writes go to as many places as the pass has digits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // hist and scatter blocks
constexpr int WARPS = THREADS / 32;
constexpr int MAX_RADIX = 256;      // 8 bits a pass at most
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ int digit_of(uint64_t key, int shift, int mask) {
    return (int)((key >> shift) & (uint64_t)mask);
}

__global__ void radix_hist_kernel(const uint64_t* __restrict__ in,
                                  int* __restrict__ hist, int64_t n, int tile,
                                  int tiles, int shift, int bits) {
    __shared__ int cnt[MAX_RADIX];
    const int radix = 1 << bits, lane = threadIdx.x & 31;
    const int64_t row = blockIdx.y, t = blockIdx.x;
    const uint64_t* src = in + row * n;
    const int64_t begin = t * tile;
    const int64_t end = begin + tile < n ? begin + tile : n;
    for (int d = threadIdx.x; d < radix; d += THREADS) cnt[d] = 0;
    __syncthreads();
    // every lane of a warp runs the same number of rounds, so that
    // __match_any_sync sees the whole warp; lanes past the end take the
    // out-of-range digit `radix` and add nothing
    for (int64_t base = begin; base < end; base += THREADS) {
        const int64_t i = base + threadIdx.x;
        const int d = i < end ? digit_of(src[i], shift, radix - 1) : radix;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        if (d < radix && lane == __ffs(peers) - 1)
            atomicAdd(&cnt[d], __popc(peers));
    }
    __syncthreads();
    for (int d = threadIdx.x; d < radix; d += THREADS)
        hist[(row * radix + d) * tiles + t] = cnt[d];
}

// hist[row] (radix * tiles counts) -> its exclusive prefix sums, in place.
__global__ void radix_scan_kernel(int* __restrict__ hist, int len) {
    __shared__ int warp_sums[SCAN_THREADS / 32];
    int* h = hist + (int64_t)blockIdx.x * len;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int per = (len + SCAN_THREADS - 1) / SCAN_THREADS;
    const int start = threadIdx.x * per;
    const int stop = start + per < len ? start + per : len;
    int sum = 0;
    for (int j = start; j < stop; j++) sum += h[j];
    int v = sum;                                  // inclusive scan of sums
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int s = warp_sums[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s += y;
        }
        warp_sums[lane] = s;
    }
    __syncthreads();
    int run = v - sum + (warp ? warp_sums[warp - 1] : 0);
    for (int j = start; j < stop; j++) {
        const int c = h[j];
        h[j] = run;
        run += c;
    }
}

__global__ void radix_scatter_kernel(const uint64_t* __restrict__ in,
                                     uint64_t* __restrict__ out,
                                     const int* __restrict__ offs, int64_t n,
                                     int tile, int tiles, int shift,
                                     int bits) {
    __shared__ int counts[WARPS][MAX_RADIX];    // per warp, this chunk
    __shared__ int place[WARPS][MAX_RADIX];     // first output place
    const int radix = 1 << bits;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t row = blockIdx.y, t = blockIdx.x;
    const uint64_t* src = in + row * n;
    uint64_t* dst = out + row * n;
    const int64_t begin = t * tile;
    const int64_t end = begin + tile < n ? begin + tile : n;
    for (int i = threadIdx.x; i < WARPS * MAX_RADIX; i += THREADS)
        (&counts[0][0])[i] = 0;
    // thread d < radix carries digit d's next place in the row's output
    int run = threadIdx.x < radix
                  ? offs[(row * radix + threadIdx.x) * tiles + t] : 0;
    const unsigned lower = (1u << lane) - 1;
    __syncthreads();
    for (int64_t base = begin; base < end; base += THREADS) {
        const int64_t i = base + threadIdx.x;
        const bool valid = i < end;
        const uint64_t key = valid ? src[i] : 0;
        const int d = valid ? digit_of(key, shift, radix - 1) : radix;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int rank = __popc(peers & lower);
        if (valid && rank == 0) counts[warp][d] = __popc(peers);
        __syncthreads();
        if (threadIdx.x < radix) {                // warps in order
            const int d0 = threadIdx.x;
#pragma unroll
            for (int w = 0; w < WARPS; w++) {
                place[w][d0] = run;
                run += counts[w][d0];
                counts[w][d0] = 0;
            }
        }
        __syncthreads();
        if (valid) dst[place[warp][d] + rank] = key;
    }
}

}  // namespace

extern "C" int zkvm_radix_sort(const void* keys, void* out, void* tmp,
                               void* hist, int64_t rows, int64_t n, int tile,
                               int lo_bit, int hi_bit, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (rows <= 0 || n <= 0) return 0;
    const int bits = hi_bit - lo_bit;
    if (bits <= 0) {                        // nothing to sort by: a copy
        cudaMemcpyAsync(out, keys, (size_t)(rows * n * 8),
                        cudaMemcpyDeviceToDevice, st);
        return (int)cudaGetLastError();
    }
    if (tile <= 0 || tile % THREADS) return (int)cudaErrorInvalidValue;
    const int passes = (bits + 7) / 8;
    const int per = (bits + passes - 1) / passes;
    const int tiles = (int)((n + tile - 1) / tile);
    const dim3 grid((unsigned)tiles, (unsigned)rows);
    const uint64_t* src = (const uint64_t*)keys;
    int err = 0;
    for (int p = 0; p < passes && !err; p++) {
        const int shift = lo_bit + p * per;
        const int b = bits - p * per < per ? bits - p * per : per;
        uint64_t* dst = (uint64_t*)(((passes - 1 - p) & 1) ? tmp : out);
        radix_hist_kernel<<<grid, THREADS, 0, st>>>(src, (int*)hist, n, tile,
                                                    tiles, shift, b);
        radix_scan_kernel<<<(unsigned)rows, SCAN_THREADS, 0, st>>>(
            (int*)hist, (1 << b) * tiles);
        radix_scatter_kernel<<<grid, THREADS, 0, st>>>(
            src, dst, (const int*)hist, n, tile, tiles, shift, b);
        err = (int)cudaGetLastError();
        src = dst;
    }
    return err;
}
