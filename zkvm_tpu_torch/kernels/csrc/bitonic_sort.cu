// K9 bitonic_sort: ascending sort of every row of (R, npad) int64 keys, in
// place, npad a power of two.
//
// Replaces the JAX package's pallas_msm.py::_bitonic_kernel (via
// sort_rows_device), which held a whole window row in VMEM and ran the
// full network there, one compare-exchange stage per pass over the row.
// A Hopper block has 227 KB of shared memory, not the TPU's megabytes, so
// the network is split by stride: every stage whose partner lies within
// a tile of TILE keys runs in shared memory (one launch sorts all tiles
// through sizes 2..TILE, and one launch per larger size finishes its
// strides below TILE), and every larger stride is one global
// compare-exchange launch.  At npad = 2^17: 1 + 5 tile launches and 15
// global ones.  Tiles never cross rows: TILE divides npad (or the tile is
// the row).  The direction of each compare-exchange comes from the index
// within the row, (i & size) == 0 ascending, so every row ends ascending.
// Plain twin: kernels/sort.py bitonic_sort_plain (the same network).
//
// Bound: bytes, as a sort is moved data: each key read and written once
// at the least; this network moves every key once per global stage and
// once per tile launch, about 21 passes over the keys at 2^17.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;          // keys per shared-memory tile (32 KB)
constexpr int TILE_THREADS = 512;
constexpr int GLOBAL_THREADS = 256;

__device__ __forceinline__ void cmp_swap(int64_t& a, int64_t& b, bool asc) {
    if (asc ? (a > b) : (a < b)) {
        const int64_t t = a;
        a = b;
        b = t;
    }
}

// Stages (size, stride) for size in [size_lo, size_hi] (powers of two),
// stride from min(size, tile) / 2 down to 1, on one tile in shared memory.
__global__ void bitonic_tile_kernel(int64_t* __restrict__ keys, int64_t npad,
                                    int tile, int64_t size_lo,
                                    int64_t size_hi) {
    __shared__ int64_t s[TILE];
    const int64_t base = (int64_t)blockIdx.x * tile;
    const int64_t row_off = base % npad;        // the tile's index in its row
    for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = keys[base + i];
    __syncthreads();
    for (int64_t size = size_lo; size <= size_hi; size <<= 1) {
        for (int stride = (int)(size < tile ? size : tile) >> 1; stride >= 1;
             stride >>= 1) {
            for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
                const int i = (p / stride) * 2 * stride + (p % stride);
                cmp_swap(s[i], s[i + stride], ((row_off + i) & size) == 0);
            }
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < tile; i += blockDim.x) keys[base + i] = s[i];
}

// One stage with a stride of at least a tile: one thread per pair.
__global__ void bitonic_global_kernel(int64_t* __restrict__ keys, int64_t npad,
                                      int64_t pairs, int64_t size,
                                      int64_t stride) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= pairs) return;
    const int64_t half = npad >> 1;
    const int64_t row = t / half, p = t % half;
    const int64_t i = (p / stride) * 2 * stride + (p % stride);
    int64_t* r = keys + row * npad;
    int64_t a = r[i], b = r[i + stride];
    if (((i & size) == 0) ? (a > b) : (a < b)) {
        r[i] = b;
        r[i + stride] = a;
    }
}

}  // namespace

extern "C" int zkvm_bitonic_sort(void* keys, int64_t rows, int64_t npad,
                                 void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int64_t* k = (int64_t*)keys;
    if (rows <= 0 || npad < 2) return 0;
    const int tile = npad < TILE ? (int)npad : TILE;
    const int64_t tiles = rows * npad / tile;
    const int64_t pairs = rows * npad / 2;
    const int64_t gblocks = (pairs + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
    bitonic_tile_kernel<<<(unsigned)tiles, TILE_THREADS, 0, st>>>(
        k, npad, tile, 2, tile);
    int err = (int)cudaGetLastError();
    for (int64_t size = 2 * (int64_t)tile; size <= npad && !err; size <<= 1) {
        for (int64_t stride = size >> 1; stride >= tile && !err; stride >>= 1) {
            bitonic_global_kernel<<<(unsigned)gblocks, GLOBAL_THREADS, 0, st>>>(
                k, npad, pairs, size, stride);
            err = (int)cudaGetLastError();
        }
        if (err) break;
        bitonic_tile_kernel<<<(unsigned)tiles, TILE_THREADS, 0, st>>>(
            k, npad, tile, size, size);
        err = (int)cudaGetLastError();
    }
    return err;
}
