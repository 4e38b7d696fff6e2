// Binned exact rasterizers: nearest covering triangle per pixel.
//
// Two kernels share one walk over a bin cell's candidates (walk_cell):
//
// raster_exact_kernel (K1) replaces the TPU kernel
// paperrenderer_tpu/ops/raster_exact.py _make_kernel_quarter(crossz=True)
// (launched by rasterize_exact's pl.pallas_call). Contract kept from it:
//   * candidates of a pixel are the 8-triangle groups binned to its cell,
//     visited in ascending group order, then triangle 0..7 of the group;
//   * accept: e0, e1, e2 >= 0, wn > 1e-12 and zn >= 0;
//   * winner: the running (zn, wn) pair, replaced when zn*wb < zb*wn
//     (cross-multiplied, no divide per candidate), starting from the empty
//     state (zb, wb) = (1, 0); the earliest candidate wins a tie;
//   * out: depth = zn / max(wn, 1e-30) (+inf where empty) and tid = global
//     triangle id (-1 where empty), taken from the coefficient ROW index.
//
// raster_keyed_kernel<CW, PEEL> replaces the quantized-key forms of the same
// pallas_call: _make_kernel_quarter(peel=True) (K2, CW = 32, PEEL),
// _make_kernel_quarter(crossz=False) (K3, CW = 32) and the classic
// full-tile _make_kernel (K4, CW = 128, with or without its peel form).
// Contract kept from them:
//   * the same candidates and accept test;
//   * key = bits(zn / wn) & KEY_MASK: accepted depths are nonnegative, so
//     their f32 bits sort as int32; the low 7 mantissa bits are dropped;
//   * PEEL: a candidate counts only when floor < key < ceil, with the two
//     i32 key planes read per pixel (depth peeling, sorted translucency);
//   * winner: the smallest key, compared strictly, so the earliest
//     candidate in group order wins a tie (the TPU's lane order breaks
//     ties its own way; the key, and so the depth, is the same);
//   * out: depth = the winner's quantized key as f32 (+inf where empty) and
//     tid as above.
// The TPU mechanism (quarter lanes, MXU coefficient replication, (8,128)
// tiles, lane_layout planes, SMEM paging of the work list) is not carried
// over: CW only sets the bin cell width, 32 or 128 pixels.
//
// Design: one block per 8 x CW-pixel cell, one thread per pixel. The block
// stages BATCH groups' coefficient rows (512 B each, contiguous in the
// [T_pad, 16] table) in shared memory with 16-byte loads; every thread then
// reads the same shared address per coefficient (a broadcast, no bank
// conflicts). The winner state stays in registers and is written once.
//
// What bounds them on an H100: the FP32 pipes. Each (group, cell) pair costs
// 8 triangles x (8 x CW) pixels x ~20 FP32 ops (the keyed kernel adds one
// divide per accepted candidate); the loads are 512 B per pair and mostly
// hit L2. Long lists in a few cells (many small distant triangles) leave
// their blocks running after the rest of the grid has drained; balancing
// that is later work.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, the
// divide is __fdiv_rn, and the build passes -fmad=false): the results are
// bitwise equal to the plain PyTorch version, rasterize_bins_plain in
// ops/raster_exact.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CELL_H = 8;
constexpr int GROUP = 8;                 // triangles per bin entry
constexpr int GROUP_F4 = GROUP * 16 / 4; // float4s per group (8 rows x 16)
constexpr int BATCH = 32;                // groups staged per pass (16 KiB)
constexpr int32_t SENTINEL = 0x7FFFFFFF;
constexpr int32_t KEY_MASK = ~(128 - 1);

__device__ __forceinline__ float plane(const float* r, float px, float py) {
    return __fadd_rn(__fadd_rn(__fmul_rn(r[0], px), __fmul_rn(r[1], py)), r[2]);
}

// Calls visit(zn, wn, global id) for every accepted candidate of the pixel
// (px, py) of `cell`, in the cell list's order. Every thread of the block
// must call it (it stages rows and synchronizes).
template <int CW, typename Visit>
__device__ __forceinline__ void walk_cell(
        const int32_t* __restrict__ cell_start,
        const int32_t* __restrict__ cell_groups,
        const float4* __restrict__ coef, int cell, float px, float py,
        float4* rows, int32_t* groups, Visit&& visit) {
    constexpr int THREADS = CW * CELL_H;
    const int begin = cell_start[cell];
    const int end = cell_start[cell + 1];
    for (int base = begin; base < end; base += BATCH) {
        const int n = min(BATCH, end - base);
        __syncthreads();  // the previous batch is fully consumed
        if (threadIdx.x < n) groups[threadIdx.x] = cell_groups[base + threadIdx.x];
        __syncthreads();
        for (int i = threadIdx.x; i < n * GROUP_F4; i += THREADS) {
            const int64_t g = groups[i / GROUP_F4];
            rows[i] = coef[g * GROUP_F4 + i % GROUP_F4];
        }
        __syncthreads();
        for (int k = 0; k < n; ++k) {
            const float* gr = reinterpret_cast<const float*>(&rows[k * GROUP_F4]);
#pragma unroll
            for (int c = 0; c < GROUP; ++c) {
                const float* r = gr + 16 * c;
                const float e0 = plane(r + 0, px, py);
                const float e1 = plane(r + 3, px, py);
                const float e2 = plane(r + 6, px, py);
                const float zn = plane(r + 9, px, py);
                const float wn = plane(r + 12, px, py);
                if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && wn > 1e-12f
                    && zn >= 0.0f) {
                    visit(zn, wn, groups[k] * GROUP + c);
                }
            }
        }
    }
}

__global__ void __launch_bounds__(32 * CELL_H)
raster_exact_kernel(const int32_t* __restrict__ cell_start,
                    const int32_t* __restrict__ cell_groups,
                    const float4* __restrict__ coef,
                    int width, int height, int n_bx,
                    float* __restrict__ depth, int32_t* __restrict__ tid) {
    __shared__ float4 rows[BATCH * GROUP_F4];
    __shared__ int32_t groups[BATCH];

    const int cell = blockIdx.x;
    const int x = (cell % n_bx) * 32 + (threadIdx.x & 31);
    const int y = (cell / n_bx) * CELL_H + threadIdx.x / 32;
    float zb = 1.0f, wb = 0.0f;
    int32_t best = -1;
    walk_cell<32>(cell_start, cell_groups, coef, cell, (float)x + 0.5f,
                  (float)y + 0.5f, rows, groups,
                  [&](float zn, float wn, int32_t id) {
                      if (__fmul_rn(zn, wb) < __fmul_rn(zb, wn)) {
                          zb = zn;
                          wb = wn;
                          best = id;
                      }
                  });
    if (x < width && y < height) {
        const int64_t o = (int64_t)y * width + x;
        depth[o] = best >= 0 ? __fdiv_rn(zb, fmaxf(wb, 1e-30f)) : INFINITY;
        tid[o] = best;
    }
}

template <int CW, bool PEEL>
__global__ void __launch_bounds__(CW * CELL_H)
raster_keyed_kernel(const int32_t* __restrict__ cell_start,
                    const int32_t* __restrict__ cell_groups,
                    const float4* __restrict__ coef,
                    int width, int height, int n_bx,
                    const int32_t* __restrict__ floor_key,
                    const int32_t* __restrict__ ceil_key,
                    float* __restrict__ depth, int32_t* __restrict__ tid) {
    __shared__ float4 rows[BATCH * GROUP_F4];
    __shared__ int32_t groups[BATCH];

    const int cell = blockIdx.x;
    const int x = (cell % n_bx) * CW + (threadIdx.x % CW);
    const int y = (cell / n_bx) * CELL_H + threadIdx.x / CW;
    const bool in_image = x < width && y < height;
    const int64_t o = (int64_t)y * width + x;
    // outside the image the empty window (0, 0) accepts nothing
    int32_t fl = 0, ce = 0;
    if (PEEL && in_image) {
        fl = floor_key[o];
        ce = ceil_key[o];
    }
    int32_t kb = SENTINEL;
    int32_t best = -1;
    walk_cell<CW>(cell_start, cell_groups, coef, cell, (float)x + 0.5f,
                  (float)y + 0.5f, rows, groups,
                  [&](float zn, float wn, int32_t id) {
                      const int32_t key =
                          __float_as_int(__fdiv_rn(zn, wn)) & KEY_MASK;
                      if ((!PEEL || (key > fl && key < ce)) && key < kb) {
                          kb = key;
                          best = id;
                      }
                  });
    if (in_image) {
        depth[o] = best >= 0 ? __int_as_float(kb) : INFINITY;
        tid[o] = best;
    }
}

template <int CW, bool PEEL>
void launch_keyed(const void* cell_start, const void* cell_groups,
                  const void* coef, int width, int height, int n_bx,
                  int n_cells, const void* floor_key, const void* ceil_key,
                  void* depth, void* tid, cudaStream_t stream) {
    raster_keyed_kernel<CW, PEEL><<<n_cells, CW * CELL_H, 0, stream>>>(
        (const int32_t*)cell_start, (const int32_t*)cell_groups,
        (const float4*)coef, width, height, n_bx, (const int32_t*)floor_key,
        (const int32_t*)ceil_key, (float*)depth, (int32_t*)tid);
}

}  // namespace

// cell_start i32[n_cells + 1], cell_groups i32[n_pairs], coef f32[T_pad, 16]
// (16-byte aligned), depth f32[height, width], tid i32[height, width];
// n_cells = n_bx * ceil(height / 8) over 8x32 cells. Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int raster_exact_launch(const void* cell_start,
                                   const void* cell_groups, const void* coef,
                                   int width, int height, int n_bx,
                                   int n_cells, void* depth, void* tid,
                                   void* stream) {
    if (n_cells > 0) {
        raster_exact_kernel<<<n_cells, 32 * CELL_H, 0, (cudaStream_t)stream>>>(
            (const int32_t*)cell_start, (const int32_t*)cell_groups,
            (const float4*)coef, width, height, n_bx, (float*)depth,
            (int32_t*)tid);
    }
    return (int)cudaGetLastError();
}

// The keyed kernel over 8 x cell_w cells (cell_w 32 or 128); floor_key and
// ceil_key are i32[height, width] window planes, or both null for no window.
// Other arguments as raster_exact_launch. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another cell width.
extern "C" int raster_keyed_launch(const void* cell_start,
                                   const void* cell_groups, const void* coef,
                                   int width, int height, int n_bx,
                                   int n_cells, int cell_w,
                                   const void* floor_key, const void* ceil_key,
                                   void* depth, void* tid, void* stream) {
    if (cell_w != 32 && cell_w != 128) return (int)cudaErrorInvalidValue;
    if (n_cells > 0) {
        const bool peel = floor_key != nullptr;
        auto s = (cudaStream_t)stream;
        if (cell_w == 32 && peel)
            launch_keyed<32, true>(cell_start, cell_groups, coef, width, height,
                                   n_bx, n_cells, floor_key, ceil_key, depth, tid, s);
        else if (cell_w == 32)
            launch_keyed<32, false>(cell_start, cell_groups, coef, width, height,
                                    n_bx, n_cells, nullptr, nullptr, depth, tid, s);
        else if (peel)
            launch_keyed<128, true>(cell_start, cell_groups, coef, width, height,
                                    n_bx, n_cells, floor_key, ceil_key, depth, tid, s);
        else
            launch_keyed<128, false>(cell_start, cell_groups, coef, width, height,
                                     n_bx, n_cells, nullptr, nullptr, depth, tid, s);
    }
    return (int)cudaGetLastError();
}
