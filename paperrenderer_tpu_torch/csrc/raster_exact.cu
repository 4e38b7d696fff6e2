// Binned exact rasterizer: nearest covering triangle per pixel.
//
// Replaces the TPU kernel paperrenderer_tpu/ops/raster_exact.py
// _make_kernel_quarter(crossz=True) (launched by rasterize_exact's
// pl.pallas_call). Contract kept from it:
//   * candidates of a pixel are the 8-triangle groups binned to its cell,
//     visited in ascending group order, then triangle 0..7 of the group;
//   * accept: e0, e1, e2 >= 0, wn > 1e-12 and zn >= 0;
//   * winner: the running (zn, wn) pair, replaced when zn*wb < zb*wn
//     (cross-multiplied, no divide per candidate), starting from the empty
//     state (zb, wb) = (1, 0); the earliest candidate wins a tie;
//   * out: depth = zn / max(wn, 1e-30) (+inf where empty) and tid = global
//     triangle id (-1 where empty), taken from the coefficient ROW index.
// The TPU mechanism (quarter lanes, MXU coefficient replication, (8,128)
// tiles, SMEM paging of the work list) is not carried over.
//
// Design: one 256-thread block per 8x32-pixel cell, one thread per pixel.
// The block stages BATCH groups' coefficient rows (512 B each, contiguous in
// the [T_pad, 16] table) in shared memory with 16-byte loads; every thread
// then reads the same shared address per coefficient (a broadcast, no bank
// conflicts). The winner state stays in registers and is written once.
//
// What bounds it on an H100: the FP32 pipes. Each (group, cell) pair costs
// 8 triangles x 256 pixels x ~20 FP32 ops; the loads are 512 B per pair and
// mostly hit L2 (the table of a 460k-triangle scene is ~30 MB, under the
// 50 MB L2). Long lists in a few cells (many small distant triangles) leave
// their blocks running after the rest of the grid has drained; balancing
// that is later work.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, and
// the build passes -fmad=false): the result is bitwise equal to the plain
// PyTorch version, rasterize_bins_plain in ops/raster_exact.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CELL_W = 32;
constexpr int CELL_H = 8;
constexpr int GROUP = 8;                 // triangles per bin entry
constexpr int THREADS = CELL_W * CELL_H; // one thread per pixel of a cell
constexpr int GROUP_F4 = GROUP * 16 / 4; // float4s per group (8 rows x 16)
constexpr int BATCH = 32;                // groups staged per pass (16 KiB)

__device__ __forceinline__ float plane(const float* r, float px, float py) {
    return __fadd_rn(__fadd_rn(__fmul_rn(r[0], px), __fmul_rn(r[1], py)), r[2]);
}

__global__ void __launch_bounds__(THREADS)
raster_exact_kernel(const int32_t* __restrict__ cell_start,
                    const int32_t* __restrict__ cell_groups,
                    const float4* __restrict__ coef,
                    int width, int height, int n_bx,
                    float* __restrict__ depth, int32_t* __restrict__ tid) {
    __shared__ float4 rows[BATCH * GROUP_F4];
    __shared__ int32_t groups[BATCH];

    const int cell = blockIdx.x;
    const int x = (cell % n_bx) * CELL_W + (threadIdx.x & (CELL_W - 1));
    const int y = (cell / n_bx) * CELL_H + threadIdx.x / CELL_W;
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;
    const int begin = cell_start[cell];
    const int end = cell_start[cell + 1];

    float zb = 1.0f, wb = 0.0f;
    int32_t best = -1;
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
                const bool accept = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f
                                    && wn > 1e-12f && zn >= 0.0f;
                if (accept && __fmul_rn(zn, wb) < __fmul_rn(zb, wn)) {
                    zb = zn;
                    wb = wn;
                    best = groups[k] * GROUP + c;
                }
            }
        }
    }
    if (x < width && y < height) {
        const int64_t o = (int64_t)y * width + x;
        depth[o] = best >= 0 ? __fdiv_rn(zb, fmaxf(wb, 1e-30f)) : INFINITY;
        tid[o] = best;
    }
}

}  // namespace

// cell_start i32[n_cells + 1], cell_groups i32[n_pairs], coef f32[T_pad, 16]
// (16-byte aligned), depth f32[height, width], tid i32[height, width];
// n_cells = n_bx * ceil(height / 8). Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int raster_exact_launch(const void* cell_start,
                                   const void* cell_groups, const void* coef,
                                   int width, int height, int n_bx,
                                   int n_cells, void* depth, void* tid,
                                   void* stream) {
    if (n_cells > 0) {
        raster_exact_kernel<<<n_cells, THREADS, 0, (cudaStream_t)stream>>>(
            (const int32_t*)cell_start, (const int32_t*)cell_groups,
            (const float4*)coef, width, height, n_bx, (float*)depth,
            (int32_t*)tid);
    }
    return (int)cudaGetLastError();
}
