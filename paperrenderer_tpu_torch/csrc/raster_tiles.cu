// Tile rasterizers of the draw-list frame: nearest covering triangle per
// pixel, with perspective-correct barycentrics.
//
// raster_tiles_kernel<false> (K5) replaces the TPU kernel
// paperrenderer_tpu/ops/raster_pallas.py _kernel (rasterize_tiles's
// pl.pallas_call); raster_tiles_kernel<true> (K6) replaces _make_wq_kernel
// (rasterize_tiles_binned's work-list pallas_call), which computes the same
// function. Contract kept from them:
//   * one 8 x 128 tile of pixels; triangles come in chunks of 128
//     consecutive coefficient rows (sorted by screen morton code);
//   * K5 visits every chunk in ascending order and skips one whose screen
//     box (lo_x, lo_y, hi_x, hi_y) misses the tile rect, with the inclusive
//     compares lo_x <= x0 + 128, hi_x >= x0, lo_y <= y0 + 8, hi_y >= y0
//     (empty chunks carry an inverted box); K6 visits the tile's list of
//     overlapping chunks, built on the device by the same test, ascending;
//   * accept: e0, e1, e2 >= 0, wn > 1e-12 and zn >= 0, each plane evaluated
//     as (px * c0 + py * c1) + c2;
//   * winner: z = zn / wn replaces the running depth when strictly smaller,
//     so the earlier candidate wins a tie (K6's per-chunk argmin followed by
//     a strict compare across chunks picks the same one);
//   * out: depth (+inf where empty), the winner's coefficient row id (-1
//     where empty), and bary = (e1, e2) / max((e0 + e1) + e2, 1e-30) from the
//     winner's edge values (0 where empty).
// The TPU mechanisms (SMEM scalar prefetch of the boxes, VMEM state carried
// across the sequential chunk grid axis, SMEM paging of the work list, seed
// entries and state aliased between pages) are not carried over: a block
// keeps its tile's state in registers for the whole walk.
//
// Design: one block of 256 threads per tile; each thread owns one pixel
// column of four rows (two row groups per tile), so each coefficient row
// read from shared memory serves four pixels and px * c0 is shared by them.
// A chunk's 128 rows (8 KB, contiguous in the [T_pad, 16] table) are staged
// in shared memory with 16-byte loads; every thread then reads the same
// shared address per coefficient (a broadcast). K5 tests 256 chunk boxes at
// a time, one per thread, into a shared flag array, so the walk over the
// chunks that miss costs a shared read each.
//
// What bounds them on an H100: the FP32 pipes. Each (tile, chunk) pair costs
// 128 triangles x 1024 pixels x 20 FP32 ops, 5 planes x (2 mul + 2 add) (~16
// here, where px * c0 is shared), plus the divides of the accepted
// candidates only; the coefficient loads are 8 KB per pair and mostly hit L2. K5
// also walks every chunk's box in every tile, which K6's lists avoid.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, the
// divides are __fdiv_rn, and the build passes -fmad=false): the results are
// bitwise equal to the plain PyTorch version, rasterize_chunk_lists_plain in
// ops/raster_pallas.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int CHUNK = 128;                 // triangles per chunk
constexpr int CHUNK_F4 = CHUNK * 16 / 4;   // float4s per chunk (128 rows x 16)
constexpr int THREADS = 256;
constexpr int ROWS = TILE_H * TILE_W / THREADS;   // pixels (rows) per thread

// (px * r[0] + py * r[1]) + r[2], with px * r[0] given as xa.
__device__ __forceinline__ float plane(float xa, const float* r, float py) {
    return __fadd_rn(__fadd_rn(xa, __fmul_rn(py, r[1])), r[2]);
}

template <bool LIST>
__global__ void __launch_bounds__(THREADS)
raster_tiles_kernel(const float4* __restrict__ coef,
                    const float4* __restrict__ chunk_aabb, int n_chunks,
                    const int32_t* __restrict__ tile_start,
                    const int32_t* __restrict__ tile_chunks,
                    int width, int height, int n_tx,
                    float* __restrict__ depth, int32_t* __restrict__ tid,
                    float2* __restrict__ bary) {
    __shared__ float4 rows[CHUNK_F4];
    __shared__ int flags[THREADS];

    const int tile = blockIdx.x;
    const int tx0 = (tile % n_tx) * TILE_W;
    const int ty0 = (tile / n_tx) * TILE_H;
    const int x = tx0 + threadIdx.x % TILE_W;
    const int y0 = ty0 + (threadIdx.x / TILE_W) * ROWS;
    const float px = (float)x + 0.5f;
    float py[ROWS], best_z[ROWS], b1[ROWS], b2[ROWS];
    int32_t best[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        py[j] = (float)(y0 + j) + 0.5f;
        best_z[j] = INFINITY;
        best[j] = -1;
        b1[j] = 0.0f;
        b2[j] = 0.0f;
    }

    // evaluates chunk k for this thread's pixels; every thread calls it
    auto visit = [&](int k) {
        __syncthreads();  // the previous chunk is fully consumed
        for (int i = threadIdx.x; i < CHUNK_F4; i += THREADS)
            rows[i] = coef[(int64_t)k * CHUNK_F4 + i];
        __syncthreads();
        for (int c = 0; c < CHUNK; ++c) {
            const float* r = reinterpret_cast<const float*>(&rows[c * 4]);
            const float x0 = __fmul_rn(px, r[0]), x1 = __fmul_rn(px, r[3]);
            const float x2 = __fmul_rn(px, r[6]), x3 = __fmul_rn(px, r[9]);
            const float x4 = __fmul_rn(px, r[12]);
#pragma unroll
            for (int j = 0; j < ROWS; ++j) {
                const float e0 = plane(x0, r + 0, py[j]);
                const float e1 = plane(x1, r + 3, py[j]);
                const float e2 = plane(x2, r + 6, py[j]);
                const float zn = plane(x3, r + 9, py[j]);
                const float wn = plane(x4, r + 12, py[j]);
                if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && wn > 1e-12f
                    && zn >= 0.0f) {
                    const float z = __fdiv_rn(zn, wn);
                    if (z < best_z[j]) {
                        const float esum =
                            fmaxf(__fadd_rn(__fadd_rn(e0, e1), e2), 1e-30f);
                        best_z[j] = z;
                        best[j] = k * CHUNK + c;
                        b1[j] = __fdiv_rn(e1, esum);
                        b2[j] = __fdiv_rn(e2, esum);
                    }
                }
            }
        }
    };

    if (LIST) {
        const int end = tile_start[tile + 1];
        for (int i = tile_start[tile]; i < end; ++i) visit(tile_chunks[i]);
    } else {
        const float fx0 = (float)tx0, fy0 = (float)ty0;
        for (int k0 = 0; k0 < n_chunks; k0 += THREADS) {
            const int n = min(THREADS, n_chunks - k0);
            __syncthreads();  // the previous flags are fully consumed
            if (threadIdx.x < n) {
                const float4 b = chunk_aabb[k0 + threadIdx.x];
                flags[threadIdx.x] = b.x <= fx0 + (float)TILE_W && b.z >= fx0
                                     && b.y <= fy0 + (float)TILE_H && b.w >= fy0;
            }
            __syncthreads();
            for (int i = 0; i < n; ++i)
                if (flags[i]) visit(k0 + i);   // block-uniform branch
        }
    }

    if (x < width) {
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            if (y0 + j < height) {
                const int64_t o = (int64_t)(y0 + j) * width + x;
                depth[o] = best_z[j];
                tid[o] = best[j];
                bary[o] = make_float2(b1[j], b2[j]);
            }
        }
    }
}

int n_tiles(int width, int height, int* n_tx) {
    *n_tx = (width + TILE_W - 1) / TILE_W;
    return *n_tx * ((height + TILE_H - 1) / TILE_H);
}

}  // namespace

// K5. coef f32[n_chunks * 128, 16] (16-byte aligned), chunk_aabb
// f32[n_chunks, 4], depth f32[height, width], tid i32[height, width], bary
// f32[height, width, 2]. Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int raster_tiles_launch(const void* coef, const void* chunk_aabb,
                                   int n_chunks, int width, int height,
                                   void* depth, void* tid, void* bary,
                                   void* stream) {
    int n_tx;
    const int tiles = n_tiles(width, height, &n_tx);
    if (tiles > 0) {
        raster_tiles_kernel<false><<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
            (const float4*)coef, (const float4*)chunk_aabb, n_chunks, nullptr,
            nullptr, width, height, n_tx, (float*)depth, (int32_t*)tid,
            (float2*)bary);
    }
    return (int)cudaGetLastError();
}

// K6. tile_start i32[n_tiles + 1] and tile_chunks i32[n_pairs]: tile i's
// chunks are tile_chunks[tile_start[i] .. tile_start[i + 1]), ascending,
// tiles in row-major order of the 8 x 128 tile grid. Other arguments as
// raster_tiles_launch.
extern "C" int raster_tiles_list_launch(const void* coef,
                                        const void* tile_start,
                                        const void* tile_chunks, int width,
                                        int height, void* depth, void* tid,
                                        void* bary, void* stream) {
    int n_tx;
    const int tiles = n_tiles(width, height, &n_tx);
    if (tiles > 0) {
        raster_tiles_kernel<true><<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
            (const float4*)coef, nullptr, 0, (const int32_t*)tile_start,
            (const int32_t*)tile_chunks, width, height, n_tx, (float*)depth,
            (int32_t*)tid, (float2*)bary);
    }
    return (int)cudaGetLastError();
}
