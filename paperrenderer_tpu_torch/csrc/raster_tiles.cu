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
// entries and state aliased between pages) are not carried over.
//
// Design (each step timed against the others on an H100; PERF.md §6):
//   * Exact per-warp rejection. A block of 8 warps takes one tile; a warp
//     owns a 16 x 8 footprint, a lane one column of four rows (px * c0 is
//     shared by them). The lanes test 32 triangles of a chunk at a time:
//     each plane at the footprint corner its coefficients' signs pick, in
//     the kernel's own rounding. Round-to-nearest is monotone, so a corner
//     with e0, e1, e2 or zn < 0, or wn <= 1e-12, rules out every pixel of
//     the footprint; a ballot of the survivors is walked in ascending order
//     and only they are evaluated (~4.5% of the candidates on config 2).
//     The chunk boxes are still tested against the whole tile: the culling
//     unit is part of the result.
//   * No block-wide staging: each lane reads its triangle's row with 16-byte
//     loads through the read-only cache, a survivor's row is read by the
//     whole warp at one address, and the warps never wait for each other.
//   * K5 tests the chunk boxes 32 at a time with a ballot and walks the
//     hits in ascending order (each warp draws the same ones).
//   * Split long tiles. A tile's list is cut into `split` ordered ranges of
//     at least RANGE_MIN chunks, one block each (the wrapper picks them:
//     2 to 8 ranges, more when the tiles are few); range 0 writes the
//     outputs, later ranges write (depth, tid) to scratch, and
//     raster_merge_kernel folds them in order with the same strict compare.
//     K5's list lengths come from a launch of their own before the ranges
//     (tile_count_kernel, one block a tile): counted in every range block
//     instead, they cost K5 40 spilled bytes of registers and ~10%.
// What bounds it now: the latency of a warp's chunk visits (four dependent
// rounds of loads, a test and a ballot, then the survivors one by one),
// not the FP32 pipes: the plane tests and the candidates they keep are
// ~0.026 ms of FP32 work on config 2 (chip_smoke.py's bound), about a tenth
// of the kernel's time. With -fmad=false every product and sum issues on
// its own, so evaluating every candidate of config 2's 12,620 (tile,
// chunk) pairs, as the plain version does, would take an H100 about 1 ms.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, the
// divides are __fdiv_rn, and the build passes -fmad=false): the results are
// bitwise equal to the plain PyTorch version, rasterize_chunk_lists_plain in
// ops/raster_pallas.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_cover.cuh"  // load_row, plane, may_cover

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int TILE_PX = TILE_H * TILE_W;
constexpr int CHUNK = 128;                 // triangles per chunk
constexpr int CHUNK_F4 = CHUNK * 16 / 4;   // float4s per chunk (128 rows x 16)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = TILE_PX / THREADS;    // pixels (rows) per thread
constexpr int FW = 16, FH = 8;             // a warp's footprint, pixels
constexpr int RANGE_MIN = 4;               // chunks, the least split range
constexpr unsigned FULL = 0xffffffffu;

// chunk k's box meets the 8 x 128 tile at (fx, fy) (inclusive compares)
__device__ __forceinline__ bool overlaps(const float4* chunk_aabb, int k,
                                         float fx, float fy) {
    const float4 b = __ldg(chunk_aabb + k);
    return b.x <= fx + (float)TILE_W && b.z >= fx && b.y <= fy + (float)TILE_H
           && b.w >= fy;
}

// the length of each of the ranges a list of n chunks is cut into
__device__ __forceinline__ int range_len(int n, int split) {
    return max(RANGE_MIN, (n + split - 1) / split);
}

// bary from a covering candidate's edge values
__device__ __forceinline__ float2 bary_of(float e0, float e1, float e2) {
    const float esum = fmaxf(__fadd_rn(__fadd_rn(e0, e1), e2), 1e-30f);
    return make_float2(__fdiv_rn(e1, esum), __fdiv_rn(e2, esum));
}

// K5's list lengths: tile_len[blockIdx.x] = the chunks whose boxes meet
// that tile, counted by the block's warps together.
__global__ void __launch_bounds__(THREADS)
tile_count_kernel(const float4* __restrict__ chunk_aabb, int n_chunks,
                  int n_tx, int32_t* __restrict__ tile_len) {
    __shared__ int counts[WARPS];
    const int tile = blockIdx.x;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float fx = (float)((tile % n_tx) * TILE_W);
    const float fy = (float)((tile / n_tx) * TILE_H);
    int c = 0;
    for (int k0 = warp * 32; k0 < n_chunks; k0 += THREADS) {
        const bool ovl = k0 + lane < n_chunks
                         && overlaps(chunk_aabb, k0 + lane, fx, fy);
        const unsigned v = __ballot_sync(FULL, ovl);
        c += __popc(v);
    }
    if (lane == 0) counts[warp] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        int n = 0;
        for (int w = 0; w < WARPS; ++w) n += counts[w];
        tile_len[tile] = n;
    }
}

// Block (tile, s), s < split (split >= 2): the s-th range of the tile's
// chunk list, of tile_len[tile] chunks (K5) or the tile's list (K6). Range
// 0 writes depth / tid / bary; range s > 0 writes its depth and tid to slot
// (tile, s - 1) of part_z / part_tid (TILE_PX entries a slot, by pixel of
// the tile), which raster_merge_kernel folds in after range 0, in order.
template <bool LIST>
__global__ void __launch_bounds__(THREADS)
raster_tiles_kernel(const float4* __restrict__ coef,
                    const float4* __restrict__ chunk_aabb, int n_chunks,
                    const int32_t* __restrict__ tile_start,
                    const int32_t* __restrict__ tile_chunks,
                    int width, int height, int n_tx, int split,
                    float* __restrict__ depth, int32_t* __restrict__ tid,
                    float2* __restrict__ bary, float* __restrict__ part_z,
                    int32_t* __restrict__ part_tid,
                    const int32_t* __restrict__ tile_len) {
    const int tile = blockIdx.x / split, s = blockIdx.x % split;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int tx0 = (tile % n_tx) * TILE_W;
    const int ty0 = (tile / n_tx) * TILE_H;
    const float fx = (float)tx0, fy = (float)ty0;

    // this block's ranks [r0, r1) of the tile's list
    const int n = LIST ? tile_start[tile + 1] - tile_start[tile]
                       : tile_len[tile];
    const int len = range_len(n, split);
    const int r0 = s * len;
    if (s > 0 && r0 >= n) return;              // block-uniform: no range
    const int r1 = min(n, r0 + len);

    // a warp: 16 columns x 8 rows; a lane: one column, four rows
    const int fx0 = tx0 + warp * FW, fy0 = ty0;
    const int x = fx0 + lane % FW;
    const int y0 = fy0 + (lane / FW) * ROWS;
    const float x_lo = (float)fx0 + 0.5f, x_hi = (float)(fx0 + FW - 1) + 0.5f;
    const float y_lo = (float)fy0 + 0.5f, y_hi = (float)(fy0 + FH - 1) + 0.5f;
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

    // candidate row r (id `id`) at this thread's pixels
    auto eval = [&](const float (&r)[16], int id) {
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
                    const float2 b = bary_of(e0, e1, e2);
                    best_z[j] = z;
                    best[j] = id;
                    b1[j] = b.x;
                    b2[j] = b.y;
                }
            }
        }
    };

    // Chunk k at this thread's pixels; every lane of the warp calls it. The
    // lanes test 32 triangles at a time against the warp's footprint, and
    // the survivors are evaluated in ascending order.
    auto visit = [&](int k) {
        const float4* base = coef + (int64_t)k * CHUNK_F4;
        float r[16];
        load_row(base + lane * 4, r);
        for (int c0 = 0; c0 < CHUNK; c0 += 32) {
            unsigned m = __ballot_sync(FULL, may_cover(r, x_lo, x_hi, y_lo,
                                                       y_hi));
            while (m) {                     // warp-uniform
                const int i = __ffs(m) - 1;
                m &= m - 1;
                float q[16];
                load_row(base + (c0 + i) * 4, q);
                eval(q, k * CHUNK + c0 + i);
            }
            if (c0 + 32 < CHUNK) load_row(base + (c0 + 32 + lane) * 4, r);
        }
    };

    if (LIST) {
        const int32_t* list = tile_chunks + tile_start[tile];
        for (int i = r0; i < r1; ++i) visit(list[i]);
    } else {
        // a ballot over 32 boxes at a time; the hits of ranks [r0, r1) in
        // ascending order (every warp of the block finds the same ones)
        int rank = 0;
        for (int k0 = 0; k0 < n_chunks && rank < r1; k0 += 32) {
            const bool ovl = k0 + lane < n_chunks
                             && overlaps(chunk_aabb, k0 + lane, fx, fy);
            unsigned hits = __ballot_sync(FULL, ovl);
            while (hits && rank < r1) {     // warp-uniform
                const int i = __ffs(hits) - 1;
                hits &= hits - 1;
                if (rank++ >= r0) visit(k0 + i);
            }
        }
    }

    if (s == 0) {
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
    } else {
        const int64_t slot = ((int64_t)tile * (split - 1) + s - 1) * TILE_PX;
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            const int p = (y0 + j - ty0) * TILE_W + (x - tx0);
            part_z[slot + p] = best_z[j];
            part_tid[slot + p] = best[j];
        }
    }
}

// Tile blockIdx.x after a split launch: range 0's result (in depth / tid /
// bary) folded with ranges 1.. in order, each replacing a pixel's winner
// only with a strictly smaller depth, as the walk over the whole list
// would; a winner from a later range gets its bary from its own row. A
// tile of one range is left as it is.
template <bool LIST>
__global__ void __launch_bounds__(THREADS)
raster_merge_kernel(const float4* __restrict__ coef,
                    const int32_t* __restrict__ tile_start,
                    const int32_t* __restrict__ tile_len,
                    const float* __restrict__ part_z,
                    const int32_t* __restrict__ part_tid,
                    int width, int height, int n_tx, int split,
                    float* __restrict__ depth, int32_t* __restrict__ tid,
                    float2* __restrict__ bary) {
    const int tile = blockIdx.x;
    const int n = LIST ? tile_start[tile + 1] - tile_start[tile]
                       : tile_len[tile];
    const int len = range_len(n, split);
    const int ranges = (n + len - 1) / len;
    if (ranges <= 1) return;
    const int tx0 = (tile % n_tx) * TILE_W;
    const int ty0 = (tile / n_tx) * TILE_H;
    for (int p = threadIdx.x; p < TILE_PX; p += THREADS) {
        const int x = tx0 + p % TILE_W, y = ty0 + p / TILE_W;
        if (x >= width || y >= height) continue;
        const int64_t o = (int64_t)y * width + x;
        float z = depth[o];
        int32_t t = tid[o];
        bool later = false;
        for (int s = 1; s < ranges; ++s) {
            const int64_t q =
                ((int64_t)tile * (split - 1) + s - 1) * TILE_PX + p;
            const float zs = part_z[q];
            if (zs < z) {
                z = zs;
                t = part_tid[q];
                later = true;
            }
        }
        if (later) {
            float r[16];
            load_row(coef + (int64_t)t * 4, r);
            const float px = (float)x + 0.5f, py = (float)y + 0.5f;
            const float e0 = plane(__fmul_rn(px, r[0]), r + 0, py);
            const float e1 = plane(__fmul_rn(px, r[3]), r + 3, py);
            const float e2 = plane(__fmul_rn(px, r[6]), r + 6, py);
            depth[o] = z;
            tid[o] = t;
            bary[o] = bary_of(e0, e1, e2);
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
// f32[height, width, 2]; each tile's list cut into `split` >= 2 ranges of
// at least RANGE_MIN chunks, with part_z f32 and part_tid i32 of n_tiles *
// (split - 1) * 1024 entries and tile_len i32[n_tiles] as scratch. Launches
// the count of each tile's list, the ranges and their merge on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int raster_tiles_launch(const void* coef, const void* chunk_aabb,
                                   int n_chunks, int width, int height,
                                   int split, void* depth, void* tid,
                                   void* bary, void* part_z, void* part_tid,
                                   void* tile_len, void* stream) {
    int n_tx;
    const int tiles = n_tiles(width, height, &n_tx);
    if (tiles > 0) {
        tile_count_kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
            (const float4*)chunk_aabb, n_chunks, n_tx, (int32_t*)tile_len);
        raster_tiles_kernel<false>
            <<<tiles * split, THREADS, 0, (cudaStream_t)stream>>>(
                (const float4*)coef, (const float4*)chunk_aabb, n_chunks,
                nullptr, nullptr, width, height, n_tx, split, (float*)depth,
                (int32_t*)tid, (float2*)bary, (float*)part_z,
                (int32_t*)part_tid, (int32_t*)tile_len);
        raster_merge_kernel<false><<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
            (const float4*)coef, nullptr, (const int32_t*)tile_len,
            (const float*)part_z, (const int32_t*)part_tid, width, height,
            n_tx, split, (float*)depth, (int32_t*)tid, (float2*)bary);
    }
    return (int)cudaGetLastError();
}

// K6. tile_start i32[n_tiles + 1] and tile_chunks i32[n_pairs]: tile i's
// chunks are tile_chunks[tile_start[i] .. tile_start[i + 1]), ascending,
// tiles in row-major order of the 8 x 128 tile grid. Other arguments as
// raster_tiles_launch (tile_len unused: the lists give the lengths).
extern "C" int raster_tiles_list_launch(const void* coef,
                                        const void* tile_start,
                                        const void* tile_chunks, int width,
                                        int height, int split, void* depth,
                                        void* tid, void* bary, void* part_z,
                                        void* part_tid, void*,
                                        void* stream) {
    int n_tx;
    const int tiles = n_tiles(width, height, &n_tx);
    if (tiles > 0) {
        raster_tiles_kernel<true>
            <<<tiles * split, THREADS, 0, (cudaStream_t)stream>>>(
                (const float4*)coef, nullptr, 0, (const int32_t*)tile_start,
                (const int32_t*)tile_chunks, width, height, n_tx, split,
                (float*)depth, (int32_t*)tid, (float2*)bary, (float*)part_z,
                (int32_t*)part_tid, nullptr);
        raster_merge_kernel<true><<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
            (const float4*)coef, (const int32_t*)tile_start, nullptr,
            (const float*)part_z, (const int32_t*)part_tid, width, height,
            n_tx, split, (float*)depth, (int32_t*)tid, (float2*)bary);
    }
    return (int)cudaGetLastError();
}
