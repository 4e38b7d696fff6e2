// Binned exact rasterizers: nearest covering triangle per pixel.
//
// Two kernels share one walk over a bin cell's candidates (walk_list):
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
// Design (each step timed against the others on an H100; PERF.md §6):
//   * One block of 8 x CW threads per cell, one thread per pixel; a warp
//     owns an 8 x 4 footprint of the cell. The warps never wait for each
//     other: each walks the cell's list on its own, with no block-wide
//     staging.
//   * Exact per-warp rejection. The 32 lanes test 32 triangles at a time,
//     four groups of the list: lane 8 * j + c holds triangle c of the j-th
//     group, its 16-float row read as four 16-byte loads through the
//     read-only cache (the block's 8 warps read the same rows).
//     Each plane is evaluated at the corner of the warp's footprint that
//     its coefficients' signs pick, in the kernel's own rounding
//     (raster_cover.cuh's may_cover, shared with the tile kernels);
//     round-to-nearest is monotone, so a rejected triangle accepts no
//     pixel of the footprint. A ballot of the survivors is walked in
//     ascending lane order, which is the list's order, and only they are
//     evaluated per pixel, each row read by the whole warp at one address
//     (~8% of config 2's candidates; 8 x 4 kept fewer than 16 x 2 and
//     32 x 1 and ran 1.4x and 2.6x faster).
//   * K2 (and K4's peel form): a warp in which no pixel's window (fl, ce)
//     holds an integer, decided in 64 bits ((int64) fl + 1 < ce; the
//     windows reach INT32_MIN + 1 and 0x7F800000), writes its empty outputs
//     and ends; otherwise its footprint shrinks to the box of its open
//     pixels.
// What bounds them now: latency. A warp's rounds are serial, each a group
// id load, a dependent row load, the test and a ballot, then the survivors
// one by one, and only more resident warps hide it: 40 registers give 6
// blocks a SM. The longest lists set the time of the peel's later
// layers (their open windows lie in the densest cells). Lost on the card
// and removed: the list's group ids read 32 at a time, the next round's
// rows loaded early and several survivors' rows loaded together (more
// registers, fewer warps), rows staged in shared memory by cp.async
// (through L2 only: 3.8x slower; through L1 it cut the long lists' tail
// but lost on dense cells), a 32-register cap, and K2's long lists split over
// blocks (the extra blocks cost more than the tail). With -fmad=false every
// product and sum issues on its own, so evaluating all of config 2's
// 202.6 M candidates, as the plain version does, would take an H100 at
// least 0.13 ms.
//
// Screen-tile windows (parallel/tiles.py): (x0, y0) is the window's origin
// in the viewport whose coefficients the rows hold. The cells are the
// viewport's cells that meet the window (cell 0 starts x0 % CW pixels left
// of the window and y0 % 8 above it) with the viewport's lists, and the
// outputs are the window's. The pixel centre and the footprint's outer
// centres add the origin in integers before the float conversion, as the
// TPU kernel does ((tx * TILE_W + org) as f32 + 0.5), so every pixel meets
// the single-device run's candidates in its order, in the same rounding.
// (0, 0) is the whole image.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, the
// divide is __fdiv_rn, and the build passes -fmad=false): the results are
// bitwise equal to the plain PyTorch version, rasterize_bins_plain in
// ops/raster_exact.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "raster_cover.cuh"  // load_row, plane, may_cover

namespace {

constexpr int CELL_H = 8;
constexpr int GROUP = 8;                 // triangles per bin entry
constexpr int32_t SENTINEL = 0x7FFFFFFF;
constexpr int32_t KEY_MASK = ~(128 - 1);
constexpr unsigned FULL = 0xffffffffu;
constexpr int FOOT_W = 8;                // a warp's footprint: 8 x 4 pixels
constexpr int FOOT_H = 32 / FOOT_W;
// blocks a SM the 8 x 32 kernels are built for: without it ptxas aims at 32
// registers and spills K2's state (32 with 28 B spilled, ~20% slower on K2's
// layers; 5 gives 40 and no spill)
constexpr int MIN_BLOCKS = 5;

// This thread's pixel (in the window; negative left of or above it) and
// its warp's footprint in `cell` of 8 x CW pixels; the centres are in the
// viewport, the window at origin (x0, y0).
struct Pixel {
    int x, y;
    float px, py;                        // the pixel centre
    float x_lo, x_hi, y_lo, y_hi;        // the footprint's outer centres
};

template <int CW>
__device__ __forceinline__ Pixel pixel_of(int cell, int n_bx, int x0, int y0) {
    constexpr int PER_ROW = CW / FOOT_W;   // footprints across a cell
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int fx = (cell % n_bx) * CW + (warp % PER_ROW) * FOOT_W - x0 % CW;
    const int fy =
        (cell / n_bx) * CELL_H + (warp / PER_ROW) * FOOT_H - y0 % CELL_H;
    Pixel p;
    p.x = fx + lane % FOOT_W;
    p.y = fy + lane / FOOT_W;
    p.px = (float)(p.x + x0) + 0.5f;
    p.py = (float)(p.y + y0) + 0.5f;
    p.x_lo = (float)(fx + x0) + 0.5f;
    p.x_hi = (float)(fx + x0 + FOOT_W - 1) + 0.5f;
    p.y_lo = (float)(fy + y0) + 0.5f;
    p.y_hi = (float)(fy + y0 + FOOT_H - 1) + 0.5f;
    return p;
}

// Narrows the warp's footprint to the box of the pixels whose `open` is
// set (at least one lane's); every lane of the warp calls it.
__device__ __forceinline__ void shrink_to(Pixel& p, bool open, int x0,
                                          int y0) {
    const unsigned big = 0x7fffffffu;
    const int xa = (int)__reduce_min_sync(FULL, open ? (unsigned)p.x : big);
    const int xb = (int)__reduce_max_sync(FULL, open ? (unsigned)p.x : 0u);
    const int ya = (int)__reduce_min_sync(FULL, open ? (unsigned)p.y : big);
    const int yb = (int)__reduce_max_sync(FULL, open ? (unsigned)p.y : 0u);
    p.x_lo = (float)(xa + x0) + 0.5f;
    p.x_hi = (float)(xb + x0) + 0.5f;
    p.y_lo = (float)(ya + y0) + 0.5f;
    p.y_hi = (float)(yb + y0) + 0.5f;
}

// Calls visit(zn, wn, global id) for every accepted candidate of the pixel
// p among the list entries [begin, end) of its cell, in the list's order.
// Every lane of the warp must call it (it votes); the warps of a block are
// independent.
template <typename Visit>
__device__ __forceinline__ void walk_list(
        const int32_t* __restrict__ cell_groups,
        const float4* __restrict__ coef, int begin, int end, const Pixel& p,
        Visit&& visit) {
    const int lane = threadIdx.x % 32;
    for (int base = begin; base < end; base += 32 / GROUP) {
        // lane 8 * j + c: triangle c of the list's group base + j
        const int k = base + lane / GROUP;
        int g = 0;
        bool may = false;
        if (k < end) {
            g = __ldg(cell_groups + k);
            float r[16];
            load_row(coef + ((int64_t)g * GROUP + lane % GROUP) * 4, r);
            may = may_cover(r, p.x_lo, p.x_hi, p.y_lo, p.y_hi);
        }
        unsigned m = __ballot_sync(FULL, may);
        while (m) {                        // warp-uniform, ascending lanes
            const int i = __ffs(m) - 1;
            m &= m - 1;
            const int32_t id = __shfl_sync(FULL, g, i) * GROUP + i % GROUP;
            float r[16];
            load_row(coef + (int64_t)id * 4, r);
            const float e0 = plane(__fmul_rn(p.px, r[0]), r + 0, p.py);
            const float e1 = plane(__fmul_rn(p.px, r[3]), r + 3, p.py);
            const float e2 = plane(__fmul_rn(p.px, r[6]), r + 6, p.py);
            const float zn = plane(__fmul_rn(p.px, r[9]), r + 9, p.py);
            const float wn = plane(__fmul_rn(p.px, r[12]), r + 12, p.py);
            if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && wn > 1e-12f
                && zn >= 0.0f) {
                visit(zn, wn, id);
            }
        }
    }
}

__global__ void __launch_bounds__(32 * CELL_H, MIN_BLOCKS)
raster_exact_kernel(const int32_t* __restrict__ cell_start,
                    const int32_t* __restrict__ cell_groups,
                    const float4* __restrict__ coef,
                    int width, int height, int n_bx, int x0, int y0,
                    float* __restrict__ depth, int32_t* __restrict__ tid) {
    const int cell = blockIdx.x;
    const Pixel p = pixel_of<32>(cell, n_bx, x0, y0);
    float zb = 1.0f, wb = 0.0f;
    int32_t best = -1;
    walk_list(cell_groups, coef, cell_start[cell], cell_start[cell + 1], p,
              [&](float zn, float wn, int32_t id) {
                  if (__fmul_rn(zn, wb) < __fmul_rn(zb, wn)) {
                      zb = zn;
                      wb = wn;
                      best = id;
                  }
              });
    if (p.x >= 0 && p.y >= 0 && p.x < width && p.y < height) {
        const int64_t o = (int64_t)p.y * width + p.x;
        depth[o] = best >= 0 ? __fdiv_rn(zb, fmaxf(wb, 1e-30f)) : INFINITY;
        tid[o] = best;
    }
}

template <int CW, bool PEEL>
__global__ void __launch_bounds__(CW * CELL_H, CW == 32 ? MIN_BLOCKS : 1)
raster_keyed_kernel(const int32_t* __restrict__ cell_start,
                    const int32_t* __restrict__ cell_groups,
                    const float4* __restrict__ coef,
                    int width, int height, int n_bx, int x0, int y0,
                    const int32_t* __restrict__ floor_key,
                    const int32_t* __restrict__ ceil_key,
                    float* __restrict__ depth, int32_t* __restrict__ tid) {
    const int cell = blockIdx.x;
    Pixel p = pixel_of<CW>(cell, n_bx, x0, y0);
    const bool in_image = p.x >= 0 && p.y >= 0 && p.x < width && p.y < height;
    const int64_t o = (int64_t)p.y * width + p.x;
    // outside the image the empty window (0, 0) accepts nothing
    int32_t fl = 0, ce = 0;
    if (PEEL && in_image) {
        fl = floor_key[o];
        ce = ceil_key[o];
    }
    if (PEEL) {
        // some int32 key lies strictly inside the window (in 64 bits: the
        // windows reach INT32_MIN + 1 below and 0x7F800000 above)
        const bool open = (int64_t)fl + 1 < (int64_t)ce;
        if (!__any_sync(FULL, open)) {                  // every lane votes
            if (in_image) {                             // warp-uniform end
                depth[o] = INFINITY;
                tid[o] = -1;
            }
            return;
        }
        shrink_to(p, open, x0, y0);
    }
    int32_t kb = SENTINEL;
    int32_t best = -1;
    walk_list(cell_groups, coef, cell_start[cell], cell_start[cell + 1], p,
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
                  int n_cells, int x0, int y0, const void* floor_key,
                  const void* ceil_key, void* depth, void* tid,
                  cudaStream_t stream) {
    raster_keyed_kernel<CW, PEEL><<<n_cells, CW * CELL_H, 0, stream>>>(
        (const int32_t*)cell_start, (const int32_t*)cell_groups,
        (const float4*)coef, width, height, n_bx, x0, y0,
        (const int32_t*)floor_key,
        (const int32_t*)ceil_key, (float*)depth, (int32_t*)tid);
}

}  // namespace

// cell_start i32[n_cells + 1], cell_groups i32[n_pairs], coef f32[T_pad, 16]
// (16-byte aligned), depth f32[height, width], tid i32[height, width] of
// the width x height window at (x0, y0) of the coefficients' viewport;
// n_cells = n_bx * ceil((height + y0 % 8) / 8) over the viewport's 8x32
// cells that meet it, n_bx = ceil((width + x0 % 32) / 32). Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int raster_exact_launch(const void* cell_start,
                                   const void* cell_groups, const void* coef,
                                   int width, int height, int n_bx,
                                   int n_cells, int x0, int y0, void* depth,
                                   void* tid, void* stream) {
    if (n_cells > 0) {
        raster_exact_kernel<<<n_cells, 32 * CELL_H, 0, (cudaStream_t)stream>>>(
            (const int32_t*)cell_start, (const int32_t*)cell_groups,
            (const float4*)coef, width, height, n_bx, x0, y0, (float*)depth,
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
                                   int n_cells, int cell_w, int x0, int y0,
                                   const void* floor_key, const void* ceil_key,
                                   void* depth, void* tid, void* stream) {
    if (cell_w != 32 && cell_w != 128) return (int)cudaErrorInvalidValue;
    if (n_cells > 0) {
        const bool peel = floor_key != nullptr;
        auto s = (cudaStream_t)stream;
        if (cell_w == 32 && peel)
            launch_keyed<32, true>(cell_start, cell_groups, coef, width, height,
                                   n_bx, n_cells, x0, y0, floor_key, ceil_key, depth, tid, s);
        else if (cell_w == 32)
            launch_keyed<32, false>(cell_start, cell_groups, coef, width, height,
                                    n_bx, n_cells, x0, y0, nullptr, nullptr, depth, tid, s);
        else if (peel)
            launch_keyed<128, true>(cell_start, cell_groups, coef, width, height,
                                    n_bx, n_cells, x0, y0, floor_key, ceil_key, depth, tid, s);
        else
            launch_keyed<128, false>(cell_start, cell_groups, coef, width, height,
                                     n_bx, n_cells, x0, y0, nullptr, nullptr, depth, tid, s);
    }
    return (int)cudaGetLastError();
}
