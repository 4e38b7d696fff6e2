// Binned exact rasterizers: nearest covering triangle per pixel.
//
// Three kernels share one walk over a bin cell's candidates (walk_list, or
// walk_ids over a prefiltered list):
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
// raster_keyed_kernel<PEEL> and raster_classic_kernel<PEEL> replace the
// quantized-key forms of the same pallas_call: on 8 x 32 cells
// _make_kernel_quarter(peel=True) (K2, PEEL) and
// _make_kernel_quarter(crossz=False) (K3); on 8 x 128 cells the classic
// full-tile _make_kernel (K4, raster_classic_kernel, with or without its
// peel form). Contract kept from them:
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
// over: the cell width (32 or 128 pixels) only sets which lists a pixel
// meets.
//
// Design of K1-K3 (each step timed against the others on an H100; PERF.md
// §6):
//   * One block of 8 x 32 threads per cell, one thread per pixel; a warp
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
//   * K2: a warp in which no pixel's window (fl, ce) holds an integer,
//     decided in 64 bits ((int64) fl + 1 < ce; the windows reach
//     INT32_MIN + 1 and 0x7F800000), writes its empty outputs and ends;
//     otherwise its footprint shrinks to the box of its open pixels.
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
// Design of K4 (walk_bench --group raster on config 2, two runs each in
// one call, against the parent's 1,024-thread blocks in which each of 32
// warps walked the whole 8 x 128 list: 0.1751 ms, peel 0.1922):
//   * Quarter blocks: one block of 8 x 32 threads (K3's shape and launch
//     bound) for each 32-column quarter of a cell, 4 a cell; a warp keeps
//     its 8 x 4 footprint.
//   * A block prefilter with the survivors in shared memory. The block's
//     threads take the list in rounds of one triangle a thread (32 groups)
//     and test each once against the box of the quarter's live pixels with
//     may_cover; the survivors' ids go to a shared buffer in list order (a
//     ballot, __popc and a prefix over the 8 warps' counts, double-buffered
//     so a round takes one barrier). Then each warp walks the survivors as
//     walk_list walks a list (walk_ids: its footprint test, then the
//     per-pixel evaluation). The buffer holds a chunk: a list whose
//     survivors may outgrow it is taken chunk by chunk. The box holds every
//     live pixel and may_cover is exact for any box of pixel centres, so a
//     dropped triangle accepts no live pixel: the results stay bitwise.
//   * The list's bounds are read before the block's first barrier, and each
//     thread's next group id a round ahead; a block whose list is empty
//     writes its empty outputs before any barrier (block-uniform).
//   * PEEL: the box narrows to the open pixels (the warps' boxes merged
//     after one barrier); a quarter with none writes its empty outputs and
//     ends as a whole block; a warp with none skips its walk but reaches
//     every barrier.
//   Kept: 0.0904 / 0.0903 ms, peel 0.0966 / 0.0966 (K3 0.0764 / 0.0768 in
//   the same call). Timed and dropped: quarter blocks alone, each warp
//   walking the whole list, 0.1381 / 0.1378; 2048 and 4096 survivor ids
//   0.7% and 1.4% slower than 1024, 512 1.2% slower (more chunk
//   barriers); 6 blocks a SM (40 registers, 16 B spilled; with the early
//   loads none) 3-5% slower; prefetch.global.L1 of the next round's rows
//   2.5% slower in the prefilter, 4% with the walks too.
// What bounds K4 now (the PROBE form's block records): every SM holds
// ~4.6 of its 5 blocks through the launch, and the densest cells' blocks
// (~500 groups, ~16 rounds, ~700 survivors) run ~85% of the span, two
// thirds of it in the walks; more resident blocks or more loads in flight
// make each block slower, so the SM's throughput on this serial mix, not its
// occupancy, sets the time.
//
// Screen-tile windows (parallel/tiles.py): (x0, y0) is the window's origin
// in the viewport whose coefficients the rows hold. The cells are the
// viewport's cells that meet the window (cell 0 starts x0 % CW pixels left
// of the window and y0 % 8 above it, CW the cell width) with the
// viewport's lists, and the outputs are the window's. The pixel centre and
// the footprint's outer centres add the origin in integers before the
// float conversion, as the TPU kernel does ((tx * TILE_W + org) as f32 +
// 0.5), so every pixel meets the single-device run's candidates in its
// order, in the same rounding. (0, 0) is the whole image.
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
// layers; 5 gives 40 and no spill; K4 48)
constexpr int MIN_BLOCKS = 5;
constexpr int BLOCK = 32 * CELL_H;       // threads of a block: 8 x 32 pixels
constexpr int WARPS = BLOCK / 32;
constexpr int QUARTERS = 128 / 32;       // K4's blocks in an 8 x 128 cell
// K4's shared survivor buffer, in triangle ids: a chunk of the cell's list
// is prefiltered until one more block round might not fit
constexpr int SURVIVORS = 1024;

// This thread's pixel (in the window; negative left of or above it) and
// its warp's footprint in the 8 x 32 block at column `col` of `cell` of
// 8 x CW pixels; the centres are in the viewport, the window at origin
// (x0, y0).
struct Pixel {
    int x, y;
    float px, py;                        // the pixel centre
    float x_lo, x_hi, y_lo, y_hi;        // the footprint's outer centres
};

template <int CW>
__device__ __forceinline__ Pixel pixel_of(int cell, int col, int n_bx, int x0,
                                          int y0) {
    constexpr int PER_ROW = 32 / FOOT_W;   // footprints across a block
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int fx =
        (cell % n_bx) * CW + col + (warp % PER_ROW) * FOOT_W - x0 % CW;
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

// Pixel columns xa..xb and rows ya..yb.
struct Box {
    int xa, xb, ya, yb;
};

// The box of the warp's pixels whose `live` is set; (big, 0, big, 0) where
// no lane's is. Every lane of the warp calls it.
__device__ __forceinline__ Box live_box(const Pixel& p, bool live) {
    const unsigned big = 0x7fffffffu;
    return {(int)__reduce_min_sync(FULL, live ? (unsigned)p.x : big),
            (int)__reduce_max_sync(FULL, live ? (unsigned)p.x : 0u),
            (int)__reduce_min_sync(FULL, live ? (unsigned)p.y : big),
            (int)__reduce_max_sync(FULL, live ? (unsigned)p.y : 0u)};
}

// The footprint's outer centres become box b's.
__device__ __forceinline__ void set_footprint(Pixel& p, const Box& b, int x0,
                                              int y0) {
    p.x_lo = (float)(b.xa + x0) + 0.5f;
    p.x_hi = (float)(b.xb + x0) + 0.5f;
    p.y_lo = (float)(b.ya + y0) + 0.5f;
    p.y_hi = (float)(b.yb + y0) + 0.5f;
}

// Narrows the warp's footprint to the box of the pixels whose `open` is
// set (at least one lane's); every lane of the warp calls it.
__device__ __forceinline__ void shrink_to(Pixel& p, bool open, int x0,
                                          int y0) {
    set_footprint(p, live_box(p, open), x0, y0);
}

// visit(zn, wn, id) where the pixel p accepts triangle `id`.
template <typename Visit>
__device__ __forceinline__ void evaluate(const float4* __restrict__ coef,
                                         int32_t id, const Pixel& p,
                                         Visit& visit) {
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
            evaluate(coef, __shfl_sync(FULL, g, i) * GROUP + i % GROUP, p,
                     visit);
        }
    }
}

// walk_list over the triangle ids ids[0, n) (K4's survivors, in shared
// memory) in place of a cell's groups.
template <typename Visit>
__device__ __forceinline__ void walk_ids(const int32_t* ids, int n,
                                         const float4* __restrict__ coef,
                                         const Pixel& p, Visit&& visit) {
    const int lane = threadIdx.x % 32;
    for (int base = 0; base < n; base += 32) {
        int32_t id = 0;
        bool may = false;
        if (base + lane < n) {
            id = ids[base + lane];
            float r[16];
            load_row(coef + (int64_t)id * 4, r);
            may = may_cover(r, p.x_lo, p.x_hi, p.y_lo, p.y_hi);
        }
        unsigned m = __ballot_sync(FULL, may);
        while (m) {                        // warp-uniform, ascending lanes
            const int i = __ffs(m) - 1;
            m &= m - 1;
            evaluate(coef, __shfl_sync(FULL, id, i), p, visit);
        }
    }
}

// The keyed compare: keep the candidate's key when it is the smallest so
// far (strictly: the earliest wins a tie) and, PEEL, inside (fl, ce).
template <bool PEEL>
__device__ __forceinline__ void keep_key(float zn, float wn, int32_t id,
                                         int32_t fl, int32_t ce, int32_t& kb,
                                         int32_t& best) {
    const int32_t key = __float_as_int(__fdiv_rn(zn, wn)) & KEY_MASK;
    if ((!PEEL || (key > fl && key < ce)) && key < kb) {
        kb = key;
        best = id;
    }
}

__device__ __forceinline__ long long globaltimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ int sm_id() {
    int s;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
    return s;
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
raster_exact_kernel(const int32_t* __restrict__ cell_start,
                    const int32_t* __restrict__ cell_groups,
                    const float4* __restrict__ coef,
                    int width, int height, int n_bx, int x0, int y0,
                    float* __restrict__ depth, int32_t* __restrict__ tid) {
    const int cell = blockIdx.x;
    const Pixel p = pixel_of<32>(cell, 0, n_bx, x0, y0);
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

template <bool PEEL>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
raster_keyed_kernel(const int32_t* __restrict__ cell_start,
                    const int32_t* __restrict__ cell_groups,
                    const float4* __restrict__ coef,
                    int width, int height, int n_bx, int x0, int y0,
                    const int32_t* __restrict__ floor_key,
                    const int32_t* __restrict__ ceil_key,
                    float* __restrict__ depth, int32_t* __restrict__ tid) {
    const int cell = blockIdx.x;
    Pixel p = pixel_of<32>(cell, 0, n_bx, x0, y0);
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
                  keep_key<PEEL>(zn, wn, id, fl, ce, kb, best);
              });
    if (in_image) {
        depth[o] = best >= 0 ? __int_as_float(kb) : INFINITY;
        tid[o] = best;
    }
}

// K4: one block of 8 x 32 threads for each 32-column quarter of an 8 x 128
// cell, its list prefiltered into `survivors` (the design above). PROBE:
// thread 0 writes the block's record to probe[8 * blockIdx.x ...]: SM id,
// %globaltimer at its start and end (ns), its clock64 cycles in all, in
// the prefilter rounds (to their barrier) and in the walks (to the barrier
// after them: the slowest warp's), its prefilter rounds and survivors.
template <bool PEEL, bool PROBE>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
raster_classic_kernel(const int32_t* __restrict__ cell_start,
                      const int32_t* __restrict__ cell_groups,
                      const float4* __restrict__ coef,
                      int width, int height, int n_bx, int x0, int y0,
                      const int32_t* __restrict__ floor_key,
                      const int32_t* __restrict__ ceil_key,
                      float* __restrict__ depth, int32_t* __restrict__ tid,
                      long long* __restrict__ probe) {
    __shared__ int32_t survivors[SURVIVORS];
    __shared__ Box boxes[WARPS];
    __shared__ int counts[2][WARPS];     // each warp's survivors, a round
    long long t_start = 0, c_start = 0, c_pre = 0, c_walk = 0, n_total = 0;
    if (PROBE) {
        t_start = globaltimer();
        c_start = clock64();
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int cell = blockIdx.x / QUARTERS;
    Pixel p = pixel_of<128>(cell, blockIdx.x % QUARTERS * 32, n_bx, x0, y0);
    const bool in_image = p.x >= 0 && p.y >= 0 && p.x < width && p.y < height;
    const int64_t o = (int64_t)p.y * width + p.x;
    const int begin = cell_start[cell], end = cell_start[cell + 1];
    int32_t fl = 0, ce = 0;
    if (PEEL && in_image) {
        fl = floor_key[o];
        ce = ceil_key[o];
    }
    int32_t kb = SENTINEL;
    int32_t best = -1;
    int rounds = 0;
    if (begin < end) {                               // block-uniform
        // a pixel that may take a candidate: in the image and, PEEL, with
        // some int32 key strictly inside its window (decided in 64 bits)
        const bool live = PEEL ? (int64_t)fl + 1 < (int64_t)ce : in_image;
        // the warp's footprint and the block's box narrow to the live pixels
        const Box wb = live_box(p, live);
        const bool warp_live = wb.xa <= wb.xb;
        if (warp_live) set_footprint(p, wb, x0, y0);
        if (lane == 0) boxes[warp] = wb;
        __syncthreads();
        Box bb = boxes[0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) {
            const Box b = boxes[w];
            bb = {min(bb.xa, b.xa), max(bb.xb, b.xb), min(bb.ya, b.ya),
                  max(bb.yb, b.yb)};
        }
        if (bb.xa <= bb.xb) {                // block-uniform: some pixel live
            Pixel q = p;                     // q's footprint: the block's box
            set_footprint(q, bb, x0, y0);
            constexpr int STEP = BLOCK / GROUP;      // groups a round
            // thread t: triangle t % 8 of the list's group pos + t / 8
            const int t8 = threadIdx.x / GROUP, c8 = threadIdx.x % GROUP;
            int pos = begin;
            int g_next = 0;                  // this thread's next group
            if (pos + t8 < end) g_next = __ldg(cell_groups + pos + t8);
            while (pos < end) {              // a chunk: block-uniform
                long long c0 = 0;
                if (PROBE) c0 = clock64();
                int n = 0;                   // ids in the buffer
                do {
                    const int k = pos + t8;
                    const int g = g_next;
                    if (k + STEP < end) g_next = __ldg(cell_groups + k + STEP);
                    int32_t id = 0;
                    bool may = false;
                    if (k < end) {
                        id = g * GROUP + c8;
                        float r[16];
                        load_row(coef + (int64_t)id * 4, r);
                        may = may_cover(r, q.x_lo, q.x_hi, q.y_lo, q.y_hi);
                    }
                    const unsigned m = __ballot_sync(FULL, may);
                    // double-buffered: a round's counts are read before the
                    // next round's barrier, written again after it
                    int* c = counts[rounds++ & 1];
                    if (lane == 0) c[warp] = __popc(m);
                    __syncthreads();
                    int before = 0, total = 0;
#pragma unroll
                    for (int w = 0; w < WARPS; ++w) {
                        const int v = c[w];
                        before += w < warp ? v : 0;
                        total += v;
                    }
                    if (may)
                        survivors[n + before + __popc(m & ((1u << lane) - 1))] = id;
                    n += total;
                    pos += STEP;
                } while (pos < end && n <= SURVIVORS - BLOCK);
                __syncthreads();             // the chunk's ids written
                long long c1 = 0;
                if (PROBE) c1 = clock64();
                if (warp_live) {
                    walk_ids(survivors, n, coef, p,
                             [&](float zn, float wn, int32_t id) {
                                 keep_key<PEEL>(zn, wn, id, fl, ce, kb, best);
                             });
                }
                __syncthreads();             // read before they are replaced
                if (PROBE) {
                    const long long c2 = clock64();
                    c_pre += c1 - c0;
                    c_walk += c2 - c1;
                    n_total += n;
                }
            }
        }
    }
    if (in_image) {
        depth[o] = best >= 0 ? __int_as_float(kb) : INFINITY;
        tid[o] = best;
    }
    if (PROBE && threadIdx.x == 0) {
        long long* r = probe + 8 * (int64_t)blockIdx.x;
        r[0] = sm_id();
        r[1] = t_start;
        r[2] = globaltimer();
        r[3] = clock64() - c_start;
        r[4] = c_pre;
        r[5] = c_walk;
        r[6] = rounds;
        r[7] = n_total;
    }
}

template <bool PEEL>
void launch_keyed(const void* cell_start, const void* cell_groups,
                  const void* coef, int width, int height, int n_bx,
                  int n_cells, int x0, int y0, const void* floor_key,
                  const void* ceil_key, void* depth, void* tid,
                  cudaStream_t stream) {
    raster_keyed_kernel<PEEL><<<n_cells, BLOCK, 0, stream>>>(
        (const int32_t*)cell_start, (const int32_t*)cell_groups,
        (const float4*)coef, width, height, n_bx, x0, y0,
        (const int32_t*)floor_key,
        (const int32_t*)ceil_key, (float*)depth, (int32_t*)tid);
}

template <bool PEEL, bool PROBE>
void launch_classic(const void* cell_start, const void* cell_groups,
                    const void* coef, int width, int height, int n_bx,
                    int n_cells, int x0, int y0, const void* floor_key,
                    const void* ceil_key, void* depth, void* tid, void* probe,
                    cudaStream_t stream) {
    raster_classic_kernel<PEEL, PROBE>
        <<<n_cells * QUARTERS, BLOCK, 0, stream>>>(
            (const int32_t*)cell_start, (const int32_t*)cell_groups,
            (const float4*)coef, width, height, n_bx, x0, y0,
            (const int32_t*)floor_key, (const int32_t*)ceil_key,
            (float*)depth, (int32_t*)tid, (long long*)probe);
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
        raster_exact_kernel<<<n_cells, BLOCK, 0, (cudaStream_t)stream>>>(
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
            launch_keyed<true>(cell_start, cell_groups, coef, width, height,
                               n_bx, n_cells, x0, y0, floor_key, ceil_key, depth, tid, s);
        else if (cell_w == 32)
            launch_keyed<false>(cell_start, cell_groups, coef, width, height,
                                n_bx, n_cells, x0, y0, nullptr, nullptr, depth, tid, s);
        else if (peel)
            launch_classic<true, false>(cell_start, cell_groups, coef, width, height,
                                        n_bx, n_cells, x0, y0, floor_key, ceil_key, depth,
                                        tid, nullptr, s);
        else
            launch_classic<false, false>(cell_start, cell_groups, coef, width, height,
                                         n_bx, n_cells, x0, y0, nullptr, nullptr, depth,
                                         tid, nullptr, s);
    }
    return (int)cudaGetLastError();
}

// K4's probe form: raster_keyed_launch with cell_w = 128, and each block's
// record in probe, i64[4 * n_cells, 8] (raster_classic_kernel's PROBE).
extern "C" int raster_classic_probe_launch(
        const void* cell_start, const void* cell_groups, const void* coef,
        int width, int height, int n_bx, int n_cells, int x0, int y0,
        const void* floor_key, const void* ceil_key, void* depth, void* tid,
        void* probe, void* stream) {
    if (n_cells > 0) {
        auto s = (cudaStream_t)stream;
        if (floor_key != nullptr)
            launch_classic<true, true>(cell_start, cell_groups, coef, width, height,
                                       n_bx, n_cells, x0, y0, floor_key, ceil_key, depth,
                                       tid, probe, s);
        else
            launch_classic<false, true>(cell_start, cell_groups, coef, width, height,
                                        n_bx, n_cells, x0, y0, nullptr, nullptr, depth,
                                        tid, probe, s);
    }
    return (int)cudaGetLastError();
}
