// The raster kernels' shared row arithmetic: one coefficient row into
// registers, a plane in the kernels' rounding, and the exact per-warp
// triangle rejection. Included by raster_exact.cu (K1-K4) and
// raster_tiles.cu (K5/K6); utils/cuda_build.py hashes this header into both
// builds. The plain form of may_cover is raster_pallas.tile_may_cover.

#pragma once

#include <cuda_runtime.h>

namespace {

// one coefficient row (e0, e1, e2, zn, wn planes and a pad) into registers
__device__ __forceinline__ void load_row(const float4* p, float (&r)[16]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float4 q = __ldg(p + i);
        r[4 * i] = q.x;
        r[4 * i + 1] = q.y;
        r[4 * i + 2] = q.z;
        r[4 * i + 3] = q.w;
    }
}

// (px * c[0] + py * c[1]) + c[2], with px * c[0] given as xa.
__device__ __forceinline__ float plane(float xa, const float* c, float py) {
    return __fadd_rn(__fadd_rn(xa, __fmul_rn(py, c[1])), c[2]);
}

// The plane's largest value over a footprint's pixel centres, in the
// kernel's own rounding: round-to-nearest is monotone, so each product is
// largest at the end its coefficient's sign picks, and so is each sum. A NaN
// corner compares false below and keeps the triangle.
__device__ __forceinline__ float corner(const float* c, float x_lo, float x_hi,
                                        float y_lo, float y_hi) {
    const float x = c[0] >= 0.0f ? x_hi : x_lo;
    const float y = c[1] >= 0.0f ? y_hi : y_lo;
    return plane(__fmul_rn(x, c[0]), c, y);
}

// false only when no pixel centre of the footprint accepts the row
__device__ __forceinline__ bool may_cover(const float (&r)[16], float x_lo,
                                          float x_hi, float y_lo, float y_hi) {
    return !(corner(r + 0, x_lo, x_hi, y_lo, y_hi) < 0.0f
             || corner(r + 3, x_lo, x_hi, y_lo, y_hi) < 0.0f
             || corner(r + 6, x_lo, x_hi, y_lo, y_hi) < 0.0f
             || corner(r + 9, x_lo, x_hi, y_lo, y_hi) < 0.0f
             || corner(r + 12, x_lo, x_hi, y_lo, y_hi) <= 1e-12f);
}

}  // namespace
