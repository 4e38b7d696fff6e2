"""Tile rasterizers of the draw-list frame: K5 and K6.

PyTorch counterpart of ``paperrenderer_tpu/ops/raster_pallas.py`` (named
after it). Same contract as ``ops.raster.rasterize``: the nearest covering
triangle per pixel, with perspective-correct barycentrics. Per frame:

  1. ``triangle_coefficients``, then ``tile_setup``: triangles sorted by the
     morton code of their screen-box centre (dead ones last), packed as
     triangle-major rows f32[T_pad, 16], and the screen box of every
     CHUNK = 128 consecutive sorted triangles (empty chunks get an inverted
     box that overlaps nothing);
  2. ``rasterize_chunks`` (K5): each 8 x 128 tile walks every chunk in
     ascending order and skips those whose box misses the tile; or
     ``tile_lists`` + ``rasterize_chunk_lists`` (K6): the overlapping
     (tile, chunk) pairs as one list per tile, built on the device, and the
     same walk over each tile's list only. Both evaluate a chunk's
     triangles in order with a strict ``<`` on the divided depth zn / wn, so
     K6's result is K5's, bit for bit. The kernels skip the triangles that
     ``tile_may_cover`` rules out for a warp's 16 x 8 pixels (exactly: no
     pixel of the footprint could accept them), and cut a tile's list into
     ordered ranges on separate blocks whose results fold in order;
  3. sorted ids map back to batch rows through the sort's permutation.

A CUDA tensor launches the kernels of ``csrc/raster_tiles.cu``; a CPU
tensor runs their plain PyTorch versions, ``rasterize_chunks_plain`` and
``rasterize_chunk_lists_plain``, which walk the same lists in the same
order with the same rounding.

The culling unit is part of the result: a sliver's f32 edge rows can accept
pixels outside its screen box, and only chunks whose box meets the tile are
evaluated. So the boxes are tested against whole 8 x 128 tiles, as the JAX
package does, also for the ragged right and bottom tiles of an image that
is not a multiple of 128 x 8 (the JAX package refuses such sizes; here
their pixels outside the image are masked).

Not ported: the TPU work list's SMEM paging, its seed entries and the state
aliased between pages, and ``work_capacity``: the list is sized exactly from
this frame's pair count (one device-to-host read), as
``ops.raster_exact`` sizes its pair buffers.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.cuda_build import load_library
from ..utils.tree import device_constant
from .bvh import morton_codes
from .raster import TriangleBatch, triangle_coefficients

TILE_H = 8
TILE_W = 128
CHUNK = 128      # triangles per chunk, of K5 and of K6 alike
WARP_FOOT = (16, 8)   # the pixels (columns, rows) of a kernel warp, whose
#                       triangles the kernels reject by ``tile_may_cover``
# The kernels cut each tile's chunk list into `split` ordered ranges (one
# block each) of at least RANGE_MIN chunks (the constant of
# csrc/raster_tiles.cu, mirrored here for the count of the ranges' lengths):
# SPLIT_MIN to SPLIT_MAX ranges, the more the fewer the tiles, so that a
# launch has about SPLIT_BLOCKS blocks.
SPLIT_MIN, SPLIT_MAX, SPLIT_BLOCKS = 2, 8, 2048
RANGE_MIN = 4
DEAD_CODE = 0xFFFFFFFF   # morton code of dead triangles: after every live one

# launches of each kernel wrapper, counted where the kernel is launched
LAUNCHES = {"raster_tiles": 0, "raster_tiles_binned": 0}


def tile_grid(width: int, height: int):
    """(n_tx, n_ty): the 8 x 128 tile grid covering a width x height image."""
    return -(-width // TILE_W), -(-height // TILE_H)


def _sort_by_screen_morton(coeffs, aabb_lo, aabb_hi, ok, width, height):
    """Sort triangles by the morton code of their screen-box centre so that
    chunks have tight screen boxes; a stable sort, dead triangles last.
    Returns (coeffs, perm, lo, hi) in sorted order."""
    center = (aabb_lo + aabb_hi) * 0.5
    c3 = torch.cat([center, torch.zeros_like(center[:, :1])], dim=-1)
    lo = device_constant((0.0, 0.0, 0.0), c3.device)
    hi = device_constant((float(width), float(height), 1.0), c3.device)
    codes = torch.where(ok, morton_codes(c3, lo, hi), DEAD_CODE)
    perm = torch.argsort(codes, stable=True)
    return coeffs[perm], perm, aabb_lo[perm], aabb_hi[perm]


class TileFrame(NamedTuple):
    """The tile kernels' inputs for one frame."""

    coef: torch.Tensor          # f32[T_pad, 16] rows (e0, e1, e2, zn, wn, 0)
    chunk_aabb: torch.Tensor    # f32[K, 4] (lo_x, lo_y, hi_x, hi_y) per chunk
    perm: Optional[torch.Tensor]  # i64[T] sorted row -> batch row (None:
    #                               presorted, rows are batch rows)


def tile_setup(coeffs, ok, lo, hi, width: int, height: int, *,
               presorted: bool = False) -> TileFrame:
    """Sort (unless ``presorted``), pack and box the output of
    ``triangle_coefficients`` for the tile kernels."""
    t = coeffs.shape[0]
    k = -(-t // CHUNK)
    t_pad = k * CHUNK
    perm = None
    if not presorted:
        coeffs, perm, lo, hi = _sort_by_screen_morton(coeffs, lo, hi, ok,
                                                      width, height)
        ok = ok[perm]
    coef = torch.nn.functional.pad(coeffs.reshape(t, 15), (0, 1, 0, t_pad - t))
    if t_pad > t:
        coef[t:, 2] = -1.0                   # padded rows never cover: e0 = -1
    inf = float("inf")
    chunk_lo = torch.nn.functional.pad(
        torch.where(ok[:, None], lo, inf), (0, 0, 0, t_pad - t), value=inf)
    chunk_hi = torch.nn.functional.pad(
        torch.where(ok[:, None], hi, -inf), (0, 0, 0, t_pad - t), value=-inf)
    cl = chunk_lo.reshape(k, CHUNK, 2).amin(dim=1)
    ch = chunk_hi.reshape(k, CHUNK, 2).amax(dim=1)
    chunk_aabb = torch.cat([torch.nan_to_num(cl, posinf=1e9),
                            torch.nan_to_num(ch, neginf=-1e9)], dim=-1)
    return TileFrame(coef.contiguous(), chunk_aabb.contiguous(), perm)


def tile_lists(chunk_aabb: torch.Tensor, width: int, height: int):
    """Every tile's overlapping chunks, ascending, as one list per tile:
    ``tile_start`` i32[n_tiles + 1] (tile i's chunks are
    ``tile_chunks[tile_start[i]:tile_start[i + 1]]``), ``tile_chunks``
    i32[n_pairs], and ``n_pairs`` — read from the device, the one
    device-to-host read of the list. The overlap test is the kernels':
    inclusive compares of the chunk box against the whole 8 x 128 tile."""
    n_tx, n_ty = tile_grid(width, height)
    n_tiles = n_tx * n_ty
    dev = chunk_aabb.device
    tiles = torch.arange(n_tiles, device=dev)
    tx0 = ((tiles % n_tx) * TILE_W).to(torch.float32)[:, None]
    ty0 = ((tiles // n_tx) * TILE_H).to(torch.float32)[:, None]
    lo_x, lo_y, hi_x, hi_y = (chunk_aabb[None, :, i] for i in range(4))
    ovl = ((lo_x <= tx0 + TILE_W) & (hi_x >= tx0)
           & (lo_y <= ty0 + TILE_H) & (hi_y >= ty0))        # [n_tiles, K]
    pairs = torch.nonzero(ovl)           # row-major: by tile, chunks ascending
    tile_start = torch.nn.functional.pad(
        torch.cumsum(ovl.sum(dim=1), 0), (1, 0)).to(torch.int32)
    return tile_start, pairs[:, 1].to(torch.int32).contiguous(), pairs.shape[0]


def rasterize_chunk_lists_plain(coef, tile_start, tile_chunks, width: int,
                                height: int):
    """Plain PyTorch version of the tile kernels (K5, K6).

    Walks list rank j = 0..max_len-1 and, within the chunk, triangles
    0..CHUNK-1, vectorised over the pixels of every tile whose list is
    longer than j (tiles are kept sorted by list length, so those are a
    prefix): every pixel sees its candidates in the kernels' order, with
    the same per-operation rounding and the same strict compare. Returns
    (depth f32[H, W], tid i32[H, W] sorted row ids, bary f32[H, W, 2])."""
    n_tx, n_ty = tile_grid(width, height)
    n_tiles = n_tx * n_ty
    dev = coef.device
    lens = (tile_start[1:] - tile_start[:-1]).long()
    lens, order = torch.sort(lens, descending=True, stable=True)
    starts = tile_start[:-1].long()[order]
    host_lens = lens.cpu().numpy()
    max_len = int(host_lens[0]) if n_tiles else 0
    # active[j]: number of tiles whose list is longer than j
    active = np.searchsorted(-host_lens, -np.arange(max_len), side="left")

    lane = torch.arange(TILE_H * TILE_W, device=dev)
    px = ((order % n_tx)[:, None] * TILE_W + lane % TILE_W).float() + 0.5
    py = ((order // n_tx)[:, None] * TILE_H + lane // TILE_W).float() + 0.5
    depth = torch.full(px.shape, float("inf"), device=dev)
    tid = torch.full(px.shape, -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros_like(px)
    b2 = torch.zeros_like(px)
    rows = coef.reshape(-1, CHUNK, 16)
    for j in range(max_len):
        a = int(active[j])
        chunk = tile_chunks[starts[:a] + j].long()
        crows = rows[chunk]                                  # [a, CHUNK, 16]
        pxa, pya = px[:a], py[:a]
        da, ta, b1a, b2a = depth[:a], tid[:a], b1[:a], b2[:a]
        for c in range(CHUNK):
            r = crows[:, c]
            col = lambda i: r[:, i:i + 1]
            e0 = pxa * col(0) + pya * col(1) + col(2)
            e1 = pxa * col(3) + pya * col(4) + col(5)
            e2 = pxa * col(6) + pya * col(7) + col(8)
            zn = pxa * col(9) + pya * col(10) + col(11)
            wn = pxa * col(12) + pya * col(13) + col(14)
            inside = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
                      & (wn > 1e-12) & (zn >= 0.0))
            z = zn / torch.where(inside, wn, 1.0)
            win = inside & (z < da)
            esum = torch.clamp(e0 + e1 + e2, min=1e-30)
            da = torch.where(win, z, da)
            ta = torch.where(win, (chunk * CHUNK + c).to(torch.int32)[:, None], ta)
            b1a = torch.where(win, e1 / esum, b1a)
            b2a = torch.where(win, e2 / esum, b2a)
        depth[:a], tid[:a], b1[:a], b2[:a] = da, ta, b1a, b2a

    def image(v):  # [n_tiles, 1024] in sorted tile order -> [H, W]
        v = torch.empty_like(v).index_copy_(0, order, v)
        v = v.reshape(n_ty, n_tx, TILE_H, TILE_W).permute(0, 2, 1, 3)
        return v.reshape(n_ty * TILE_H, n_tx * TILE_W)[:height, :width]

    return (image(depth).contiguous(), image(tid).contiguous(),
            torch.stack([image(b1), image(b2)], dim=-1))


def rasterize_chunks_plain(coef, chunk_aabb, width: int, height: int):
    """Plain PyTorch version of K5: the chunks whose box meets each tile, in
    ascending order, walked as ``rasterize_chunk_lists_plain`` walks them."""
    tile_start, tile_chunks, _ = tile_lists(chunk_aabb, width, height)
    return rasterize_chunk_lists_plain(coef, tile_start, tile_chunks, width,
                                       height)


def tile_may_cover(rows, x_lo, x_hi, y_lo, y_hi):
    """The tile kernels' exact triangle rejection, in plain PyTorch: False
    where coefficient row ``rows[..., :15]`` accepts no pixel centre of the
    footprint of pixel columns ``x_lo..x_hi`` and rows ``y_lo..y_hi``
    (inclusive integer bounds; tensors broadcast against ``rows[..., 0]``).

    Each plane is evaluated at one corner of the footprint's pixel centres,
    x at the high end where its x coefficient is >= 0 and at the low end
    otherwise, y likewise, with the kernels' rounding ((px * c0 + py * c1) +
    c2, each operation rounded). Round-to-nearest is monotone, so no pixel
    of the footprint computes a larger value: a corner with e0, e1, e2 or zn
    < 0, or wn <= 1e-12, rules out every pixel. A NaN corner keeps the row.
    The kernels skip the rows this rejects; nothing else calls it."""
    def centre(i):
        return torch.as_tensor(i, device=rows.device).to(torch.float32) + 0.5

    xs, ys = (centre(x_lo), centre(x_hi)), (centre(y_lo), centre(y_hi))

    def corner(i):
        c0, c1, c2 = rows[..., i], rows[..., i + 1], rows[..., i + 2]
        px = torch.where(c0 >= 0.0, xs[1], xs[0])
        py = torch.where(c1 >= 0.0, ys[1], ys[0])
        return px * c0 + py * c1 + c2

    e0, e1, e2, zn, wn = (corner(i) for i in (0, 3, 6, 9, 12))
    return ~((e0 < 0.0) | (e1 < 0.0) | (e2 < 0.0) | (zn < 0.0)
             | (wn <= 1e-12))


_LIB = []


def _lib():
    """The built ``csrc/raster_tiles.cu`` with its C signatures declared."""
    if not _LIB:
        lib = load_library("raster_tiles")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.raster_tiles_launch.argtypes = [P, P, I, I, I, I, P, P, P, P, P,
                                            P, P]
        lib.raster_tiles_list_launch.argtypes = [P, P, P, I, I, I, P, P, P,
                                                 P, P, P, P]
        lib.raster_tiles_launch.restype = I
        lib.raster_tiles_list_launch.restype = I
        _LIB.append(lib)
    return _LIB[0]


def split_ranges(n_tiles: int) -> int:
    """The ranges the kernels cut each tile's list into, for n_tiles."""
    return min(SPLIT_MAX, max(SPLIT_MIN, -(-SPLIT_BLOCKS // max(n_tiles, 1))))


def _launch(name, coef, planes, width, height, call):
    """Checks the inputs, allocates the outputs and the split ranges'
    scratch, and launches ``call(lib, split, depth, tid, bary, part_z,
    part_tid, tile_len, stream)`` (pointers)."""
    for what, t, dtype in [("coef", coef, torch.float32)] + planes:
        if t.device != coef.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} "
                             f"tensor on {coef.device}")
    if coef.dim() != 2 or coef.shape[1] != 16 or coef.shape[0] % CHUNK:
        raise ValueError(f"{name}: coef must be [{CHUNK}k, 16], "
                         f"got {tuple(coef.shape)}")
    dev = coef.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    bary = torch.empty((height, width, 2), dtype=torch.float32, device=dev)
    n_tx, n_ty = tile_grid(width, height)
    split = split_ranges(n_tx * n_ty)
    parts = n_tx * n_ty * (split - 1) * TILE_H * TILE_W
    # one allocation: part_z f32[parts], part_tid i32[parts], tile_len
    scratch = torch.empty(2 * parts + n_tx * n_ty, dtype=torch.int32,
                          device=dev)
    ptr = scratch.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = call(_lib(), split, depth.data_ptr(), tid.data_ptr(),
              bary.data_ptr(), ptr, ptr + 4 * parts, ptr + 8 * parts, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return depth, tid, bary


def rasterize_chunks(coef, chunk_aabb, width: int, height: int):
    """K5: nearest covering triangle per pixel over all chunks.

    ``coef`` f32[T_pad, 16] and ``chunk_aabb`` f32[T_pad / 128, 4] from
    ``tile_setup``. Returns (depth f32[H, W], +inf where empty; tid i32[H, W]
    coefficient-row ids, -1 where empty; bary f32[H, W, 2]). A CUDA tensor
    launches the kernel of ``csrc/raster_tiles.cu`` (after a count of each
    tile's list, before the merge of the split ranges); a CPU tensor runs
    ``rasterize_chunks_plain``."""
    if coef.device.type == "cpu":
        return rasterize_chunks_plain(coef, chunk_aabb, width, height)
    if coef.device.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {coef.device}")
    if chunk_aabb.shape != (coef.shape[0] // CHUNK, 4):
        raise ValueError("raster_tiles: chunk_aabb must be [T_pad / 128, 4]")
    return _launch(
        "raster_tiles", coef, [("chunk_aabb", chunk_aabb, torch.float32)],
        width, height,
        lambda lib, *out: lib.raster_tiles_launch(
            coef.data_ptr(), chunk_aabb.data_ptr(), chunk_aabb.shape[0],
            width, height, *out))


def rasterize_chunk_lists(coef, tile_start, tile_chunks, width: int,
                          height: int):
    """K6: ``rasterize_chunks`` over each tile's chunk list from
    ``tile_lists``; the same returns. A CUDA tensor launches the kernel of
    ``csrc/raster_tiles.cu``; a CPU tensor runs
    ``rasterize_chunk_lists_plain``."""
    if coef.device.type == "cpu":
        return rasterize_chunk_lists_plain(coef, tile_start, tile_chunks,
                                           width, height)
    if coef.device.type != "cuda":
        raise ValueError(f"raster_tiles_binned: unsupported device {coef.device}")
    n_tx, n_ty = tile_grid(width, height)
    if tile_start.shape != (n_tx * n_ty + 1,):
        raise ValueError("raster_tiles_binned: tile_start does not match the "
                         "tile grid")
    return _launch(
        "raster_tiles_binned", coef,
        [("tile_start", tile_start, torch.int32),
         ("tile_chunks", tile_chunks, torch.int32)],
        width, height,
        lambda lib, *out: lib.raster_tiles_list_launch(
            coef.data_ptr(), tile_start.data_ptr(), tile_chunks.data_ptr(),
            width, height, *out))


def _batch_ids(tid, perm, t):
    """Sorted row ids -> batch rows (-1 stays -1)."""
    miss = tid < 0
    row = torch.clamp(tid, 0, t - 1).long()
    if perm is not None:
        row = perm[row]
    return torch.where(miss, -1, row.to(torch.int32))


def rasterize_tiles(batch: TriangleBatch, width: int, height: int):
    """The tile rasterizer (K5); returns (depth f32[H, W], tid i32[H, W]
    batch rows, bary f32[H, W, 2]) like ``ops.raster.rasterize``."""
    coeffs, ok, (lo, hi) = triangle_coefficients(batch, width, height)
    f = tile_setup(coeffs, ok, lo, hi, width, height)
    depth, tid, bary = rasterize_chunks(f.coef, f.chunk_aabb, width, height)
    return depth, _batch_ids(tid, f.perm, batch.capacity), bary


def rasterize_tiles_binned(batch: TriangleBatch, width: int, height: int, *,
                           presorted: bool = False):
    """The work-list tile rasterizer (K6): only each tile's overlapping
    chunks are visited. Returns (depth, tid, bary, required) with
    ``required`` = n_tiles + the (tile, chunk) pair count, the JAX
    package's work-list demand. ``presorted``: the batch is already
    spatially coherent; the screen-morton sort is skipped and ids are batch
    rows as they are."""
    coeffs, ok, (lo, hi) = triangle_coefficients(batch, width, height)
    f = tile_setup(coeffs, ok, lo, hi, width, height, presorted=presorted)
    tile_start, tile_chunks, n_pairs = tile_lists(f.chunk_aabb, width, height)
    depth, tid, bary = rasterize_chunk_lists(f.coef, tile_start, tile_chunks,
                                             width, height)
    required = tile_start.shape[0] - 1 + n_pairs
    return depth, _batch_ids(tid, f.perm, batch.capacity), bary, required
