"""Triangle-exact binned rasterizer: binning, the kernel wrapper and its
plain PyTorch version, and the pair-space G-buffer resolve.

PyTorch counterpart of ``paperrenderer_tpu/ops/raster_exact.py`` on its
default path (quarter kernel, cross-multiplied depth). Per frame:

  1. ``triangle_coefficients`` -> packed per-triangle rows (``pack_attr_coef``);
  2. ``bin_groups``: the screen AABB of each 8-triangle group -> its span of
     8x32-pixel cells (``_bin_spans``); one (group, cell) pair per covered
     cell, expanded with ``repeat_interleave`` and ordered by ONE stable sort
     on the cell, so every cell's list is in ascending group order;
  3. ``rasterize_bins``: the nearest covering triangle per pixel — the CUDA
     kernel ``csrc/raster_exact.cu`` on a CUDA tensor, the plain version on
     a CPU tensor;
  4. ``resolve_gbuffer_pairs``: one packed row gather per pixel.

Capacity: eager PyTorch has dynamic shapes, so the pair buffers are sized
exactly from this frame's pair count — one host read per frame
(``int(ends[-1])`` in ``bin_groups``). The JAX package's static-shape
capacity tiers, demand probe and in-graph 4x overflow branch have no
counterpart here; ``required`` still reports the pair count.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.cuda_build import load_library
from .raster import GBuffer, TriangleBatch, triangle_coefficients

GROUP = 8      # triangles per bin entry
CELL_H = 8     # bin cell = one kernel block = 8 x 32 pixels
CELL_W = 32
ROW = 32       # packed row: 15 coef + global id + 9 normal + 6 uv + material

# launches of each kernel wrapper, counted where the kernel is launched
LAUNCHES = {"raster_exact": 0}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def grid_cells(width: int, height: int) -> Tuple[int, int]:
    """(n_bx, n_by): the 8x32 bin-cell grid covering a width x height image
    (ragged right/bottom cells are masked by the rasterizers)."""
    return -(-width // CELL_W), -(-height // CELL_H)


def pack_attr_coef(batch: TriangleBatch, coeffs: torch.Tensor) -> torch.Tensor:
    """Per-triangle raster coefficients + shading attributes as f32[T, 32]:
    [0:15] edge/z/w rows, [15] zero (pads the kernel's 16-float rows; the
    triangle id is the row index), [16:25] vertex normals, [25:31] vertex
    uvs, [31] material id."""
    t = batch.capacity
    return torch.cat(
        [
            coeffs.reshape(t, 15),
            coeffs.new_zeros((t, 1)),
            batch.normal.reshape(t, 9),
            batch.uv.reshape(t, 6),
            batch.material.to(torch.float32)[:, None],
        ],
        dim=-1,
    )


def _bin_spans(ok, lo, hi, t_pad, width, height):
    """Group screen AABBs -> inclusive bin-cell spans. Returns (gx0, gx1,
    gy0, gy1, count) over GROUP-packed triangles; ``count`` is the group's
    pair count (0 for a dead group or one whose AABB misses the image)."""
    n_bx, n_by = grid_cells(width, height)
    t = ok.shape[0]
    lo_m = torch.where(ok[:, None], lo, float("inf"))
    hi_m = torch.where(ok[:, None], hi, float("-inf"))
    lo_m = torch.nn.functional.pad(lo_m, (0, 0, 0, t_pad - t), value=float("inf"))
    hi_m = torch.nn.functional.pad(hi_m, (0, 0, 0, t_pad - t), value=float("-inf"))
    glo = lo_m.reshape(-1, GROUP, 2).amin(dim=1)
    ghi = hi_m.reshape(-1, GROUP, 2).amax(dim=1)
    alive = torch.isfinite(glo[:, 0])
    glo = torch.nan_to_num(glo, posinf=0.0)
    ghi = torch.nan_to_num(ghi, neginf=0.0)
    # cull groups whose AABB misses the image entirely
    alive &= ((ghi[:, 0] >= 0.0) & (glo[:, 0] <= width)
              & (ghi[:, 1] >= 0.0) & (glo[:, 1] <= height))

    def cell_of(v, size, n):
        # clamp in float before the int cast: far-off AABBs reach ~1e30
        return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int64)

    gx0 = cell_of(glo[:, 0], CELL_W, n_bx)
    gx1 = torch.maximum(cell_of(ghi[:, 0], CELL_W, n_bx), gx0)
    gy0 = cell_of(glo[:, 1], CELL_H, n_by)
    gy1 = torch.maximum(cell_of(ghi[:, 1], CELL_H, n_by), gy0)
    count = torch.where(alive, (gx1 - gx0 + 1) * (gy1 - gy0 + 1), 0)
    return gx0, gx1, gy0, gy1, count


def bin_groups(ok, lo, hi, t_pad: int, width: int, height: int,
               n_pairs: Optional[int] = None):
    """(group, cell) pairs sorted by cell.

    Returns ``cell_start`` i32[n_cells + 1] (cell c's list is
    ``cell_groups[cell_start[c]:cell_start[c + 1]]``), ``cell_groups``
    i32[n_pairs] in ascending group order within each cell, and ``n_pairs``
    — read from the device (the frame's one device-to-host read) unless the
    caller passes the count it already knows, e.g. for an unchanged frame."""
    n_bx, n_by = grid_cells(width, height)
    n_cells = n_bx * n_by
    dev = lo.device
    gx0, gx1, gy0, gy1, count = _bin_spans(ok, lo, hi, t_pad, width, height)
    ends = torch.cumsum(count, 0)
    if n_pairs is None:
        n_pairs = int(ends[-1]) if ends.numel() else 0
    offsets = ends - count                                    # exclusive
    ng = count.shape[0]
    pg = torch.repeat_interleave(
        torch.arange(ng, device=dev), count, output_size=n_pairs)
    within = torch.arange(n_pairs, device=dev) - offsets[pg]
    spanw = (gx1 - gx0 + 1)[pg]
    cell = (gy0[pg] + within // spanw) * n_bx + gx0[pg] + within % spanw
    # pairs are generated in ascending group order, so a STABLE sort by cell
    # leaves every cell's list in ascending group order (the tie rule)
    cell_sorted, perm = torch.sort(cell, stable=True)
    cell_groups = pg[perm].to(torch.int32)
    cell_start = torch.searchsorted(
        cell_sorted, torch.arange(n_cells + 1, device=dev)).to(torch.int32)
    return cell_start, cell_groups, n_pairs


def rasterize_bins_plain(cell_start, cell_groups, coef, width: int,
                         height: int):
    """Plain PyTorch version of the ``raster_exact`` kernel.

    Walks list rank k = 0..max_len-1 and, within each group, triangles
    0..7, vectorised over the pixels of every cell whose list is longer
    than k (cells are kept sorted by list length, so those are a prefix);
    every pixel sees its candidates in the kernel's order, with the same
    per-operation rounding and the same strict cross-multiplied compare.
    Returns (depth f32[H, W], tid i32[H, W])."""
    n_bx, n_by = grid_cells(width, height)
    n_cells = n_bx * n_by
    dev = coef.device
    counts = (cell_start[1:] - cell_start[:-1]).long()
    counts, order = torch.sort(counts, descending=True, stable=True)
    starts = cell_start[:-1].long()[order]
    # active[k]: number of cells whose list is longer than k
    host_counts = counts.cpu().numpy()
    max_len = int(host_counts[0]) if n_cells else 0
    active = np.searchsorted(-host_counts, -np.arange(max_len), side="left")
    lane = torch.arange(CELL_W * CELL_H, device=dev)
    px = ((order % n_bx)[:, None] * CELL_W + lane % CELL_W).float() + 0.5
    py = ((order // n_bx)[:, None] * CELL_H + lane // CELL_W).float() + 0.5
    zb = torch.ones_like(px)
    wb = torch.zeros_like(px)
    best = torch.full(px.shape, -1, dtype=torch.int32, device=dev)
    rows = coef.reshape(-1, GROUP, 16)
    for k in range(max_len):
        a = int(active[k])
        g = cell_groups[starts[:a] + k].long()
        grows = rows[g]                                      # [a, 8, 16]
        pxa, pya = px[:a], py[:a]
        zba, wba, besta = zb[:a], wb[:a], best[:a]
        for c in range(GROUP):
            r = grows[:, c]
            col = lambda i: r[:, i:i + 1]
            e0 = col(0) * pxa + col(1) * pya + col(2)
            e1 = col(3) * pxa + col(4) * pya + col(5)
            e2 = col(6) * pxa + col(7) * pya + col(8)
            zn = col(9) * pxa + col(10) * pya + col(11)
            wn = col(12) * pxa + col(13) * pya + col(14)
            accept = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
                      & (wn > 1e-12) & (zn >= 0.0))
            win = accept & (zn * wba < zba * wn)
            zba = torch.where(win, zn, zba)
            wba = torch.where(win, wn, wba)
            besta = torch.where(win, (g * GROUP + c).to(torch.int32)[:, None],
                                besta)
        zb[:a], wb[:a], best[:a] = zba, wba, besta
    depth = torch.where(best >= 0, zb / torch.clamp(wb, min=1e-30),
                        torch.full_like(zb, float("inf")))

    def image(v):  # [n_cells, 256] in sorted cell order -> [H, W]
        v = torch.empty_like(v).index_copy_(0, order, v)
        v = v.reshape(n_by, n_bx, CELL_H, CELL_W).permute(0, 2, 1, 3)
        return v.reshape(n_by * CELL_H, n_bx * CELL_W)[:height, :width]

    return image(depth).contiguous(), image(best).contiguous()


def _launch_kernel(cell_start, cell_groups, coef, width, height):
    for name, t, dtype in (("cell_start", cell_start, torch.int32),
                           ("cell_groups", cell_groups, torch.int32),
                           ("coef", coef, torch.float32)):
        if t.device != coef.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"raster_exact: {name} must be a contiguous "
                             f"{dtype} tensor on {coef.device}")
    n_bx, n_by = grid_cells(width, height)
    if coef.dim() != 2 or coef.shape[1] != 16 or coef.shape[0] % GROUP:
        raise ValueError(f"raster_exact: coef must be [8k, 16], got {tuple(coef.shape)}")
    if cell_start.shape != (n_bx * n_by + 1,):
        raise ValueError("raster_exact: cell_start does not match the image grid")
    lib = load_library("raster_exact")
    fn = lib.raster_exact_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    depth = torch.empty((height, width), dtype=torch.float32, device=coef.device)
    tid = torch.empty((height, width), dtype=torch.int32, device=coef.device)
    stream = torch.cuda.current_stream(coef.device).cuda_stream
    rc = fn(cell_start.data_ptr(), cell_groups.data_ptr(), coef.data_ptr(),
            width, height, n_bx, n_bx * n_by, depth.data_ptr(), tid.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"raster_exact kernel launch failed: CUDA error {rc}")
    LAUNCHES["raster_exact"] += 1
    return depth, tid


def rasterize_bins(cell_start, cell_groups, coef, width: int, height: int):
    """Nearest covering triangle per pixel over binned groups.

    ``coef`` f32[T_pad, 16]: rows of (e0, e1, e2, zn, wn) coefficients;
    ``cell_start``/``cell_groups`` from ``bin_groups``. Returns (depth
    f32[H, W], +inf where empty; tid i32[H, W], global triangle id, -1 where
    empty). A CUDA tensor launches ``csrc/raster_exact.cu``; a CPU tensor
    runs ``rasterize_bins_plain``."""
    if coef.device.type == "cuda":
        return _launch_kernel(cell_start, cell_groups, coef, width, height)
    if coef.device.type == "cpu":
        return rasterize_bins_plain(cell_start, cell_groups, coef, width, height)
    raise ValueError(f"raster_exact: unsupported device {coef.device}")


class BinnedFrame(NamedTuple):
    """Everything ``rasterize_bins`` needs for one frame."""

    table: torch.Tensor        # f32[T_pad, 32] packed rows (pack_attr_coef)
    coef: torch.Tensor         # f32[T_pad, 16] the rows' coefficient part
    cell_start: torch.Tensor   # i32[n_cells + 1]
    cell_groups: torch.Tensor  # i32[n_pairs]
    n_pairs: int


def bin_triangles(batch: TriangleBatch, width: int, height: int) -> BinnedFrame:
    """Triangle setup + binning: the raster kernel's inputs for ``batch``."""
    coeffs, ok, (lo, hi) = triangle_coefficients(batch, width, height)
    t = batch.capacity
    t_pad = _round_up(t, GROUP)
    table = pack_attr_coef(batch, coeffs)
    if t_pad > t:
        pad = table.new_zeros((t_pad - t, ROW))
        pad[:, 2] = -1.0                                  # dead: e0 < 0
        table = torch.cat([table, pad])
    cell_start, cell_groups, n_pairs = bin_groups(ok, lo, hi, t_pad, width,
                                                  height)
    return BinnedFrame(table, table[:, :16].contiguous(), cell_start,
                       cell_groups, n_pairs)


def rasterize_exact(batch: TriangleBatch, width: int, height: int):
    """Exact-binned raster. Returns (depth f32[H,W], tid i32[H,W] global
    triangle ids, attr_table f32[T_pad, 32], required int — this frame's
    (group, cell) pair count)."""
    b = bin_triangles(batch, width, height)
    depth, tid = rasterize_bins(b.cell_start, b.cell_groups, b.coef, width,
                                height)
    return depth, tid, b.table, b.n_pairs


def resolve_gbuffer_pairs(attr_table, depth, tri_id, camera) -> GBuffer:
    """G-buffer resolve: one packed row gather per pixel; barycentrics are
    recomputed from the row's edge coefficients and the world position is
    unprojected from (pixel, depth)."""
    h, w = depth.shape
    dev = depth.device
    covered = (tri_id >= 0).reshape(-1)
    rows = attr_table[torch.clamp(tri_id, min=0).reshape(-1).long()]  # [P, 32]

    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    px = xs[None, :].expand(h, w).reshape(-1)
    py = ys[:, None].expand(h, w).reshape(-1)
    e0 = rows[:, 0] * px + rows[:, 1] * py + rows[:, 2]
    e1 = rows[:, 3] * px + rows[:, 4] * py + rows[:, 5]
    e2 = rows[:, 6] * px + rows[:, 7] * py + rows[:, 8]
    esum = torch.clamp(e0 + e1 + e2, min=1e-30)
    b1 = e1 / esum
    b2 = e2 / esum
    b0 = 1.0 - b1 - b2

    inv_vp = camera.inverse_view_proj
    ndc_x = px / w * 2.0 - 1.0
    ndc_y = 1.0 - py / h * 2.0
    z = torch.where(covered, depth.reshape(-1), 0.0)
    cols = [inv_vp[i, 0] * ndc_x + inv_vp[i, 1] * ndc_y + inv_vp[i, 2] * z
            + inv_vp[i, 3] for i in range(4)]
    inv_w = 1.0 / torch.where(cols[3].abs() < 1e-12, 1e-12, cols[3])
    world = torch.stack([cols[0] * inv_w, cols[1] * inv_w, cols[2] * inv_w],
                        dim=-1)

    n = (b0[:, None] * rows[:, 16:19] + b1[:, None] * rows[:, 19:22]
         + b2[:, None] * rows[:, 22:25])
    normal = n / torch.clamp(
        torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    uv = (b0[:, None] * rows[:, 25:27] + b1[:, None] * rows[:, 27:29]
          + b2[:, None] * rows[:, 29:31])
    material = torch.where(covered, rows[:, 31].to(torch.int32), 0)
    cov = covered[:, None]
    return GBuffer(
        depth=depth,
        tri_id=tri_id,
        world_pos=torch.where(cov, world, 0.0).reshape(h, w, 3),
        normal=torch.where(cov, normal, 0.0).reshape(h, w, 3),
        uv=torch.where(cov, uv, 0.0).reshape(h, w, 2),
        material=material.reshape(h, w),
    )
