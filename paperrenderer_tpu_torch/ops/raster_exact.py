"""Triangle-exact binned rasterizer: binning, the kernel wrappers and their
plain PyTorch version, and the pair-space G-buffer resolve.

PyTorch counterpart of ``paperrenderer_tpu/ops/raster_exact.py``. Per frame:

  1. ``triangle_coefficients`` -> packed per-triangle rows (``pack_attr_coef``);
  2. ``bin_groups``: the screen AABB of each 8-triangle group -> its span of
     8 x ``cell_w``-pixel cells (``_bin_spans``); one (group, cell) pair per
     covered cell, expanded with ``repeat_interleave`` and ordered by ONE
     stable sort on the cell, so every cell's list is in ascending group
     order;
  3. ``rasterize_bins``: the nearest covering triangle per pixel — a CUDA
     kernel of ``csrc/raster_exact.cu`` on a CUDA tensor, the plain version
     on a CPU tensor;
  4. ``resolve_gbuffer_pairs``: one packed row gather per pixel.

Two depth schemes, as in the JAX package. The default opaque path (its
quarter kernel with ``crossz``) carries the exact (zn, wn) pair and compares
by cross-multiplication: kernel K1 on 8x32 cells. The KEYED scheme compares
quantized depth keys, ``bits(zn / wn) & KEY_MASK``, and returns the
quantized depth: K3 (8x32 cells, ``crossz=False``), K4 (8x128 cells, the
classic ``quarter=False`` kernel) and K2, K3 inside a per-pixel (floor,
ceil) key window (``depth_window``, the depth peel of sorted translucency).

Screen-tile windows (``parallel/tiles.py``): ``full_width``/``full_height``
and ``origin`` = (x0, y0) render a width x height window of a larger
viewport. The coefficients stay in full-viewport pixel space, so every edge
test is bitwise the single-device run's; the kernels add the origin to
their pixel and footprint coordinates in integers before the float
conversion, as the JAX kernels do. A window's bin cells are the
viewport's own cells that meet it (its grid starts at the cell holding the
origin), with the viewport's lists: every pixel then meets the same
candidates in the same order as in the single-device run, sliver strays
included, at any origin. On a cell-aligned window (all of the JAX
package's, whose windows are 128 x 8 multiples) this is the JAX package's
window-space binning. Origin (0, 0) is the whole image.

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
CELL_H = 8     # bin cell = one kernel block = 8 x CELL_W pixels
CELL_W = 32    # the quarter kernels' cell width (K1, K2, K3)
TILE_W = 128   # the classic kernel's cell width (K4)
ROW = 32       # packed row: 15 coef + global id + 9 normal + 6 uv + material
WARP_FOOT = (8, 4)   # the pixels (columns, rows) of a kernel warp, whose
#                      triangles the kernels reject by
#                      ``raster_pallas.tile_may_cover`` (csrc/raster_exact.cu
#                      FOOT_W); the 8 x 32 cell holds 8 of them
# Depth keys: accepted depths are nonnegative, so their f32 bits sort
# directly as int32; the key drops the low 7 mantissa bits (the TPU kernels
# carried a 128-lane id there). SENTINEL = int32 max never wins a min.
SENTINEL = 0x7FFFFFFF
KEY_MASK = ~(128 - 1)

# launches of each kernel wrapper, counted where the kernel is launched
LAUNCHES = {"raster_exact": 0, "raster_peel": 0, "raster_keyed": 0,
            "raster_classic": 0}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def grid_cells(width: int, height: int, cell_w: int = CELL_W,
               origin=(0, 0)) -> Tuple[int, int]:
    """(n_bx, n_by): the 8 x ``cell_w`` bin-cell grid covering a width x
    height image, or the viewport's cells that meet the width x height
    window at ``origin`` (ragged cells are masked by the rasterizers)."""
    ax, ay = origin[0] % cell_w, origin[1] % CELL_H
    return -(-(width + ax) // cell_w), -(-(height + ay) // CELL_H)


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


def _bin_spans(ok, lo, hi, t_pad, width, height, cell_w, window=None):
    """Group screen AABBs -> inclusive bin-cell spans over the width x height
    image. Returns (gx0, gx1, gy0, gy1, count) over GROUP-packed triangles;
    ``count`` is the group's pair count (0 for a dead group or one whose
    AABB misses the image). ``window`` = (x0, y0, w, h) keeps the cells
    that meet that window, numbered in its grid (``grid_cells`` at the
    window's origin)."""
    n_bx, n_by = grid_cells(width, height, cell_w)
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

    gx0 = cell_of(glo[:, 0], cell_w, n_bx)
    gx1 = torch.maximum(cell_of(ghi[:, 0], cell_w, n_bx), gx0)
    gy0 = cell_of(glo[:, 1], CELL_H, n_by)
    gy1 = torch.maximum(cell_of(ghi[:, 1], CELL_H, n_by), gy0)
    if window is not None:       # the window's cells, in its own grid
        x0, y0, w, h = window
        cx0, cy0 = x0 // cell_w, y0 // CELL_H
        cx1, cy1 = (x0 + w - 1) // cell_w, (y0 + h - 1) // CELL_H
        gx0, gx1 = torch.clamp(gx0, min=cx0) - cx0, torch.clamp(gx1, max=cx1) - cx0
        gy0, gy1 = torch.clamp(gy0, min=cy0) - cy0, torch.clamp(gy1, max=cy1) - cy0
        alive &= (gx0 <= gx1) & (gy0 <= gy1)
    count = torch.where(alive, (gx1 - gx0 + 1) * (gy1 - gy0 + 1), 0)
    return gx0, gx1, gy0, gy1, count


def bin_groups(ok, lo, hi, t_pad: int, width: int, height: int,
               n_pairs: Optional[int] = None, cell_w: int = CELL_W, *,
               full_width: Optional[int] = None,
               full_height: Optional[int] = None, origin=(0, 0)):
    """(group, cell) pairs sorted by cell, over 8 x ``cell_w`` cells of the
    width x height image, or of the window at ``origin`` of the
    full_width x full_height viewport (``lo``/``hi`` in viewport pixels):
    the viewport's cells that meet the window, each with its viewport list.

    Returns ``cell_start`` i32[n_cells + 1] (cell c's list is
    ``cell_groups[cell_start[c]:cell_start[c + 1]]``), ``cell_groups``
    i32[n_pairs] in ascending group order within each cell, and ``n_pairs``
    — read from the device (the frame's one device-to-host read) unless the
    caller passes the count it already knows, e.g. for an unchanged frame."""
    n_bx, n_by = grid_cells(width, height, cell_w, origin)
    n_cells = n_bx * n_by
    dev = lo.device
    fw, fh = full_width or width, full_height or height
    window = (None if (fw, fh, tuple(origin)) == (width, height, (0, 0))
              else (int(origin[0]), int(origin[1]), width, height))
    gx0, gx1, gy0, gy1, count = _bin_spans(ok, lo, hi, t_pad, fw, fh, cell_w,
                                           window)
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


def depth_to_key(z: torch.Tensor) -> torch.Tensor:
    """f32 depth -> masked sortable depth key (the kernels' encoding); used
    to chain depth-peeling windows."""
    return z.to(torch.float32).contiguous().view(torch.int32) & KEY_MASK


def _unpack_depth(key: torch.Tensor, covered: torch.Tensor) -> torch.Tensor:
    """Invert the depth key: the quantized depth, +inf where not covered."""
    z = (key & KEY_MASK).view(torch.float32)
    return torch.where(covered, z, torch.full_like(z, float("inf")))


def peel_window_open(floor: torch.Tensor, ceil: torch.Tensor) -> torch.Tensor:
    """True where the depth window (``floor``, ``ceil``) of i32 keys holds
    some int32 strictly inside it, so that a key may pass ``floor < key <
    ceil``: ``floor + 1 < ceil``, decided in 64 bits (in int32, ``ceil -
    floor`` overflows on the windows the frames build, from ``INT32_MIN +
    1`` to ``0x7F800000``). K2 ends a warp whose pixels' windows are all
    closed, and narrows its rejection footprint to the open ones."""
    return floor.to(torch.int64) + 1 < ceil.to(torch.int64)


def rasterize_bins_plain(cell_start, cell_groups, coef, width: int,
                         height: int, *, cell_w: int = CELL_W,
                         keyed: bool = False, window=None, origin=(0, 0)):
    """Plain PyTorch version of the raster kernels (K1; keyed: K3/K4, and K2
    with ``window``).

    Walks list rank k = 0..max_len-1 and, within each group, triangles
    0..7, vectorised over the pixels of every cell whose list is longer
    than k (cells are kept sorted by list length, so those are a prefix);
    every pixel sees its candidates in the kernel's order, with the same
    per-operation rounding and the same strict compare: cross-multiplied
    (zn, wn), or with ``keyed`` the masked key of the IEEE quotient zn / wn,
    kept only inside ``window`` = (floor, ceil) i32[H, W] when given.
    ``origin`` (x0, y0) offsets the pixel centres: the H x W window of the
    viewport whose coefficients ``coef`` holds. Returns (depth f32[H, W],
    tid i32[H, W])."""
    n_bx, n_by = grid_cells(width, height, cell_w, origin)
    n_cells = n_bx * n_by
    x0, y0 = (int(v) for v in origin)
    ax, ay = x0 % cell_w, y0 % CELL_H     # the window inside its cells
    dev = coef.device
    lens = (cell_start[1:] - cell_start[:-1]).long()
    lens, order = torch.sort(lens, descending=True, stable=True)
    starts = cell_start[:-1].long()[order]
    # active[k]: number of cells whose list is longer than k
    host_lens = lens.cpu().numpy()
    max_len = int(host_lens[0]) if n_cells else 0
    active = np.searchsorted(-host_lens, -np.arange(max_len), side="left")

    def cells(img):  # [H, W] -> [n_cells, 8 * cell_w] in sorted cell order
        img = torch.nn.functional.pad(
            img, (ax, n_bx * cell_w - width - ax, ay,
                  n_by * CELL_H - height - ay))
        img = img.reshape(n_by, CELL_H, n_bx, cell_w).permute(0, 2, 1, 3)
        return img.reshape(n_cells, CELL_H * cell_w)[order]

    lane = torch.arange(cell_w * CELL_H, device=dev)
    # viewport pixel coordinates, in integers before the float (the kernels')
    px = ((order % n_bx)[:, None] * cell_w + lane % cell_w + (x0 - ax)
          ).float() + 0.5
    py = ((order // n_bx)[:, None] * CELL_H + lane // cell_w + (y0 - ay)
          ).float() + 0.5
    if keyed:
        kb = torch.full(px.shape, SENTINEL, dtype=torch.int32, device=dev)
        if window is not None:
            floor, ceil = (cells(p) for p in window)
    else:
        zb = torch.ones_like(px)
        wb = torch.zeros_like(px)
    best = torch.full(px.shape, -1, dtype=torch.int32, device=dev)
    rows = coef.reshape(-1, GROUP, 16)
    for k in range(max_len):
        a = int(active[k])
        g = cell_groups[starts[:a] + k].long()
        grows = rows[g]                                      # [a, 8, 16]
        pxa, pya, besta = px[:a], py[:a], best[:a]
        if keyed:
            kba = kb[:a]
        else:
            zba, wba = zb[:a], wb[:a]
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
            ids = (g * GROUP + c).to(torch.int32)[:, None]
            if keyed:
                key = (zn / torch.where(accept, wn, 1.0)).view(torch.int32) \
                    & KEY_MASK
                if window is not None:
                    accept = accept & (key > floor[:a]) & (key < ceil[:a])
                win = accept & (key < kba)
                kba = torch.where(win, key, kba)
            else:
                win = accept & (zn * wba < zba * wn)
                zba = torch.where(win, zn, zba)
                wba = torch.where(win, wn, wba)
            besta = torch.where(win, ids, besta)
        best[:a] = besta
        if keyed:
            kb[:a] = kba
        else:
            zb[:a], wb[:a] = zba, wba
    if keyed:
        depth = _unpack_depth(kb, best >= 0)
    else:
        depth = torch.where(best >= 0, zb / torch.clamp(wb, min=1e-30),
                            torch.full_like(zb, float("inf")))

    def image(v):  # [n_cells, 8 * cell_w] in sorted cell order -> [H, W]
        v = torch.empty_like(v).index_copy_(0, order, v)
        v = v.reshape(n_by, n_bx, CELL_H, cell_w).permute(0, 2, 1, 3)
        return v.reshape(n_by * CELL_H, n_bx * cell_w)[ay:ay + height,
                                                       ax:ax + width]

    return image(depth).contiguous(), image(best).contiguous()


def _kernel_name(cell_w: int, keyed: bool, window) -> str:
    """The LAUNCHES key of the kernel that a call selects."""
    if not keyed:
        return "raster_exact"
    if cell_w == TILE_W:
        return "raster_classic"
    return "raster_keyed" if window is None else "raster_peel"


_LIB = []


def _lib():
    """The built ``csrc/raster_exact.cu`` with its C signatures declared."""
    if not _LIB:
        lib = load_library("raster_exact")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.raster_exact_launch.argtypes = [P] * 3 + [I] * 6 + [P] * 3
        lib.raster_keyed_launch.argtypes = [P] * 3 + [I] * 7 + [P] * 5
        lib.raster_exact_launch.restype = I
        lib.raster_keyed_launch.restype = I
        _LIB.append(lib)
    return _LIB[0]


def check_window(name: str, width: int, height: int, full_width=None,
                 full_height=None, origin=(0, 0)) -> Tuple[int, int]:
    """The window's origin as ints; ValueError for a negative origin or a
    window that leaves the full_width x full_height viewport (the window's
    own size when not given)."""
    x0, y0 = (int(v) for v in origin)
    fw, fh = full_width or width, full_height or height
    if x0 < 0 or y0 < 0 or x0 + width > fw or y0 + height > fh:
        raise ValueError(
            f"{name}: the {width}x{height} window at origin ({x0}, {y0}) "
            f"does not lie inside the {fw}x{fh} viewport")
    return x0, y0


def _launch_kernel(cell_start, cell_groups, coef, width, height, cell_w,
                   keyed, window, full_width=None, full_height=None,
                   origin=(0, 0)):
    name = _kernel_name(cell_w, keyed, window)
    x0, y0 = check_window(name, width, height, full_width, full_height,
                          origin)
    planes = [("cell_start", cell_start, torch.int32),
              ("cell_groups", cell_groups, torch.int32),
              ("coef", coef, torch.float32)]
    if window is not None:
        planes += [("floor", window[0], torch.int32),
                   ("ceil", window[1], torch.int32)]
    for what, t, dtype in planes:
        if t.device != coef.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"{dtype} tensor on {coef.device}")
    if window is not None and any(p.shape != (height, width) for p in window):
        raise ValueError(f"{name}: the depth-window planes must be the "
                         f"[{height}, {width}] window grid's")
    if cell_w not in (CELL_W, TILE_W) or (cell_w != CELL_W and not keyed):
        raise ValueError(f"{name}: no kernel for {cell_w}-pixel cells")
    n_bx, n_by = grid_cells(width, height, cell_w, (x0, y0))
    if coef.dim() != 2 or coef.shape[1] != 16 or coef.shape[0] % GROUP:
        raise ValueError(f"{name}: coef must be [8k, 16], got {tuple(coef.shape)}")
    if cell_start.shape != (n_bx * n_by + 1,):
        raise ValueError(f"{name}: cell_start does not match the "
                         f"{width}x{height} window's grid")
    lib = _lib()
    depth = torch.empty((height, width), dtype=torch.float32, device=coef.device)
    tid = torch.empty((height, width), dtype=torch.int32, device=coef.device)
    stream = torch.cuda.current_stream(coef.device).cuda_stream
    head = (cell_start.data_ptr(), cell_groups.data_ptr(), coef.data_ptr(),
            width, height, n_bx, n_bx * n_by)
    if keyed:
        fl, ce = (None, None) if window is None else (
            window[0].data_ptr(), window[1].data_ptr())
        rc = lib.raster_keyed_launch(*head, cell_w, x0, y0, fl, ce,
                                     depth.data_ptr(), tid.data_ptr(), stream)
    else:
        rc = lib.raster_exact_launch(*head, x0, y0, depth.data_ptr(),
                                     tid.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return depth, tid


def rasterize_bins(cell_start, cell_groups, coef, width: int, height: int,
                   *, cell_w: int = CELL_W, keyed: bool = False, window=None,
                   full_width: Optional[int] = None,
                   full_height: Optional[int] = None, origin=(0, 0)):
    """Nearest covering triangle per pixel over binned groups.

    ``coef`` f32[T_pad, 16]: rows of (e0, e1, e2, zn, wn) coefficients;
    ``cell_start``/``cell_groups`` from ``bin_groups`` at the same
    ``cell_w``. Default: the exact cross-multiplied compare (K1, 8x32
    cells). ``keyed``: the quantized-key compare, K3 on 8x32 cells or K4 on
    8x128; with ``window`` = (floor, ceil) i32[H, W] keys, K2 (or K4's peel
    form), which keeps only keys strictly inside the window. Returns (depth
    f32[H, W], +inf where empty and quantized when keyed; tid i32[H, W],
    global triangle id, -1 where empty). ``origin`` places the width x
    height window in the full_width x full_height viewport (the bins and
    planes are the window's; ValueError where it leaves the viewport). A
    CUDA tensor launches the kernel of ``csrc/raster_exact.cu``; a CPU
    tensor runs ``rasterize_bins_plain``."""
    if window is not None and not keyed:
        raise ValueError("a depth window needs the keyed compare")
    if coef.device.type == "cuda":
        return _launch_kernel(cell_start, cell_groups, coef, width, height,
                              cell_w, keyed, window, full_width, full_height,
                              origin)
    if coef.device.type == "cpu":
        origin = check_window("raster_exact", width, height, full_width,
                              full_height, origin)
        return rasterize_bins_plain(cell_start, cell_groups, coef, width,
                                    height, cell_w=cell_w, keyed=keyed,
                                    window=window, origin=origin)
    raise ValueError(f"raster_exact: unsupported device {coef.device}")


class BinnedFrame(NamedTuple):
    """Everything ``rasterize_bins`` needs for one frame."""

    table: torch.Tensor        # f32[T_pad, 32] packed rows (pack_attr_coef)
    coef: torch.Tensor         # f32[T_pad, 16] the rows' coefficient part
    cell_start: torch.Tensor   # i32[n_cells + 1]
    cell_groups: torch.Tensor  # i32[n_pairs]
    n_pairs: int
    cell_w: int


def bin_triangles(batch: TriangleBatch, width: int, height: int,
                  cell_w: int = CELL_W, *, full_width: Optional[int] = None,
                  full_height: Optional[int] = None,
                  origin=(0, 0)) -> BinnedFrame:
    """Triangle setup + binning: the raster kernel's inputs for ``batch``;
    the setup over the full_width x full_height viewport, the bins over the
    width x height window at ``origin``."""
    coeffs, ok, (lo, hi) = triangle_coefficients(
        batch, full_width or width, full_height or height)
    t = batch.capacity
    t_pad = _round_up(t, GROUP)
    table = pack_attr_coef(batch, coeffs)
    if t_pad > t:
        pad = table.new_zeros((t_pad - t, ROW))
        pad[:, 2] = -1.0                                  # dead: e0 < 0
        table = torch.cat([table, pad])
    cell_start, cell_groups, n_pairs = bin_groups(
        ok, lo, hi, t_pad, width, height, cell_w=cell_w,
        full_width=full_width, full_height=full_height, origin=origin)
    return BinnedFrame(table, table[:, :16].contiguous(), cell_start,
                       cell_groups, n_pairs, cell_w)


def rasterize_exact(batch: TriangleBatch, width: int, height: int, *,
                    full_width: Optional[int] = None,
                    full_height: Optional[int] = None, origin=(0, 0),
                    depth_window=None, quarter: Optional[bool] = None,
                    crossz: Optional[bool] = None):
    """Exact-binned raster. Returns (depth f32[H,W], tid i32[H,W] global
    triangle ids, attr_table f32[T_pad, 32], required int — this frame's
    (group, cell) pair count).

    ``quarter`` (default True) bins to 8x32 cells, else to the classic
    8x128 tiles. ``crossz`` (default True) keeps the exact cross-multiplied
    depth; it applies only on the quarter path without a window (the JAX
    rule), otherwise depth is the quantized key. ``depth_window`` =
    (floor, ceil) i32[H, W] keys peels: each pixel's nearest fragment
    strictly inside the window.

    ``full_width``/``full_height``/``origin`` render the width x height
    window at ``origin`` of a larger viewport (screen-tile sharding): the
    setup over the full viewport, the binning in window space."""
    quarter = True if quarter is None else quarter
    crossz = (True if crossz is None else crossz) and quarter \
        and depth_window is None
    win = dict(full_width=full_width, full_height=full_height, origin=origin)
    b = bin_triangles(batch, width, height, CELL_W if quarter else TILE_W,
                      **win)
    depth, tid = rasterize_bins(b.cell_start, b.cell_groups, b.coef, width,
                                height, cell_w=b.cell_w, keyed=not crossz,
                                window=depth_window, **win)
    return depth, tid, b.table, b.n_pairs


def resolve_gbuffer_pairs(attr_table, depth, tri_id, camera, *,
                          full_width: Optional[int] = None,
                          full_height: Optional[int] = None,
                          origin=(0, 0)) -> GBuffer:
    """G-buffer resolve: one packed row gather per pixel; barycentrics are
    recomputed from the row's edge coefficients and the world position is
    unprojected from (pixel, depth). ``full_*``/``origin`` resolve the
    window at ``origin`` of a larger viewport."""
    h, w = depth.shape
    fw, fh = full_width or w, full_height or h
    x0, y0 = origin
    dev = depth.device
    covered = (tri_id >= 0).reshape(-1)
    rows = attr_table[torch.clamp(tri_id, min=0).reshape(-1).long()]  # [P, 32]

    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5 + x0
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5 + y0
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
    ndc_x = px / fw * 2.0 - 1.0
    ndc_y = 1.0 - py / fh * 2.0
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
