"""Triangle batch, clipless homogeneous triangle setup, the reference
rasterizer and the G-buffer resolve.

PyTorch counterpart of ``paperrenderer_tpu/ops/raster.py``: ``TriangleBatch``,
``GBuffer``, ``attach_cull``, ``triangle_coefficients``, the draw-list
expansion ``build_triangle_batch``, the plain reference rasterizer
``rasterize`` and ``resolve_gbuffer``. The reference rasterizes with
hardware fed by the GPU-driven draw list (IndirectDraw.cpp:207-242); here the
per-triangle setup is dense tensor math and the per-pixel search is a kernel:
the binned K1 of ``ops.raster_exact`` on the static frame, the tile kernel
K5 of ``ops.raster_pallas`` on the draw-list frame. The XLA route
(``use_pallas=False``) runs ``rasterize`` instead, with
``pack_attributes`` + ``resolve_gbuffer_packed`` on the static frame and
``resolve_gbuffer_unproject`` on the translucent peel.

Fill convention: a pixel is covered when all three (y-down screen) edge
functions are >= 0 at its centre.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.camera import CameraMatrices
from ..core.geometry import GeometryArrays
from ..core.transforms import apply_mat34
from .preprocess import PreprocessResult

NO_HIT = -1   # the triangle id of a pixel no triangle covers


@dataclasses.dataclass(frozen=True)
class TriangleBatch:
    """Flat clip-space triangle SoA of capacity T."""

    clip: torch.Tensor       # f32[T, 3, 4] — clip-space positions
    world: torch.Tensor      # f32[T, 3, 3] — world-space positions
    normal: torch.Tensor     # f32[T, 3, 3] — world-space vertex normals
    uv: torch.Tensor         # f32[T, 3, 2]
    material: torch.Tensor   # i32[T] — resolved material id
    valid: torch.Tensor      # bool[T]
    # bool[T] — reject back-facing triangles (VK_CULL_MODE_BACK_BIT,
    # Pipeline.h:80); None = render two-sided. Set by ``attach_cull``.
    cull: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.clip.shape[0]


def attach_cull(batch: TriangleBatch, materials) -> TriangleBatch:
    """Resolve per-material cull modes into per-triangle ``cull`` flags."""
    return dataclasses.replace(batch, cull=materials.cull_back[batch.material])


@dataclasses.dataclass(frozen=True)
class GBuffer:
    """Per-pixel geometry attributes, input to deferred shading."""

    depth: torch.Tensor      # f32[H, W] — NDC depth, +inf where empty
    tri_id: torch.Tensor     # i32[H, W] — triangle row, -1 where empty
    world_pos: torch.Tensor  # f32[H, W, 3]
    normal: torch.Tensor     # f32[H, W, 3]
    uv: torch.Tensor         # f32[H, W, 2]
    material: torch.Tensor   # i32[H, W]

    @property
    def coverage(self) -> torch.Tensor:
        return self.tri_id >= 0


def transform_triangles(m: torch.Tensor, v_obj: torch.Tensor,
                        n_obj: torch.Tensor, view_proj: torch.Tensor):
    """Object-space triangles through per-triangle model matrices ``m``
    f32[T, 3, 4] and the camera: (world f32[T, 3, 3], unit world normals
    f32[T, 3, 3], clip f32[T, 3, 4]). Broadcast multiply-adds in a fixed
    order (``apply_mat34``), so both raster paths see the same clip rows for
    the same triangle. Normals are rotated by the model matrix's 3x3 part
    (the reference shaders' uniform-scale assumption, example
    Default.vert)."""
    mt = m[:, None]
    world = apply_mat34(mt, v_obj)
    n_world = (mt[..., :, 0] * n_obj[..., None, 0]
               + mt[..., :, 1] * n_obj[..., None, 1]
               + mt[..., :, 2] * n_obj[..., None, 2])
    n_world = n_world / torch.clamp(
        torch.linalg.vector_norm(n_world, dim=-1, keepdim=True), min=1e-12)
    return world, n_world, apply_mat34(view_proj, world)


def _row_for_triangle(tri_counts: torch.Tensor, capacity: int):
    """Flat triangle index -> (draw row, index within the row): a binary
    search over the rows' inclusive ends (the scan + gather that replaces a
    GPU's per-thread append). Returns two i64[capacity]."""
    ends = torch.cumsum(tri_counts, 0)
    starts = ends - tri_counts
    t = torch.arange(capacity, dtype=ends.dtype, device=ends.device)
    row = torch.searchsorted(ends, t, right=True)
    row = torch.clamp(row, max=tri_counts.shape[0] - 1)
    return row, t - starts[row]


def build_triangle_batch(pre: PreprocessResult, geo: GeometryArrays,
                         camera: CameraMatrices, *,
                         capacity: int) -> TriangleBatch:
    """Expand the draw rows into a clip-space triangle batch of
    ``capacity`` rows; rows past ``pre.total_tris`` are invalid."""
    row, within = _row_for_triangle(pre.draw_tri_count, capacity)
    dev = row.device
    valid = torch.arange(capacity, device=dev) < pre.total_tris
    inst = torch.clamp(pre.draw_instance[row], min=0).long()
    tri_idx = torch.where(valid, pre.draw_tri_offset[row] + within, 0)
    vidx = geo.indices[tri_idx].long()                  # [T, 3]
    world, normal, clip = transform_triangles(
        pre.matrices[inst], geo.positions[vidx], geo.normals[vidx],
        camera.view_proj)
    return TriangleBatch(
        clip=clip, world=world, normal=normal, uv=geo.uvs[vidx],
        material=torch.where(valid, pre.draw_material[row], 0), valid=valid)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cross(a, b) over the last axis, one rounding per product and per
    difference (no fused multiply-add anywhere)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _edge_row(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """cross(p, q) computed in a canonical (lexicographic) vertex order.

    Adjacent triangles share edges with opposite orientation, and
    watertightness needs their edge rows to be EXACT negations: both compute
    the cross product with the same operand order and flip the sign after,
    and a sign flip is exact."""
    swap = (
        (q[:, 0] < p[:, 0])
        | ((q[:, 0] == p[:, 0]) & (q[:, 1] < p[:, 1]))
        | ((q[:, 0] == p[:, 0]) & (q[:, 1] == p[:, 1]) & (q[:, 2] < p[:, 2]))
    )[:, None]
    row = _cross(torch.where(swap, q, p), torch.where(swap, p, q))
    return torch.where(swap, -row, row)


def triangle_coefficients(batch: TriangleBatch, width: int, height: int):
    """Per-triangle setup for clipless homogeneous rasterization
    (Olano-Greer; ``paperrenderer_tpu/ops/raster.py:147-268``).

    Returns ``coeffs`` f32[T, 5, 3] packing (e0, e1, e2, z_num, w_num): per
    pixel p = (px, py, 1)
      b_i = e_i . p;  inside = all b_i >= 0 and (w_num . p) > 0
      depth = (z_num . p) / (w_num . p)       (NDC depth)
    plus ``ok`` bool[T] and conservative pixel AABBs ``(lo, hi)`` f32[T, 2]
    for binning (triangles crossing w <= 0 get a full-screen AABB)."""
    clip = batch.clip
    w = clip[..., 3]
    # viewport folded into homogeneous coords; row 0 = image top = camera up
    xh = (clip[..., 0] * 0.5 + w * 0.5) * width         # = x_pix * w
    yh = (w * 0.5 - clip[..., 1] * 0.5) * height
    v = torch.stack([xh, yh, w], dim=-1)                # [T, 3(vert), 3]

    e0 = _edge_row(v[:, 1], v[:, 2])
    e1 = _edge_row(v[:, 2], v[:, 0])
    e2 = _edge_row(v[:, 0], v[:, 1])
    v0 = v[:, 0]
    det = v0[:, 0] * e0[:, 0] + v0[:, 1] * e0[:, 1] + v0[:, 2] * e0[:, 2]

    ok = batch.valid & (det.abs() > 1e-14)
    if batch.cull is not None:
        # back faces (VK_CULL_MODE_BACK_BIT + VK_FRONT_FACE_CLOCKWISE under
        # the reference's unflipped viewport) have det > 0 here
        ok &= ~(batch.cull & (det > 0))
    # orient by sign(det) ONLY — an exact sign flip keeps shared edges exact
    # negations; scaling edge rows per triangle would open seams
    s = torch.where(det < 0, -1.0, 1.0)[:, None]
    e0, e1, e2 = e0 * s, e1 * s, e2 * s

    z = clip[..., 2]
    z_num = z[:, 0, None] * e0 + z[:, 1, None] * e1 + z[:, 2, None] * e2
    w_num = w[:, 0, None] * e0 + w[:, 1, None] * e1 + w[:, 2, None] * e2

    # Normalize the DEPTH rows (only) by a per-triangle power of two, built
    # in the exponent bits: zn/wn, the zn >= 0 clip and the cross-multiplied
    # compare are invariant under it, and without it zn_a * wn_b overflows
    # f32 on km-scale worlds.
    m = torch.maximum(z_num.abs().amax(dim=-1), w_num.abs().amax(dim=-1))
    m = torch.clamp(m, min=1e-30)
    mexp = (m.view(torch.int32) >> 23) & 0xFF
    scale = (torch.clamp(254 - mexp, 1, 254) << 23).view(torch.float32)[:, None]
    z_num = z_num * scale
    w_num = w_num * scale

    coeffs = torch.stack([e0, e1, e2, z_num, w_num], dim=1)  # f32[T, 5, 3]
    never = torch.zeros((5, 3), dtype=torch.float32, device=clip.device)
    never[:3, 2] = -1.0
    coeffs = torch.where(ok[:, None, None], coeffs, never)

    safe_w = torch.clamp(w, min=1e-6)
    px = xh / safe_w
    py = yh / safe_w
    unbounded = (w <= 1e-6).any(dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=clip.device)
    aabb_lo = torch.stack(
        [torch.where(unbounded, zero, px.amin(dim=-1)),
         torch.where(unbounded, zero, py.amin(dim=-1))], dim=-1)
    aabb_hi = torch.stack(
        [torch.where(unbounded, zero + width, px.amax(dim=-1)),
         torch.where(unbounded, zero + height, py.amax(dim=-1))], dim=-1)
    return coeffs, ok, (aabb_lo, aabb_hi)


def rasterize(
    batch: TriangleBatch,
    width: int,
    height: int,
    *,
    chunk: int = 128,
    full_width: Optional[int] = None,
    full_height: Optional[int] = None,
    origin: Tuple[int, int] = (0, 0),
    depth_window: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """The reference rasterizer: nearest covering triangle per pixel, every
    triangle against every pixel, ``chunk`` triangles at a time.

    Returns (depth f32[H, W], +inf where empty; tri_id i32[H, W], -1 where
    empty; bary f32[H, W, 2], the perspective-correct (b1, b2)). Within a
    chunk the first of equal nearest depths wins; across chunks a later one
    must be strictly nearer. ``origin`` = (x0, y0) renders a width x height
    window of a ``full_width`` x ``full_height`` viewport (screen-tile
    sharding). No chunk is culled by its screen box, unlike the tile
    kernels, so a sliver's stray pixels outside its box can differ from
    theirs. ``depth_window`` = (z_floor, z_ceil) f32[H, W] keeps only
    fragments with z_floor < z < z_ceil (a depth-peel layer)."""
    fw = full_width or width
    fh = full_height or height
    coeffs, _ok, _aabb = triangle_coefficients(batch, fw, fh)
    t_cap = batch.capacity
    n_chunks = -(-t_cap // chunk)
    pad = n_chunks * chunk - t_cap
    coeffs = torch.nn.functional.pad(coeffs, (0, 0, 0, 0, 0, pad))
    if pad:
        coeffs[t_cap:, :3, 2] = -1.0                   # padded rows never cover
    # each chunk's 5 x chunk planes (plane-major) as three contiguous rows
    # of x, y and constant coefficients: every per-pixel pass below then
    # runs over contiguous [P, chunk] rows
    planes = coeffs.reshape(n_chunks, chunk, 5, 3).permute(0, 3, 2, 1).reshape(
        n_chunks, 3, 5 * chunk).contiguous()

    dev = planes.device
    x0, y0 = origin
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5 + x0
          )[None, :].expand(height, width).reshape(-1, 1)
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5 + y0
          )[:, None].expand(height, width).reshape(-1, 1)
    window = (None if depth_window is None
              else tuple(z.reshape(-1, 1) for z in depth_window))
    # the CPU walks the pixels in blocks whose [block, 5 * chunk] passes stay
    # in cache (3x faster there); the card takes them in one block
    p = height * width
    block = p if dev.type == "cuda" else 1024
    outs = [_rasterize_pixels(planes, chunk, px[i:i + block], py[i:i + block],
                              None if window is None else
                              tuple(z[i:i + block] for z in window))
            for i in range(0, p, block)]
    depth, tid, bary = (torch.cat(o) for o in zip(*outs))
    return (depth.reshape(height, width), tid.reshape(height, width),
            bary.reshape(height, width, 2))


def _rasterize_pixels(planes, chunk: int, px, py, window):
    """``rasterize``'s search over every chunk for the pixels (px, py)
    f32[P, 1] -> (depth f32[P], tri_id i32[P], bary f32[P, 2])."""
    dev = planes.device
    n = px.shape[0]
    depth = torch.full((n,), float("inf"), device=dev)
    tid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((n, 2), device=dev)
    for k in range(planes.shape[0]):
        cx, cy, c1 = planes[k]                          # [5 * C] each
        vals = (px * cx + py * cy + c1).view(-1, 5, chunk)   # [P, 5, C]
        e = vals[:, :3]
        zn, wn = vals[:, 3], vals[:, 4]
        inside = ((e[:, 0] >= 0.0) & (e[:, 1] >= 0.0) & (e[:, 2] >= 0.0)
                  & (wn > 1e-12) & (zn >= 0.0))
        z = torch.where(inside, zn / torch.where(inside, wn, 1.0), float("inf"))
        if window is not None:   # strictly behind the floor, before the ceiling
            z = torch.where((z > window[0]) & (z < window[1]), z, float("inf"))
        best_z, best = torch.min(z, dim=-1)     # the first of equal minima
        win = best_z < depth
        be = torch.gather(e, 2, best[:, None, None].expand(-1, 3, 1))[..., 0]
        esum = torch.clamp(be[:, 0] + be[:, 1] + be[:, 2], min=1e-30)
        depth = torch.where(win, best_z, depth)
        tid = torch.where(win, (best + k * chunk).to(torch.int32), tid)
        bary = torch.where(win[:, None], be[:, 1:3] / esum[:, None], bary)
    return depth, tid, bary


def resolve_gbuffer(batch: TriangleBatch, depth: torch.Tensor,
                    tri_id: torch.Tensor, bary: torch.Tensor) -> GBuffer:
    """Gather the winning triangles' attributes and interpolate them with
    the (perspective-correct) barycentrics: a plain weighted sum."""
    tid = torch.clamp(tri_id, min=0).long()
    covered = tri_id >= 0
    b1 = bary[..., 0:1]
    b2 = bary[..., 1:2]
    b0 = 1.0 - b1 - b2

    def interp(attr):                                   # attr [T, 3, C]
        a = attr[tid]                                   # [H, W, 3, C]
        return b0 * a[..., 0, :] + b1 * a[..., 1, :] + b2 * a[..., 2, :]

    normal = interp(batch.normal)
    normal = normal / torch.clamp(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-12)
    cov = covered[..., None]
    return GBuffer(
        depth=depth,
        tri_id=tri_id,
        world_pos=torch.where(cov, interp(batch.world), 0.0),
        normal=torch.where(cov, normal, 0.0),
        uv=torch.where(cov, interp(batch.uv), 0.0),
        material=torch.where(covered, batch.material[tid], 0),
    )


def _unproject(depth: torch.Tensor, covered: torch.Tensor, camera,
               full_width: Optional[int], full_height: Optional[int],
               origin) -> torch.Tensor:
    """World positions f32[H, W, 3] of the pixel centres of a width x
    height window at ``origin`` of a full_width x full_height viewport, at
    their NDC ``depth`` (0 where not ``covered``), through
    ``camera.inverse_view_proj`` (the inverse ``resolve_gbuffer_pairs``
    uses)."""
    h, w = depth.shape
    fw = full_width or w
    fh = full_height or h
    x0, y0 = origin
    dev = depth.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5 + x0
          ) / fw * 2.0 - 1.0
    ys = 1.0 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5 + y0
                ) / fh * 2.0
    ndc_x = xs[None, :].expand(h, w)
    ndc_y = ys[:, None].expand(h, w)
    z = torch.where(covered, depth, 0.0)
    inv_vp = camera.inverse_view_proj
    cols = [inv_vp[i, 0] * ndc_x + inv_vp[i, 1] * ndc_y + inv_vp[i, 2] * z
            + inv_vp[i, 3] for i in range(4)]
    inv_w = 1.0 / torch.where(cols[3].abs() < 1e-12, 1e-12, cols[3])
    return torch.stack([cols[0] * inv_w, cols[1] * inv_w, cols[2] * inv_w],
                       dim=-1)


def pack_attributes(batch: TriangleBatch) -> torch.Tensor:
    """Per-triangle hit attributes in one row f32[T, 16]: (n0, n1, n2 |
    uv0, uv1, uv2 | material), the material id as an f32 VALUE (exact
    below 2^24), so the G-buffer resolve gathers one row per pixel."""
    t = batch.capacity
    return torch.cat([batch.normal.reshape(t, 9), batch.uv.reshape(t, 6),
                      batch.material.to(torch.float32)[:, None]], dim=-1)


def resolve_gbuffer_packed(
    attr: torch.Tensor,      # f32[T, 16] from pack_attributes
    depth: torch.Tensor,
    tri_id: torch.Tensor,
    bary: torch.Tensor,
    camera,
    *,
    full_width: Optional[int] = None,
    full_height: Optional[int] = None,
    origin: Tuple[int, int] = (0, 0),
) -> GBuffer:
    """``resolve_gbuffer_unproject`` with one packed attribute row gathered
    per pixel. ``origin``/``full_*`` resolve a window of a larger
    viewport."""
    covered = tri_id >= 0
    world = _unproject(depth, covered, camera, full_width, full_height,
                       origin)
    rows = attr[torch.clamp(tri_id, min=0).long()]      # [H, W, 16]
    b1 = bary[..., 0:1]
    b2 = bary[..., 1:2]
    b0 = 1.0 - b1 - b2
    n = b0 * rows[..., 0:3] + b1 * rows[..., 3:6] + b2 * rows[..., 6:9]
    normal = n / torch.clamp(
        torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    uv = b0 * rows[..., 9:11] + b1 * rows[..., 11:13] + b2 * rows[..., 13:15]
    cov = covered[..., None]
    return GBuffer(
        depth=depth,
        tri_id=tri_id,
        world_pos=torch.where(cov, world, 0.0),
        normal=torch.where(cov, normal, 0.0),
        uv=torch.where(cov, uv, 0.0),
        material=torch.where(covered, rows[..., 15].to(torch.int32), 0),
    )


def resolve_gbuffer_unproject(
    batch: TriangleBatch,
    depth: torch.Tensor,
    tri_id: torch.Tensor,
    bary: torch.Tensor,
    camera,
    *,
    full_width: Optional[int] = None,
    full_height: Optional[int] = None,
    origin: Tuple[int, int] = (0, 0),
) -> GBuffer:
    """Like ``resolve_gbuffer``, but the world position is unprojected from
    (pixel, depth) through the inverse view-projection instead of
    interpolated from the vertices; normals and uvs are interpolated from
    the batch. ``origin``/``full_*`` resolve a window of a larger
    viewport."""
    tid = torch.clamp(tri_id, min=0).long()
    covered = tri_id >= 0
    world = _unproject(depth, covered, camera, full_width, full_height,
                       origin)
    b1 = bary[..., 0]
    b2 = bary[..., 1]
    pw = torch.stack([1.0 - b1 - b2, b1, b2], dim=-1)[..., None]  # [H,W,3,1]

    def interp(a):                                      # a [T, 3, C]
        v = pw * a[tid]                                 # [H, W, 3, C]
        return v[..., 0, :] + v[..., 1, :] + v[..., 2, :]

    normal = interp(batch.normal)
    normal = normal / torch.clamp(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-12)
    cov = covered[..., None]
    return GBuffer(
        depth=depth,
        tri_id=tri_id,
        world_pos=torch.where(cov, world, 0.0),
        normal=torch.where(cov, normal, 0.0),
        uv=torch.where(cov, interp(batch.uv), 0.0),
        material=torch.where(covered, batch.material[tid], 0),
    )
