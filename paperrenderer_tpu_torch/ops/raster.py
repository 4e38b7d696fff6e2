"""Triangle batch, clipless homogeneous triangle setup, the reference
rasterizer and the G-buffer resolve.

PyTorch counterpart of ``paperrenderer_tpu/ops/raster.py``: ``TriangleBatch``,
``GBuffer``, ``attach_cull``, ``triangle_coefficients``, the draw-list
expansion ``build_triangle_batch``, the plain reference rasterizer
``rasterize`` and ``resolve_gbuffer``. The reference rasterizes with
hardware fed by the GPU-driven draw list (IndirectDraw.cpp:207-242); here the
per-triangle setup is dense tensor math and the per-pixel search is a kernel:
the binned K1 of ``ops.raster_exact`` on the static frame, the tile kernel
K5 of ``ops.raster_pallas`` on the draw-list frame. Not ported:
``pack_attributes``, ``resolve_gbuffer_packed`` and
``resolve_gbuffer_unproject`` (no ported frame calls them).

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
    theirs."""
    fw = full_width or width
    fh = full_height or height
    coeffs, _ok, _aabb = triangle_coefficients(batch, fw, fh)
    t_cap = batch.capacity
    n_chunks = -(-t_cap // chunk)
    pad = n_chunks * chunk - t_cap
    coeffs = torch.nn.functional.pad(coeffs, (0, 0, 0, 0, 0, pad))
    if pad:
        coeffs[t_cap:, :3, 2] = -1.0                   # padded rows never cover
    coeffs = coeffs.reshape(n_chunks, chunk, 5, 3)

    dev = coeffs.device
    x0, y0 = origin
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5 + x0
          )[None, :].expand(height, width).reshape(-1, 1)
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5 + y0
          )[:, None].expand(height, width).reshape(-1, 1)
    depth = torch.full((height * width,), float("inf"), device=dev)
    tid = torch.full((height * width,), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((height * width, 2), device=dev)
    for k in range(n_chunks):
        c = coeffs[k]                                   # [C, 5, 3]
        vals = px[:, :, None] * c[None, :, :, 0] + py[:, :, None] * c[None, :, :, 1] \
            + c[None, :, :, 2]                          # [P, C, 5]
        e = vals[..., :3]
        zn, wn = vals[..., 3], vals[..., 4]
        inside = (e >= 0.0).all(dim=-1) & (wn > 1e-12) & (zn >= 0.0)
        z = torch.where(inside, zn / torch.where(inside, wn, 1.0), float("inf"))
        best_z, best = torch.min(z, dim=-1)     # the first of equal minima
        win = best_z < depth
        be = torch.gather(e, 1, best[:, None, None].expand(-1, 1, 3))[:, 0]
        esum = torch.clamp(be[:, 0] + be[:, 1] + be[:, 2], min=1e-30)
        depth = torch.where(win, best_z, depth)
        tid = torch.where(win, (best + k * chunk).to(torch.int32), tid)
        bary = torch.where(win[:, None], be[:, 1:3] / esum[:, None], bary)
    return (depth.reshape(height, width), tid.reshape(height, width),
            bary.reshape(height, width, 2))


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
