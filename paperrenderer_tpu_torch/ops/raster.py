"""Triangle batch, G-buffer and clipless homogeneous triangle setup.

PyTorch counterpart of the parts of ``paperrenderer_tpu/ops/raster.py`` that
the static raster frame runs: ``TriangleBatch``, ``GBuffer``,
``attach_cull`` and ``triangle_coefficients``. The reference rasterizes with
hardware fed by the GPU-driven draw list (IndirectDraw.cpp:207-242); here the
per-triangle setup is dense tensor math and the per-pixel search is the
binned kernel of ``ops.raster_exact``.

Fill convention: a pixel is covered when all three (y-down screen) edge
functions are >= 0 at its centre.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


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
