"""Instance preprocess: frustum cull + LOD select.

PyTorch counterpart of the two functions of
``paperrenderer_tpu/ops/preprocess.py`` that the static raster path uses
(reference: IndirectDrawBuild.comp, math in Common.glsl:119-188). The
draw-list build (``preprocess_instances``) belongs to the draw-list path and
is not ported yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import torch

from ..core.camera import CameraMatrices
from ..core.transforms import apply_mat34
from ..utils.tree import device_constant

# the 8 box-corner selectors of Common.glsl:123-152
_CORNERS = ((1, 1, 1), (1, 1, 0), (0, 1, 1), (1, 0, 1),
            (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0))


def frustum_cull(
    aabb_min: torch.Tensor,   # f32[N, 3] object-space AABB min
    aabb_max: torch.Tensor,   # f32[N, 3]
    matrices: torch.Tensor,   # f32[N, 3, 4]
    camera: CameraMatrices,
) -> torch.Tensor:
    """View-space AABB frustum test, reproducing Common.glsl:119-168: the 8
    box corners go to view space, their AABB is tested against planes taken
    from the projection rows. Returns bool[N]."""
    sel = device_constant(_CORNERS, aabb_min.device)
    corners = (sel[None] * aabb_max[:, None, :]
               + (1.0 - sel[None]) * aabb_min[:, None, :])      # [N, 8, 3]
    world = apply_mat34(matrices[:, None], corners)
    vs = apply_mat34(camera.view[:3], world)
    lo = vs.amin(dim=1)
    hi = vs.amax(dim=1)

    proj = camera.projection
    fx = proj[3] + proj[0]
    fx = fx / torch.linalg.vector_norm(fx[:3])
    fy = proj[3] + proj[1]
    fy = fy / torch.linalg.vector_norm(fy[:3])

    visible = lo[:, 2] < 0.0  # everything fully behind the camera is culled
    kx = fx[2] / fx[0]
    visible &= ~((hi[:, 0] < kx * -lo[:, 2]) | (lo[:, 0] > kx * lo[:, 2]))
    ky = fy[1]
    visible &= ~((hi[:, 1] < ky * lo[:, 2]) | (lo[:, 1] > ky * -lo[:, 2]))
    return visible


def select_lod(
    pos: torch.Tensor,        # f32[N, 3] instance positions
    aabb_min: torch.Tensor,   # f32[N, 3]
    aabb_max: torch.Tensor,
    lod_count: torch.Tensor,  # i32[N]
    cam_pos: torch.Tensor,    # f32[3]
) -> torch.Tensor:
    """LOD level = floor(invsqrt(worldSize*10) * sqrt(camDist)), clamped —
    Common.glsl:170-188 + the min() at IndirectDrawBuild.comp:121."""
    size = (aabb_max - aabb_min).amax(dim=-1)
    dist = torch.linalg.vector_norm(pos - cam_pos[None], dim=-1)
    raw = torch.floor(torch.rsqrt(torch.clamp(size * 10.0, min=1e-12))
                      * torch.sqrt(dist))
    raw = torch.nan_to_num(raw, nan=0.0, posinf=1e9).to(torch.int32)
    top = torch.clamp(lod_count - 1, min=0)
    return torch.minimum(torch.clamp(raw, min=0), top)
