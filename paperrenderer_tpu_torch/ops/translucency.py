"""Sorted translucency: a depth-peeled, back-to-front blended pass over the
non-opaque triangles.

PyTorch counterpart of ``paperrenderer_tpu/ops/translucency.py`` on its
exact-peel path (``use_exact=True``). The reference's sorted RenderPass path
(src/PaperRenderer/RenderPass.cpp:560-709) sorts translucent instances by
camera distance on the CPU and draws them with src_alpha /
one_minus_src_alpha blending. Here, per frame:

  * triangles whose material is SHADE_TRANSLUCENT or SHADE_LEAF are binned
    once (``raster_exact.bin_triangles``);
  * ``layers`` depth-peel passes of kernel K2 over those bins: pass i keeps
    each pixel's nearest fragment strictly inside (previous layer's key,
    opaque depth key);
  * the layers are shaded and blended back to front over the opaque HDR
    image; a leaf's alpha is its procedural cutout at the hit uv.

The JAX package bins the translucent set again for every layer; its inputs
do not change between layers, so binning once gives the same output.

``use_exact=False`` is the JAX package's XLA peel, the XLA route's
(``RenderPass(use_pallas=False)``): each layer is ``_rasterize_peel``, the
reference rasterizer with explicit (previous layer, opaque depth) depth
clamps, resolved by ``resolve_gbuffer_unproject``; it launches no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.camera import CameraMatrices
from ..core.material import SHADE_LEAF, SHADE_TRANSLUCENT, MaterialTable
from .raster import TriangleBatch, rasterize, resolve_gbuffer_unproject
from .raster_exact import (
    bin_triangles, depth_to_key, rasterize_bins, resolve_gbuffer_pairs,
)
from .shading import Lights, leaf_alpha, shade_gbuffer


def non_opaque_mask(materials: MaterialTable,
                    material_ids: torch.Tensor) -> torch.Tensor:
    """Triangles needing the sorted/cutout pass: BLEND translucency and
    alpha-cutout leaves (the reference's blended pipeline + any-hit cutout)."""
    sm = materials.shading_model[material_ids.long()]
    return (sm == SHADE_TRANSLUCENT) | (sm == SHADE_LEAF)


def _rasterize_peel(batch: TriangleBatch, width: int, height: int,
                    z_floor: torch.Tensor, z_ceil: torch.Tensor, *,
                    full_width=None, full_height=None, origin=(0, 0)):
    """One depth-peel layer of the reference rasterizer: each pixel's
    nearest fragment with z_floor < z < z_ceil (f32[H, W] each) -> (depth,
    tri_id, bary) as ``raster.rasterize`` returns them. ``origin``/
    ``full_*`` peel a window of a larger viewport."""
    return rasterize(batch, width, height, full_width=full_width,
                     full_height=full_height, origin=origin,
                     depth_window=(z_floor, z_ceil))


def composite_translucency(
    opaque_hdr: torch.Tensor,     # f32[H, W, 3]
    opaque_depth: torch.Tensor,   # f32[H, W]
    batch: TriangleBatch,         # the FULL triangle batch (all materials)
    materials: MaterialTable,
    lights: Lights,
    camera: CameraMatrices,
    *,
    layers: int = 4,
    textures=None,
    use_exact: bool = True,
    full_width=None,
    full_height=None,
    origin=(0, 0),
    pair_capacity=None,
) -> Tuple[torch.Tensor, int]:
    """Depth-peel the non-opaque triangles and blend them back to front over
    the opaque HDR image; each layer's shade samples ``textures`` (the
    atlas, or None). ``use_exact`` peels with K2, else with the XLA peel.
    ``full_*``/``origin`` composite the H x W window at ``origin`` of a
    larger viewport (screen-tile sharding), on either peel. Returns (hdr
    f32[H, W, 3], required int: the translucent set's pair count, which
    every layer shares; 0 on the XLA peel). ``pair_capacity`` (the TPU's
    pair-buffer tier) is accepted and ignored: the port's exact peel sizes
    its buffers from this frame's count."""
    del pair_capacity
    h, w = opaque_depth.shape
    win = dict(full_width=full_width, full_height=full_height, origin=origin)
    translucent = non_opaque_mask(materials, batch.material)
    # leaf/translucent materials default to CULL_NONE: both faces peel
    tbatch = dataclasses.replace(batch, valid=batch.valid & translucent)

    # up to `layers` nearest fragments per pixel, front to back
    peels = []
    required = 0
    if use_exact:
        bins = bin_triangles(tbatch, w, h, **win)
        required = bins.n_pairs
        floor = torch.full((h, w), torch.iinfo(torch.int32).min + 1,
                           dtype=torch.int32, device=opaque_depth.device)
        ceil = depth_to_key(opaque_depth)
        for _ in range(layers):
            depth, tid = rasterize_bins(
                bins.cell_start, bins.cell_groups, bins.coef, w, h,
                keyed=True, window=(floor, ceil), **win)
            peels.append(resolve_gbuffer_pairs(bins.table, depth, tid, camera,
                                               **win))
            floor = depth_to_key(depth)
    else:
        z_floor = torch.full((h, w), float("-inf"), device=opaque_depth.device)
        for _ in range(layers):
            depth, tid, bary = _rasterize_peel(tbatch, w, h, z_floor,
                                               opaque_depth, **win)
            peels.append(resolve_gbuffer_unproject(tbatch, depth, tid, bary,
                                                   camera, **win))
            z_floor = torch.where(torch.isfinite(depth), depth, z_floor)

    # shade each layer, then blend BACK to front: dst = src*a + dst*(1-a)
    out = opaque_hdr
    for gbuf in reversed(peels):
        color = shade_gbuffer(gbuf, materials, lights, camera.cam_pos,
                              textures=textures)
        ids = gbuf.material.long()
        alpha = torch.where(materials.shading_model[ids] == SHADE_LEAF,
                            leaf_alpha(gbuf.uv), materials.alpha[ids])
        a = torch.where(gbuf.coverage, alpha, 0.0)[..., None]
        out = color * a + out * (1.0 - a)
    return out, required
