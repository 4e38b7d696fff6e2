"""RenderPass: raster frame orchestration.

PyTorch counterpart of ``paperrenderer_tpu/render/renderpass.py``
(reference RenderPass.h:103-134, RenderPass.cpp:444-742). A frame is a
sequence of tensor ops on the pass's device, on one of two paths.

The static path (``render(cam)``, ``render_frame_static``):

    Scene.flush -> expand_static (transform, cull + LOD masks)
      -> attach_cull -> rasterize_exact (setup, binning, raster kernel K1)
      -> resolve_gbuffer_pairs -> shade_gbuffer
      [-> composite_translucency: depth peel (K2 per layer), blend]
      [-> supersample box resolve] -> tonemap

Pair buffers are sized from each frame's own pair count, so a frame is
always complete (no capacity to outgrow); see ``ops.raster_exact``.

The draw-list path (``render(cam, static_path=False)``, ``render_frame``),
the reference's GPU-driven preprocess:

    Scene.flush -> preprocess_instances (cull, LOD, draw-list compaction)
      -> build_triangle_batch -> attach_cull
      -> rasterize_tiles (setup, morton sort, tile kernel K5)
      -> resolve_gbuffer -> shade_gbuffer [-> supersample box resolve]
      -> tonemap

``RenderPass(use_pallas=False)`` takes the JAX package's XLA route on
either path, on the pass's device: the reference rasterizer
``raster.rasterize`` instead of K1 (resolved by ``resolve_gbuffer_packed``)
or K5, and the XLA peel instead of K2; it launches no kernel. None and
True run the kernels on every device.

On both paths ``shade_gbuffer`` samples the materials' textures from the
registry's atlas (trilinear, the mip level from the shaded uv image, so at
s x s the resolution under ``supersample``), and so does each peel layer's
shade. The atlas is uploaded with the material table, when the registry
or the bindings change, never once a frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.camera import Camera, CameraMatrices
from ..core.material import MaterialInstance, MaterialRegistry, MaterialTable
from ..core.model import ModelInstance
from ..core.geometry import GeometryArrays
from ..core.scene import InstanceArrays, Scene, SceneTables
from ..ops.preprocess import preprocess_instances
from ..ops.raster import (
    attach_cull, build_triangle_batch, pack_attributes, rasterize,
    resolve_gbuffer, resolve_gbuffer_packed)
from ..ops.raster_exact import rasterize_exact, resolve_gbuffer_pairs
from ..ops.raster_pallas import rasterize_tiles
from ..ops.shading import Lights, shade_gbuffer
from ..ops.static_batch import (
    StaticMapping, _tier, build_static_mapping, expand_static)
from ..ops.tonemap import TonemapParams, tonemap
from ..ops.translucency import composite_translucency, non_opaque_mask
from ..utils.device import require_device, use_kernels
from ..utils.stats import Timer


def _box_resolve(hdr, depth, ss):
    """The supersample resolve: the HDR image box-filtered in ss x ss cells
    in the JAX package's order (strided slices summed row-major, then
    scaled); the depth keeps the top-left sample of each cell."""
    acc = hdr[0::ss, 0::ss]
    for i in range(ss):
        for j in range(ss):
            if i or j:
                acc = acc + hdr[i::ss, j::ss]
    return acc * (1.0 / (ss * ss)), depth[::ss, ::ss]


def raster_gbuffer(batch, width: int, height: int, camera,
                   use_pallas: bool = True, **window):
    """The static frame's G-buffer of a triangle batch: K1 and
    ``resolve_gbuffer_pairs``, or on the XLA route ``raster.rasterize`` and
    ``resolve_gbuffer_packed``; ``window`` (``full_width``,
    ``full_height``, ``origin``) renders a window of a larger viewport.
    Returns (depth, GBuffer, required: the pair count, 0 on the XLA
    route)."""
    if use_pallas:
        depth, tid, attr_table, required = rasterize_exact(
            batch, width, height, **window)
        return depth, resolve_gbuffer_pairs(attr_table, depth, tid, camera,
                                            **window), required
    depth, tid, bary = rasterize(batch, width, height, **window)
    return depth, resolve_gbuffer_packed(pack_attributes(batch), depth, tid,
                                         bary, camera, **window), 0


def draw_list_batch(
    instances: InstanceArrays,
    tables: SceneTables,
    geo: GeometryArrays,
    materials: MaterialTable,
    camera: CameraMatrices,
    slot_materials: torch.Tensor,     # i32[N, S]
    instance_visible: torch.Tensor,   # bool[N]
    *,
    max_meshes_per_lod: int,
    tri_capacity: int,
    do_culling: bool = True,
):
    """The draw-list frame's triangle batch, as ``render_frame`` rasterizes
    it: preprocess_instances -> build_triangle_batch -> attach_cull.
    Returns (PreprocessResult, TriangleBatch)."""
    pre = preprocess_instances(
        instances, tables, camera, max_meshes_per_lod=max_meshes_per_lod,
        do_culling=do_culling, instance_visible=instance_visible,
        slot_materials=slot_materials)
    batch = build_triangle_batch(pre, geo, camera, capacity=tri_capacity)
    return pre, attach_cull(batch, materials)


def render_frame(
    instances: InstanceArrays,
    tables: SceneTables,
    geo: GeometryArrays,
    materials: MaterialTable,
    lights: Lights,
    camera: CameraMatrices,
    slot_materials: torch.Tensor,     # i32[N, S]
    instance_visible: torch.Tensor,   # bool[N]
    tonemap_params: TonemapParams,
    *,
    width: int,
    height: int,
    max_meshes_per_lod: int,
    tri_capacity: int,
    do_culling: bool = True,
    supersample: int = 1,
    textures=None,
    use_pallas: bool = True,
):
    """The draw-list raster frame (the reference-parity path: a per-frame
    draw list built by the preprocess pass, IndirectDrawBuild.comp). Returns
    (ldr f32[H, W, 3], aux dict). ``tri_capacity`` rows of triangle batch
    must hold the frame's ``total_tris``; ``supersample``, ``textures`` and
    ``use_pallas`` (False: ``raster.rasterize`` instead of K5) are
    ``render_frame_static``'s."""
    ss = max(1, int(supersample))
    pre, batch = draw_list_batch(
        instances, tables, geo, materials, camera, slot_materials,
        instance_visible, max_meshes_per_lod=max_meshes_per_lod,
        tri_capacity=tri_capacity, do_culling=do_culling)
    raster = rasterize_tiles if use_pallas else rasterize
    depth, tid, bary = raster(batch, width * ss, height * ss)
    gbuf = resolve_gbuffer(batch, depth, tid, bary)
    hdr = shade_gbuffer(gbuf, materials, lights, camera.cam_pos,
                        textures=textures)
    if ss > 1:
        hdr, depth = _box_resolve(hdr, depth, ss)
    ldr = tonemap(hdr, tonemap_params)
    aux = {
        "visible_count": pre.visible.sum(),
        "draw_count": pre.draw_count,
        "total_tris": pre.total_tris,
        "coverage": gbuf.coverage.float().mean(),
        "depth": depth,
        "hdr": hdr,
    }
    return ldr, aux


def render_frame_static(
    mapping: StaticMapping,
    instances: InstanceArrays,
    tables: SceneTables,
    materials: MaterialTable,
    lights: Lights,
    camera: CameraMatrices,
    slot_materials: torch.Tensor,     # i32[N, S]
    instance_visible: torch.Tensor,   # bool[N]
    tonemap_params: TonemapParams,
    *,
    width: int,
    height: int,
    do_culling: bool = True,
    translucent_layers: int = 0,
    supersample: int = 1,
    textures=None,
    use_pallas: bool = True,
):
    """The static raster frame. Returns (ldr f32[H, W, 3], aux dict).

    ``translucent_layers > 0`` adds the sorted-translucency pass (depth
    peeling + back-to-front blend) over SHADE_TRANSLUCENT and SHADE_LEAF
    materials; the opaque pass then leaves those triangles out.

    ``supersample`` = s rasterizes and shades at s x s the resolution and
    box-filters the HDR image before tonemapping (the analogue of the
    reference's MSAA sample count, RenderPass.h:61); ``aux["depth"]`` keeps
    the top-left sample of each s x s cell.

    ``textures`` (the registry's atlas on this device, or None when no
    material is textured) goes to every shade of the frame.

    ``use_pallas=False`` is the XLA route: ``raster.rasterize`` and
    ``resolve_gbuffer_packed`` instead of K1, the XLA peel instead of K2
    (``required_work`` then counts only the opaque pass: 0)."""
    ss = max(1, int(supersample))
    batch, inst_visible = expand_static(
        mapping, instances, tables, camera, slot_materials, instance_visible,
        do_culling=do_culling,
    )
    batch = attach_cull(batch, materials)
    full_batch = batch
    if translucent_layers > 0:
        # the opaque pass must not z-write translucent/cutout geometry
        batch = dataclasses.replace(
            batch, valid=batch.valid & ~non_opaque_mask(materials, batch.material))
    depth, gbuf, required = raster_gbuffer(batch, width * ss, height * ss,
                                           camera, use_pallas)
    hdr = shade_gbuffer(gbuf, materials, lights, camera.cam_pos,
                        textures=textures)
    if translucent_layers > 0:
        hdr, peel_required = composite_translucency(
            hdr, depth, full_batch, materials, lights, camera,
            layers=translucent_layers, textures=textures,
            use_exact=use_pallas)
        required = max(required, peel_required)
    if ss > 1:
        hdr, depth = _box_resolve(hdr, depth, ss)
    ldr = tonemap(hdr, tonemap_params)
    aux = {
        "visible_count": inst_visible.sum(),
        "total_tris": batch.valid.sum(),
        "coverage": gbuf.coverage.float().mean(),
        "required_work": required,
        "depth": depth,
        "hdr": hdr,
    }
    return ldr, aux


class RenderPass:
    """Host-side raster pass (reference RenderPass.h:103-134 surface).

    ``device`` defaults to the scene's; every per-frame tensor lives there.
    ``use_pallas`` (``utils.device.use_kernels``): None or True renders
    through the kernels, False through the XLA route."""

    def __init__(
        self,
        scene: Scene,
        materials: MaterialRegistry,
        *,
        width: int = 512,
        height: int = 512,
        do_culling: bool = True,
        lights: Optional[Lights] = None,
        tonemap_params: Optional[TonemapParams] = None,
        translucent_layers: int = 0,
        supersample: int = 1,
        device=None,
        use_pallas: Optional[bool] = None,
    ):
        self.use_pallas = use_kernels(use_pallas)
        self.scene = scene
        self.materials = materials
        self.device = require_device(device if device is not None
                                     else scene.device)
        self.width = width
        self.height = height
        self.do_culling = do_culling
        self.supersample = max(1, int(supersample))
        self.translucent_layers = int(translucent_layers)
        # default key light: intensity sized for unit-scale scenes under the
        # windowed-1/d^2 attenuation (pbr.glsl:104-108)
        self.lights = (lights or Lights.make(
            [{"position": (3.0, -4.0, 5.0), "color": (40.0, 40.0, 40.0),
              "bounds": 100.0}])).to(self.device)
        self.tonemap_params = (
            tonemap_params or TonemapParams.default()).to(self.device)
        # per-pass instance state: index -> {slot: material id}
        self._bindings: Dict[int, Dict[int, int]] = {}
        self._visible: Dict[int, bool] = {}
        # device-input caches, rebuilt only when bindings/materials change
        self._cache_dirty = True
        self._cached_capacity = -1
        self._cached = None
        self._cached_textures = None
        # static mapping, and the draw-list path's triangle capacity, keyed
        # on scene.version
        self._mapping = None
        self._mapping_version = -1
        self._tri_capacity = 2048
        self._tri_capacity_version = -1

    # -- instance registration (RenderPass::addInstance, :744-801) ----------
    def add_instance(
        self,
        instance: ModelInstance,
        materials: Optional[Dict[int, MaterialInstance]] = None,
    ) -> None:
        if instance.index < 0:
            self.scene.add_instance(instance)
        self._bindings[instance.index] = {
            slot: self.materials.register(mat)
            for slot, mat in (materials or {}).items()}
        self._visible[instance.index] = True
        self._cache_dirty = True

    def remove_instance(self, instance: ModelInstance) -> None:
        self._bindings.pop(instance.index, None)
        self._visible.pop(instance.index, None)
        self._cache_dirty = True

    def set_instance_visibility(self, instance: ModelInstance, visible: bool) -> None:
        self._visible[instance.index] = visible
        self._cache_dirty = True

    def invalidate(self) -> None:
        """Force re-upload of material/visibility tables (after editing a
        registered material live)."""
        self._cache_dirty = True

    def resize(self, width: int, height: int) -> None:
        """Change the render resolution (Swapchain.cpp:378-402 analogue)."""
        self.width = int(width)
        self.height = int(height)

    # -- per-frame device inputs --------------------------------------------
    def _device_inputs(self, capacity: int):
        """(slot materials i32[N, S], visible bool[N], MaterialTable); the
        texture atlas is cached beside them (``_cached_textures``)."""
        if self._cache_dirty or capacity != self._cached_capacity:
            s = max(1, self.scene.max_slots)
            slots = np.zeros((capacity, s), np.int32)
            for idx, binds in self._bindings.items():
                if 0 <= idx < capacity:
                    for slot, mid in binds.items():
                        if slot < s:
                            slots[idx, slot] = mid
            visible = np.ones((capacity,), bool)
            for idx, vis in self._visible.items():
                if 0 <= idx < capacity:
                    visible[idx] = vis
            self._cached = (torch.from_numpy(slots).to(self.device),
                            torch.from_numpy(visible).to(self.device),
                            self.materials.table(self.device))
            # after the table: it adds the rows' images to the atlas
            self._cached_textures = self.materials.texture_arrays(self.device)
            self._cached_capacity = capacity
            self._cache_dirty = False
        return self._cached

    def _current_mapping(self) -> StaticMapping:
        if self._mapping is None or self._mapping_version != self.scene.version:
            self._mapping = build_static_mapping(self.scene)
            self._mapping_version = self.scene.version
        return self._mapping

    def _required_tri_capacity(self) -> int:
        """The draw-list batch capacity: the triangles of every instance's
        densest LOD, in ``_tier`` steps; recomputed only when the scene's
        topology version moves (a walk over every instance in Python)."""
        if self._tri_capacity_version != self.scene.version:
            total = sum(
                max(sum(mm.handle.tri_count for mm in lod.meshes)
                    for lod in inst.model.lods)
                for inst in self.scene.instances)
            self._tri_capacity = max(self._tri_capacity, _tier(total))
            self._tri_capacity_version = self.scene.version
        return self._tri_capacity

    def render(
        self,
        camera: Camera | CameraMatrices,
        *,
        static_path: bool = True,
        statistics=None,
    ):
        """Render one frame; returns (ldr f32[H, W, 3], aux dict).

        ``static_path=True`` (default) rasterizes the pre-expanded triangle
        buffer with the binned kernel; False runs the per-frame draw-list
        build and the tile kernel (``render_frame``; translucent layers do
        not apply there, as in the JAX package). Pass a StatisticsTracker
        to record the submission timer (the reference's "RenderPass
        Submission" timer, RenderPass.cpp:447)."""
        if statistics is not None:
            with Timer(statistics, "RenderPass Submission"):
                return self.render(camera, static_path=static_path)
        if not static_path:
            inputs = self.draw_list_inputs(camera)
            return render_frame(
                lights=self.lights, tonemap_params=self.tonemap_params,
                width=self.width, height=self.height,
                supersample=self.supersample, textures=self._cached_textures,
                use_pallas=self.use_pallas, **inputs)
        mapping, instances, tables, materials, cam, slots, visible = (
            self.frame_inputs(camera))
        return render_frame_static(
            mapping, instances, tables, materials, self.lights, cam, slots,
            visible, self.tonemap_params,
            width=self.width, height=self.height, do_culling=self.do_culling,
            translucent_layers=self.translucent_layers,
            supersample=self.supersample, textures=self._cached_textures,
            use_pallas=self.use_pallas,
        )

    def frame_inputs(self, camera: Camera | CameraMatrices):
        """The device inputs of one static frame, as ``render`` hands them to
        ``render_frame_static``: (mapping, instances, tables, materials,
        camera, slot materials, visible); the atlas is then
        ``_cached_textures``. Flushes pending scene changes."""
        cam = camera.matrices if isinstance(camera, Camera) else camera
        instances = self.scene.flush()
        slots, visible, materials = self._device_inputs(instances.capacity)
        return (self._current_mapping(), instances, self.scene.tables(),
                materials, cam.to(self.device), slots, visible)

    def draw_list_inputs(self, camera: Camera | CameraMatrices) -> dict:
        """The arguments of ``draw_list_batch`` for one draw-list frame, as
        ``render`` hands them to ``render_frame``. Flushes pending scene
        changes."""
        cam = camera.matrices if isinstance(camera, Camera) else camera
        instances = self.scene.flush()
        slots, visible, materials = self._device_inputs(instances.capacity)
        return dict(
            instances=instances, tables=self.scene.tables(),
            geo=self.scene.geometry(), materials=materials,
            camera=cam.to(self.device), slot_materials=slots,
            instance_visible=visible,
            max_meshes_per_lod=self.scene.max_meshes_per_lod,
            tri_capacity=self._required_tri_capacity(),
            do_culling=self.do_culling)
