"""RenderPass: raster frame orchestration.

PyTorch counterpart of ``paperrenderer_tpu/render/renderpass.py`` on the
static path (reference RenderPass.h:103-134, RenderPass.cpp:444-742). One
frame is a sequence of tensor ops on the pass's device:

    Scene.flush -> expand_static (transform, cull + LOD masks)
      -> attach_cull -> rasterize_exact (setup, binning, raster kernel K1)
      -> resolve_gbuffer_pairs -> shade_gbuffer
      [-> composite_translucency: depth peel (K2 per layer), blend]
      [-> supersample box resolve] -> tonemap

Pair buffers are sized from each frame's own pair count, so a frame is
always complete (no capacity to outgrow); see ``ops.raster_exact``.

Not ported yet, and refused with ``NotImplementedError``: the draw-list path
``static_path=False`` (ROADMAP Queue 1 item 6) and textures (item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.camera import Camera, CameraMatrices
from ..core.material import MaterialInstance, MaterialRegistry, MaterialTable
from ..core.model import ModelInstance
from ..core.scene import InstanceArrays, Scene, SceneTables
from ..ops.raster import attach_cull
from ..ops.raster_exact import rasterize_exact, resolve_gbuffer_pairs
from ..ops.shading import Lights, shade_gbuffer
from ..ops.static_batch import StaticMapping, build_static_mapping, expand_static
from ..ops.tonemap import TonemapParams, tonemap
from ..ops.translucency import composite_translucency, non_opaque_mask
from ..utils.device import require_device
from ..utils.stats import Timer


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
):
    """The static raster frame. Returns (ldr f32[H, W, 3], aux dict).

    ``translucent_layers > 0`` adds the sorted-translucency pass (depth
    peeling + back-to-front blend) over SHADE_TRANSLUCENT and SHADE_LEAF
    materials; the opaque pass then leaves those triangles out.

    ``supersample`` = s rasterizes and shades at s x s the resolution and
    box-filters the HDR image before tonemapping (the analogue of the
    reference's MSAA sample count, RenderPass.h:61); ``aux["depth"]`` keeps
    the top-left sample of each s x s cell."""
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
    depth, tid, attr_table, required = rasterize_exact(
        batch, width * ss, height * ss)
    gbuf = resolve_gbuffer_pairs(attr_table, depth, tid, camera)
    hdr = shade_gbuffer(gbuf, materials, lights, camera.cam_pos)
    if translucent_layers > 0:
        hdr, peel_required = composite_translucency(
            hdr, depth, full_batch, materials, lights, camera,
            layers=translucent_layers)
        required = max(required, peel_required)
    if ss > 1:
        # box filter in the JAX package's order: strided slices summed
        # row-major, then scaled
        acc = hdr[0::ss, 0::ss]
        for i in range(ss):
            for j in range(ss):
                if i or j:
                    acc = acc + hdr[i::ss, j::ss]
        hdr = acc * (1.0 / (ss * ss))
        depth = depth[::ss, ::ss]
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

    ``device`` defaults to the scene's; every per-frame tensor lives there."""

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
    ):
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
        # static mapping keyed on scene.version
        self._mapping = None
        self._mapping_version = -1

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
        """(slot materials i32[N, S], visible bool[N], MaterialTable)."""
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
            self._cached_capacity = capacity
            self._cache_dirty = False
        return self._cached

    def _current_mapping(self) -> StaticMapping:
        if self._mapping is None or self._mapping_version != self.scene.version:
            self._mapping = build_static_mapping(self.scene)
            self._mapping_version = self.scene.version
        return self._mapping

    def render(
        self,
        camera: Camera | CameraMatrices,
        *,
        static_path: bool = True,
        statistics=None,
    ):
        """Render one frame; returns (ldr f32[H, W, 3], aux dict).

        Pass a StatisticsTracker to record the submission timer (the
        reference's "RenderPass Submission" timer, RenderPass.cpp:447)."""
        if statistics is not None:
            with Timer(statistics, "RenderPass Submission"):
                return self.render(camera, static_path=static_path)
        if not static_path:
            raise NotImplementedError(
                "the draw-list raster path is not ported yet (ROADMAP Queue 1 "
                "item 6)")
        mapping, instances, tables, materials, cam, slots, visible = (
            self.frame_inputs(camera))
        return render_frame_static(
            mapping, instances, tables, materials, self.lights, cam, slots,
            visible, self.tonemap_params,
            width=self.width, height=self.height, do_culling=self.do_culling,
            translucent_layers=self.translucent_layers,
            supersample=self.supersample,
        )

    def frame_inputs(self, camera: Camera | CameraMatrices):
        """The device inputs of one static frame, as ``render`` hands them to
        ``render_frame_static``: (mapping, instances, tables, materials,
        camera, slot materials, visible). Flushes pending scene changes."""
        cam = camera.matrices if isinstance(camera, Camera) else camera
        instances = self.scene.flush()
        slots, visible, materials = self._device_inputs(instances.capacity)
        return (self._current_mapping(), instances, self.scene.tables(),
                materials, cam.to(self.device), slots, visible)
