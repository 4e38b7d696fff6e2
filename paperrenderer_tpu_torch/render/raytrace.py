"""RayTraceRender: the ray-traced render path.

PyTorch counterpart of ``paperrenderer_tpu/render/raytrace.py`` on its
two-level path (reference RayTrace.h:37-99):

  * **BLAS** per model, built once at first use over LOD-0 object-space
    triangles (Model.cpp:59-74) and cached (``AccelCache``);
  * **TLAS** per frame per pass over the instances' world AABBs, the
    ``TLAS::updateTLAS`` analogue (AccelerationStructure.cpp:618-650);
  * **several TLASes** (RayTrace.h:50-56, ``add_tlas``) share the BLAS rows
    and are appended as extra node-row blocks with their own roots;
  * per-instance 8-bit visibility masks and force-opaque flags;
  * big scenes on the paged layout (chunked TLAS, big models' BLAS chunks):
    ``render`` picks it with ``accel.prefer_paged``, as the JAX package
    does, on every device; a paged frame traces the one TLAS it renders.

The frame traces on the scene's device: the traversal kernels of
``csrc/trace.cu`` on the card (K7-K9 flat, K10/K11 paged), their plain
versions on the CPU.

A scene with a ``SHADE_LEAF`` material traces with the any-hit leaf
cutout (``leaf_cutout`` = ``MaterialRegistry.has_leaf``, as in the JAX
package): primary, AO and reflection rays skip a leaf hit outside the
procedural leaf, shadow rays stay opaque. ``reflection_half_rate`` traces
reflections for every other pixel (``ops.trace.reflections_half_rate``).

Textured materials shade their hits with the registry's atlas, uploaded
with the material table and sampled bilinear at mip 0 (``ops.trace``).

Unique-geometry animation (Model.cpp:398-404): an instance made with
``unique_geometry=True`` gets a BLAS of its own, whose rows each frame
refits from ``animate(v, time + phase)`` (``RayTraceRender(animate=)``,
``render(cam, time=)``); ``anim_resplit`` re-splits its leaves at the
animated pose first (``accel.resplit_anim_tables``).

Not ported yet, refused with ``NotImplementedError``: the XLA route
(``use_pallas=False``, ROADMAP Queue 1 item 8). ``compact_secondary``,
``compact_refl``,
``packet_pack`` and ``bvh_wide`` are TPU scheduling knobs that leave every
result unchanged: they are accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.camera import Camera, CameraMatrices
from ..core.material import MaterialInstance, MaterialRegistry
from ..core.model import ModelInstance
from ..core.scene import InstanceArrays, Scene
from ..ops import accel as ACC
from ..ops.animation import f32_time
from ..ops.shading import Lights
from ..ops.tonemap import TonemapParams, tonemap
from ..ops.trace import RTParams, trace_frame
from ..utils import random as rnd
from ..utils.device import check_use_pallas, require_device


class AccelCache:
    """The scene's BLAS set and per-topology device inputs, rebuilt only
    when models or the unique-geometry instances (BLAS) or the instance set
    (``inst_blas``) change — the AccelerationStructureBuilder analogue."""

    def __init__(self, scene: Scene):
        self.scene = scene
        self._blas_key = self._blas = None
        self._inst_key = self._inst_blas = None
        self._attr_key = self._tri_attr = None

    def _blas_signature(self):
        uniq = tuple(i.index for i in self.scene.instances
                     if i.unique_geometry)
        return (len(self.scene.models), self.scene.arena.revision, uniq)

    def blas(self):
        """(BLASSet, BLASSetMeta, anim_rest, anim_rest_nodes) on the
        scene's device (``accel.build_blas_set``)."""
        k = self._blas_signature()
        if k != self._blas_key:
            self._blas = ACC.build_blas_set(self.scene, self.scene.device)
            self._blas_key = k
        return self._blas

    def inst_blas(self, capacity: int) -> torch.Tensor:
        k = (self.scene.version, capacity, self._blas_signature())
        if k != self._inst_key:
            meta = self.blas()[1]
            arr = np.zeros(capacity, np.int32)
            for inst in self.scene.instances:
                arr[inst.index] = meta.blas_of_model[inst.model.model_id]
            for a in meta.anim:   # a unique instance traces its own BLAS
                if 0 <= a.instance_index < capacity:
                    arr[a.instance_index] = a.blas_id
            self._inst_blas = torch.from_numpy(arr).to(self.scene.device)
            self._inst_key = k
        return self._inst_blas

    def tri_attr(self) -> torch.Tensor:
        k = (self.scene.arena.revision, len(self.scene.models))
        if k != self._attr_key:
            self._tri_attr = ACC.build_tri_attr(self.scene, self.scene.device)
            self._attr_key = k
        return self._tri_attr

    def stack_size(self, capacity: int) -> int:
        return ACC.required_stack_size(self.blas()[1], capacity)

    def prefer_paged(self, capacity: int) -> bool:
        """The layout of this scene's frames (``accel.prefer_paged``)."""
        return ACC.prefer_paged(self.blas()[1], capacity,
                                max(1, self.scene.max_slots))


def render_frame_rt(blasset, meta, anim_rest, anim_rest_nodes,
                    instances: InstanceArrays, inst_blas, masks, tri_attr,
                    materials, lights: Lights, camera: CameraMatrices,
                    slot_materials, tonemap_params, key, time=None,
                    inst_mask=None, inst_opaque=None, *, width: int,
                    height: int, stack_size: int, params: RTParams,
                    tlas_index: int = 0, paged: bool = False, textures=None,
                    animate=None, resplit: bool = False):
    """One ray-traced frame (the JAX package's ``make_rt_frame`` body):
    refit the anim BLASes at ``time`` with ``animate`` (re-split first with
    ``resplit``), assemble this frame's TLAS on the flat or, with
    ``paged``, the paged layout, trace, tonemap; ``textures`` is the atlas
    of textured materials (or None). Returns (ldr f32[H, W, 3], {"hdr":
    f32[H, W, 3]})."""
    ctx = ACC.make_scene_tracer(
        blasset, meta, anim_rest, anim_rest_nodes, instances, inst_blas,
        masks, tri_attr, slot_materials, materials, tlas_index=tlas_index,
        stack_size=stack_size, paged=paged, inst_mask=inst_mask,
        inst_opaque=inst_opaque, leaf_cutout=params.leaf_cutout,
        textures=textures, time=time, animate=animate, resplit=resplit)
    hdr = trace_frame(ctx, materials, lights, camera, key, width=width,
                      height=height, params=params)
    return tonemap(hdr, tonemap_params), {"hdr": hdr}


class RayTraceRender:
    """Host-side RT pass (reference RayTrace.h:37-99). ``add_tlas()`` mirrors
    ``addNewTLAS`` (RayTrace.cpp:159-170); ``render(camera, tlas=i)``
    traces against TLAS ``i``. Every tensor lives on the scene's device.
    ``animate(v, t)`` moves a unique-geometry instance's object-space
    vertices v f32[M, 3] at its time t f32[] (``render``'s time + the
    instance's phase), as in the JAX package, and ``anim_resplit``
    re-splits their BLASes at the animated pose every frame."""

    def __init__(
        self,
        scene: Scene,
        materials: MaterialRegistry,
        *,
        width: int = 512,
        height: int = 512,
        lights: Optional[Lights] = None,
        tonemap_params: Optional[TonemapParams] = None,
        shadow_samples: int = 1,
        reflection_samples: int = 1,
        ao_samples: int = 1,
        ao_radius: float = 2.0,
        seed: int = 0,
        animate=None,
        anim_resplit: bool = False,
        use_pallas: Optional[bool] = None,
        reflection_half_rate: bool = False,
        fuse_bounce: bool = False,
        cull_mask: int = 0xFF,
        shadow_cull_mask: int = 0xFF,
        compact_secondary: bool = False,   # TPU scheduling knobs: results
        compact_refl: bool = False,        # are the same either way, so
        packet_pack: Optional[int] = None,  # they are accepted and ignored
        bvh_wide: bool = True,
    ):
        check_use_pallas(use_pallas)
        self.scene = scene
        self.animate = animate
        self.anim_resplit = anim_resplit
        self.materials = materials
        self.device = scene.device
        self.width = width
        self.height = height
        self.lights = lights or Lights.make(
            [{"position": (3.0, -4.0, 5.0), "color": (40.0, 40.0, 40.0),
              "bounds": 100.0}])
        self.tonemap_params = tonemap_params or TonemapParams.default()
        self.params = RTParams(
            shadow_samples=shadow_samples,
            reflection_samples=reflection_samples, ao_samples=ao_samples,
            ao_radius=ao_radius, cull_mask=int(cull_mask) & 0xFF,
            shadow_cull_mask=int(shadow_cull_mask) & 0xFF,
            reflection_half_rate=reflection_half_rate,
            fuse_bounce=fuse_bounce)
        self._key = rnd.prng_key(seed)
        self._frame = 0
        # per-TLAS instance sets: index -> {slot: material id}
        self._tlas_bindings: List[Dict[int, Dict[int, int]]] = [{}]
        self._inst_masks: Dict[int, int] = {}
        self._inst_opaque: set = set()
        self.accel = AccelCache(scene)
        self._cache_dirty = True
        self._cached_capacity = -1
        self._cached = None
        self._cached_textures = None

    # -- TLAS management (addNewTLAS parity) ---------------------------------
    def add_tlas(self) -> int:
        self._tlas_bindings.append({})
        self._cache_dirty = True
        return len(self._tlas_bindings) - 1

    @property
    def num_tlas(self) -> int:
        return len(self._tlas_bindings)

    def add_instance(self, instance: ModelInstance,
                     materials: Optional[Dict[int, MaterialInstance]] = None,
                     tlas: int = 0, *, mask: int = 0xFF,
                     force_opaque: bool = False) -> None:
        """Register an instance in TLAS ``tlas`` with its 8-bit visibility
        ``mask`` (a trace sees it only when ``mask & cull_mask != 0``) and
        force-opaque flag (AccelerationStructureInstanceData, RayTrace.h:19-35)."""
        if instance.index < 0:
            self.scene.add_instance(instance)
        self._tlas_bindings[tlas][instance.index] = {
            slot: self.materials.register(mat)
            for slot, mat in (materials or {}).items()}
        self._inst_masks[instance.index] = int(mask) & 0xFF
        if force_opaque:
            self._inst_opaque.add(instance.index)
        else:
            self._inst_opaque.discard(instance.index)
        self._cache_dirty = True

    def add_instances_from(self, render_pass, tlas: int = 0) -> None:
        """Adopt a RenderPass's instances and material bindings (the
        reference example's raster <-> RT switch renders one scene through
        either pipeline, GuiRender.cpp:79-87). Both must share one
        MaterialRegistry."""
        if render_pass.materials is not self.materials:
            raise ValueError("renders must share a MaterialRegistry")
        for idx, binds in render_pass._bindings.items():
            self._tlas_bindings[tlas][idx] = dict(binds)
        self._cache_dirty = True

    def remove_instance(self, instance: ModelInstance,
                        tlas: Optional[int] = None) -> None:
        sets = (self._tlas_bindings if tlas is None
                else [self._tlas_bindings[tlas]])
        for b in sets:
            b.pop(instance.index, None)
        if not any(instance.index in b for b in self._tlas_bindings):
            self._inst_masks.pop(instance.index, None)
            self._inst_opaque.discard(instance.index)
        self._cache_dirty = True

    def set_instance_mask(self, instance: ModelInstance, mask: int) -> None:
        self._inst_masks[instance.index] = int(mask) & 0xFF
        self._cache_dirty = True

    def invalidate(self) -> None:
        """Force re-upload of material tables after live edits."""
        self._cache_dirty = True

    # -- device inputs --------------------------------------------------------
    def _device_inputs(self, capacity: int):
        """(slot materials i32[N, S], TLAS masks, MaterialTable, instance
        masks i32[N], force-opaque bool[N], lights, tonemap params); the
        texture atlas is cached beside them (``_cached_textures``)."""
        if self._cache_dirty or capacity != self._cached_capacity:
            s = max(1, self.scene.max_slots)
            slots = np.zeros((capacity, s), np.int32)
            masks = []
            for binds_by_inst in self._tlas_bindings:
                m = np.zeros(capacity, bool)
                for idx, binds in binds_by_inst.items():
                    if 0 <= idx < capacity:
                        m[idx] = True
                        for slot, mid in binds.items():
                            if slot < s:
                                slots[idx, slot] = mid
                masks.append(m)
            inst_mask = np.full(capacity, 0xFF, np.int32)
            for idx, v in self._inst_masks.items():
                if 0 <= idx < capacity:
                    inst_mask[idx] = v
            opaque = np.zeros(capacity, bool)
            for idx in self._inst_opaque:
                if 0 <= idx < capacity:
                    opaque[idx] = True
            dev = lambda a: torch.from_numpy(a).to(self.device)
            self._cached = (dev(slots), tuple(dev(m) for m in masks),
                            self.materials.table(self.device), dev(inst_mask),
                            dev(opaque), self.lights.to(self.device),
                            self.tonemap_params.to(self.device))
            # after the table: it adds the rows' images to the atlas
            self._cached_textures = self.materials.texture_arrays(self.device)
            self._cached_capacity = capacity
            self._cache_dirty = False
        return self._cached

    def render(self, camera: Camera | CameraMatrices, *, tlas: int = 0,
               time: float = 0.0, paged: Optional[bool] = None):
        """Trace one frame; returns (ldr f32[H, W, 3], {"hdr": ...}).
        ``paged`` forces a layout (None: ``accel.prefer_paged``'s);
        ``time`` is the animation time of the unique-geometry instances
        (f32, each instance's phase added in f32)."""
        require_device(self.device)
        cam = camera.matrices if isinstance(camera, Camera) else camera
        instances = self.scene.flush()
        blasset, meta, anim_rest, anim_nodes = self.accel.blas()
        slots, masks, table, inst_mask, opaque, lights, tm = (
            self._device_inputs(instances.capacity))
        self._frame += 1
        if paged is None:
            paged = self.accel.prefer_paged(instances.capacity)
        return render_frame_rt(
            blasset, meta, anim_rest, anim_nodes, instances,
            self.accel.inst_blas(instances.capacity), masks,
            self.accel.tri_attr(), table, lights, cam.to(self.device), slots,
            tm, rnd.fold_in(self._key, self._frame),
            f32_time(time), inst_mask, opaque,
            width=self.width, height=self.height,
            stack_size=self.accel.stack_size(instances.capacity),
            params=dataclasses.replace(self.params,
                                       leaf_cutout=self.materials.has_leaf),
            tlas_index=tlas, paged=paged, textures=self._cached_textures,
            animate=self.animate, resplit=self.anim_resplit)
