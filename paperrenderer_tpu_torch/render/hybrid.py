"""Hybrid rendering: raster G-buffer + ray-traced lighting composited.

PyTorch counterpart of ``paperrenderer_tpu/render/hybrid.py`` (bench config
4): primary visibility from the rasterizer, then the RT passes (soft
shadows, RTAO, 1-bounce reflections) evaluated at the G-buffer surfaces and
fed into the raster frame's deferred shading. The RT passes trace the
two-level BLAS/TLAS of ``ops/accel.py`` on the layout ``accel.prefer_paged``
picks: flat (K9 for shadows + AO, K8 for reflections) or paged (K10 for
shadows and AO, K11 for reflections). A scene with a ``SHADE_LEAF``
material traces its AO and reflection rays with the any-hit leaf cutout
(K8/K11's alpha forms; shadows stay opaque and AO leaves the fused bundle),
while the G-buffer stays the raster one with no cutout, as in the JAX
package. Textured materials are sampled trilinear in the G-buffer's shade
and bilinear at mip 0 on the reflection hits, as in the JAX package.

``HybridRender(animate=)`` refits the unique-geometry instances' BLASes at
``render(cam, time=)`` for the RT passes; the G-buffer comes from
``expand_static`` without ``animate``, so those instances are rasterized
at their rest pose while the RT passes see them animated, as in the JAX
package (a reference behaviour, ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.camera import Camera, CameraMatrices
from ..core.material import MaterialInstance
from ..core.model import ModelInstance
from ..ops import accel as ACC
from ..ops.animation import f32_time
from ..ops import trace as T
from ..ops.raster import attach_cull
from ..ops.raster_exact import rasterize_exact, resolve_gbuffer_pairs
from ..ops.shading import Lights, shade_gbuffer
from ..ops.static_batch import expand_static
from ..ops.tonemap import TonemapParams, tonemap
from ..utils import random as rnd
from ..utils.device import check_use_pallas, require_device
from .raytrace import AccelCache
from .renderpass import RenderPass


def render_frame_hybrid(mapping, blasset, meta, anim_rest, anim_rest_nodes,
                        instances, inst_blas, tri_attr, tables, materials,
                        lights: Lights, camera: CameraMatrices,
                        slot_materials, instance_visible, tonemap_params, key,
                        time=None, *, width: int,
                        height: int, stack_size: int, paged: bool = False,
                        do_culling: bool = True, shadow_samples: int = 1,
                        reflection_samples: int = 1, ao_samples: int = 1,
                        ao_radius: float = 2.0, leaf_cutout: bool = False,
                        reflection_half_rate: bool = False, textures=None,
                        animate=None):
    """One hybrid frame (the body of the JAX package's ``make_hybrid_frame``):
    the static raster G-buffer through K1, the scene's tracer on the flat or
    (``paged``) the paged layout, shadows + AO + the fused-or-not bounce at
    the G-buffer surfaces, deferred shading with them, reflections (at half
    rate with ``reflection_half_rate`` on an even width), tonemap; with
    ``leaf_cutout`` the RT passes apply the any-hit leaf cutout;
    ``textures`` (the atlas, or None) goes to the shade and the tracer;
    ``animate`` refits the anim BLASes at ``time`` for the RT passes (the
    G-buffer keeps the rest pose, as in the JAX package). Returns (ldr
    f32[H, W, 3], aux dict)."""
    batch, inst_visible = expand_static(
        mapping, instances, tables, camera, slot_materials, instance_visible,
        do_culling=do_culling)
    batch = attach_cull(batch, materials)
    depth, tid, attr_table, required = rasterize_exact(batch, width, height)
    gbuf = resolve_gbuffer_pairs(attr_table, depth, tid, camera)

    # the RT passes see the whole scene (one TLAS of every live instance)
    mask = (torch.ones(instances.capacity, dtype=torch.bool,
                       device=instances.pos.device),)
    ctx = ACC.make_scene_tracer(
        blasset, meta, anim_rest, anim_rest_nodes, instances, inst_blas,
        mask, tri_attr, slot_materials, materials, tlas_index=0,
        stack_size=stack_size, paged=paged, leaf_cutout=leaf_cutout,
        textures=textures, time=time, animate=animate)
    cov = gbuf.coverage.reshape(-1)
    surf = T.SurfaceHits(
        world_pos=gbuf.world_pos.reshape(-1, 3),
        normal=gbuf.normal.reshape(-1, 3), uv=gbuf.uv.reshape(-1, 2),
        material=gbuf.material.reshape(-1), valid=cov,
        t=torch.where(cov, depth.reshape(-1), float("inf")))
    params = T.RTParams(shadow_samples=shadow_samples,
                        reflection_samples=reflection_samples,
                        ao_samples=ao_samples, ao_radius=ao_radius,
                        leaf_cutout=leaf_cutout,
                        reflection_half_rate=reflection_half_rate)
    refl_key = rnd.fold_in(key, 7)
    svis, ao, pre_bounce = T.shadow_ao_bounce(
        surf, ctx, materials, lights, camera.cam_pos, key,
        rnd.fold_in(key, 3), refl_key, params=params)
    hdr = shade_gbuffer(gbuf, materials, lights, camera.cam_pos,
                        shadow_vis=svis.reshape(-1, height, width),
                        ambient_occlusion=ao.reshape(height, width),
                        background=T.BACKGROUND_RGB, textures=textures)
    if reflection_samples > 0:
        if reflection_half_rate and width % 2 == 0:
            refl = T.reflections_half_rate(surf, ctx, materials, lights,
                                           camera.cam_pos, refl_key, params)
        else:
            refl = T.reflections(surf, ctx, materials, lights,
                                 camera.cam_pos, refl_key, params,
                                 pretraced=pre_bounce)
        hdr = hdr + torch.where(gbuf.coverage[..., None],
                                refl.reshape(height, width, 3), 0.0)
    ldr = tonemap(hdr, tonemap_params)
    aux = {"hdr": hdr, "coverage": gbuf.coverage.float().mean(),
           "visible_count": inst_visible.sum(), "required_work": required,
           "paged": paged}
    return ldr, aux


class HybridRender:
    """Host-side hybrid pass: a ``RenderPass`` holds the instances, their
    materials and visibility, the lights and the tonemap; this adds the RT
    settings. ``render`` picks the layout with ``accel.prefer_paged`` and
    draws the JAX package's samples (``fold_in(seed key, frame)``; shadows
    from it, AO from its ``fold_in(., 3)``, reflections from ``fold_in(.,
    7)``).

    ``animate`` (as ``RayTraceRender``'s) moves the unique-geometry
    instances for the RT passes at ``render(cam, time=)``. Not ported yet,
    refused with ``NotImplementedError``: ``use_pallas=False`` (ROADMAP
    Queue 1 item 8). ``bvh_wide`` is a TPU scheduling knob and is ignored.
    The JAX
    package's pair-capacity protocol is not ported: the port sizes its
    raster pair buffers from each frame's own count."""

    def __init__(
        self,
        scene,
        materials,
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
        use_pallas: Optional[bool] = None,
        reflection_half_rate: bool = False,
        bvh_wide: bool = True,
    ):
        check_use_pallas(use_pallas)
        self.animate = animate
        self._rp = RenderPass(scene, materials, width=width, height=height,
                              lights=lights, tonemap_params=tonemap_params)
        self.scene = scene
        self.materials = materials
        self.device = self._rp.device
        self.width = width
        self.height = height
        self.shadow_samples = shadow_samples
        self.reflection_samples = reflection_samples
        self.ao_samples = ao_samples
        self.ao_radius = ao_radius
        self.reflection_half_rate = reflection_half_rate
        self._key = rnd.prng_key(seed)
        self._frame = 0
        self.accel = AccelCache(scene)

    # the instance API delegates to the RenderPass
    def add_instance(self, instance: ModelInstance,
                     materials: Optional[Dict[int, MaterialInstance]] = None):
        self._rp.add_instance(instance, materials)

    def add_instances_from(self, render_pass: RenderPass) -> None:
        """Adopt a RenderPass's instances, material bindings and visibility
        (as ``RayTraceRender.add_instances_from``); both must share one
        MaterialRegistry."""
        if render_pass.materials is not self.materials:
            raise ValueError("renders must share a MaterialRegistry")
        self._rp._bindings.update(
            {i: dict(b) for i, b in render_pass._bindings.items()})
        self._rp._visible.update(render_pass._visible)
        self._rp.invalidate()

    def remove_instance(self, instance: ModelInstance) -> None:
        self._rp.remove_instance(instance)

    def set_instance_visibility(self, instance: ModelInstance,
                                visible: bool) -> None:
        self._rp.set_instance_visibility(instance, visible)

    def invalidate(self) -> None:
        """Force re-upload of material/visibility tables after live edits."""
        self._rp.invalidate()

    @property
    def lights(self) -> Lights:
        return self._rp.lights

    def render(self, camera: Camera | CameraMatrices, *, time: float = 0.0,
               paged: Optional[bool] = None):
        """One hybrid frame; returns (ldr f32[H, W, 3], aux dict).
        ``paged`` forces a layout (None: ``accel.prefer_paged``'s);
        ``time`` is the animation time of the unique-geometry instances."""
        require_device(self.device)
        rp = self._rp
        mapping, instances, tables, table, cam, slots, visible = (
            rp.frame_inputs(camera))
        blasset, meta, anim_rest, anim_nodes = self.accel.blas()
        cap = instances.capacity
        self._frame += 1
        return render_frame_hybrid(
            mapping, blasset, meta, anim_rest, anim_nodes, instances,
            self.accel.inst_blas(cap), self.accel.tri_attr(), tables, table,
            rp.lights, cam, slots, visible, rp.tonemap_params,
            rnd.fold_in(self._key, self._frame), f32_time(time),
            width=self.width, height=self.height,
            stack_size=self.accel.stack_size(cap),
            paged=(self.accel.prefer_paged(cap) if paged is None else paged),
            do_culling=rp.do_culling,
            shadow_samples=self.shadow_samples,
            reflection_samples=self.reflection_samples,
            ao_samples=self.ao_samples, ao_radius=self.ao_radius,
            leaf_cutout=self.materials.has_leaf,
            reflection_half_rate=self.reflection_half_rate,
            textures=rp._cached_textures, animate=self.animate)
