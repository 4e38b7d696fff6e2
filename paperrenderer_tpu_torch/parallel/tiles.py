"""Screen-tile sharded rendering over ``torch.distributed``.

PyTorch counterpart of ``paperrenderer_tpu/parallel/tiles.py``. Each rank of
a ``TileMesh`` renders one window of the frame:

  * the scene (instance SoA, tables, materials, the BLASes) is REPLICATED:
    every rank holds a copy and assembles the TLAS itself;
  * the static triangle expansion is SHARDED over the triangle axis: rank i
    expands the contiguous i-th ``capacity / n`` slice of the static
    mapping's per-triangle rows (the run tables stay whole), and one
    ``all_gather`` per ``TriangleBatch`` field assembles the full batch;
  * each rank then rasterizes, resolves, shades, peels, box-resolves,
    traces and tonemaps its own window, with full-viewport coefficients and
    the window's origin (``ops.raster_exact``, ``ops.trace.raygen``), so
    its pixels are bitwise the single-device frame's;
  * ``required`` (the binned raster's pair count) is an all-reduce MAX, the
    counterpart of JAX's ``pmax``; each function returns the rank's tile,
    and ``gather_tiles`` assembles the image on every rank (JAX's host
    gather on readback).

The random samples of a tile come from ``fold_in(key, row * cols + col)``,
as in the JAX package, so an RT or hybrid tile matches a one-process call
on its window with that key, not the single-device frame.

Collectives by backend, never a silent fallback: NCCL gathers the card's
tensors where each rank has its own card; gloo gathers CPU tensors (the CPU
tests) and, where the ranks share one card (NCCL refuses two ranks on one
GPU), stages each gathered tensor through host memory while the kernels
stay on the card. ``launch.spawn_ranks`` starts the ranks.

``sharded_rt_frame`` (JAX's legacy per-frame world BVH) is not ported: it
needs ``BatchTracer``, which the port leaves out (a validation path only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..core.camera import CameraMatrices
from ..core.material import MaterialTable
from ..core.scene import InstanceArrays, SceneTables
from ..ops import accel as ACC
from ..ops import trace as T
from ..ops.preprocess import preprocess_instances
from ..ops.raster import (
    TriangleBatch, attach_cull, build_triangle_batch, rasterize,
    resolve_gbuffer, triangle_coefficients)
from ..ops.raster_exact import CELL_W, GROUP, _bin_spans, _round_up
from ..ops.shading import Lights, shade_gbuffer
from ..ops.static_batch import StaticMapping, expand_static
from ..ops.tonemap import TonemapParams, tonemap
from ..ops.translucency import composite_translucency, non_opaque_mask
from ..render.renderpass import _box_resolve, raster_gbuffer
from ..utils import random as rnd
from .mesh import TileMesh

_BATCH_FIELDS = ("clip", "world", "normal", "uv", "material", "valid")


# -- collectives ---------------------------------------------------------------

def _staged(mesh: TileMesh, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through host memory for a collective of
    ``mesh``'s backend; ValueError for a pairing the backend cannot take."""
    backend = mesh.backend
    if backend == "nccl" and t.device.type == "cuda":
        return False
    if backend == "gloo":
        return t.device.type == "cuda"
    raise ValueError(f"no {backend} collective for a tensor on {t.device}")


def all_gather_rows(t: torch.Tensor, mesh: TileMesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated on dim 0 in rank (tile) order, on
    ``t``'s device (JAX's ``all_gather(tiled=True)``)."""
    if mesh.size == 1:
        return t
    src = t.contiguous()
    wire = src.view(torch.uint8) if src.dtype == torch.bool else src
    if _staged(mesh, src):
        wire = wire.cpu()
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    out = torch.cat(parts).to(t.device)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def all_reduce_max(value: int, mesh: TileMesh,
                   device: torch.device) -> int:
    """The maximum of ``value`` over the mesh's ranks (JAX's ``pmax``)."""
    if mesh.size == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    if _staged(mesh, t):
        t = t.cpu()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())


def gather_tiles(tile: torch.Tensor, mesh: TileMesh) -> torch.Tensor:
    """The full image [H, W, ...] on every rank from each rank's tile
    [H / rows, W / cols, ...]."""
    rows, cols = mesh.shape
    th, tw = tile.shape[:2]
    flat = all_gather_rows(tile.unsqueeze(0), mesh)     # [n, th, tw, ...]
    rest = tuple(tile.shape[2:])
    img = flat.reshape((rows, cols, th, tw) + rest)
    img = img.permute((0, 2, 1, 3) + tuple(range(4, img.dim())))
    return img.reshape((rows * th, cols * tw) + rest)


# -- the window and the triangle shard -----------------------------------------

def tile_window(mesh: TileMesh, width: int, height: int):
    """(tile_w, tile_h, window keywords) of the rank's tile of a
    width x height viewport; the image must tile evenly."""
    rows, cols = mesh.shape
    assert height % rows == 0 and width % cols == 0, \
        "image must tile evenly"
    tile_h, tile_w = height // rows, width // cols
    ri, ci = mesh.coords
    return tile_w, tile_h, dict(full_width=width, full_height=height,
                                origin=(ci * tile_w, ri * tile_h))


def shard_mapping(mapping: StaticMapping, index: int,
                  n: int) -> StaticMapping:
    """The ``index``-th of ``n`` contiguous slices of the mapping's
    per-triangle rows; the run tables stay whole (JAX's ``mapping_specs``)."""
    assert mapping.capacity % n == 0, "triangle capacity must split evenly"
    k = mapping.capacity // n
    rows = slice(index * k, (index + 1) * k)
    return dataclasses.replace(
        mapping, v_obj=mapping.v_obj[rows], n_obj=mapping.n_obj[rows],
        uv=mapping.uv[rows], valid=mapping.valid[rows],
        run_id=mapping.run_id[rows])


def sharded_batch(mesh: TileMesh, mapping: StaticMapping, instances,
                  tables, camera, slot_materials, instance_visible,
                  do_culling: bool = True) -> TriangleBatch:
    """This rank's triangle shard expanded, then every field gathered: the
    full frame's ``TriangleBatch`` on every rank."""
    local, _vis = expand_static(
        shard_mapping(mapping, mesh.index, mesh.size), instances, tables,
        camera, slot_materials, instance_visible, do_culling=do_culling)
    return TriangleBatch(**{f: all_gather_rows(getattr(local, f), mesh)
                            for f in _BATCH_FIELDS})


# -- the frames ------------------------------------------------------------------

def sharded_render_frame(
    mesh: TileMesh,
    instances: InstanceArrays,
    tables: SceneTables,
    geo,
    materials: MaterialTable,
    lights: Lights,
    camera: CameraMatrices,
    slot_materials: torch.Tensor,
    instance_visible: torch.Tensor,
    tonemap_params: TonemapParams,
    textures=None,
    *,
    width: int,
    height: int,
    max_meshes_per_lod: int,
    tri_capacity: int,
    do_culling: bool = True,
):
    """Raster frame sharded over screen tiles (the draw-list preprocess
    path, replicated on every rank; no collective). Returns the rank's ldr
    tile f32[H / rows, W / cols, 3], rasterized by ``raster.rasterize``
    (the XLA route, as in the JAX package)."""
    tile_w, tile_h, win = tile_window(mesh, width, height)
    pre = preprocess_instances(
        instances, tables, camera, max_meshes_per_lod=max_meshes_per_lod,
        do_culling=do_culling, instance_visible=instance_visible,
        slot_materials=slot_materials)
    batch = attach_cull(build_triangle_batch(pre, geo, camera,
                                             capacity=tri_capacity),
                        materials)
    depth, tid, bary = rasterize(batch, tile_w, tile_h, **win)
    gbuf = resolve_gbuffer(batch, depth, tid, bary)
    hdr = shade_gbuffer(gbuf, materials, lights, camera.cam_pos,
                        textures=textures)
    return tonemap(hdr, tonemap_params)


def static_tile(batch: TriangleBatch, materials, lights, camera,
                tonemap_params, textures=None, *, tile_w: int, tile_h: int,
                window: dict, use_pallas: bool = False,
                translucent_layers: int = 0, ss: int = 1):
    """The static frame's work on one window of the full (gathered) batch:
    (ldr, required, aux {"depth", "tri_id"} of the opaque pass at the
    supersampled resolution). ``required`` is this window's own."""
    batch = attach_cull(batch, materials)
    full_batch = batch
    if translucent_layers > 0:
        # the opaque pass must not z-write translucent/cutout geometry
        batch = dataclasses.replace(
            batch,
            valid=batch.valid & ~non_opaque_mask(materials, batch.material))
    depth, gbuf, required = raster_gbuffer(batch, tile_w, tile_h, camera,
                                           use_pallas, **window)
    hdr = shade_gbuffer(gbuf, materials, lights, camera.cam_pos,
                        textures=textures)
    if translucent_layers > 0:
        hdr, peel_required = composite_translucency(
            hdr, depth, full_batch, materials, lights, camera,
            layers=translucent_layers, textures=textures,
            use_exact=use_pallas, **window)
        required = max(required, peel_required)
    aux = {"depth": depth, "tri_id": gbuf.tri_id}
    if ss > 1:
        hdr, _ = _box_resolve(hdr, depth, ss)
    return tonemap(hdr, tonemap_params), required, aux


def sharded_render_frame_static(
    mesh: TileMesh,
    mapping: StaticMapping,
    instances: InstanceArrays,
    tables: SceneTables,
    materials: MaterialTable,
    lights: Lights,
    camera: CameraMatrices,
    slot_materials: torch.Tensor,
    instance_visible: torch.Tensor,
    tonemap_params: TonemapParams,
    textures=None,
    *,
    width: int,
    height: int,
    do_culling: bool = True,
    use_pallas: bool = False,
    work_capacity: int = 0,
    return_required: bool = False,
    translucent_layers: int = 0,
    supersample: int = 1,
    return_aux: bool = False,
):
    """The static frame sharded two ways: triangle expansion over the
    triangle axis (one ``all_gather`` a batch field assembles the full
    batch), raster + shading over screen tiles. ``use_pallas=True``
    rasterizes each window with K1 (the peel with K2), else with the XLA
    route; ``translucent_layers``/``supersample`` as in
    ``render_frame_static``, each rank peeling, blending and box-resolving
    its own window.

    Returns the rank's ldr tile f32[H / rows, W / cols, 3]; with
    ``return_required`` also the pair count's maximum over the ranks (0 on
    the XLA route); with ``return_aux`` also {"depth", "tri_id"}, the
    tile's opaque pass at the supersampled resolution. ``work_capacity``
    is accepted for the JAX signature: the port sizes its pair buffers
    from each frame's own count."""
    del work_capacity
    assert mapping.capacity % mesh.size == 0, \
        "triangle capacity must split evenly"
    ss = max(1, int(supersample))
    tile_w, tile_h, win = tile_window(mesh, width * ss, height * ss)
    batch = sharded_batch(mesh, mapping, instances, tables, camera,
                          slot_materials, instance_visible, do_culling)
    ldr, required, aux = static_tile(
        batch, materials, lights, camera, tonemap_params, textures,
        tile_w=tile_w, tile_h=tile_h, window=win, use_pallas=use_pallas,
        translucent_layers=translucent_layers, ss=ss)
    if use_pallas:
        required = all_reduce_max(required, mesh, ldr.device)
    out = (ldr,) + ((required,) if return_required else ()) \
        + ((aux,) if return_aux else ())
    return out if len(out) > 1 else ldr


def measure_sharded_demand(
    mapping: StaticMapping,
    instances: InstanceArrays,
    tables: SceneTables,
    camera: CameraMatrices,
    slot_materials: torch.Tensor,
    instance_visible: torch.Tensor,
    materials: Optional[MaterialTable] = None,
    *,
    width: int,
    height: int,
    rows: int,
    cols: int,
    do_culling: bool = True,
    translucent_layers: int = 0,
    supersample: int = 1,
) -> int:
    """The ``required`` that ``sharded_render_frame_static(use_pallas=True)``
    returns, without rasterizing, on one process: the maximum over the
    rows x cols windows of the windowed binning's pair count (of the opaque
    and the peel pass with ``translucent_layers``). ``materials`` adds the
    per-material back-face culling the pipeline applies. Launches no
    kernel."""
    assert height % rows == 0 and width % cols == 0
    ss = max(1, int(supersample))
    width, height = width * ss, height * ss
    tile_h, tile_w = height // rows, width // cols
    batch, _vis = expand_static(mapping, instances, tables, camera,
                                slot_materials, instance_visible,
                                do_culling=do_culling)
    if materials is not None:
        batch = attach_cull(batch, materials)
    t_pad = _round_up(batch.capacity, GROUP)

    def tile_demand(b):
        _c, ok, (lo, hi) = triangle_coefficients(b, width, height)
        return max(int(_bin_spans(ok, lo, hi, t_pad, width, height, CELL_W,
                                  (c * tile_w, r * tile_h, tile_w, tile_h)
                                  )[4].sum())
                   for r in range(rows) for c in range(cols))

    if translucent_layers > 0:
        assert materials is not None, \
            "translucent demand probe needs the material table"
        non_op = non_opaque_mask(materials, batch.material)
        return max(
            tile_demand(dataclasses.replace(batch, valid=batch.valid & ~non_op)),
            tile_demand(dataclasses.replace(batch, valid=batch.valid & non_op)))
    return tile_demand(batch)


def make_sharded_rt_frame(mesh: TileMesh, meta, animate=None, *,
                          use_pallas: bool = False, paged: bool = False,
                          wide: bool = True):
    """Screen-tile sharded two-level RT frame: every rank assembles the
    acceleration structure (flat, or ``paged``) and traces its window with
    the tile key ``fold_in(key, row * cols + col)``. ``use_pallas`` runs the
    traversal kernels (K7-K11), else the XLA route; ``wide`` is a TPU
    scheduling knob, ignored. Returns ``rt_frame_sharded(...)`` -> the
    rank's ldr tile."""
    del wide

    def rt_frame_sharded(blasset, anim_rest, anim_nodes, instances,
                         inst_blas, masks, tri_attr, materials, lights,
                         camera, slot_materials, tonemap_params, key, time,
                         textures=None, *, width: int, height: int,
                         stack_size: int, shadow_samples: int,
                         reflection_samples: int, ao_samples: int,
                         ao_radius: float, leaf_cutout: bool,
                         tlas_index: int = 0):
        tile_w, tile_h, win = tile_window(mesh, width, height)
        ctx = ACC.make_scene_tracer(
            blasset, meta, anim_rest, anim_nodes, instances, inst_blas,
            masks, tri_attr, slot_materials, materials,
            tlas_index=tlas_index, stack_size=stack_size, paged=paged,
            leaf_cutout=leaf_cutout, textures=textures, time=time,
            animate=animate, use_pallas=use_pallas)
        params = T.RTParams(shadow_samples=shadow_samples,
                            reflection_samples=reflection_samples,
                            ao_samples=ao_samples, ao_radius=ao_radius,
                            leaf_cutout=leaf_cutout)
        hdr = T.trace_frame(ctx, materials, lights, camera,
                            rnd.fold_in(key, mesh.index), width=tile_w,
                            height=tile_h, params=params, **win)
        return tonemap(hdr, tonemap_params)

    return rt_frame_sharded


def hybrid_tile(batch: TriangleBatch, ctx, materials, lights, camera,
                tonemap_params, tile_key, textures=None, *, tile_w: int,
                tile_h: int, window: dict, use_pallas: bool = False,
                shadow_samples: int = 1, reflection_samples: int = 1,
                ao_samples: int = 1, ao_radius: float = 2.0,
                leaf_cutout: bool = False):
    """The hybrid frame's work on one window of the full batch, traced by
    ``ctx`` with ``tile_key``: the raster G-buffer, then shadows, AO and
    reflections at its surfaces as separate passes (as JAX's sharded frame
    traces them), deferred shade, tonemap. Returns (ldr, the window's pair
    count)."""
    batch = attach_cull(batch, materials)
    depth, gbuf, required = raster_gbuffer(batch, tile_w, tile_h, camera,
                                           use_pallas, **window)
    cov = gbuf.coverage.reshape(-1)
    surf = T.SurfaceHits(
        world_pos=gbuf.world_pos.reshape(-1, 3),
        normal=gbuf.normal.reshape(-1, 3), uv=gbuf.uv.reshape(-1, 2),
        material=gbuf.material.reshape(-1), valid=cov,
        t=torch.where(cov, depth.reshape(-1), float("inf")))
    params = T.RTParams(shadow_samples=shadow_samples,
                        reflection_samples=reflection_samples,
                        ao_samples=ao_samples, ao_radius=ao_radius,
                        leaf_cutout=leaf_cutout)
    svis = T.shadow_visibility(surf, ctx, lights, tile_key,
                               max(1, shadow_samples))
    ao = T.ambient_occlusion(surf, ctx, materials, rnd.fold_in(tile_key, 3),
                             ao_samples, ao_radius)
    hdr = shade_gbuffer(gbuf, materials, lights, camera.cam_pos,
                        shadow_vis=svis.reshape(-1, tile_h, tile_w),
                        ambient_occlusion=ao.reshape(tile_h, tile_w),
                        background=T.BACKGROUND_RGB, textures=textures)
    if reflection_samples > 0:
        refl = T.reflections(surf, ctx, materials, lights, camera.cam_pos,
                             rnd.fold_in(tile_key, 7), params)
        hdr = hdr + torch.where(gbuf.coverage[..., None],
                                refl.reshape(tile_h, tile_w, 3), 0.0)
    return tonemap(hdr, tonemap_params), required


def make_sharded_hybrid_frame(mesh: TileMesh, meta, animate=None, *,
                              use_pallas_trace: bool = False,
                              paged: bool = False, wide: bool = True):
    """Screen-tile sharded hybrid frame (config 4 across ranks): the
    triangle-sharded static expansion, gathered; each rank's window of the
    raster G-buffer (K1 with ``use_pallas``, else the XLA route); the RT
    passes at its surfaces against the acceleration structure every rank
    assembles (flat, or ``paged``; the kernels with ``use_pallas_trace``,
    else the XLA route), with the tile key; deferred shade; tonemap.
    ``wide`` is ignored. Returns ``hybrid_frame_sharded(...)`` -> (ldr
    tile, {"required_work": the pair count's maximum over the ranks})."""
    del wide

    def hybrid_frame_sharded(mapping, blasset, anim_rest, anim_nodes,
                             instances, inst_blas, tri_attr, tables,
                             materials, lights, camera, slot_materials,
                             instance_visible, tonemap_params, key, time,
                             textures=None, *, width: int, height: int,
                             stack_size: int, do_culling: bool = True,
                             use_pallas: bool = False, work_capacity: int = 0,
                             shadow_samples: int = 1,
                             reflection_samples: int = 1, ao_samples: int = 1,
                             ao_radius: float = 2.0,
                             leaf_cutout: bool = False):
        del work_capacity
        assert mapping.capacity % mesh.size == 0, \
            "triangle capacity must split evenly"
        tile_w, tile_h, win = tile_window(mesh, width, height)
        batch = sharded_batch(mesh, mapping, instances, tables, camera,
                              slot_materials, instance_visible, do_culling)
        mask = (torch.ones(instances.capacity, dtype=torch.bool,
                           device=instances.pos.device),)
        ctx = ACC.make_scene_tracer(
            blasset, meta, anim_rest, anim_nodes, instances, inst_blas, mask,
            tri_attr, slot_materials, materials, tlas_index=0,
            stack_size=stack_size, paged=paged, leaf_cutout=leaf_cutout,
            textures=textures, time=time, animate=animate,
            use_pallas=use_pallas_trace)
        ldr, required = hybrid_tile(
            batch, ctx, materials, lights, camera, tonemap_params,
            rnd.fold_in(key, mesh.index), textures, tile_w=tile_w,
            tile_h=tile_h, window=win, use_pallas=use_pallas,
            shadow_samples=shadow_samples,
            reflection_samples=reflection_samples, ao_samples=ao_samples,
            ao_radius=ao_radius, leaf_cutout=leaf_cutout)
        if use_pallas:
            required = all_reduce_max(required, mesh, ldr.device)
        return ldr, {"required_work": required}

    return hybrid_frame_sharded


# -- the inputs of a render object's frame ---------------------------------------

def static_inputs(rp, camera):
    """The positional arguments after ``mesh`` of
    ``sharded_render_frame_static`` for a ``RenderPass``'s frame, and its
    keywords (size, culling, textures)."""
    mapping, instances, tables, materials, cam, slots, visible = (
        rp.frame_inputs(camera))
    return ((mapping, instances, tables, materials, rp.lights, cam, slots,
             visible, rp.tonemap_params, rp._cached_textures),
            dict(width=rp.width, height=rp.height, do_culling=rp.do_culling))


def rt_inputs(rt, camera, key, time=0.0):
    """(meta, arguments, keywords) of a ``RayTraceRender``'s frame for
    ``make_sharded_rt_frame(mesh, meta)``'s function, with ``key``."""
    from ..ops.animation import f32_time

    cam = camera.matrices if hasattr(camera, "matrices") else camera
    instances = rt.scene.flush()
    blasset, meta, anim_rest, anim_nodes = rt.accel.blas()
    cap = instances.capacity
    slots, masks, table, _mask, _opaque, lights, tm = rt._device_inputs(cap)
    p = rt.params
    return meta, (
        blasset, anim_rest, anim_nodes, instances, rt.accel.inst_blas(cap),
        masks, rt.accel.tri_attr(), table, lights, cam.to(rt.device), slots,
        tm, key, f32_time(time), rt._cached_textures), dict(
        width=rt.width, height=rt.height, stack_size=rt.accel.stack_size(cap),
        shadow_samples=p.shadow_samples,
        reflection_samples=p.reflection_samples, ao_samples=p.ao_samples,
        ao_radius=p.ao_radius, leaf_cutout=rt.materials.has_leaf)


def hybrid_inputs(hy, camera, key, time=0.0):
    """(meta, arguments, keywords) of a ``HybridRender``'s frame for
    ``make_sharded_hybrid_frame(mesh, meta)``'s function, with ``key``."""
    from ..ops.animation import f32_time

    rp = hy._rp
    mapping, instances, tables, table, cam, slots, visible = (
        rp.frame_inputs(camera))
    blasset, meta, anim_rest, anim_nodes = hy.accel.blas()
    cap = instances.capacity
    return meta, (
        mapping, blasset, anim_rest, anim_nodes, instances,
        hy.accel.inst_blas(cap), hy.accel.tri_attr(), tables, table,
        rp.lights, cam, slots, visible, rp.tonemap_params, key,
        f32_time(time), rp._cached_textures), dict(
        width=hy.width, height=hy.height, stack_size=hy.accel.stack_size(cap),
        do_culling=rp.do_culling, shadow_samples=hy.shadow_samples,
        reflection_samples=hy.reflection_samples, ao_samples=hy.ao_samples,
        ao_radius=hy.ao_radius, leaf_cutout=hy.materials.has_leaf)
