"""Wavefront ray tracing: raygen, the RT lighting passes and the RT frame.

PyTorch counterpart of ``paperrenderer_tpu/ops/trace.py`` (reference
raytrace.rgen / raytrace.rchit / raycommon.glsl): the recursive
``traceRayEXT`` call tree becomes flat passes over ray wavefronts,

  primary rays -> trace + resolve -> surface hits
    -> shadow rays (per light x sample, any hit, sphere-light sampling)
       + AO rays (cosine hemisphere, distance-weighted), one bundle
    -> reflection rays (cosine-perturbed mirror, one bounce), whose hits
       are shaded with the same lighting.

Random numbers come from ``utils.random``, bit-exact with the JAX package's
``jax.random`` keys, so each pixel draws the reference's samples. Rays are
generated in pixel-tile order (``pick_tile``); only the final image is
un-tiled.

``ctx`` is a tracer: ``accel.SceneTracer`` (flat layout), which has the
fused shadow/AO bundles, or ``accel.PagedSceneTracer``, which has not; as
in the JAX package, each pass uses a fused bundle only where the tracer has
it and traces the samples apart otherwise. Under the any-hit leaf cutout
(``RTParams.leaf_cutout``, ``ctx.leaf_cutout``) primary, AO and reflection
rays trace with ``use_alpha``, shadow rays stay opaque (the reference's
OpaqueEXT), and shadows and AO no longer share a bundle. The group
compaction of the JAX package (``compact_secondary``/``compact_refl``)
only reorders work for the TPU's packets and leaves every result
unchanged; it is not ported. A tracer with a texture atlas
(``ctx.textures``) shades its primary and reflection hits with the
materials' textures, sampled bilinear at mip 0 (no screen derivatives on
a ray hit), as the JAX package does; the reflection tint and the AO
influence keep the untextured parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core import texture as TX
from ..core.camera import CameraMatrices
from ..core.material import MaterialTable
from ..utils import random as rnd
from ..utils.tree import device_constant
from .shading import (
    Lights, apply_textures, lookup_material_params, lookup_texture_ids,
    point_light_contribution)

BACKGROUND_RGB = (0.1, 0.1, 0.1)  # environment color, raytrace.rgen:52


@dataclasses.dataclass(frozen=True)
class RTParams:
    """The example's RT uniform block (sample counts + AO radius) and the
    per-trace 8-bit cull masks (traceRayEXT cullMask): ``cull_mask`` for
    primary/reflection/AO rays, ``shadow_cull_mask`` for shadow rays.
    ``leaf_cutout`` applies the any-hit leaf cutout to SHADE_LEAF materials.
    ``reflection_half_rate`` traces reflections for every other pixel
    (``reflections_half_rate``; not reference parity). ``fuse_bounce``
    folds the reflection ray into the primary-side shadow+AO bundle (one
    traversal launch for all primary-side secondary rays; the same result
    as tracing it separately)."""

    shadow_samples: int = 1
    reflection_samples: int = 1
    ao_samples: int = 1
    ao_radius: float = 2.0
    leaf_cutout: bool = False
    cull_mask: int = 0xFF
    shadow_cull_mask: int = 0xFF
    reflection_half_rate: bool = False
    fuse_bounce: bool = False


@dataclasses.dataclass(frozen=True)
class SurfaceHits:
    """Resolved hit attributes of a ray wavefront."""

    world_pos: torch.Tensor  # f32[R, 3]
    normal: torch.Tensor     # f32[R, 3]
    uv: torch.Tensor         # f32[R, 2]
    material: torch.Tensor   # i32[R]
    valid: torch.Tensor      # bool[R]
    t: torch.Tensor          # f32[R]


def pick_tile(width: int, height: int):
    """Pixel tile of the ray order: the most square of (32,32), (16,64),
    (8,128), (4,256) that divides the image; None -> row-major order."""
    for th, tw in ((32, 32), (16, 64), (8, 128), (4, 256)):
        if height % th == 0 and width % tw == 0:
            return th, tw
    return None


def untile_image(flat: torch.Tensor, width: int, height: int, tile):
    """Invert ``raygen(tile_order=tile)``'s pixel order -> [H, W, ...]."""
    th, tw = tile
    nty, ntx = height // th, width // tw
    x = flat.reshape((nty, ntx, th, tw) + tuple(flat.shape[1:]))
    return x.permute((0, 2, 1, 3) + tuple(range(4, x.dim()))).reshape(
        (height, width) + tuple(flat.shape[1:]))


def tile_image(img: torch.Tensor, width: int, height: int, tile):
    """Inverse of ``untile_image``: [H, W, ...] -> flat tile-major [H*W, ...]."""
    th, tw = tile
    nty, ntx = height // th, width // tw
    x = img.reshape((nty, th, ntx, tw) + tuple(img.shape[2:]))
    return x.permute((0, 2, 1, 3) + tuple(range(4, x.dim()))).reshape(
        (height * width,) + tuple(img.shape[2:]))


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def raygen(camera: CameraMatrices, width: int, height: int, *,
           full_width: Optional[int] = None, full_height: Optional[int] = None,
           origin=(0, 0), tile_order=None):
    """Primary camera rays (raytrace.rgen:16-22): NDC -> unproject -> world.
    Returns (origins f32[P, 3], dirs f32[P, 3]), P = H*W, row 0 = image top;
    ``tile_order=(th, tw)`` emits them in pixel-tile-major order, taken
    inside the window; ``full_*``/``origin`` generate the rays of the
    width x height window at ``origin`` of a larger viewport."""
    fw = full_width or width
    fh = full_height or height
    x0, y0 = origin
    dev = camera.view.device
    if tile_order:
        th, tw = tile_order
        ntx = width // tw
        idx = torch.arange(width * height, dtype=torch.int32, device=dev)
        tile_id = idx // (th * tw)
        within = idx % (th * tw)
        yy = (tile_id // ntx) * th + within // tw
        xx = (tile_id % ntx) * tw + within % tw
        dx = (xx.to(torch.float32) + 0.5 + x0) / fw * 2.0 - 1.0
        dy = 1.0 - (yy.to(torch.float32) + 0.5 + y0) / fh * 2.0
    else:
        xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5
              + x0) / fw * 2.0 - 1.0
        ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev)
                    + 0.5 + y0) / fh * 2.0
        dx = xs[None, :].expand(height, width).reshape(-1)
        dy = ys[:, None].expand(height, width).reshape(-1)
    inv_proj, _ = torch.linalg.inv_ex(camera.projection)
    one = torch.ones_like(dx)
    ndc = torch.stack([dx, dy, one, one], dim=-1)
    target = ndc @ inv_proj.T
    tdir = target[:, :3] / torch.clamp(_norm(target[:, :3], keepdim=True),
                                       min=1e-12)
    d = tdir @ camera.view[:3, :3]   # = inv(view)[:3, :3] @ tdir
    return camera.cam_pos.expand(d.shape), d


def _default_basis(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ComputeDefaultBasis (raycommon.glsl:61-69)."""
    z0, z1, z2 = n[..., 0], n[..., 1], n[..., 2]
    yz = -z1 * z2
    near_z = (z2.abs() > 0.99999)[..., None]
    y = torch.where(near_z,
                    torch.stack([-z0 * z1, 1.0 - z1 ** 2, yz], dim=-1),
                    torch.stack([-z0 * z2, yz, 1.0 - z2 ** 2], dim=-1))
    y = y / torch.clamp(_norm(y, keepdim=True), min=1e-12)
    return torch.linalg.cross(y, n, dim=-1), y


def _cosine_sample(n, tx, ty, max_offset, r1, r2):
    """cosineSample (raycommon.glsl:44-57)."""
    sq = torch.sqrt(1.0 - r2) * torch.clamp(max_offset, 0.0, 1.0)
    phi = 2.0 * math.pi * r1
    lx = torch.cos(phi) * sq
    ly = torch.sin(phi) * sq
    lz = torch.clamp(torch.sqrt(r2), min=1e-4)
    d = lx[..., None] * tx + ly[..., None] * ty + lz[..., None] * n
    return d / torch.clamp(_norm(d, keepdim=True), min=1e-12)


def _uniform2(key, r: int, device):
    u = rnd.uniform(key, (2, r), device)
    return u[0], u[1]


def _light_shadow_samples(surf: SurfaceHits, lights: Lights, li: int, key,
                          samples: int):
    """Light ``li``'s shadow-sample directions (raytrace.rchit:61-116).
    Returns (dirs, dist, active)."""
    r = surf.world_pos.shape[0]
    lpos = lights.position[li]
    to_l = lpos - surf.world_pos
    dist = _norm(to_l)
    ldir = to_l / torch.clamp(dist, min=1e-9)[:, None]
    tx, ty = _default_basis(ldir)
    # shadow rays only where dot(N, L) > 0 (rchit:58)
    active = surf.valid & ((surf.normal * ldir).sum(dim=-1) > 0.0)
    dirs = []
    for si in range(samples):
        r1, r2 = _uniform2(rnd.fold_in(rnd.fold_in(key, li), si), r,
                           surf.world_pos.device)
        sq = torch.sqrt(1.0 - r2)
        phi = 2.0 * math.pi * r1
        offs = ((torch.cos(phi) * sq)[:, None] * tx
                + (torch.sin(phi) * sq)[:, None] * ty
                + torch.sqrt(r2)[:, None] * ldir) * lights.radius[li]
        sdir = lpos + offs - surf.world_pos
        sdir = sdir / torch.clamp(_norm(sdir, keepdim=True), min=1e-9)
        dirs.append(torch.where(lights.radius[li] > 0.0, sdir, ldir))
    return dirs, dist, active


def _shadow_vis_from_bits(bits, active, cast_shadow, n_s: int, shift: int):
    """Occlusion bits -> per-light visibility fraction (rchit:100-116);
    inactive rays and non-casting lights are fully visible."""
    unshadowed = torch.zeros(bits.shape, dtype=torch.float32,
                             device=bits.device)
    for si in range(n_s):
        unshadowed = unshadowed + (
            1.0 - ((bits >> (shift + si)) & 1).to(torch.float32))
    v = torch.where(active, unshadowed / n_s, 1.0)
    return torch.where(cast_shadow, v, 1.0)


def _occlusion_samples(surf, lights, key, samples):
    """Every light's shadow samples as one list: (dirs, caps, actives,
    per-light (bit shift, active))."""
    dirs, caps, actives, slots = [], [], [], []
    for li in range(lights.count):
        d, dist, active = _light_shadow_samples(surf, lights, li, key, samples)
        slots.append((len(dirs), active))
        dirs += d
        caps += [dist] * samples
        actives += [active] * samples
    return dirs, caps, actives, slots


def _visibility(bits, lights, slots, samples):
    return torch.stack([
        _shadow_vis_from_bits(bits, active, lights.cast_shadow[li], samples,
                              shift)
        for li, (shift, active) in enumerate(slots)])


def _ao_samples(surf: SurfaceHits, key, samples: int, radius: float):
    """AO sample directions (rchit:175-219) and their caps."""
    r = surf.world_pos.shape[0]
    tx, ty = _default_basis(surf.normal)
    ones = torch.ones(r, device=surf.normal.device)
    dirs = []
    for si in range(samples):
        r1, r2 = _uniform2(rnd.fold_in(key, 1000 + si), r, surf.normal.device)
        dirs.append(_cosine_sample(surf.normal, tx, ty, ones, r1, r2))
    return dirs, [torch.full((r,), radius, device=surf.normal.device)] * samples


def _ao_from_t(surf, materials, ao_ts, samples: int, radius: float):
    """AO weights (rchit:205-213): occ += 1 - t/radius per sample; a miss
    reports t == radius (weight 0), a parked ray -3e38 (masked)."""
    occ = torch.zeros(surf.valid.shape, dtype=torch.float32,
                      device=surf.valid.device)
    for t in ao_ts:
        occ = occ + torch.clamp(1.0 - t / radius, 0.0, 1.0)
    _, _, rough, metal = lookup_material_params(materials, surf.material)
    influence = (1.0 - metal) + rough * metal
    ao = torch.clamp(1.0 - occ / samples, 0.0, 1.0) * influence
    return torch.where(surf.valid, ao, 1.0)


def shadow_visibility(surf: SurfaceHits, ctx, lights: Lights, key,
                      samples: int, cull_mask: int = 0xFF) -> torch.Tensor:
    """Per-light soft-shadow visibility in [0, 1], f32[L, R]
    (raytrace.rchit:61-116): ``samples`` any-hit rays toward a sphere light
    up to the light-center distance, all lights in one origin-shared bundle
    (``trace_shadow_ao_bundle``) where the tracer has it, else one
    ``trace_occlusion_bundle`` per light. Origins are offset along the
    normal (OffsetRay) against acne."""
    origin = surf.world_pos + surf.normal * 5e-3
    dirs, caps, actives, slots = _occlusion_samples(surf, lights, key, samples)
    if getattr(ctx, "trace_shadow_ao_bundle", None) is not None:
        bits, _ = ctx.trace_shadow_ao_bundle(origin, dirs, caps, [], [],
                                             occ_actives=actives,
                                             cull_mask=cull_mask)
        return _visibility(bits, lights, slots, samples)
    vis = []
    for li, (shift, active) in enumerate(slots):
        bits = ctx.trace_occlusion_bundle(
            origin, dirs[shift:shift + samples], caps[shift:shift + samples],
            active=active, cull_mask=cull_mask)
        vis.append(_shadow_vis_from_bits(bits, active,
                                         lights.cast_shadow[li], samples, 0))
    return torch.stack(vis)


def occlusion_bits(ctx, o, dirs, t_caps, *, active=None,
                   cull_mask: int = 0xFF) -> torch.Tensor:
    """Origin-shared occlusion samples, one any-hit ``ctx.trace`` each ->
    i32[R] bits: bit s set where sample s is occluded or inactive."""
    bits = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    for s, (d, tc) in enumerate(zip(dirs, t_caps)):
        rec = ctx.trace(o, d, tc, any_hit=True, active=active,
                        cull_mask=cull_mask)
        occ = rec.hit if active is None else (rec.hit | ~active)
        bits = bits | (occ.to(torch.int32) << s)
    return bits


def ambient_occlusion(surf: SurfaceHits, ctx, materials: MaterialTable, key,
                      samples: int, radius: float,
                      cull_mask: int = 0xFF) -> torch.Tensor:
    """RTAO factor in [0, 1] (raytrace.rchit:175-219): cosine-hemisphere
    rays, occlusion weighted by 1 - t/radius, scaled by
    mix(1, roughness, metallic). Under the tracer's leaf cutout the rays go
    through ``trace_resolve(use_alpha=True)``, whose kernels hold the
    cutout, and only its hit flag and t are read."""
    r = surf.world_pos.shape[0]
    if samples <= 0 or radius <= 0.0:
        return torch.ones(r, device=surf.world_pos.device)
    dirs, caps = _ao_samples(surf, key, samples, radius)
    o = surf.world_pos + surf.normal * 1e-3
    ao_ts = []
    for d in dirs:
        if getattr(ctx, "leaf_cutout", False):
            s2 = ctx.trace_resolve(o, d, torch.full((r,), radius,
                                                    device=o.device),
                                   active=surf.valid, use_alpha=True,
                                   cull_mask=cull_mask)
            hit, t = s2.valid, s2.t
        else:
            rec = ctx.trace(o, d, radius, active=surf.valid,
                            cull_mask=cull_mask)
            hit, t = rec.hit, rec.t
        ao_ts.append(torch.where(hit, torch.clamp(t, max=radius), radius))
    return _ao_from_t(surf, materials, ao_ts, samples, radius)


def shadow_and_ao(surf: SurfaceHits, ctx, materials: MaterialTable,
                  lights: Lights, shadow_key, ao_key, *, shadow_samples: int,
                  ao_samples: int, ao_radius: float, cull_mask: int = 0xFF,
                  shadow_cull_mask: int = 0xFF):
    """Shadow visibility + RTAO in ONE origin-shared bundle launch (every
    sample starts at the same surface point). Returns (svis f32[L, R],
    ao f32[R]) with the sampling of ``shadow_visibility`` +
    ``ambient_occlusion``. The AO samples share the shadow offset (normal *
    5e-3; the separate AO pass uses 1e-3). Separate passes run when the
    tracer has no fused bundle, the cull masks differ, AO is off or the AO
    rays must honor the leaf cutout (the bundle has no alpha form; shadow
    rays are opaque either way)."""
    if (getattr(ctx, "trace_shadow_ao_bundle", None) is None
            or shadow_cull_mask != cull_mask or ao_samples <= 0
            or ao_radius <= 0.0 or getattr(ctx, "leaf_cutout", False)):
        return (shadow_visibility(surf, ctx, lights, shadow_key,
                                  shadow_samples, cull_mask=shadow_cull_mask),
                ambient_occlusion(surf, ctx, materials, ao_key, ao_samples,
                                  ao_radius, cull_mask=cull_mask))
    origin = surf.world_pos + surf.normal * 5e-3
    dirs, caps, actives, slots = _occlusion_samples(surf, lights, shadow_key,
                                                    shadow_samples)
    ao_ds, ao_caps = _ao_samples(surf, ao_key, ao_samples, ao_radius)
    bits, ao_ts = ctx.trace_shadow_ao_bundle(
        origin, dirs, caps, ao_ds, ao_caps, occ_actives=actives,
        ao_actives=[surf.valid] * ao_samples, cull_mask=cull_mask)
    return (_visibility(bits, lights, slots, shadow_samples),
            _ao_from_t(surf, materials, ao_ts, ao_samples, ao_radius))


def shadow_ao_bounce(surf: SurfaceHits, ctx, materials: MaterialTable,
                     lights: Lights, cam_pos, shadow_key, ao_key, refl_key, *,
                     params: RTParams):
    """The primary-side lighting wavefront: shadow + AO samples, and with
    ``params.fuse_bounce`` the 1-bounce reflection ray too, in one bundle.
    Returns (svis, ao, bounce hits or None when the bounce is traced by
    ``reflections``, as it is on a tracer without the fused bundle, at half
    rate and under the leaf cutout)."""
    fuse = (params.fuse_bounce and params.reflection_samples == 1
            and not params.reflection_half_rate
            and getattr(ctx, "trace_shadow_ao_resolve_bundle", None) is not None
            and params.shadow_cull_mask == params.cull_mask
            and params.ao_samples > 0 and params.ao_radius > 0.0
            and not getattr(ctx, "leaf_cutout", False))
    samples = max(1, params.shadow_samples)
    if not fuse:
        svis, ao = shadow_and_ao(
            surf, ctx, materials, lights, shadow_key, ao_key,
            shadow_samples=samples, ao_samples=params.ao_samples,
            ao_radius=params.ao_radius, cull_mask=params.cull_mask,
            shadow_cull_mask=params.shadow_cull_mask)
        return svis, ao, None
    r = surf.world_pos.shape[0]
    origin = surf.world_pos + surf.normal * 5e-3
    dirs, caps, actives, slots = _occlusion_samples(surf, lights, shadow_key,
                                                    samples)
    ao_ds, ao_caps = _ao_samples(surf, ao_key, params.ao_samples,
                                 params.ao_radius)
    rdir = _reflection_dir(surf, materials, cam_pos, refl_key, 0)
    bits, ao_ts, hit2 = ctx.trace_shadow_ao_resolve_bundle(
        origin, dirs, caps, ao_ds, ao_caps, rdir,
        torch.full((r,), 1000.0, device=origin.device), occ_actives=actives,
        ao_actives=[surf.valid] * params.ao_samples, rs_active=surf.valid,
        cull_mask=params.cull_mask)
    return (_visibility(bits, lights, slots, samples),
            _ao_from_t(surf, materials, ao_ts, params.ao_samples,
                       params.ao_radius), hit2)


def shade_surfaces(surf: SurfaceHits, materials: MaterialTable,
                   lights: Lights, viewer: torch.Tensor,
                   shadow_vis: torch.Tensor, ao: torch.Tensor,
                   textures: Optional[TX.TextureArrays] = None) -> torch.Tensor:
    """Direct lighting + ambient + emissive at hit points (rchit:48-122,
    :173-226 without reflections). ``viewer`` is f32[3] or f32[R, 3].
    ``textures`` samples the materials' textures bilinear at mip 0.
    Returns f32[R, 3]; invalid rays -> 0."""
    albedo, emissive, roughness, metallic = lookup_material_params(
        materials, surf.material)
    if textures is not None:
        albedo, emissive, roughness, metallic, tex_occ = apply_textures(
            textures, lookup_texture_ids(materials, surf.material), albedo,
            emissive, roughness, metallic,
            lambda t, i: TX.sample_bilinear(t, i, surf.uv))
        ao = ao * tex_occ
    view_dir = viewer - surf.world_pos
    view_dir = view_dir / torch.clamp(_norm(view_dir, keepdim=True), min=1e-9)
    total = torch.zeros_like(albedo)
    for li in range(lights.count):
        contrib = point_light_contribution(
            surf.normal, view_dir, surf.world_pos, albedo, roughness,
            metallic, lights.position[li], lights.color[li],
            lights.bounds[li])
        total = total + contrib * shadow_vis[li][:, None]
    total = total + lights.ambient[:3] * lights.ambient[3] * albedo * ao[:, None]
    total = total + emissive
    return torch.where(surf.valid[:, None], total, 0.0)


def _reflection_dir(surf: SurfaceHits, materials: MaterialTable, cam_pos,
                    key, si: int) -> torch.Tensor:
    """Reflection-sample direction (rchit:124-146): cosine-perturbed mirror
    with cone angle roughness * (1 - (1 - N.V)^5)."""
    r = surf.world_pos.shape[0]
    _, _, rough, _ = lookup_material_params(materials, surf.material)
    v = cam_pos - surf.world_pos
    v = v / torch.clamp(_norm(v, keepdim=True), min=1e-9)
    n_dot_v = torch.clamp((surf.normal * v).sum(dim=-1), min=0.0)
    max_angle = rough * (1.0 - torch.pow(1.0 - n_dot_v, 5.0))
    tx, ty = _default_basis(surf.normal)
    r1, r2 = _uniform2(rnd.fold_in(key, 2000 + si), r, surf.normal.device)
    pert_n = _cosine_sample(surf.normal, tx, ty, max_angle, r1, r2)
    return -v + 2.0 * (pert_n * v).sum(dim=-1, keepdim=True) * pert_n


def reflections(surf: SurfaceHits, ctx, materials: MaterialTable,
                lights: Lights, cam_pos, key, params: RTParams,
                pretraced: Optional[SurfaceHits] = None) -> torch.Tensor:
    """1-bounce glossy reflections (rchit:124-167): reflected hits get full
    direct lighting with shadows and AO (depth-1 shading), misses the
    environment color. Returns radiance to ADD, f32[R, 3]. ``pretraced``
    holds sample 0's hits when the bounce rode the primary bundle."""
    r = surf.world_pos.shape[0]
    dev = surf.world_pos.device
    if params.reflection_samples <= 0:
        return torch.zeros((r, 3), device=dev)
    albedo, _, _, metal = lookup_material_params(materials, surf.material)
    background = device_constant(BACKGROUND_RGB, dev)
    acc = torch.zeros((r, 3), device=dev)
    for si in range(params.reflection_samples):
        k = rnd.fold_in(key, 2000 + si)
        if si == 0 and pretraced is not None:
            hit2 = pretraced
        else:
            rdir = _reflection_dir(surf, materials, cam_pos, key, si)
            # the shadow offset (5e-3) for every secondary origin, as the
            # fused bundle uses, so both paths trace the same ray
            o = surf.world_pos + surf.normal * 5e-3
            hit2 = ctx.trace_resolve(o, rdir, torch.full((r,), 1000.0, device=dev),
                                     active=surf.valid,
                                     use_alpha=params.leaf_cutout,
                                     cull_mask=params.cull_mask)
        svis, ao2 = shadow_and_ao(
            hit2, ctx, materials, lights, rnd.fold_in(k, 1),
            rnd.fold_in(k, 2), shadow_samples=max(1, params.shadow_samples),
            ao_samples=params.ao_samples, ao_radius=params.ao_radius,
            cull_mask=params.cull_mask,
            shadow_cull_mask=params.shadow_cull_mask)
        color2 = shade_surfaces(hit2, materials, lights, surf.world_pos, svis,
                                ao2, getattr(ctx, "textures", None))
        acc = acc + torch.where(hit2.valid[:, None], color2, background)
    refl = acc / params.reflection_samples
    influence = torch.clamp(metal, 0.04, 1.0)[:, None]
    tint = (1.0 - metal)[:, None] + albedo * metal[:, None]
    return refl * influence * tint


def reflections_half_rate(surf: SurfaceHits, ctx, materials: MaterialTable,
                          lights: Lights, cam_pos, key,
                          params: RTParams) -> torch.Tensor:
    """Reflections traced for every other ray (flat stride 2, which is
    x-parity both in row-major order and in ``pick_tile``'s tile order,
    whose tile widths are even), each odd ray's reconstructed as the mean
    of its two traced horizontal neighbours (the last one repeats its left
    neighbour). Halves the bounce trace and its secondary shadow/AO
    wavefronts; a perf option of the JAX package, not reference parity.
    Returns radiance to ADD, f32[R, 3]; R must be even."""
    r = surf.world_pos.shape[0]
    if r % 2:
        raise ValueError("half-rate reflections need an even ray count")
    half = SurfaceHits(**{f.name: getattr(surf, f.name)[0::2]
                          for f in dataclasses.fields(surf)})
    refl_h = reflections(half, ctx, materials, lights, cam_pos, key, params)
    right = torch.cat([refl_h[1:], refl_h[-1:]], dim=0)
    odd = 0.5 * (refl_h + right)
    return torch.stack([refl_h, odd], dim=1).reshape(r, 3)


def trace_frame(ctx, materials: MaterialTable, lights: Lights,
                camera: CameraMatrices, key, *, width: int, height: int,
                params: RTParams, full_width: Optional[int] = None,
                full_height: Optional[int] = None,
                origin=(0, 0)) -> torch.Tensor:
    """Full RT frame -> HDR image f32[H, W, 3] (RayTraceRender::render +
    the rgen/rchit/rmiss pipeline). ``full_*``/``origin`` trace the
    width x height window at ``origin`` of a larger viewport (screen-tile
    sharding), its rays in tile order inside the window."""
    tiled = pick_tile(width, height)
    o, d = raygen(camera, width, height, full_width=full_width,
                  full_height=full_height, origin=origin, tile_order=tiled)
    r = o.shape[0]
    surf = ctx.trace_resolve(o, d, torch.full((r,), 1000.0, device=o.device),
                             use_alpha=params.leaf_cutout,
                             cull_mask=params.cull_mask)
    refl_key = rnd.fold_in(key, 7)
    svis, ao, pre_bounce = shadow_ao_bounce(
        surf, ctx, materials, lights, camera.cam_pos, key, key, refl_key,
        params=params)
    color = shade_surfaces(surf, materials, lights, camera.cam_pos, svis, ao,
                           getattr(ctx, "textures", None))
    if params.reflection_half_rate and width % 2 == 0:
        color = color + reflections_half_rate(
            surf, ctx, materials, lights, camera.cam_pos, refl_key, params)
    else:
        color = color + reflections(surf, ctx, materials, lights,
                                    camera.cam_pos, refl_key, params,
                                    pretraced=pre_bounce)
    color = torch.where(surf.valid[:, None], color,
                        device_constant(BACKGROUND_RGB, o.device))
    if tiled:
        return untile_image(color, width, height, tiled)
    return color.reshape(height, width, 3)
