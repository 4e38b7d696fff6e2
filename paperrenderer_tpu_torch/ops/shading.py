"""Deferred PBR shading: Cook-Torrance point lights + ambient + emissive.

PyTorch counterpart of ``paperrenderer_tpu/ops/shading.py``; the math is
the reference example's
(example/resources/shaders/pbr.glsl:53-136):
  * Lambertian diffuse: max(N.L, 0) * baseColor
  * GGX NDF with a2 = roughness^2 (pbr.glsl:61)
  * Schlick fresnel, pow5; Smith-Schlick geometry, k = (r+1)^2 / 8
  * windowed inverse-square attenuation: clamp(1-(d/bounds)^4)^2 / d^2
  * specular term scaled by N.L * 2 (pbr.glsl:130)
  * roughness clamped to [mix(0.001, 0, metallic), 1]

Textured materials sample the atlas (``core.texture``) per pixel:
baseColor scales albedo, emissive adds where the material has one,
metallicRoughness scales roughness (g) and metallic (b), occlusion (r)
scales the ambient term.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import texture as TX
from ..core.material import MaterialTable
from ..utils.tree import device_constant, tree_to
from .raster import GBuffer


@dataclasses.dataclass(frozen=True)
class Lights:
    """Point lights + ambient (example main.cpp:205-330, pbr.glsl:6-24)."""

    position: torch.Tensor     # f32[L, 3]
    color: torch.Tensor        # f32[L, 3]
    radius: torch.Tensor       # f32[L] — soft-shadow source radius
    bounds: torch.Tensor       # f32[L] — influence range
    cast_shadow: torch.Tensor  # bool[L]
    ambient: torch.Tensor      # f32[4] — rgb + strength

    @staticmethod
    def make(points, ambient=(1.0, 1.0, 1.0, 0.1), device="cpu") -> "Lights":
        """points: list of dicts with position/color/radius/bounds/cast_shadow."""
        n = max(1, len(points))
        pos = np.zeros((n, 3), np.float32)
        col = np.ones((n, 3), np.float32)
        rad = np.zeros((n,), np.float32)
        bnd = np.zeros((n,), np.float32)
        shd = np.zeros((n,), bool)
        for i, p in enumerate(points):
            pos[i] = p["position"]
            col[i] = p.get("color", (1, 1, 1))
            rad[i] = p.get("radius", 0.0)
            bnd[i] = p.get("bounds", 10.0)
            shd[i] = p.get("cast_shadow", True)
        t = lambda a: torch.from_numpy(a).to(device)
        return Lights(position=t(pos), color=t(col), radius=t(rad),
                      bounds=t(bnd), cast_shadow=t(shd),
                      ambient=t(np.asarray(ambient, np.float32)))

    @property
    def count(self) -> int:
        return self.position.shape[0]

    def to(self, device) -> "Lights":
        return tree_to(self, device)


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _ggx_ndf(n_dot_h, roughness):
    a2 = roughness * roughness  # reference convention (pbr.glsl:61)
    d = (n_dot_h * n_dot_h) * (a2 - 1.0) + 1.0
    return a2 / (d * d)


def _schlick_fresnel(cos_theta, f0):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_theta, min=0.0), 5.0)


def _schlick_ggx(a_dot_b, roughness):
    k = (roughness + 1.0) ** 2 / 8.0
    ab = torch.clamp(a_dot_b, min=0.0)
    return ab / (ab * (1.0 - k) + k)


def leaf_alpha(uv: torch.Tensor) -> torch.Tensor:
    """Procedural leaf cutout (example leaf.glsl getAlpha): a lens-shaped
    region around v=0.5 whose half-width follows a parabola in u. Returns
    1.0 inside the leaf, 0.0 outside."""
    x = uv[..., 0]
    y = uv[..., 1] - 0.5
    curve = (-((1.0 - 2.0 * x) ** 2) + 1.0) * 0.2
    return torch.where(y.abs() < curve, 1.0, 0.0)


def _attenuate(dist, bounds):
    win = torch.clamp(1.0 - (dist / torch.clamp(bounds, min=1e-6)) ** 4,
                      0.0, 1.0) ** 2
    return win / torch.clamp(dist * dist, min=1e-4)


def point_light_contribution(
    normal: torch.Tensor,       # f32[..., 3]
    view_dir: torch.Tensor,     # f32[..., 3] (to camera)
    world_pos: torch.Tensor,    # f32[..., 3]
    albedo: torch.Tensor,       # f32[..., 3]
    roughness: torch.Tensor,    # f32[...]
    metallic: torch.Tensor,     # f32[...]
    light_pos: torch.Tensor,    # f32[3]
    light_color: torch.Tensor,  # f32[3]
    light_bounds: torch.Tensor,  # f32[]
) -> torch.Tensor:
    """One point light's radiance at each pixel — pbr.glsl calculatePointLight."""
    to_light = light_pos - world_pos
    dist = _norm(to_light)
    l_dir = to_light / torch.clamp(dist, min=1e-9)[..., None]
    h = view_dir + l_dir
    h = h / torch.clamp(_norm(h, keepdim=True), min=1e-9)

    r = torch.minimum(torch.maximum(roughness, 0.001 * (1.0 - metallic)),
                      torch.ones_like(roughness))
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    v_dot_h = (view_dir * h).sum(dim=-1)
    f = _schlick_fresnel(v_dot_h[..., None], f0)

    k_d = (1.0 - f) * (1.0 - metallic[..., None])
    n_dot_l = (normal * l_dir).sum(dim=-1)
    diffuse = torch.clamp(n_dot_l, min=0.0)[..., None] * albedo

    n_dot_v = (normal * view_dir).sum(dim=-1)
    n_dot_h = torch.clamp((normal * h).sum(dim=-1), min=0.0)
    d = _ggx_ndf(n_dot_h, r)
    g = _schlick_ggx(n_dot_l, r) * _schlick_ggx(n_dot_v, r)
    denom = torch.clamp(
        4.0 * torch.clamp(n_dot_l, min=0.0) * torch.clamp(n_dot_v, min=0.0),
        min=1e-4)
    specular = (d * g)[..., None] * f / denom[..., None]

    radiance = torch.clamp(
        k_d * diffuse + specular * (n_dot_l * 2.0)[..., None], min=0.0)
    atten = _attenuate(dist, light_bounds)
    in_bounds = (dist < light_bounds).to(torch.float32)
    return radiance * (atten * in_bounds)[..., None] * light_color


def lookup_material_params(materials: MaterialTable, ids: torch.Tensor):
    """(albedo, emissive, roughness, metallic) at material ``ids``."""
    ids = ids.long()
    return (materials.albedo[ids], materials.emissive[ids],
            materials.roughness[ids], materials.metallic[ids])


def lookup_texture_ids(materials: MaterialTable, ids: torch.Tensor):
    """(base_tex, emissive_tex, mr_tex, occ_tex) at material ``ids``: one
    gather of the four packed id columns."""
    packed = torch.stack([materials.base_tex, materials.emissive_tex,
                          materials.mr_tex, materials.occ_tex], dim=-1)
    return packed[ids.long()].unbind(dim=-1)


def apply_textures(textures: TX.TextureArrays, tex_ids, albedo, emissive,
                   roughness, metallic, sample):
    """The textured material parameters: ``tex_ids`` is
    ``lookup_texture_ids``'s four id tensors, ``sample(tex, tex_id)`` ->
    f32[..., 4] samples one slot's texture (white where the id is
    negative). The four slots are sampled one after another. Returns
    (albedo, emissive, roughness, metallic, occlusion f32[...])."""
    base_tex, emis_tex, mr_tex, occ_tex = tex_ids
    albedo = albedo * sample(textures, base_tex)[..., :3]
    emissive = emissive + torch.where((emis_tex >= 0)[..., None],
                                      sample(textures, emis_tex)[..., :3], 0.0)
    # glTF metallicRoughness: g = roughness factor, b = metallic factor
    mr = sample(textures, mr_tex)
    roughness = roughness * torch.where(mr_tex >= 0, mr[..., 1], 1.0)
    metallic = metallic * torch.where(mr_tex >= 0, mr[..., 2], 1.0)
    # glTF occlusion: r channel scales ambient/indirect light
    occlusion = torch.where(occ_tex >= 0, sample(textures, occ_tex)[..., 0],
                            1.0)
    return albedo, emissive, roughness, metallic, occlusion


MIP_FILTERS = ("nearest", "linear", "aniso2")


def shade_gbuffer(
    gbuf: GBuffer,
    materials: MaterialTable,
    lights: Lights,
    cam_pos: torch.Tensor,
    *,
    shadow_vis: Optional[torch.Tensor] = None,          # f32[L, H, W]
    ambient_occlusion: Optional[torch.Tensor] = None,   # f32[H, W]
    background: Optional[tuple] = None,
    textures: Optional[TX.TextureArrays] = None,
    mip_filter: str = "linear",
) -> torch.Tensor:
    """Shade the G-buffer -> HDR image f32[H, W, 3].
    The hybrid frame passes its ray-traced per-light visibility, AO factor
    and environment color (replacing the shadow-ray loop of
    raytrace.rchit:61-122); the raster frames pass none of them: full
    visibility, no AO, black where no triangle covers the pixel.

    ``textures`` (the registry's atlas on this device) samples the
    materials' textures, the mip level from the uv image's screen
    derivatives, with the base texture's mip-0 extent for every slot:
    ``mip_filter`` "nearest" (bilinear in the lod's mip, truncated),
    "linear" (trilinear, the reference samplers' mode,
    VulkanResources.cpp:787-794) or "aniso2" (two trilinear taps along the
    footprint's major axis)."""
    albedo, emissive, roughness, metallic = lookup_material_params(
        materials, gbuf.material)
    tex_occ = None
    if textures is not None:
        if mip_filter not in MIP_FILTERS:
            raise ValueError(f"mip_filter {mip_filter!r} not in {MIP_FILTERS}")
        tex_ids = lookup_texture_ids(materials, gbuf.material)
        wh = textures.rects[:, 0, 2:4][
            torch.clamp(tex_ids[0].long(), 0, textures.count - 1)]
        if mip_filter == "aniso2":
            lod, duv = TX.uv_screen_lod_aniso(gbuf.uv, wh[..., 0], wh[..., 1])
            sample = lambda t, i: TX.sample_aniso2(t, i, gbuf.uv, lod, duv)
        else:
            lod = TX.uv_screen_lod(gbuf.uv, wh[..., 0], wh[..., 1])
            fn = (TX.sample_trilinear if mip_filter == "linear"
                  else TX.sample_bilinear)
            sample = lambda t, i: fn(t, i, gbuf.uv, lod)
        albedo, emissive, roughness, metallic, tex_occ = apply_textures(
            textures, tex_ids, albedo, emissive, roughness, metallic, sample)
    view_dir = cam_pos - gbuf.world_pos
    view_dir = view_dir / torch.clamp(_norm(view_dir, keepdim=True), min=1e-9)

    total = torch.zeros_like(albedo)
    for i in range(lights.count):
        contrib = point_light_contribution(
            gbuf.normal, view_dir, gbuf.world_pos, albedo, roughness, metallic,
            lights.position[i], lights.color[i], lights.bounds[i],
        )
        if shadow_vis is not None:
            contrib = contrib * shadow_vis[i][..., None]
        total = total + contrib
    ambient = lights.ambient[:3] * lights.ambient[3] * albedo
    ao = ambient_occlusion
    if tex_occ is not None:
        ao = tex_occ if ao is None else ao * tex_occ
    if ao is not None:
        ambient = ambient * ao[..., None]
    total = total + ambient + emissive
    bg = 0.0 if background is None else device_constant(background,
                                                         total.device)
    return torch.where(gbuf.coverage[..., None], total, bg)
