"""Materials: parameter tables + shading model selection.

PyTorch counterpart of ``paperrenderer_tpu/core/material.py`` (reference
Material.h:11-53, example/src/Materials.cpp). A material is a row of a
device SoA parameter table that the shading ops index by material id.
Its four texture-id columns name textures in the registry's atlas
(``core.texture.TextureAtlas``), added in row order when the table is
built, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.tree import tree_to
from .texture import TextureArrays, TextureAtlas

SHADE_PBR = 0
SHADE_LEAF = 1
SHADE_EMISSIVE = 2
SHADE_TRANSLUCENT = 3

CULL_NONE = 0
CULL_BACK = 1

_TEXTURE_KEYS = ("base_texture", "emissive_texture", "mr_texture",
                 "occlusion_texture")


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Device SoA of material-instance parameters, indexed by material id."""

    albedo: torch.Tensor         # f32[M, 3]
    emissive: torch.Tensor       # f32[M, 3]
    roughness: torch.Tensor      # f32[M]
    metallic: torch.Tensor       # f32[M]
    alpha: torch.Tensor          # f32[M]
    shading_model: torch.Tensor  # i32[M]
    cull_back: torch.Tensor      # bool[M] — raster back-face culling
    base_tex: torch.Tensor       # i32[M] — atlas texture id, -1 = untextured
    emissive_tex: torch.Tensor   # i32[M]
    mr_tex: torch.Tensor         # i32[M] — metallicRoughness (linear; g=rough, b=metal)
    occ_tex: torch.Tensor        # i32[M] — occlusion (linear; r channel)

    def to(self, device) -> "MaterialTable":
        return tree_to(self, device)


class Material:
    """Host-side material definition (reference ``Material``, Material.h:11-44)."""

    def __init__(
        self,
        name: str = "material",
        *,
        albedo=(1.0, 1.0, 1.0),
        emissive=(0.0, 0.0, 0.0),
        roughness: float = 0.5,
        metallic: float = 0.0,
        alpha: float = 1.0,
        shading_model: int = SHADE_PBR,
        cull_mode: Optional[int] = None,  # None = BACK for opaque, NONE for
        #   leaf/translucent (Pipeline.h:80, main.cpp:543)
        base_texture=None,       # u8/f32 [H, W, C] image (sRGB) or None
        emissive_texture=None,   # sRGB
        mr_texture=None,         # linear metallicRoughness (glTF: g=rough, b=metal)
        occlusion_texture=None,  # linear occlusion (glTF: r channel)
    ):
        self.name = name
        self.albedo = tuple(albedo)
        self.emissive = tuple(emissive)
        self.roughness = float(roughness)
        self.metallic = float(metallic)
        self.alpha = float(alpha)
        self.shading_model = int(shading_model)
        self.cull_mode = cull_mode if cull_mode is None else int(cull_mode)
        self.base_texture = base_texture
        self.emissive_texture = emissive_texture
        self.mr_texture = mr_texture
        self.occlusion_texture = occlusion_texture

    def instance(self, **overrides) -> "MaterialInstance":
        return MaterialInstance(self, **overrides)


class MaterialInstance:
    """Per-instance parameter override (reference ``MaterialInstance``)."""

    def __init__(self, base: Material, **overrides):
        self.base = base
        self.overrides = overrides

    def resolved(self) -> Dict:
        vals = dict(
            albedo=self.base.albedo,
            emissive=self.base.emissive,
            roughness=self.base.roughness,
            metallic=self.base.metallic,
            alpha=self.base.alpha,
            shading_model=self.base.shading_model,
            cull_mode=self.base.cull_mode,
        )
        vals.update({k: getattr(self.base, k) for k in _TEXTURE_KEYS})
        vals.update(self.overrides)
        return vals


def _resolve(mat) -> Dict:
    return (mat.resolved() if isinstance(mat, MaterialInstance)
            else Material.instance(mat).resolved())


class MaterialRegistry:
    """Assigns dense ids to (Material|MaterialInstance) and builds the table.

    Keys by ``id(obj)`` and holds a reference to every registered object, so
    a collected temporary's address can never alias another material. The
    texture atlas is shared by all materials; an image is added once per
    (``id(image)``, sRGB flag), and held as materials are."""

    def __init__(self):
        self._rows = []
        self._ids: Dict[int, int] = {}
        self._objects = []
        self.textures = TextureAtlas()
        self._tex_ids: Dict[tuple, int] = {}   # (id(image), srgb) -> atlas id
        self._tex_refs = []
        self.default = Material("default")
        self.register(self.default)

    def _texture_id(self, img, srgb: bool = True) -> int:
        if img is None:
            return -1
        key = (id(img), srgb)
        if key not in self._tex_ids:
            self._tex_ids[key] = self.textures.add(img, srgb=srgb)
            self._tex_refs.append(img)
        return self._tex_ids[key]

    def _row_texture_ids(self, vals: Dict) -> tuple:
        """(base, emissive, mr, occlusion) atlas ids of a row, adding its
        images to the atlas on first sight; mr and occlusion are linear."""
        return (self._texture_id(vals.get("base_texture")),
                self._texture_id(vals.get("emissive_texture")),
                self._texture_id(vals.get("mr_texture"), srgb=False),
                self._texture_id(vals.get("occlusion_texture"), srgb=False))

    def register(self, mat) -> int:
        key = id(mat)
        if key in self._ids:
            return self._ids[key]
        vals = _resolve(mat)
        row = len(self._rows)
        self._rows.append(vals)
        self._ids[key] = row
        self._objects.append(mat)
        return row

    def update(self, mat) -> None:
        """Re-read a registered material's parameters (live editing)."""
        key = id(mat)
        if key not in self._ids:
            raise KeyError("material not registered")
        self._rows[self._ids[key]] = _resolve(mat)

    def __len__(self) -> int:
        return len(self._rows)

    def objects(self) -> list:
        return list(self._objects)

    def rows(self) -> list:
        return [dict(v) for v in self._rows]

    @property
    def has_leaf(self) -> bool:
        """A registered material is a leaf cutout (SHADE_LEAF): the RT
        frames then trace with the any-hit leaf test."""
        return any(v["shading_model"] == SHADE_LEAF for v in self._rows)

    @property
    def has_textures(self) -> bool:
        """A registered material carries a texture."""
        return any(v.get(k) is not None for v in self._rows
                   for k in _TEXTURE_KEYS)

    def texture_arrays(self, device="cpu") -> Optional[TextureArrays]:
        """The atlas on ``device`` (None when no material is textured). Adds
        the rows' images in the order ``table`` does."""
        for vals in self._rows:
            self._row_texture_ids(vals)
        if self.textures.count == 0:
            return None
        return self.textures.device_arrays(device)

    def table(self, device="cpu") -> MaterialTable:
        n = max(1, len(self._rows))
        albedo = np.ones((n, 3), np.float32)
        emissive = np.zeros((n, 3), np.float32)
        roughness = np.full((n,), 0.5, np.float32)
        metallic = np.zeros((n,), np.float32)
        alpha = np.ones((n,), np.float32)
        shading = np.zeros((n,), np.int32)
        cull_back = np.zeros((n,), bool)
        tex_ids = np.full((4, n), -1, np.int32)   # base, emissive, mr, occ
        for i, vals in enumerate(self._rows):
            albedo[i] = vals["albedo"]
            emissive[i] = vals["emissive"]
            roughness[i] = vals["roughness"]
            metallic[i] = vals["metallic"]
            alpha[i] = vals["alpha"]
            shading[i] = vals["shading_model"]
            cm = vals.get("cull_mode")
            if cm is None:
                cm = (CULL_NONE
                      if vals["shading_model"] in (SHADE_LEAF, SHADE_TRANSLUCENT)
                      else CULL_BACK)
            cull_back[i] = cm == CULL_BACK
            tex_ids[:, i] = self._row_texture_ids(vals)
        t = lambda a: torch.from_numpy(a).to(device)
        return MaterialTable(
            albedo=t(albedo), emissive=t(emissive), roughness=t(roughness),
            metallic=t(metallic), alpha=t(alpha), shading_model=t(shading),
            cull_back=t(cull_back), base_tex=t(tex_ids[0]),
            emissive_tex=t(tex_ids[1]), mr_tex=t(tex_ids[2]),
            occ_tex=t(tex_ids[3]),
        )
