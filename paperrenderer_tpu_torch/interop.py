"""Build the port's state dataclasses from plain numpy arrays.

The JAX package's dataclasses (``CameraMatrices``, ``InstanceArrays``, ...)
have the same field names as the port's. Fetch their fields with
``np.asarray`` and hand them to ``from_numpy`` to get bit-identical inputs
for both packages — the parity tests do exactly that. Fields the port does
not carry (the jump-fill and per-triangle id fields of ``StaticMapping``,
the leaf-normal and forward-matrix tables of ``BLASSet``, ``RTScene`` and
``PagedScene`` that only the TPU kernels read) are ignored. The static
light flags of ``Lights`` (``shadow_flags``, ``hard_flags``: tuples, not
arrays) are taken as tuples of bools when the dict has them, so a JAX
``Lights`` and its copy skip the same shadow samples. The world BVH
(``BVH``) and its hit record (``HitRecord``) come over the same way.
``texture_arrays_from_numpy`` does the same for the texture atlas
(``TextureArrays``), whose atlas width is a plain int.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .core.camera import CameraMatrices
from .core.geometry import GeometryArrays
from .core.material import MaterialTable
from .core.scene import InstanceArrays, SceneTables
from .core.texture import TextureArrays
from .ops.accel import BLASSet, HitRecord2, PagedScene, RTScene
from .ops.bvh import BVH, HitRecord
from .ops.preprocess import PreprocessResult
from .ops.raster import TriangleBatch
from .ops.shading import Lights
from .ops.static_batch import StaticMapping
from .ops.tonemap import TonemapParams
from .utils.device import require_device

KINDS = {cls.__name__: cls for cls in (
    CameraMatrices, InstanceArrays, SceneTables, StaticMapping, TriangleBatch,
    MaterialTable, Lights, TonemapParams, RTScene, BLASSet, HitRecord2,
    GeometryArrays, PreprocessResult, PagedScene, BVH, HitRecord)}
# fields held as tuples of host values, not tensors
_STATIC_FIELDS = {"shadow_flags": bool, "hard_flags": bool}


def from_numpy(kind: str, arrays: Dict[str, np.ndarray], device="cuda"):
    """The port's ``kind`` dataclass (a name in ``KINDS``) from a dict of
    numpy arrays keyed by field name, with every tensor on ``device``."""
    cls = KINDS[kind]
    device = require_device(device)
    values = {}
    for f in dataclasses.fields(cls):
        v = arrays.get(f.name)
        if v is None:      # an optional field keeps its default
            continue
        if f.name in _STATIC_FIELDS:
            values[f.name] = tuple(_STATIC_FIELDS[f.name](x)
                                   for x in np.asarray(v).reshape(-1))
        else:
            values[f.name] = torch.from_numpy(np.array(v)).to(device)
    return cls(**values)


def texture_arrays_from_numpy(arrays: Dict[str, np.ndarray], width: int,
                              device="cuda") -> TextureArrays:
    """The port's ``TextureArrays`` from the atlas's ``pairs``, ``rects``
    and ``mip_counts`` as numpy and its ``width`` in texels."""
    device = require_device(device)
    return TextureArrays(
        **{k: torch.from_numpy(np.array(arrays[k])).to(device)
           for k in ("pairs", "rects", "mip_counts")}, width=int(width))
