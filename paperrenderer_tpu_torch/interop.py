"""Build the port's state dataclasses from plain numpy arrays.

The JAX package's dataclasses (``CameraMatrices``, ``InstanceArrays``, ...)
have the same field names as the port's. Fetch their fields with
``np.asarray`` and hand them to ``from_numpy`` to get bit-identical inputs
for both packages — the parity tests do exactly that. Fields the port does
not carry (the texture ids of ``MaterialTable``, the jump-fill and
per-triangle id fields of ``StaticMapping``, the static light flags, the
leaf-normal and forward-matrix tables of ``BLASSet``, ``RTScene`` and
``PagedScene`` that only the TPU kernels read) are ignored.
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
from .ops.accel import BLASSet, HitRecord2, PagedScene, RTScene
from .ops.preprocess import PreprocessResult
from .ops.raster import TriangleBatch
from .ops.shading import Lights
from .ops.static_batch import StaticMapping
from .ops.tonemap import TonemapParams
from .utils.device import require_device

KINDS = {cls.__name__: cls for cls in (
    CameraMatrices, InstanceArrays, SceneTables, StaticMapping, TriangleBatch,
    MaterialTable, Lights, TonemapParams, RTScene, BLASSet, HitRecord2,
    GeometryArrays, PreprocessResult, PagedScene)}


def from_numpy(kind: str, arrays: Dict[str, np.ndarray], device="cuda"):
    """The port's ``kind`` dataclass (a name in ``KINDS``) from a dict of
    numpy arrays keyed by field name, with every tensor on ``device``."""
    cls = KINDS[kind]
    device = require_device(device)
    values = {}
    for f in dataclasses.fields(cls):
        v = arrays.get(f.name)
        if v is not None:  # else an optional field keeps its default
            values[f.name] = torch.from_numpy(np.array(v)).to(device)
    return cls(**values)
