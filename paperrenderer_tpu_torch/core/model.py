"""Models and model instances.

PyTorch counterpart of ``paperrenderer_tpu/core/model.py`` (reference:
Model.cpp:237-341 packs per-LOD, per-slot meshes into shared geometry;
``ModelInstance`` is a mutable TRS transform, Model.h:177-235). Pure host
code: the instance SoA that the device sees is built by ``core.scene``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .geometry import GeometryArena, MeshHandle


@dataclasses.dataclass(frozen=True)
class MaterialMesh:
    """One mesh bound to a material slot inside an LOD
    (reference ``MaterialMeshInfo``, Model.h:59-66)."""

    handle: MeshHandle
    material_slot: int
    opaque: bool = True


@dataclasses.dataclass(frozen=True)
class ModelLOD:
    meshes: Tuple[MaterialMesh, ...]


class Model:
    """Immutable LOD'd geometry owned by the engine (reference Model.h:130-157)."""

    def __init__(
        self,
        arena: GeometryArena,
        lods: Sequence[Sequence[MaterialMesh]],
        name: str = "model",
        aabb: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ):
        if not lods or not lods[0]:
            raise ValueError("Model needs at least one LOD with one mesh")
        self.name = name
        self.arena = arena
        self.lods: Tuple[ModelLOD, ...] = tuple(ModelLOD(tuple(l)) for l in lods)
        if aabb is None:
            bounds = [arena.mesh_aabb(mm.handle) for mm in self.lods[0].meshes]
            aabb = (np.min([b[0] for b in bounds], axis=0),
                    np.max([b[1] for b in bounds], axis=0))
        self.aabb_min = np.asarray(aabb[0], np.float32)
        self.aabb_max = np.asarray(aabb[1], np.float32)
        self.model_id: int = -1  # assigned by Scene.register_model
        self.num_slots = 1 + max(
            mm.material_slot for lod in self.lods for mm in lod.meshes
        )

    @classmethod
    def from_mesh(
        cls,
        arena: GeometryArena,
        positions: np.ndarray,
        indices: np.ndarray,
        normals: Optional[np.ndarray] = None,
        uvs: Optional[np.ndarray] = None,
        name: str = "model",
        material_slot: int = 0,
    ) -> "Model":
        h = arena.add_mesh(positions, indices, normals, uvs)
        return cls(arena, [[MaterialMesh(h, material_slot)]], name=name)

    @property
    def lod_count(self) -> int:
        return len(self.lods)


class ModelInstance:
    """Mutable TRS instance of a Model (reference Model.h:177-235).

    Transform setters mark the instance dirty; the Scene stages only dirty
    rows to the device (queueModelsAndInstancesTransfers,
    PaperRenderer.cpp:308-363)."""

    __slots__ = ("model", "index", "_pos", "_scale", "_quat", "dirty",
                 "visible", "_scene", "unique_geometry", "anim_phase")

    def __init__(self, model: Model, unique_geometry: bool = False,
                 anim_phase: float = 0.0):
        self.model = model
        self.index: int = -1  # slot in the Scene's instance SoA
        self._pos = np.zeros(3, np.float32)
        self._scale = np.ones(3, np.float32)
        self._quat = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
        self.dirty = True
        self.visible = True
        # a unique-geometry instance gets a BLAS of its own, animated and
        # refit every RT frame (reference Model.cpp:398-404); its phase is
        # read when the BLAS set is built (the per-instance push constants
        # of BasicAnimation.comp)
        self.unique_geometry = unique_geometry
        self.anim_phase = anim_phase
        self._scene = None

    def set_transform(self, pos=None, scale=None, quat=None) -> None:
        if pos is not None:
            self._pos = np.asarray(pos, np.float32)
        if scale is not None:
            s = np.asarray(scale, np.float32)
            self._scale = np.full(3, s, np.float32) if s.ndim == 0 else s
        if quat is not None:
            self._quat = np.asarray(quat, np.float32)
        self.dirty = True
        if self._scene is not None:
            self._scene.mark_instance_dirty(self)

    @property
    def position(self) -> np.ndarray:
        return self._pos

    @property
    def scale(self) -> np.ndarray:
        return self._scale

    @property
    def rotation(self) -> np.ndarray:
        return self._quat
