"""Scene: model/instance registries + device-side SoA buffers.

PyTorch counterpart of ``paperrenderer_tpu/core/scene.py``, the analogue of
the reference RenderEngine's global state:
  * the instance SoA rebuilt at 1.4x overhead when full
    (PaperRenderer.cpp:151-196),
  * swap-remove registries with back-pointer fixup (:255-306),
  * the per-frame dirty-row staging queue (:308-363).

``flush`` uploads the whole SoA after growth and otherwise writes only the
dirty rows into a copy of the device arrays (the returned ``InstanceArrays``
are never mutated in place, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

import numpy as np
import torch

from ..utils.device import require_device
from .geometry import GeometryArena, GeometryArrays
from .model import Model, ModelInstance

GROWTH = 1.4          # PaperRenderer.h:70
INSTANCE_FLOOR = 128  # PaperRenderer.cpp:158


@dataclasses.dataclass(frozen=True)
class SceneTables:
    """Static model/LOD/mesh lookup tables (rebuilt only when models change)."""

    model_aabb_min: torch.Tensor    # f32[M, 3]
    model_aabb_max: torch.Tensor    # f32[M, 3]
    model_lod_offset: torch.Tensor  # i32[M] — first LOD row
    model_lod_count: torch.Tensor   # i32[M]
    lod_mesh_offset: torch.Tensor   # i32[L] — first mesh row of this LOD
    lod_mesh_count: torch.Tensor    # i32[L]
    mesh_tri_offset: torch.Tensor   # i32[K] — into the arena index buffer
    mesh_tri_count: torch.Tensor    # i32[K]
    mesh_vertex_offset: torch.Tensor  # i32[K]
    mesh_vertex_count: torch.Tensor   # i32[K]
    mesh_slot: torch.Tensor         # i32[K] — material slot within the model


@dataclasses.dataclass(frozen=True)
class InstanceArrays:
    """Global instance SoA (reference ShaderModelInstance, Model.h:161-168)."""

    pos: torch.Tensor       # f32[N, 3]
    scale: torch.Tensor     # f32[N, 3]
    quat: torch.Tensor      # f32[N, 4] (w,x,y,z)
    model_id: torch.Tensor  # i32[N], -1 = dead slot

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def alive(self) -> torch.Tensor:
        return self.model_id >= 0


def _grow(n: int, floor: int = INSTANCE_FLOOR) -> int:
    cap = max(floor, int(np.ceil(n * GROWTH)))
    return ((cap + 127) // 128) * 128


class Scene:
    """Host-side registry; owns the geometry arena, model tables, instances.

    ``device`` is where ``flush()`` and ``tables()`` put their tensors: the
    card unless the caller asks for the CPU."""

    def __init__(self, arena: Optional[GeometryArena] = None, *, device="cuda"):
        self.device = torch.device(device)
        self.arena = arena or GeometryArena()
        self.models: List[Model] = []
        self.instances: List[ModelInstance] = []
        self._dirty: Set[int] = set()
        self._tables: Optional[SceneTables] = None
        self._tables_dirty = True
        self._capacity = INSTANCE_FLOOR
        self._device: Optional[InstanceArrays] = None
        self._full_upload = True
        self.max_meshes_per_lod = 1
        self.max_slots = 1
        # topology version: bumps on instance add/remove + model registration;
        # consumers (static mappings) key their rebuilds on it
        self.version = 0

    # -- models --------------------------------------------------------------
    def register_model(self, model: Model) -> int:
        model.model_id = len(self.models)
        self.models.append(model)
        self._tables_dirty = True
        self.version += 1
        self.max_meshes_per_lod = max(
            self.max_meshes_per_lod, max(len(l.meshes) for l in model.lods))
        self.max_slots = max(self.max_slots, model.num_slots)
        return model.model_id

    def tables(self) -> SceneTables:
        if self._tables_dirty or self._tables is None:
            m = max(1, len(self.models))
            aabb_min = np.zeros((m, 3), np.float32)
            aabb_max = np.zeros((m, 3), np.float32)
            lod_off = np.zeros(m, np.int32)
            lod_cnt = np.zeros(m, np.int32)
            lod_mesh_off: List[int] = []
            lod_mesh_cnt: List[int] = []
            tri_off: List[int] = []
            tri_cnt: List[int] = []
            v_off: List[int] = []
            v_cnt: List[int] = []
            slot: List[int] = []
            for i, model in enumerate(self.models):
                aabb_min[i] = model.aabb_min
                aabb_max[i] = model.aabb_max
                lod_off[i] = len(lod_mesh_off)
                lod_cnt[i] = len(model.lods)
                for lod in model.lods:
                    lod_mesh_off.append(len(tri_off))
                    lod_mesh_cnt.append(len(lod.meshes))
                    for mm in lod.meshes:
                        tri_off.append(mm.handle.tri_offset)
                        tri_cnt.append(mm.handle.tri_count)
                        v_off.append(mm.handle.vertex_offset)
                        v_cnt.append(mm.handle.vertex_count)
                        slot.append(mm.material_slot)
            device = require_device(self.device)
            dev = lambda a: torch.from_numpy(a).to(device)
            as_i32 = lambda xs: dev(np.asarray(xs or [0], np.int32))
            self._tables = SceneTables(
                model_aabb_min=dev(aabb_min),
                model_aabb_max=dev(aabb_max),
                model_lod_offset=dev(lod_off),
                model_lod_count=dev(lod_cnt),
                lod_mesh_offset=as_i32(lod_mesh_off),
                lod_mesh_count=as_i32(lod_mesh_cnt),
                mesh_tri_offset=as_i32(tri_off),
                mesh_tri_count=as_i32(tri_cnt),
                mesh_vertex_offset=as_i32(v_off),
                mesh_vertex_count=as_i32(v_cnt),
                mesh_slot=as_i32(slot),
            )
            self._tables_dirty = False
        return self._tables

    def geometry(self) -> GeometryArrays:
        """The geometry arena's device view on the scene's device."""
        return self.arena.device_arrays(require_device(self.device))

    def compact_geometry(self) -> None:
        """Compact the arena and fix up every model's mesh handles off the
        relocation remap (reference PaperRenderer.cpp:129-149)."""
        remap = self.arena.compact()
        for model in self.models:
            model.lods = tuple(
                dataclasses.replace(lod, meshes=tuple(
                    dataclasses.replace(
                        mm, handle=remap.get(mm.handle.mesh_id, mm.handle))
                    for mm in lod.meshes))
                for lod in model.lods)
        self._tables_dirty = True
        self.version += 1

    # -- instances (swap-remove registry, PaperRenderer.cpp:255-306) ----------
    def add_instance(self, instance: ModelInstance) -> ModelInstance:
        if instance.model.model_id < 0:
            self.register_model(instance.model)
        instance.index = len(self.instances)
        instance._scene = self
        self.instances.append(instance)
        self._dirty.add(instance.index)
        self.version += 1
        if len(self.instances) > self._capacity:
            self._capacity = _grow(len(self.instances))
            self._full_upload = True
        return instance

    def remove_instance(self, instance: ModelInstance) -> None:
        idx = instance.index
        if idx < 0 or idx >= len(self.instances) or self.instances[idx] is not instance:
            return
        last = self.instances.pop()
        if last is not instance:
            # swap-remove: the previously-last instance takes the freed slot
            last.index = idx
            self.instances[idx] = last
            self._dirty.add(idx)
        self._dirty.add(len(self.instances))  # stale tail row -> model_id -1
        instance.index = -1
        instance._scene = None
        self.version += 1

    def mark_instance_dirty(self, instance: ModelInstance) -> None:
        if instance.index >= 0:
            self._dirty.add(instance.index)

    @property
    def count(self) -> int:
        return len(self.instances)

    # -- device sync -----------------------------------------------------------
    def _host_rows(self, rows):
        """Packed host values of instance slots ``rows`` (dead slots get the
        identity transform and model id -1)."""
        n = len(rows)
        pos = np.zeros((n, 3), np.float32)
        scale = np.ones((n, 3), np.float32)
        quat = np.tile(np.asarray([1, 0, 0, 0], np.float32), (n, 1))
        model_id = np.full((n,), -1, np.int32)
        for j, i in enumerate(rows):
            if i < len(self.instances):
                inst = self.instances[i]
                pos[j] = inst.position
                scale[j] = inst.scale
                quat[j] = inst.rotation
                model_id[j] = inst.model.model_id
                inst.dirty = False
        return pos, scale, quat, model_id

    def flush(self) -> InstanceArrays:
        """Upload pending changes; returns the current device SoA.

        Full rebuild on growth, dirty rows only otherwise — reference:
        rebuildInstancesbuffer vs per-row staging writes."""
        if self._device is None or self._full_upload:
            require_device(self.device)
            cols = self._host_rows(range(self._capacity))
            self._device = InstanceArrays(
                *(torch.from_numpy(c).to(self.device) for c in cols))
            self._full_upload = False
            self._dirty.clear()
            return self._device
        if self._dirty:
            rows = sorted(self._dirty)
            idx = torch.tensor(rows, dtype=torch.long, device=self.device)
            cols = self._host_rows(rows)
            d = self._device
            old = (d.pos, d.scale, d.quat, d.model_id)
            self._device = InstanceArrays(*(
                o.index_put((idx,), torch.from_numpy(c).to(self.device))
                for o, c in zip(old, cols)))
            self._dirty.clear()
        return self._device
