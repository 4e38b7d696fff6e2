"""Geometry arena: packed vertex/index storage + procedural mesh builders.

PyTorch counterpart of ``paperrenderer_tpu/core/geometry.py``, on its numpy
path (the reference: Model.cpp:237-341 packs LODs into one VBO/IBO;
PaperRenderer.cpp:93-149 keeps the model-data heap). All models share one
growable host SoA arena:

  positions f32[Vcap, 3], normals f32[Vcap, 3], uvs f32[Vcap, 2]
  indices   i32[Tcap, 3]   (triangle lists; indices are arena-global)

Mesh ranges are placed by a FragmentableBuffer-parity offset allocator
(best-fit reuse of freed ranges, top-of-stack shrink, compaction emitting
relocation records — VulkanResources.cpp:332-542): the native C++
``FragmentableArena`` (``native/scenecore.cpp``, through ``native.py``)
when it loads and ``use_native`` is set, the Python mirror ``PyFragArena``
otherwise. The static raster path
reads the host arrays once per topology change (``ops.static_batch``); the
draw-list path reads the arena's device view, ``device_arrays``, every frame.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

GROWTH_FACTOR = 1.4  # mirrors instancesDataBufferOverhead, PaperRenderer.h:70


class PyFragArena:
    """Offset allocator: best-fit reuse by size, top-of-stack free shrinks
    directly, compaction shifts live ranges down and reports relocations."""

    def __init__(self, capacity: int = 1 << 60, alignment: int = 1):
        self.capacity = capacity
        self.alignment = max(1, alignment)
        self.stack_top = 0
        self._free: List[Tuple[int, int]] = []   # (size, offset), sorted
        self._live: Dict[int, int] = {}          # offset -> size

    def alloc(self, size: int) -> Optional[int]:
        size = -(-size // self.alignment) * self.alignment
        i = bisect.bisect_left(self._free, (size, 0))
        if i < len(self._free):
            fsize, off = self._free.pop(i)
            if fsize > size:
                bisect.insort(self._free, (fsize - size, off + size))
            self._live[off] = size
            return off
        if self.stack_top + size > self.capacity:
            return None
        off = self.stack_top
        self.stack_top += size
        self._live[off] = size
        return off

    def free(self, offset: int) -> bool:
        size = self._live.pop(offset, None)
        if size is None:
            return False
        if offset + size == self.stack_top:
            self.stack_top = offset
        else:
            bisect.insort(self._free, (size, offset))
        return True

    @property
    def live_count(self) -> int:
        return len(self._live)

    def compact(self):
        """Returns (old_offsets, new_offsets, sizes, new_top)."""
        old, new, sizes = [], [], []
        cursor = 0
        relocated: Dict[int, int] = {}
        for off in sorted(self._live):
            size = self._live[off]
            if off != cursor:
                old.append(off)
                new.append(cursor)
                sizes.append(size)
            relocated[cursor] = size
            cursor += size
        self._live = relocated
        self._free = []
        self.stack_top = cursor
        return old, new, sizes, cursor


def _make_allocator(use_native: bool):
    """The native arena when asked for and loadable, else the mirror."""
    if use_native:
        from .. import native

        if native.AVAILABLE:
            return native.NativeArena(1 << 48, 1)
    return PyFragArena()


@dataclasses.dataclass(frozen=True)
class MeshHandle:
    """A packed mesh's location inside the arena (all units: elements)."""

    mesh_id: int
    vertex_offset: int
    vertex_count: int
    tri_offset: int
    tri_count: int


@dataclasses.dataclass(frozen=True)
class GeometryArrays:
    """Device view of the arena (the draw-list path gathers from it)."""

    positions: torch.Tensor  # f32[Vcap, 3]
    normals: torch.Tensor    # f32[Vcap, 3]
    uvs: torch.Tensor        # f32[Vcap, 2]
    indices: torch.Tensor    # i32[Tcap, 3] — arena-global vertex indices


def _round_capacity(n: int, floor: int = 1024) -> int:
    cap = max(floor, int(math.ceil(n * GROWTH_FACTOR)))
    return ((cap + 127) // 128) * 128


class GeometryArena:
    """Host-side packed geometry heap (FragmentableBuffer::newWrite
    semantics, VulkanResources.cpp:332-403)."""

    def __init__(self, vertex_capacity: int = 1024, tri_capacity: int = 1024,
                 use_native: bool = True):
        vertex_capacity = _round_capacity(vertex_capacity)
        tri_capacity = _round_capacity(tri_capacity)
        self._pos = np.zeros((vertex_capacity, 3), np.float32)
        self._nrm = np.zeros((vertex_capacity, 3), np.float32)
        self._uv = np.zeros((vertex_capacity, 2), np.float32)
        self._idx = np.zeros((tri_capacity, 3), np.int32)
        self.vertex_count = 0   # high-water mark (allocator stack top)
        self.tri_count = 0
        self._valloc = _make_allocator(use_native)
        self._talloc = _make_allocator(use_native)
        self._meshes: Dict[int, MeshHandle] = {}
        self._next_mesh_id = 0
        # bumped on any content/layout change
        self.revision = 0
        # device_arrays cache: (revision, device) -> GeometryArrays
        self._device_key = None
        self._device_view: Optional[GeometryArrays] = None

    def _ensure(self, need_v: int, need_t: int) -> None:
        if need_v > self._pos.shape[0]:
            cap = _round_capacity(need_v)
            for name, width in (("_pos", 3), ("_nrm", 3), ("_uv", 2)):
                arr = np.zeros((cap, width), np.float32)
                old = getattr(self, name)
                arr[: old.shape[0]] = old
                setattr(self, name, arr)
        if need_t > self._idx.shape[0]:
            idx = np.zeros((_round_capacity(need_t), 3), np.int32)
            idx[: self._idx.shape[0]] = self._idx
            self._idx = idx

    def add_mesh(
        self,
        positions: np.ndarray,
        indices: np.ndarray,
        normals: Optional[np.ndarray] = None,
        uvs: Optional[np.ndarray] = None,
    ) -> MeshHandle:
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        if normals is None:
            normals = compute_vertex_normals(positions, indices)
        if uvs is None:
            uvs = np.zeros((positions.shape[0], 2), np.float32)
        nv, nt = positions.shape[0], indices.shape[0]
        vo = self._valloc.alloc(nv)
        to = self._talloc.alloc(nt)
        assert vo is not None and to is not None
        self._ensure(vo + nv, to + nt)
        self._pos[vo : vo + nv] = positions
        self._nrm[vo : vo + nv] = np.asarray(normals, np.float32).reshape(-1, 3)
        self._uv[vo : vo + nv] = np.asarray(uvs, np.float32).reshape(-1, 2)
        self._idx[to : to + nt] = indices + vo  # arena-global indexing
        self.vertex_count = max(self.vertex_count, vo + nv)
        self.tri_count = max(self.tri_count, to + nt)
        handle = MeshHandle(self._next_mesh_id, vo, nv, to, nt)
        self._meshes[handle.mesh_id] = handle
        self._next_mesh_id += 1
        self.revision += 1
        return handle

    def remove_mesh(self, handle: MeshHandle) -> None:
        """Free a mesh's ranges (FragmentableBuffer::removeFromRange parity);
        the space is reusable by ``add_mesh`` right away."""
        if self._meshes.pop(handle.mesh_id, None) is None:
            return
        self._valloc.free(handle.vertex_offset)
        self._talloc.free(handle.tri_offset)
        # dead triangle rows become degenerate so stale references draw nothing
        self._idx[handle.tri_offset : handle.tri_offset + handle.tri_count] = 0
        self.revision += 1

    def compact(self) -> Dict[int, MeshHandle]:
        """Re-pack live meshes densely; returns {mesh_id: new handle} so owners
        can fix up offsets (FragmentableBuffer::compact relocation callback,
        VulkanResources.cpp:424-542)."""
        v_old, v_new, v_size, v_top = self._valloc.compact()
        t_old, t_new, t_size, t_top = self._talloc.compact()
        # the native allocator reports u64 arrays: plain ints from here on
        v_old, v_new, v_size, t_old, t_new, t_size = (
            [int(x) for x in a]
            for a in (v_old, v_new, v_size, t_old, t_new, t_size))
        # ascending shift-down moves: dest < src, so overlap is safe
        for old, new, size in zip(v_old, v_new, v_size):
            for arr in (self._pos, self._nrm, self._uv):
                arr[new : new + size] = arr[old : old + size]
        for old, new, size in zip(t_old, t_new, t_size):
            self._idx[new : new + size] = self._idx[old : old + size]
        vmap = dict(zip(v_old, v_new))
        tmap = dict(zip(t_old, t_new))
        remapped: Dict[int, MeshHandle] = {}
        for mid, h in self._meshes.items():
            nvo = vmap.get(h.vertex_offset, h.vertex_offset)
            nto = tmap.get(h.tri_offset, h.tri_offset)
            if nvo != h.vertex_offset:
                # triangle indices embed arena-global vertex ids: shift them
                self._idx[nto : nto + h.tri_count] += nvo - h.vertex_offset
            remapped[mid] = MeshHandle(mid, nvo, h.vertex_count, nto, h.tri_count)
        self._meshes = remapped
        self.vertex_count = int(v_top)
        self.tri_count = int(t_top)
        self.revision += 1
        return remapped

    def device_arrays(self, device) -> GeometryArrays:
        """The arena's arrays on ``device``, uploaded again only after the
        arena changed (its ``revision`` moved) or for another device."""
        key = (self.revision, torch.device(device))
        if self._device_key != key:
            # a copy also on the CPU: the host arrays are edited in place
            dev = lambda a: torch.from_numpy(a).to(key[1], copy=True)
            self._device_view = GeometryArrays(
                positions=dev(self._pos), normals=dev(self._nrm),
                uvs=dev(self._uv), indices=dev(self._idx))
            self._device_key = key
        return self._device_view

    def mesh_aabb(self, handle: MeshHandle) -> Tuple[np.ndarray, np.ndarray]:
        pos = self._pos[handle.vertex_offset : handle.vertex_offset + handle.vertex_count]
        return pos.min(axis=0), pos.max(axis=0)


def compute_vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (host-side, at mesh build time)."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    face_n = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, indices[:, k], face_n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(lens, 1e-12)).astype(np.float32)


# ---------------------------------------------------------------------------
# Procedural meshes (the example scenes are procedural — no external assets).
# Each returns (positions f32[V,3], indices i32[T,3], normals f32[V,3],
# uvs f32[V,2]), identical to the JAX package's builders.
# ---------------------------------------------------------------------------

def make_plane(size: float = 1.0, segments: int = 1):
    s = segments
    xs = np.linspace(-size / 2, size / 2, s + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    pos = np.stack([gx, gy, np.zeros_like(gx)], axis=-1).reshape(-1, 3)
    uv = np.stack(
        [(gx / size + 0.5), (gy / size + 0.5)], axis=-1
    ).reshape(-1, 2).astype(np.float32)
    idx = []
    for i in range(s):
        for j in range(s):
            a = i * (s + 1) + j
            b = a + 1
            c = a + (s + 1)
            d = c + 1
            idx += [[a, c, b], [b, c, d]]
    nrm = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (pos.shape[0], 1))
    return pos, np.asarray(idx, np.int32), nrm, uv


def make_cube(size: float = 1.0):
    h = size / 2.0
    faces = [
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (0, 1, 0), (1, 0, 0)),
        ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (0, 0, 1), (1, 0, 0)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for n, u, v in faces:
        n, u, v = (np.asarray(x, np.float32) for x in (n, u, v))
        base = len(pos)
        for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            pos.append(n * h + u * (du * h) + v * (dv * h))
            nrm.append(n)
            uv.append([(du + 1) / 2, (dv + 1) / 2])
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return (
        np.asarray(pos, np.float32),
        np.asarray(idx, np.int32),
        np.asarray(nrm, np.float32),
        np.asarray(uv, np.float32),
    )


def make_uv_sphere(radius: float = 0.5, rings: int = 16, sectors: int = 24):
    pos, nrm, uv, idx = [], [], [], []
    for r in range(rings + 1):
        theta = math.pi * r / rings
        for s in range(sectors + 1):
            phi = 2.0 * math.pi * s / sectors
            n = np.asarray(
                [
                    math.sin(theta) * math.cos(phi),
                    math.sin(theta) * math.sin(phi),
                    math.cos(theta),
                ],
                np.float32,
            )
            pos.append(n * radius)
            nrm.append(n)
            uv.append([s / sectors, r / rings])
    for r in range(rings):
        for s in range(sectors):
            a = r * (sectors + 1) + s
            b = a + sectors + 1
            idx += [[a, b, a + 1], [a + 1, b, b + 1]]
    return (
        np.asarray(pos, np.float32),
        np.asarray(idx, np.int32),
        np.asarray(nrm, np.float32),
        np.asarray(uv, np.float32),
    )


def make_torus(major: float = 0.6, minor: float = 0.25, rings: int = 24,
               sides: int = 12):
    pos, nrm, uv, idx = [], [], [], []
    for r in range(rings + 1):
        a = 2.0 * math.pi * r / rings
        ca, sa = math.cos(a), math.sin(a)
        for s in range(sides + 1):
            b = 2.0 * math.pi * s / sides
            cb, sb = math.cos(b), math.sin(b)
            pos.append(
                [(major + minor * cb) * ca, (major + minor * cb) * sa, minor * sb]
            )
            nrm.append([cb * ca, cb * sa, sb])
            uv.append([r / rings, s / sides])
    for r in range(rings):
        for s in range(sides):
            a0 = r * (sides + 1) + s
            b0 = a0 + sides + 1
            idx += [[a0, b0, a0 + 1], [a0 + 1, b0, b0 + 1]]
    return (
        np.asarray(pos, np.float32),
        np.asarray(idx, np.int32),
        np.asarray(nrm, np.float32),
        np.asarray(uv, np.float32),
    )


def make_icosphere(radius: float = 0.5, subdivisions: int = 2):
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float32,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts_list: List[np.ndarray] = [v for v in verts]
    cache: Dict[Tuple[int, int], int] = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = verts_list[i] + verts_list[j]
            m /= np.linalg.norm(m)
            cache[key] = len(verts_list)
            verts_list.append(m.astype(np.float32))
        return cache[key]

    for _ in range(subdivisions):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    pos = np.asarray(verts_list, np.float32) * radius
    nrm = np.asarray(verts_list, np.float32)
    uv = np.zeros((pos.shape[0], 2), np.float32)
    uv[:, 0] = 0.5 + np.arctan2(nrm[:, 1], nrm[:, 0]) / (2 * math.pi)
    uv[:, 1] = 0.5 - np.arcsin(np.clip(nrm[:, 2], -1, 1)) / math.pi
    return pos, np.asarray(faces, np.int32), nrm, uv
