"""Static triangle expansion: scene-topology-keyed triangle buffers.

PyTorch counterpart of ``paperrenderer_tpu/ops/static_batch.py``. The
(triangle -> instance, vertex data) mapping changes only with the scene's
topology (instance add/remove, model registration) — exactly when the
reference rebuilds its buffers (PaperRenderer.cpp:151-196) — so it is
expanded once per topology version on the host and kept on the device:

  * every instance contributes ALL of its model's LODs' triangles to a flat
    buffer of object-space positions/normals/uvs;
  * per frame, instance matrices + visibility + material ids are computed
    per (instance, lod, slot) RUN and broadcast to the run's triangles with
    one index; frustum culling and LOD selection become per-triangle masks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.camera import CameraMatrices
from ..core.scene import InstanceArrays, Scene, SceneTables
from ..core.transforms import trs_to_mat34
from .preprocess import frustum_cull, select_lod
from .raster import TriangleBatch, transform_triangles


@dataclasses.dataclass(frozen=True)
class StaticMapping:
    """Pre-expanded per-triangle scene data (device-resident)."""

    v_obj: torch.Tensor         # f32[T, 3, 3] object-space positions
    n_obj: torch.Tensor         # f32[T, 3, 3] object-space normals
    uv: torch.Tensor            # f32[T, 3, 2]
    valid: torch.Tensor         # bool[T]
    # run structure: triangles of one (instance, lod, slot) mesh are
    # contiguous; per-frame values are computed per run
    run_inst: torch.Tensor      # i32[R] instance slot
    run_lod: torch.Tensor       # i32[R] LOD the run belongs to
    run_slot: torch.Tensor      # i32[R] material slot
    run_id: torch.Tensor        # i32[T] run id per triangle (-1 = dead tail)

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


def _tier(n: int, floor: int = 2048) -> int:
    """Geometric capacity tiers at 1.25x steps (256-aligned) — the JAX
    package's sizing, kept so both packages expand to the same capacity."""
    n = max(n, floor)
    cap = floor
    while cap < n:
        cap = -(-(cap * 5) // (4 * 256)) * 256
    return cap


def _spread21(v: np.ndarray) -> np.ndarray:
    v = v & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def _morton_u64(p: np.ndarray, use_native: bool = True) -> np.ndarray:
    """63-bit morton codes (21 bits/axis) over the points' AABB: the native
    scene core's ``morton3d`` when it loads (``native.AVAILABLE``) and
    ``use_native`` is set, else its formula in numpy f32 arithmetic, which
    gives the same codes."""
    from .. import native

    p = np.asarray(p, np.float32).reshape(-1, 3)
    if use_native and native.AVAILABLE:
        return native.morton3d(p, p.min(axis=0), p.max(axis=0))
    lo = p.min(axis=0)
    ext = np.maximum(p.max(axis=0) - lo, np.float32(1e-12))
    q = np.clip((p - lo) / ext, np.float32(0.0), np.float32(1.0))
    g = np.minimum((q * np.float32(2097151.0)).astype(np.uint64),
                   np.uint64(2097151))
    return ((_spread21(g[:, 0]) << np.uint64(2))
            | (_spread21(g[:, 1]) << np.uint64(1)) | _spread21(g[:, 2]))


def build_static_mapping(scene: Scene, capacity: Optional[int] = None,
                         spatial_sort: bool = True) -> StaticMapping:
    """Host-side expansion (numpy), uploaded to ``scene.device``; call when
    the scene topology changes. ``capacity`` fixes the triangle rows
    (ValueError when the scene has more), else the next tier.

    With ``spatial_sort`` instances are ordered by world morton code so
    8-triangle groups stay spatially tight, which keeps the rasterizer's
    bins small (a scene with the native core, ``Scene(use_native=True)``,
    codes them natively, one without through numpy: the same codes);
    without, they keep the scene's instance order."""
    arena = scene.arena
    rows_inst: list = []
    rows_lod: list = []
    rows_slot: list = []
    tri_ranges: list = []  # (tri_offset, tri_count) in the arena
    order = list(scene.instances)
    if spatial_sort and len(order) > 1:
        # the native morton codes when the scene runs the native core
        native = getattr(scene, "_native", None) is not None
        codes = _morton_u64(np.stack([i.position for i in order]),
                            use_native=native)
        order = [order[i] for i in np.argsort(codes, kind="stable")]
    for inst in order:
        for lod_i, lod in enumerate(inst.model.lods):
            for mm in lod.meshes:
                rows_inst.append(inst.index)
                rows_lod.append(lod_i)
                rows_slot.append(mm.material_slot)
                tri_ranges.append((mm.handle.tri_offset, mm.handle.tri_count))
    total = sum(c for _, c in tri_ranges)
    cap = capacity or _tier(total)
    if total > cap:
        raise ValueError(f"static mapping overflow: {total} > {cap}")

    arena_tri = np.zeros(cap, np.int64)
    valid = np.zeros(cap, bool)
    run_id = np.full(cap, -1, np.int32)
    w = 0
    for ri, (off, cnt) in enumerate(tri_ranges):
        arena_tri[w : w + cnt] = np.arange(off, off + cnt)
        valid[w : w + cnt] = True
        run_id[w : w + cnt] = ri
        w += cnt

    idx = arena._idx[arena_tri]            # [cap, 3] vertex ids (0 for dead)
    runs = lambda xs: np.asarray(xs or [0], np.int32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(scene.device)
    return StaticMapping(
        v_obj=dev(arena._pos[idx]),
        n_obj=dev(arena._nrm[idx]),
        uv=dev(arena._uv[idx]),
        valid=dev(valid),
        run_inst=dev(runs(rows_inst)),
        run_lod=dev(runs(rows_lod)),
        run_slot=dev(runs(rows_slot)),
        run_id=dev(run_id),
    )


def expand_static(
    mapping: StaticMapping,
    instances: InstanceArrays,
    tables: SceneTables,
    camera: CameraMatrices,
    slot_materials: torch.Tensor,             # i32[N, S]
    instance_visible: Optional[torch.Tensor] = None,
    *,
    do_culling: bool = True,
    lod_override: Optional[int] = None,
    animate_time=None,
    animate=None,
    use_runs: bool = True,
):
    """Per-frame: instance math + dense transform -> (TriangleBatch,
    visible bool[N]). ``animate``, a vertex animation f(v_obj, time) ->
    v_obj, moves the object-space vertices before the transform when it
    and ``animate_time`` are given (the unique-geometry path,
    BasicAnimation.comp).

    Per-run values (matrix 12 | valid flag | material id) are gathered once
    per run and broadcast to the run's triangles by ``run_id``: one row
    index per triangle (the JAX package's jump-fill exists for TPU gather
    costs only). ``lod_override`` forces that LOD (clamped to each model's
    last), as ``preprocess_instances``' does. ``use_runs`` False is the JAX
    package's per-triangle gather, used where its triangle axis is
    sharded; the run gather gives the same batch, so it is ignored."""
    del use_runs
    model_id = torch.clamp(instances.model_id, min=0)
    matrices = trs_to_mat34(instances.pos, instances.scale, instances.quat)

    aabb_min = tables.model_aabb_min[model_id]
    aabb_max = tables.model_aabb_max[model_id]
    lod_count = tables.model_lod_count[model_id]

    visible = instances.alive
    if instance_visible is not None:
        visible = visible & instance_visible
    if do_culling:
        visible = visible & frustum_cull(aabb_min, aabb_max, matrices, camera)
    if lod_override is None:
        lod = select_lod(instances.pos, aabb_min, aabb_max, lod_count,
                         camera.cam_pos)
    else:
        lod = torch.clamp(torch.clamp(lod_count - 1, min=0),
                          max=lod_override)

    ri = mapping.run_inst
    m12_runs = matrices.reshape(-1, 12)[ri]                       # [R, 12]
    run_ok = visible[ri] & (lod[ri] == mapping.run_lod)
    mat_runs = slot_materials[ri, mapping.run_slot]
    # dead-tail triangles (run_id -1) read an appended zero row: zero
    # matrix, invalid, material 0 — as the JAX package's fill leaves them
    seed = torch.cat([m12_runs, run_ok[:, None].float(),
                      mat_runs[:, None].float()], dim=-1)          # [R, 14]
    seed = torch.cat([seed, seed.new_zeros((1, 14))])
    r = mapping.run_id.long()
    vals = seed[torch.where(r >= 0, r, seed.shape[0] - 1)]         # [T, 14]

    tri_valid = mapping.valid & (vals[:, 12] > 0.5)
    material = vals[:, 13].to(torch.int32)
    v_obj = mapping.v_obj
    if animate is not None and animate_time is not None:
        v_obj = animate(v_obj, animate_time)
    world, n_world, clip = transform_triangles(
        vals[:, :12].reshape(-1, 3, 4), v_obj, mapping.n_obj,
        camera.view_proj)
    batch = TriangleBatch(
        clip=clip, world=world, normal=n_world, uv=mapping.uv,
        material=material, valid=tri_valid,
    )
    return batch, visible
