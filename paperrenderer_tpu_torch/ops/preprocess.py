"""Instance preprocess: transform + frustum cull + LOD select + draw build.

PyTorch counterpart of ``paperrenderer_tpu/ops/preprocess.py``, the
reference's GPU-driven preprocess compute pass (IndirectDrawBuild.comp, math
in Common.glsl:79-188), over the whole instance SoA at once:

  getModelMatrix per instance         ->  trs_to_mat34 over the SoA
  isInBounds view-space AABB cull     ->  ``frustum_cull``, vectorized
  getLODLevel                         ->  ``select_lod``, vectorized
  atomicAdd(drawCmd.instanceCount) +  ->  visibility mask + prefix-sum
    scattered matrix write                compaction (deterministic)

The indirect draw becomes a *draw list*: one row of {tri_offset, tri_count,
instance, material} per (instance, mesh of its chosen LOD), in instance
order. Its capacity is ``instance_capacity * max_meshes_per_lod``; dead rows
carry count 0. No value is read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.camera import CameraMatrices
from ..core.scene import InstanceArrays, SceneTables
from ..core.transforms import apply_mat34, trs_to_mat34
from ..utils.tree import device_constant

# the 8 box-corner selectors of Common.glsl:123-152
_CORNERS = ((1, 1, 1), (1, 1, 0), (0, 1, 1), (1, 0, 1),
            (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0))


def frustum_cull(
    aabb_min: torch.Tensor,   # f32[N, 3] object-space AABB min
    aabb_max: torch.Tensor,   # f32[N, 3]
    matrices: torch.Tensor,   # f32[N, 3, 4]
    camera: CameraMatrices,
) -> torch.Tensor:
    """View-space AABB frustum test, reproducing Common.glsl:119-168: the 8
    box corners go to view space, their AABB is tested against planes taken
    from the projection rows. Returns bool[N]."""
    sel = device_constant(_CORNERS, aabb_min.device)
    corners = (sel[None] * aabb_max[:, None, :]
               + (1.0 - sel[None]) * aabb_min[:, None, :])      # [N, 8, 3]
    world = apply_mat34(matrices[:, None], corners)
    vs = apply_mat34(camera.view[:3], world)
    lo = vs.amin(dim=1)
    hi = vs.amax(dim=1)

    proj = camera.projection
    fx = proj[3] + proj[0]
    fx = fx / torch.linalg.vector_norm(fx[:3])
    fy = proj[3] + proj[1]
    fy = fy / torch.linalg.vector_norm(fy[:3])

    visible = lo[:, 2] < 0.0  # everything fully behind the camera is culled
    kx = fx[2] / fx[0]
    visible &= ~((hi[:, 0] < kx * -lo[:, 2]) | (lo[:, 0] > kx * lo[:, 2]))
    ky = fy[1]
    visible &= ~((hi[:, 1] < ky * lo[:, 2]) | (lo[:, 1] > ky * -lo[:, 2]))
    return visible


def select_lod(
    pos: torch.Tensor,        # f32[N, 3] instance positions
    aabb_min: torch.Tensor,   # f32[N, 3]
    aabb_max: torch.Tensor,
    lod_count: torch.Tensor,  # i32[N]
    cam_pos: torch.Tensor,    # f32[3]
) -> torch.Tensor:
    """LOD level = floor(invsqrt(worldSize*10) * sqrt(camDist)), clamped —
    Common.glsl:170-188 + the min() at IndirectDrawBuild.comp:121."""
    size = (aabb_max - aabb_min).amax(dim=-1)
    dist = torch.linalg.vector_norm(pos - cam_pos[None], dim=-1)
    raw = torch.floor(torch.rsqrt(torch.clamp(size * 10.0, min=1e-12))
                      * torch.sqrt(dist))
    raw = torch.nan_to_num(raw, nan=0.0, posinf=1e9).to(torch.int32)
    top = torch.clamp(lod_count - 1, min=0)
    return torch.minimum(torch.clamp(raw, min=0), top)


@dataclasses.dataclass(frozen=True)
class PreprocessResult:
    """Per-frame device outputs of the preprocess pass."""

    matrices: torch.Tensor       # f32[N, 3, 4] — model matrices (all instances)
    visible: torch.Tensor        # bool[N]      — post-cull visibility
    lod: torch.Tensor            # i32[N]       — selected LOD per instance
    # compacted draw list (capacity D = N * max_meshes_per_lod):
    draw_instance: torch.Tensor  # i32[D] — instance id, -1 past draw_count
    draw_mesh: torch.Tensor      # i32[D] — mesh-table row
    draw_slot: torch.Tensor      # i32[D] — material slot of the mesh
    draw_material: torch.Tensor  # i32[D] — resolved material id
    draw_tri_offset: torch.Tensor  # i32[D]
    draw_tri_count: torch.Tensor   # i32[D]
    draw_count: torch.Tensor       # i32[] — live rows
    total_tris: torch.Tensor       # i32[] — sum of draw_tri_count


def _compact(values: torch.Tensor, write: torch.Tensor, fill: int) -> torch.Tensor:
    """``values`` moved to rows ``write`` of a ``fill``-initialised vector of
    the same length; rows whose ``write`` is that length are dropped (they
    land in a spare last row, which is cut off). Live rows have distinct
    targets, so the result does not depend on the order of the writes."""
    d = values.shape[0]
    out = values.new_full((d + 1,), fill)
    return out.index_copy_(0, write, values)[:d]


def preprocess_instances(
    instances: InstanceArrays,
    tables: SceneTables,
    camera: CameraMatrices,
    *,
    max_meshes_per_lod: int,
    do_culling: bool = True,
    instance_visible: Optional[torch.Tensor] = None,  # bool[N] user flag
    slot_materials: Optional[torch.Tensor] = None,    # i32[N, S]
    lod_override: Optional[int] = None,   # force an LOD (RT uses LOD 0)
) -> PreprocessResult:
    """The preprocess pass (RasterPreprocessPipeline::submit +
    IndirectDrawBuild.comp): cull, pick the LOD and append one draw row per
    (visible instance, mesh of its LOD), by a prefix sum and a scatter."""
    n = instances.capacity
    dev = instances.pos.device
    model_id = torch.clamp(instances.model_id, min=0)  # safe gather for dead rows
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
        lod = torch.clamp(torch.clamp(lod_count - 1, min=0), max=lod_override)

    # chosen LOD -> its mesh rows (at most max_meshes_per_lod of them)
    lod_row = (tables.model_lod_offset[model_id] + lod).long()
    mesh_off = tables.lod_mesh_offset[lod_row]
    mesh_cnt = tables.lod_mesh_count[lod_row]
    k = max_meshes_per_lod
    ks = torch.arange(k, dtype=torch.int32, device=dev)
    pair_valid = visible[:, None] & (ks[None, :] < mesh_cnt[:, None])
    mesh_idx = torch.where(pair_valid, mesh_off[:, None] + ks[None, :], 0)

    # prefix-sum compaction (the atomicAdd replacement)
    flat_valid = pair_valid.reshape(-1)
    d = flat_valid.numel()
    slot_pos = torch.cumsum(flat_valid.to(torch.int32), 0) - 1
    draw_count = (slot_pos[-1] + 1 if d else slot_pos.new_zeros(())
                  ).to(torch.int32)
    write = torch.where(flat_valid, slot_pos, d).long()
    flat_inst = torch.arange(n, dtype=torch.int32, device=dev)[:, None] \
        .expand(n, k).reshape(-1)
    draw_instance = _compact(flat_inst, write, -1)
    draw_mesh = _compact(mesh_idx.reshape(-1).to(torch.int32), write, 0)
    dm = draw_mesh.long()
    live = draw_instance >= 0
    draw_slot = torch.where(live, tables.mesh_slot[dm], 0)
    tri_cnt = torch.where(live, tables.mesh_tri_count[dm], 0)

    # the per-pass (instance, slot) -> material binding; unbound slots use
    # material 0 (RenderPass.cpp:744-801's default)
    if slot_materials is not None:
        draw_material = torch.where(
            live, slot_materials[torch.clamp(draw_instance, min=0).long(),
                                 draw_slot.long()], 0)
    else:
        draw_material = torch.zeros_like(draw_slot)

    return PreprocessResult(
        matrices=matrices, visible=visible, lod=lod,
        draw_instance=draw_instance, draw_mesh=draw_mesh, draw_slot=draw_slot,
        draw_material=draw_material,
        draw_tri_offset=tables.mesh_tri_offset[dm], draw_tri_count=tri_cnt,
        draw_count=draw_count, total_tris=tri_cnt.sum().to(torch.int32),
    )


def mesh_group_instance_counts(result: PreprocessResult,
                               num_meshes: int) -> torch.Tensor:
    """Instances drawn per mesh row, i32[num_meshes] — the
    DrawCommand.instanceCount analogue (IndirectDrawBuild.comp:132)."""
    live = result.draw_instance >= 0
    rows = torch.where(live, result.draw_mesh, num_meshes).long()
    counts = torch.zeros(num_meshes + 1, dtype=torch.int32,
                         device=rows.device)
    return counts.index_add_(0, rows, live.to(torch.int32))[:num_meshes]
