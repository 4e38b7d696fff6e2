"""Wrappers of the paged traversal kernels (``csrc/trace.cu``) and their
plain PyTorch versions.

  * ``trace_scene_paged_kernel``   K10: closest or any hit over a PagedScene
  * ``trace_resolve_paged_kernel`` K11: closest hit + resolved uv/normal/
    material, the material from the chunk's slot-material block

Both take ``shading_model`` (i32[M]): with it they run their alpha form,
the any-hit leaf cutout (``accel.leaf_cutout_keep``), the kernel reading
each candidate's material from the chunk's slot-material block; counted
apart as ``trace_scene_paged_alpha`` / ``trace_resolve_paged_alpha``. K10
takes ``debug_steps``: its step-count form (u = each ray's walk-loop trip
count), counted apart as ``trace_scene_paged_steps``.

On a CUDA tensor each wrapper launches its kernel (built at first use) and
counts the launch in ``LAUNCHES``; on a CPU tensor it runs the plain
version: the flat view (``accel.paged_to_flat``) walked by
``accel.trace_scene`` (K10), then ``accel.resolve_attrs`` (K11), which is
the JAX package's own CPU route for a paged scene. There is no other
fallback: a build or launch failure raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import trace_kernel as TK
from .accel import (
    BL_LEAVES, BROWS, K, HitRecord2, PagedScene, RTScene, paged_to_flat,
    smat_block, trace_scene)

# launches of each kernel wrapper, counted where the kernel is launched
LAUNCHES = {"trace_scene_paged": 0, "trace_resolve_paged": 0,
            "trace_scene_paged_alpha": 0, "trace_resolve_paged_alpha": 0,
            "trace_scene_paged_steps": 0}


def _paged_args(lib, scene: PagedScene, root_code: int, stack_size: int,
                cull_mask: int, max_steps: int):
    dev = scene.static_nodes.device
    if stack_size > lib.trace_stack_max():
        raise ValueError(f"scene needs a traversal stack of {stack_size}; "
                         f"csrc/trace.cu holds {lib.trace_stack_max()}")
    nct = scene.chunk_boxes.shape[0] // 12
    nbn = scene.bch_codes.shape[0] // 2
    nbl = scene.bch_lprim.shape[0] // K
    if max(nct, nbn, scene.static_nodes.shape[0]) >= 1 << 27:
        raise ValueError("a paged row table exceeds the 27-bit payload")
    for name, t, dtype, shape in (
            ("static_nodes", scene.static_nodes, torch.float32,
             (scene.static_nodes.shape[0], 12)),
            ("static_codes", scene.static_codes, torch.int32,
             (scene.static_nodes.shape[0], 2)),
            ("leaf_rows", scene.leaf_rows, torch.float32,
             (scene.leaf_rows.shape[0], 120)),
            ("leaf_prim", scene.leaf_prim, torch.int32,
             (scene.leaf_rows.shape[0], K)),
            ("chunk_boxes", scene.chunk_boxes, torch.float32, (nct * 12,)),
            ("chunk_codes", scene.chunk_codes, torch.int32, (nct * 2,)),
            ("bch_nodes", scene.bch_nodes, torch.float32, (nbn * 12,)),
            ("bch_codes", scene.bch_codes, torch.int32, (nbn * 2,)),
            ("bch_lpos", scene.bch_lpos, torch.float32, (nbl * 72,)),
            ("bch_lprim", scene.bch_lprim, torch.int32, (nbl * K,))):
        TK.check_table(name, t, dtype, dev, shape)
    if nct % BROWS or nbn % (2 * BL_LEAVES):
        raise ValueError("chunk tables must hold whole blocks")
    return (scene.static_nodes.data_ptr(), scene.static_codes.data_ptr(),
            scene.leaf_rows.data_ptr(), scene.leaf_prim.data_ptr(),
            scene.static_nodes.shape[0], scene.leaf_rows.shape[0], root_code,
            stack_size, cull_mask & 0xFF, TK.T_MIN,
            scene.chunk_boxes.data_ptr(), scene.chunk_codes.data_ptr(), nct,
            scene.bch_nodes.data_ptr(), scene.bch_codes.data_ptr(), nbn,
            scene.bch_lpos.data_ptr(), scene.bch_lprim.data_ptr(), nbl,
            max_steps)


def _smat_args(scene: PagedScene, slot_materials, shading_model, dev):
    """The resolve tables (tri_attr, inv_rows, chunk_smat) with their
    sizes, and the leaf cutout's shading model."""
    n, s = slot_materials.shape
    nc = scene.chunk_boxes.shape[0] // (BROWS * 12)
    TK.check_table("tri_attr", scene.tri_attr, torch.float32, dev,
                   (scene.tri_attr.shape[0], 16))
    TK.check_table("inv_rows", scene.inv_rows, torch.float32, dev, (n, 12))
    TK._check("chunk_smat", scene.chunk_smat, torch.int32, dev,
              (nc * smat_block(s),))
    return (scene.tri_attr.data_ptr(), scene.inv_rows.data_ptr(),
            scene.chunk_smat.data_ptr(), n, s, smat_block(s),
            *TK._alpha_args(shading_model, dev))


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _flat(scene: PagedScene, root_code: int,
          flat: Optional[Tuple[RTScene, int]]):
    """(flat view, its root code): ``flat`` when the caller built it."""
    if flat is not None:
        return flat
    view, remap_root = paged_to_flat(scene)
    return view, remap_root(root_code)


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

def trace_scene_paged_plain(scene: PagedScene, o, d, t_max, *, root_code: int,
                            stack_size: int, max_steps: int,
                            any_hit: bool = False, active=None,
                            cull_mask: int = 0xFF, counts=None,
                            flat=None, slot_materials=None,
                            shading_model=None,
                            debug_steps: bool = False) -> HitRecord2:
    """Plain version of K10: ``accel.trace_scene`` on the flat view
    (``flat`` = (RTScene, root code) when already built); with
    ``shading_model`` through the leaf cutout; with ``debug_steps`` each
    ray's walk-loop trip count in ``bary[:, 0]`` (the flat view holds a box
    row where the paged walk pops a chunk, so the counts agree)."""
    view, root = _flat(scene, root_code, flat)
    return trace_scene(view, o, d, t_max, root_code=root,
                       stack_size=stack_size, t_min=TK.T_MIN, any_hit=any_hit,
                       active=active, cull_mask=cull_mask, counts=counts,
                       max_steps=max_steps, slot_materials=slot_materials,
                       shading_model=shading_model, debug_steps=debug_steps)


def trace_scene_paged_kernel(scene: PagedScene, o, d, t_max, *,
                             root_code: int, stack_size: int, max_steps: int,
                             any_hit: bool = False, active=None,
                             cull_mask: int = 0xFF, flat=None,
                             slot_materials=None, shading_model=None,
                             debug_steps: bool = False) -> HitRecord2:
    """Two-level traversal of a PagedScene (closest or any hit): kernel K10
    on CUDA tensors, ``trace_scene_paged_plain`` on CPU tensors; with
    ``shading_model`` (and the frame's ``slot_materials``) its alpha form,
    the any-hit leaf cutout; with ``debug_steps`` its step-count form
    (``trace_scene_paged_pallas(debug_steps=True)``): ``bary[:, 0]`` is
    each ray's walk-loop trip count as f32, the ray's own where the TPU
    kernel counts its packet's."""
    key = TK.form_key("trace_scene_paged", shading_model, debug_steps)
    if TK._device(o, "trace_scene_paged") == "cpu":
        return trace_scene_paged_plain(
            scene, o, d, t_max, root_code=root_code, stack_size=stack_size,
            max_steps=max_steps, any_hit=any_hit, active=active,
            cull_mask=cull_mask, flat=flat, slot_materials=slot_materials,
            shading_model=shading_model, debug_steps=debug_steps)
    lib = TK._lib()
    dev = o.device
    res = ((None, None, None, 1, 1, 0, None, 1) if shading_model is None
           else _smat_args(scene, slot_materials, shading_model, dev))
    o, d, t, act = TK._rays(o, d, t_max, active)
    r = o.shape[0]
    out = TK._hit_outputs(r, dev)
    work = TK.work_counters(lib, act)
    rc = lib.trace_paged_launch(
        *_paged_args(lib, scene, root_code, stack_size, cull_mask, max_steps),
        int(any_hit), int(debug_steps), *res, o.data_ptr(), d.data_ptr(),
        t.data_ptr(), TK._ptr(act), r, *(x.data_ptr() for x in out),
        TK._ptr(work),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, key)
    return HitRecord2(*out)


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------

def trace_resolve_paged_plain(scene: PagedScene, slot_materials, o, d, t_max,
                              *, root_code: int, stack_size: int,
                              max_steps: int, active=None,
                              cull_mask: int = 0xFF, counts=None, flat=None,
                              shading_model=None):
    """Plain version of K11: ``trace_kernel.trace_resolve_plain`` on the
    flat view. Returns (HitRecord2, (uv, unnormalized normal, material))."""
    view, root = _flat(scene, root_code, flat)
    return TK.trace_resolve_plain(
        view, slot_materials, o, d, t_max, root_code=root,
        stack_size=stack_size, active=active, cull_mask=cull_mask,
        counts=counts, max_steps=max_steps, shading_model=shading_model)


def trace_resolve_paged_kernel(scene: PagedScene, slot_materials, o, d,
                               t_max, *, root_code: int, stack_size: int,
                               max_steps: int, active=None,
                               cull_mask: int = 0xFF, flat=None,
                               shading_model=None):
    """Closest hit + resolve over a PagedScene: kernel K11 on CUDA tensors
    (material from ``chunk_smat``), its plain version (material from
    ``slot_materials``) on CPU tensors; with ``shading_model`` the alpha
    form (the any-hit leaf cutout). Returns (HitRecord2, (uv, normal,
    material))."""
    if TK._device(o, "trace_resolve_paged") == "cpu":
        return trace_resolve_paged_plain(
            scene, slot_materials, o, d, t_max, root_code=root_code,
            stack_size=stack_size, max_steps=max_steps, active=active,
            cull_mask=cull_mask, flat=flat, shading_model=shading_model)
    lib = TK._lib()
    dev = o.device
    res = _smat_args(scene, slot_materials, shading_model, dev)
    o, d, t, act = TK._rays(o, d, t_max, active)
    r = o.shape[0]
    hit_out = TK._hit_outputs(r, dev)
    res_out = TK._resolve_outputs(r, dev)
    work = TK.work_counters(lib, act)
    rc = lib.trace_resolve_paged_launch(
        *_paged_args(lib, scene, root_code, stack_size, cull_mask, max_steps),
        *res, o.data_ptr(), d.data_ptr(), t.data_ptr(), TK._ptr(act), r,
        *(x.data_ptr() for x in hit_out + res_out), TK._ptr(work),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, TK.form_key("trace_resolve_paged", shading_model))
    return HitRecord2(*hit_out), res_out

