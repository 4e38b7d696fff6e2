"""Wrappers of the traversal kernels (``csrc/trace.cu``) and their plain
PyTorch versions.

  * ``trace_scene_kernel``   K7: closest or any hit -> HitRecord2
  * ``trace_resolve_kernel`` K8: closest hit + resolved uv/normal/material
  * ``trace_bundle_kernel``  K9: origin-shared occlusion samples (bitmask),
    AO samples (closest t) and optionally one closest + resolve sample; the
    kernel walks a pixel's occlusion samples as one union walk a group of
    ``UNION_GROUP`` (``occlusion_union_plain`` is that walk in PyTorch, for
    the tests and the bound; its bits are the per-sample walks')

K7 and K8 take ``shading_model`` (i32[M]): with it they run their alpha
form, the any-hit leaf cutout (``accel.leaf_cutout_keep``), counted apart
as ``trace_scene_alpha`` / ``trace_resolve_alpha``. K7 takes
``debug_steps``: its step-count form (u = each ray's walk-loop trip count),
counted apart as ``trace_scene_steps``.

On a CUDA tensor each wrapper launches its kernel (built at first use) and
counts the launch in ``LAUNCHES``; on a CPU tensor it runs the plain
version: ``accel.trace_scene`` (K7), ``trace_scene`` then
``accel.resolve_attrs`` (K8), one ``trace_scene`` per sample (K9). There is
no other fallback: a build or launch failure raises. A wave with an active
mask runs on persistent warps that claim rays from work counters, which
the wrapper allocates zeroed for the launch; a wave without one runs a
thread per ray (``csrc/trace.cu``). The scene and resolve tables must start
16-byte aligned (the kernels read their rows as 16-byte vectors).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..utils.cuda_build import load_library
from .accel import (_PAYLOAD_MASK, _TYPE_SHIFT, _UV, TYPE_BOX, TYPE_INST,
                    TYPE_LEAF, K, HitRecord2, RTScene, _slab2, resolve_attrs,
                    trace_scene)
from .bvh import moller_trumbore_edges

# launches of each kernel wrapper, counted where the kernel is launched
LAUNCHES = {"trace_scene": 0, "trace_resolve": 0, "trace_bundle": 0,
            "trace_scene_alpha": 0, "trace_resolve_alpha": 0,
            "trace_scene_steps": 0}

T_MIN = 1e-3
# occlusion samples one union walk of K9 takes (csrc/trace.cu GROUP, which
# the built library's trace_union_group() returns)
UNION_GROUP = 2
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SCENE_ARGS = [_P] * 4 + [_I] * 5 + [_F]
_RESOLVE_ARGS = [_P] * 3 + [_I] * 2
_ALPHA_ARGS = [_P, _I]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


_PAGED_ARGS = ([_P] * 4 + [_I] * 5 + [_F] + [_P] * 2 + [_I] + [_P] * 2 + [_I]
               + [_P] * 2 + [_I] + [_I])
_SMAT_ARGS = [_P] * 3 + [_I] * 3 + _ALPHA_ARGS
_LIB = []


def _lib():
    """The built ``csrc/trace.cu`` with the C signatures of its entry
    points declared."""
    if not _LIB:
        lib = load_library("trace")
        lib.trace_stack_max.restype = _I
        lib.trace_work_ints.restype = _I
        lib.trace_union_group.restype = _I
        lib.trace_launch.argtypes = (
            _SCENE_ARGS + [_I, _I] + _RESOLVE_ARGS + _ALPHA_ARGS + [_P] * 4
            + [_I] + [_P] * 4 + [_P, _P])
        lib.trace_resolve_launch.argtypes = (
            _SCENE_ARGS + _RESOLVE_ARGS + _ALPHA_ARGS + [_P] * 4 + [_I]
            + [_P] * 7 + [_P, _P])
        lib.trace_bundle_launch.argtypes = (
            _SCENE_ARGS + _RESOLVE_ARGS + [_P, _I] + [_P] * 3 + [_I]
            + [_P] * 3 + [_I] + [_P] * 3 + [_P] * 9 + [_P])
        lib.trace_paged_launch.argtypes = (
            _PAGED_ARGS + [_I, _I] + _SMAT_ARGS + [_P] * 4 + [_I] + [_P] * 4
            + [_P, _P])
        lib.trace_resolve_paged_launch.argtypes = (
            _PAGED_ARGS + _SMAT_ARGS + [_P] * 4 + [_I] + [_P] * 7 + [_P, _P])
        for fn in (lib.trace_launch, lib.trace_resolve_launch,
                   lib.trace_bundle_launch, lib.trace_paged_launch,
                   lib.trace_resolve_paged_launch):
            fn.restype = _I
        _LIB.append(lib)
    return _LIB[0]


def _check(name: str, t: torch.Tensor, dtype, device, shape=None):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def check_table(name: str, t: torch.Tensor, dtype, device, shape=None):
    """``_check`` for a scene or resolve table, which the kernels read in
    16-byte rows: it must also start 16-byte aligned."""
    _check(name, t, dtype, device, shape)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start 16-byte aligned (the kernels "
                         "read it in 16-byte vectors)")


def work_counters(lib, active: Optional[torch.Tensor]):
    """The zeroed work counters of one traversal launch of a wave with an
    active mask, from which its persistent warps claim their rays; None
    for a wave without one, which runs a thread per ray."""
    if active is None:
        return None
    return torch.zeros(lib.trace_work_ints(), dtype=torch.int32,
                       device=active.device)


def _scene_args(lib, scene: RTScene, root_code: int, stack_size: int,
                cull_mask: int):
    dev = scene.nodes.device
    if stack_size > lib.trace_stack_max():
        raise ValueError(f"scene needs a traversal stack of {stack_size}; "
                         f"csrc/trace.cu holds {lib.trace_stack_max()}")
    check_table("nodes", scene.nodes, torch.float32, dev,
                (scene.nodes.shape[0], 12))
    check_table("codes", scene.codes, torch.int32, dev,
                (scene.nodes.shape[0], 2))
    check_table("leaf_rows", scene.leaf_rows, torch.float32, dev,
                (scene.leaf_rows.shape[0], 120))
    check_table("leaf_prim", scene.leaf_prim, torch.int32, dev,
                (scene.leaf_rows.shape[0], 8))
    return (scene.nodes.data_ptr(), scene.codes.data_ptr(),
            scene.leaf_rows.data_ptr(), scene.leaf_prim.data_ptr(),
            scene.nodes.shape[0], scene.leaf_rows.shape[0], root_code,
            stack_size, cull_mask & 0xFF, T_MIN)


def _resolve_args(scene: RTScene, slot_materials: torch.Tensor):
    dev = scene.nodes.device
    n = scene.inv_rows.shape[0]
    check_table("tri_attr", scene.tri_attr, torch.float32, dev,
                (scene.tri_attr.shape[0], 16))
    check_table("inv_rows", scene.inv_rows, torch.float32, dev, (n, 12))
    _check("slot_materials", slot_materials, torch.int32, dev)
    if slot_materials.shape[0] != n:
        raise ValueError("slot_materials must have one row per instance")
    return (scene.tri_attr.data_ptr(), scene.inv_rows.data_ptr(),
            slot_materials.data_ptr(), n, slot_materials.shape[1])


def _alpha_args(shading_model: Optional[torch.Tensor], dev):
    """(shading model pointer, material count): a null pointer selects the
    kernel without the leaf cutout."""
    if shading_model is None:
        return None, 1
    _check("shading_model", shading_model, torch.int32, dev)
    if shading_model.dim() != 1 or shading_model.shape[0] == 0:
        raise ValueError("shading_model must be a non-empty i32[M]")
    return shading_model.data_ptr(), shading_model.shape[0]


def form_key(name: str, shading_model, debug_steps: bool = False) -> str:
    """The launch counter of a kernel's plain, alpha or step-count form."""
    if debug_steps:
        if shading_model is not None:
            raise ValueError("the step-count form has no leaf cutout")
        return name + "_steps"
    return name if shading_model is None else name + "_alpha"


def _rays(o, d, t_max, active):
    """Ray tensors as the kernels take them: f32[R, 3] o/d, f32[R] t_max,
    u8[R] active (or None)."""
    dev, r = o.device, o.shape[0]
    o = o.contiguous()
    d = d.contiguous()
    t = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r)
    act = None if active is None else active.to(torch.uint8).contiguous()
    for name, x, dtype, shape in (("ray_o", o, torch.float32, (r, 3)),
                                  ("ray_d", d, torch.float32, (r, 3))):
        _check(name, x, dtype, dev, shape)
    return o, d, t.contiguous(), act


def _hit_outputs(r, dev):
    return (torch.empty(r, dtype=torch.float32, device=dev),
            torch.empty(r, dtype=torch.int32, device=dev),
            torch.empty(r, dtype=torch.int32, device=dev),
            torch.empty((r, 2), dtype=torch.float32, device=dev))


def _resolve_outputs(r, dev):
    return (torch.empty((r, 2), dtype=torch.float32, device=dev),
            torch.empty((r, 3), dtype=torch.float32, device=dev),
            torch.empty(r, dtype=torch.int32, device=dev))


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _device(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def trace_scene_kernel(scene: RTScene, o, d, t_max, *, root_code: int,
                       stack_size: int, any_hit: bool = False,
                       active=None, cull_mask: int = 0xFF,
                       slot_materials=None, shading_model=None,
                       debug_steps: bool = False) -> HitRecord2:
    """Two-level traversal (closest or any hit): kernel K7 on CUDA tensors,
    ``accel.trace_scene`` on CPU tensors. With ``shading_model`` (and the
    frame's ``slot_materials``) its alpha form: the any-hit leaf cutout.
    With ``debug_steps`` its step-count form (``trace_scene_pallas(
    debug_steps=True)``): ``bary[:, 0]`` is each ray's walk-loop trip count
    as f32. The TPU kernel counts the steps a 1024-ray packet shares; here a
    thread walks one ray, so the count is the ray's own."""
    key = form_key("trace_scene", shading_model, debug_steps)
    if _device(o, "trace_scene") == "cpu":
        return trace_scene(scene, o, d, t_max, root_code=root_code,
                           stack_size=stack_size, t_min=T_MIN,
                           any_hit=any_hit, active=active,
                           cull_mask=cull_mask, slot_materials=slot_materials,
                           shading_model=shading_model,
                           debug_steps=debug_steps)
    lib = _lib()
    o, d, t, act = _rays(o, d, t_max, active)
    r = o.shape[0]
    out = _hit_outputs(r, o.device)
    res = ((None, None, None, 1, 1) if shading_model is None
           else _resolve_args(scene, slot_materials))
    work = work_counters(lib, act)
    rc = lib.trace_launch(
        *_scene_args(lib, scene, root_code, stack_size, cull_mask),
        int(any_hit), int(debug_steps), *res,
        *_alpha_args(shading_model, o.device),
        o.data_ptr(), d.data_ptr(), t.data_ptr(), _ptr(act), r,
        *(x.data_ptr() for x in out), _ptr(work),
        torch.cuda.current_stream(o.device).cuda_stream)
    _raise_on(rc, key)
    return HitRecord2(*out)


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

def trace_resolve_plain(scene: RTScene, slot_materials, o, d, t_max, *,
                        root_code: int, stack_size: int, active=None,
                        cull_mask: int = 0xFF, counts=None, max_steps=None,
                        shading_model=None):
    """Plain version of K8: closest hit (with ``shading_model``, through
    the leaf cutout), then ``accel.resolve_attrs``. Returns (HitRecord2,
    (uv, unnormalized world normal, material))."""
    rec = trace_scene(scene, o, d, t_max, root_code=root_code,
                      stack_size=stack_size, t_min=T_MIN, active=active,
                      cull_mask=cull_mask, counts=counts, max_steps=max_steps,
                      slot_materials=slot_materials,
                      shading_model=shading_model)
    return rec, resolve_attrs(scene, slot_materials, rec)


def trace_resolve_kernel(scene: RTScene, slot_materials, o, d, t_max, *,
                         root_code: int, stack_size: int, active=None,
                         cull_mask: int = 0xFF, shading_model=None):
    """Closest hit + resolve: kernel K8 on CUDA tensors, its plain version
    on CPU tensors; with ``shading_model`` its alpha form (the any-hit leaf
    cutout). Returns (HitRecord2, (uv, normal, material))."""
    if _device(o, "trace_resolve") == "cpu":
        return trace_resolve_plain(scene, slot_materials, o, d, t_max,
                                   root_code=root_code, stack_size=stack_size,
                                   active=active, cull_mask=cull_mask,
                                   shading_model=shading_model)
    lib = _lib()
    o, d, t, act = _rays(o, d, t_max, active)
    r = o.shape[0]
    hit_out = _hit_outputs(r, o.device)
    res_out = _resolve_outputs(r, o.device)
    work = work_counters(lib, act)
    rc = lib.trace_resolve_launch(
        *_scene_args(lib, scene, root_code, stack_size, cull_mask),
        *_resolve_args(scene, slot_materials),
        *_alpha_args(shading_model, o.device),
        o.data_ptr(), d.data_ptr(), t.data_ptr(), _ptr(act), r,
        *(x.data_ptr() for x in hit_out + res_out), _ptr(work),
        torch.cuda.current_stream(o.device).cuda_stream)
    _raise_on(rc, form_key("trace_resolve", shading_model))
    return HitRecord2(*hit_out), res_out


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

def trace_bundle_plain(scene: RTScene, o, dirs: Sequence, caps: Sequence,
                       occ_actives, ao_dirs: Sequence, ao_caps: Sequence,
                       ao_actives, *, root_code: int, stack_size: int,
                       resolve=None, cull_mask: int = 0xFF, counts=None):
    """Plain version of K9: one any-hit trace per occlusion sample (bit s
    set where sample s is occluded or inactive), one closest-hit trace per
    AO sample (t = its cap on a miss, -3e38 where inactive) and, with
    ``resolve = (slot_materials, dir, cap, active)``, one closest-hit +
    resolve trace. Returns (bits i32[R], AO t tuple, resolved or None).
    ``counts`` (optional) accumulates the AO and resolve walks' pops, and
    the occlusion walks' under ``counts["occlusion"]``."""
    r = o.shape[0]
    walk = dict(root_code=root_code, stack_size=stack_size, t_min=T_MIN,
                cull_mask=cull_mask, counts=counts)
    occ_walk = dict(walk, counts=None if counts is None
                    else counts.setdefault("occlusion", {}))
    bits = torch.zeros(r, dtype=torch.int32, device=o.device)
    for s, (d, tc) in enumerate(zip(dirs, caps)):
        act = None if occ_actives is None else occ_actives[s]
        rec = trace_scene(scene, o, d, tc, any_hit=True, active=act,
                          **occ_walk)
        occ = rec.hit if act is None else (rec.hit | ~act)
        bits = bits | (occ.to(torch.int32) << s)
    ao_ts = []
    for j, (d, tc) in enumerate(zip(ao_dirs, ao_caps)):
        act = None if ao_actives is None else ao_actives[j]
        cap = torch.as_tensor(tc, dtype=torch.float32, device=o.device).expand(r)
        rec = trace_scene(scene, o, d, cap, active=act, **walk)
        t = torch.where(rec.hit, rec.t, cap)
        if act is not None:
            t = torch.where(act, t, -3e38)
        ao_ts.append(t)
    resolved = None
    if resolve is not None:
        smat, rs_d, rs_cap, rs_active = resolve
        resolved = trace_resolve_plain(
            scene, smat, o, rs_d, rs_cap, root_code=root_code,
            stack_size=stack_size, active=rs_active, cull_mask=cull_mask,
            counts=counts)
    return bits, tuple(ao_ts), resolved


def occlusion_union_plain(scene: RTScene, o, dirs: Sequence, caps: Sequence,
                          occ_actives, *, root_code: int, stack_size: int,
                          cull_mask: int = 0xFF,
                          counts=None) -> torch.Tensor:
    """Plain version of K9's union walk of its occlusion samples: bit s of
    the result is set where occlusion sample s is occluded or inactive, as
    ``trace_bundle_plain``'s bits. The samples go in groups of
    ``UNION_GROUP``;
    each ray walks one stack for a group, each entry with the mask of the
    samples that reached it. A box pop slab-tests each live sample of its
    mask with the sample's own 1/d and cap and pushes each child with the
    samples that hit it (the far child first, by the lowest sample that
    hits a child); a leaf tests each of its samples; a sample leaves at its
    first winning leaf; an entry none of whose samples is live is dropped
    without a visit; a sample equal to the one before it in its group
    (both active, the direction and cap bit for bit) does not walk and
    takes that sample's bit. Any-hit bits do not depend on the order of the visits, so they
    equal the per-sample walks'. ``counts`` (optional) accumulates
    the box, leaf and instance pops; ``box_tests``, ``leaf_tests`` and
    ``inst_tests``, the samples each pop tests; ``walks``, the samples that
    walk; ``leaf_tris``, the triangles a leaf pop visits (its real ones, up
    to the last live sample's first win) and ``tri_tests``, the (triangle,
    sample) tests among them (each sample's up to its first win)."""
    r, dev = o.shape[0], o.device
    n, group = len(dirs), UNION_GROUP
    d = torch.stack([x.to(torch.float32) for x in dirs]) if n else None
    c = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev)
                     .expand(r) for x in caps]) if n else None
    a = torch.stack([torch.ones(r, dtype=torch.bool, device=dev)
                     if occ_actives is None or occ_actives[s] is None
                     else occ_actives[s] for s in range(n)]) if n else None
    # a sample equal to the one before in its group (both active; direction
    # and cap bit for bit) does not walk: its bit is that sample's
    no = torch.zeros(r, dtype=torch.bool, device=dev)
    same = [no if s % group == 0 else
            a[s] & a[s - 1]
            & (c[s].view(torch.int32) == c[s - 1].view(torch.int32))
            & (d[s].view(torch.int32) == d[s - 1].view(torch.int32)).all(-1)
            for s in range(n)]
    bits = torch.zeros(r, dtype=torch.int32, device=dev)
    for g0 in range(0, n, group):
        g1 = min(g0 + group, n)
        walks = a[g0:g1] & ~torch.stack(same[g0:g1])
        bits = bits | (_union_group(scene, o, d[g0:g1], c[g0:g1], walks,
                                    root_code=root_code,
                                    stack_size=stack_size,
                                    cull_mask=cull_mask, counts=counts) << g0)
    for s in range(1, n):
        prev = (bits >> (s - 1)) & 1
        bits = torch.where(same[s], (bits & ~(1 << s)) | (prev << s), bits)
    return bits


def _union_group(scene, o, d, cap, act, *, root_code, stack_size, cull_mask,
                 counts):
    """One group's union walk (``occlusion_union_plain``): d f32[G, R, 3],
    cap f32[G, R], act bool[G, R] -> i32[R], bit g set where sample g is
    occluded or inactive."""
    n, r = d.shape[0], o.shape[0]
    dev, nn, nl, s = o.device, scene.nodes.shape[0], scene.leaf_rows.shape[0], \
        stack_size
    bit = 1 << torch.arange(n, dtype=torch.int32, device=dev)
    alive0 = (act.to(torch.int32) * bit[:, None]).sum(0, dtype=torch.int32)
    result = ((~act).to(torch.int32) * bit[:, None]).sum(0, dtype=torch.int32)
    w = torch.nonzero(alive0 != 0).flatten()
    m = w.shape[0]
    if counts is not None:
        counts["walks"] = counts.get("walks", 0) + int(act.sum())
    o_w = o[w]
    d_w = d[:, w].permute(1, 0, 2).contiguous()          # [m, G, 3]
    cap_w = cap[:, w].t().contiguous()                   # [m, G]
    iw = 1.0 / torch.where(d_w.abs() < 1e-12, 1e-12, d_w)
    oo, dd, io = o_w.clone(), d_w.clone(), iw.clone()
    alive, won = alive0[w], torch.zeros_like(alive0[w])
    # column s is a trash slot: a push past the stack bound is dropped
    stack = torch.zeros((m, s + 1), dtype=torch.int32, device=dev)
    smask = torch.zeros((m, s + 1), dtype=torch.int32, device=dev)
    stack[:, 0] = root_code
    smask[:, 0] = alive
    sp = torch.ones((m,), dtype=torch.int64, device=dev)

    def push(rows, val, mask, do_push):
        rows, val, mask = rows[do_push], val[do_push], mask[do_push]
        top = sp[rows]
        stack[rows, torch.clamp(top, max=s)] = val
        smask[rows, torch.clamp(top, max=s)] = mask
        sp[rows] = top + 1

    def tally(key, idx, mk):
        if counts is not None:
            counts[key] = counts.get(key, 0) + int(idx.shape[0])
            tests = int(((mk[idx][:, None] & bit) != 0).sum())
            counts[key + "_tests"] = counts.get(key + "_tests", 0) + tests

    while m:
        top = sp - 1
        inb = top < s
        at = torch.clamp(top, max=s)[:, None]
        code = torch.where(inb, stack.gather(1, at)[:, 0], 0)
        # an entry dropped past the bound: code 0 for every sample
        mk = torch.where(inb, smask.gather(1, at)[:, 0], 0xFF) & alive
        sp = top
        typ = (code >> _TYPE_SHIFT) & 3
        payload = code & _PAYLOAD_MASK
        live = mk != 0
        ii = torch.nonzero(live & (typ == TYPE_INST)).flatten()
        ib = torch.nonzero(live & (typ == TYPE_BOX)).flatten()
        il = torch.nonzero(live & (typ == TYPE_LEAF)).flatten()
        sel = (mk[:, None] & bit) != 0                    # [m, G]
        for key, idx in (("box", ib), ("leaf", il), ("inst", ii)):
            tally(key, idx, mk)

        if ii.numel():   # instance: the shared origin and each sample's d
            p = torch.clamp(payload[ii], 0, nn - 1).long()
            inv, cpair = scene.nodes[p], scene.codes[p]
            wo, wd = o_w[ii], d_w[ii]
            oo[ii] = torch.stack(
                [inv[:, 4 * k] * wo[:, 0] + inv[:, 4 * k + 1] * wo[:, 1]
                 + inv[:, 4 * k + 2] * wo[:, 2] + inv[:, 4 * k + 3]
                 for k in range(3)], dim=-1)
            nd = torch.stack(
                [inv[:, None, 4 * k] * wd[..., 0]
                 + inv[:, None, 4 * k + 1] * wd[..., 1]
                 + inv[:, None, 4 * k + 2] * wd[..., 2] for k in range(3)],
                dim=-1)
            on = sel[ii][..., None]
            dd[ii] = torch.where(on, nd, dd[ii])
            io[ii] = torch.where(
                on, 1.0 / torch.where(nd.abs() < 1e-12, 1e-12, nd), io[ii])
            push(ii, cpair[:, 0], mk[ii],
                 ((cpair[:, 1] >> 24) & cull_mask) != 0)

        if ib.numel():   # box row: each live sample against both children
            p = torch.clamp(payload[ib], 0, nn - 1).long()
            row, cpair = scene.nodes[p], scene.codes[p]
            k_ = ib.shape[0]
            obj = ((code[ib] >> 30) & 1) == 1
            ot = torch.where(obj[:, None], oo[ib], o_w[ib])
            inv = torch.where(obj[:, None, None], io[ib], iw[ib])
            rows = row[:, None, :].expand(k_, n, 12).reshape(-1, 12)
            h0, h1, tn0, tn1 = (x.reshape(k_, n) for x in _slab2(
                ot[:, None, :].expand(k_, n, 3).reshape(-1, 3),
                inv.reshape(-1, 3), cap_w[ib].reshape(-1), rows[:, 0:3],
                rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]))
            h0, h1 = h0 & sel[ib], h1 & sel[ib]
            m0 = (h0.to(torch.int32) * bit).sum(1, dtype=torch.int32)
            m1 = (h1.to(torch.int32) * bit).sum(1, dtype=torch.int32)
            lead = (h0 | h1).to(torch.int32).argmax(dim=1, keepdim=True)
            first0 = tn0.gather(1, lead)[:, 0] <= tn1.gather(1, lead)[:, 0]
            c0, c1 = cpair[:, 0], cpair[:, 1]
            far_m = torch.where(first0, m1, m0)
            near_m = torch.where(first0, m0, m1)
            push(ib, torch.where(first0, c1, c0), far_m, far_m != 0)
            push(ib, torch.where(first0, c0, c1), near_m, near_m != 0)

        if il.numel():   # leaf: each live sample against its K triangles
            p = torch.clamp(payload[il], 0, nl - 1).long()
            tri = scene.leaf_rows[p, :_UV].reshape(-1, 1, K, 9)
            t, _, _, hit = moller_trumbore_edges(
                oo[il][:, None, None, :], dd[il][:, :, None, :],
                tri[..., 0:3], tri[..., 3:6], tri[..., 6:9], t_min=T_MIN)
            real = scene.leaf_prim[p] >= 0
            cand = hit & real[:, None, :] & (t < cap_w[il][:, :, None])
            wins = cand.any(-1) & sel[il]
            wm = (wins.to(torch.int32) * bit).sum(1, dtype=torch.int32)
            if counts is not None:   # slot order, a sample out at its win
                upto = torch.cumsum(real.to(torch.int64), -1)
                stop = torch.where(wins, cand.to(torch.int8).argmax(-1),
                                   K - 1)
                tests = upto.gather(1, stop) * sel[il]
                last = torch.where(sel[il], stop, 0).amax(1, keepdim=True)
                counts["leaf_tris"] = counts.get("leaf_tris", 0) + int(
                    upto.gather(1, last).sum())
                counts["tri_tests"] = counts.get("tri_tests", 0) + int(
                    tests.sum())
            alive[il] = alive[il] & ~wm
            won[il] = won[il] | wm

        done = (sp <= 0) | (alive == 0)
        if bool(done.any()):
            result[w[done]] = result[w[done]] | won[done]
            keep = ~done
            w, o_w, d_w, cap_w = w[keep], o_w[keep], d_w[keep], cap_w[keep]
            oo, dd, iw, io = oo[keep], dd[keep], iw[keep], io[keep]
            alive, won = alive[keep], won[keep]
            stack, smask, sp = stack[keep], smask[keep], sp[keep]
            m = w.shape[0]
    return result


def _stack_samples(dirs, caps, actives, r, dev):
    n = len(dirs)
    if n == 0:
        return None, None, None
    d = torch.stack([x.to(torch.float32) for x in dirs]).contiguous()
    c = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev)
                     .expand(r) for x in caps]).contiguous()
    if actives is None:
        a = torch.ones((n, r), dtype=torch.uint8, device=dev)
    else:
        a = torch.stack([torch.ones(r, dtype=torch.bool, device=dev)
                         if x is None else x for x in actives]
                        ).to(torch.uint8).contiguous()
    return d, c, a


def trace_bundle_kernel(scene: RTScene, o, dirs: Sequence, caps: Sequence,
                        occ_actives, ao_dirs: Sequence, ao_caps: Sequence,
                        ao_actives, *, root_code: int, stack_size: int,
                        resolve=None, cull_mask: int = 0xFF):
    """Origin-shared sample bundle: kernel K9 on CUDA tensors,
    ``trace_bundle_plain`` on CPU tensors (same arguments and results)."""
    if len(dirs) > 30:
        raise ValueError("at most 30 occlusion samples fit the i32 bitmask")
    if _device(o, "trace_bundle") == "cpu":
        return trace_bundle_plain(scene, o, dirs, caps, occ_actives, ao_dirs,
                                  ao_caps, ao_actives, root_code=root_code,
                                  stack_size=stack_size, resolve=resolve,
                                  cull_mask=cull_mask)
    lib = _lib()
    dev, r = o.device, o.shape[0]
    o = o.contiguous()
    _check("origin", o, torch.float32, dev, (r, 3))
    occ = _stack_samples(dirs, caps, occ_actives, r, dev)
    ao = _stack_samples(ao_dirs, ao_caps, ao_actives, r, dev)
    bits = torch.empty(r, dtype=torch.int32, device=dev)
    ao_t = torch.empty((len(ao_dirs), r), dtype=torch.float32, device=dev)
    smat = scene.codes.new_zeros((scene.inv_rows.shape[0], 1))
    rs_in = (None, None, None)
    hit_out = res_out = None
    if resolve is not None:
        smat, rs_d, rs_cap, rs_active = resolve
        _, rs_d, rs_cap, rs_act = _rays(o, rs_d, rs_cap, rs_active)
        if rs_act is None:
            rs_act = torch.ones(r, dtype=torch.uint8, device=dev)
        rs_in = (rs_d, rs_cap, rs_act)
        hit_out = _hit_outputs(r, dev)
        res_out = _resolve_outputs(r, dev)
    outs = (hit_out + res_out) if hit_out is not None else (None,) * 7
    rc = lib.trace_bundle_launch(
        *_scene_args(lib, scene, root_code, stack_size, cull_mask),
        *_resolve_args(scene, smat), o.data_ptr(), r,
        _ptr(occ[0]), _ptr(occ[1]), _ptr(occ[2]), len(dirs),
        _ptr(ao[0]), _ptr(ao[1]), _ptr(ao[2]), len(ao_dirs),
        *(_ptr(x) for x in rs_in), bits.data_ptr(), ao_t.data_ptr(),
        *(_ptr(x) for x in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "trace_bundle")
    resolved = None
    if hit_out is not None:
        resolved = (HitRecord2(*hit_out), res_out)
    return bits, tuple(ao_t.unbind(0)), resolved
