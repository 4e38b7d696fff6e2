"""The copy and plumbing probes (K12, ``csrc/probes.cu``) and the
measurements of the three TPU probe scripts on the card.

  * ``chunk_stream``        K12a (``scripts/probe_smem_dma.py``): one CTA
    copies the chunk blocks that ``order`` names into shared memory, one
    after another, in one of three copy forms (``FORMS``), and sums
    ``acc + f[0] + f[BLK-1] + f32(i[0])`` a step;
  * ``chunk_stream_sweep``  K12b (``scripts/probe_smem_dma2.py``): the bulk
    copy chain at one block size, chained or double-buffered, summing the
    first float of each block;
  * ``pass_through``        K12c (``scripts/prof_rt_floor2.py`` ``ident``):
    seven f32 ray planes in, five hit planes out (two as their i32 bits).

On a CUDA tensor each wrapper launches its kernel (built at first use) and
counts the launch in ``LAUNCHES``; on a CPU tensor it runs its plain version
beside it. The copy kernels also return their own ``%globaltimer`` span in
ns (-1 when a copy never completed; the plain versions return None).

``measure()`` runs the scripts' measurements on the card, and
``python -m paperrenderer_tpu_torch.utils.probes`` prints them as JSON lines:
µs per copy step of each K12a form and K12b case, K12c's ms at 1080p's
2,073,600 rays and at 1,024 (the empty-launch floor) beside the five
``Tensor.copy_`` calls of the same bytes (device ms, and the host's ms to
issue a call), K7 on the 1080p RT scene's primary rays all dead (closest and
any hit) and live, and the step-count forms of K7 and K10 (``debug_steps``):
every ray of the dead any-hit wave counts 0 steps.

The traversal kernels' waves are built here once, for ``chip_smoke.py`` and
``walk_bench.py`` alike: ``primary_wavefront``, ``rt_wavefronts``,
``leaf_wavefronts``, ``masked_waves`` (the masked launches of one frame)
and ``headline_waves``, the cases the walk's design is timed on.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import subprocess
import time
from typing import Sequence

import numpy as np
import torch

from ..ops import trace_kernel as TK
from ..ops import trace_paged as TPG
from .cuda_build import load_library
from .device import require_device
from .profiling import device_time, host_time

# the TPU probes' sizes (scripts/probe_smem_dma.py:20-22, probe_smem_dma2.py:
# 111-112, the 256-step order of probe_smem_dma.py:50)
NC = 64            # chunks
BLK = 6144         # f32 per block (24 KiB)
IBLK = 1024        # i32 per block (4 KiB)
N_STEPS = 256
SWEEP_ITERS = 256
# K12b's cases: (floats per block, double-buffered)
SWEEP_CASES = ((1024, False), (2048, False), (6144, False), (24576, False),
               (6144, True))
FORMS = ("plain", "cp_async", "bulk")
PASS_RAYS = (1920 * 1080, 1024)
WAIT_S = 30.0      # host-side limit on one probe launch
REPS = 10          # timed calls a measurement
SEED = 0           # the scripts' numpy seed
ORDER_SEED = 8     # the seed of ray_order's random order of a wave
ADVERSARIAL_SEED = 10   # the seed of adversarial_bundle's random samples

# launches of each kernel wrapper, counted where the kernel is launched
LAUNCHES = {"chunk_stream": 0, "chunk_stream_sweep": 0, "pass_through": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = []


def _lib():
    """The built ``csrc/probes.cu`` with its C signatures declared."""
    if not _LIB:
        lib = load_library("probes")
        lib.chunk_stream_launch.argtypes = [_P] * 3 + [_I] * 5 + [_P] * 3
        lib.chunk_stream_sweep_launch.argtypes = [_P] * 2 + [_I] * 4 + [_P] * 3
        lib.pass_through_launch.argtypes = [_P] * 7 + [_I] + [_P] * 6
        for fn in (lib.chunk_stream_launch, lib.chunk_stream_sweep_launch,
                   lib.pass_through_launch):
            fn.restype = _I
        _LIB.append(lib)
    return _LIB[0]


def _check(name: str, t: torch.Tensor, dtype, device, numel=None):
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or t.dim() != 1):
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor on "
                         f"{device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} must hold {numel} elements, got {t.numel()}")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for the bulk copy")


def _device(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _sequential_sum(terms: torch.Tensor) -> torch.Tensor:
    """f32[T] -> f32[1]: 0 + t0 + t1 + ..., one f32 add at a time."""
    acc = torch.zeros((), dtype=torch.float32, device=terms.device)
    for x in terms.unbind():
        acc = acc + x
    return acc.reshape(1)


def _blocks(order: torch.Tensor, nc: int) -> torch.Tensor:
    return order.long().clamp(0, nc - 1)


def _chunk_count(hf: torch.Tensor, blk: int) -> int:
    if blk <= 0 or blk % 4 or hf.numel() % blk:
        raise ValueError("blocks must be whole multiples of 4 floats that "
                         "tile hf")
    return hf.numel() // blk


# ---------------------------------------------------------------------------
# K12a
# ---------------------------------------------------------------------------

def chunk_stream_plain(hf, hi, order) -> torch.Tensor:
    """Plain version of K12a: for each chunk c of ``order`` (clamped to the
    chunks), acc + hf[c, 0] + hf[c, BLK-1] + f32(hi[c, 0]), accumulated
    in f32 left to right from 0 -> f32[1]."""
    nc = _chunk_count(hf, BLK)
    c = _blocks(order, nc)
    f, i = hf.view(nc, BLK), hi.view(nc, IBLK)
    terms = torch.stack([f[c, 0], f[c, BLK - 1], i[c, 0].to(torch.float32)],
                        dim=1)
    return _sequential_sum(terms.reshape(-1))


def chunk_stream(hf, hi, order, *, form: str = "bulk"):
    """Chained copies of the chunk blocks ``order`` names (f32 blocks of
    BLK, i32 blocks of IBLK) into shared memory, in one copy ``form`` of
    ``FORMS``: kernel K12a on CUDA tensors, its plain version on CPU
    tensors. Returns (sum f32[1], kernel span i64[1] in ns or None)."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if _device(hf, "chunk_stream") == "cpu":
        return chunk_stream_plain(hf, hi, order), None
    dev = hf.device
    nc = _chunk_count(hf, BLK)
    _check("hf", hf, torch.float32, dev)
    _check("hi", hi, torch.int32, dev, nc * IBLK)
    _check("order", order, torch.int32, dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    span = torch.empty(1, dtype=torch.int64, device=dev)
    rc = _lib().chunk_stream_launch(
        hf.data_ptr(), hi.data_ptr(), order.data_ptr(), order.numel(), nc,
        BLK, IBLK, FORMS.index(form), out.data_ptr(), span.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "chunk_stream")
    return out, span


# ---------------------------------------------------------------------------
# K12b
# ---------------------------------------------------------------------------

def chunk_stream_sweep_plain(hf, order, blk: int, dbuf: bool) -> torch.Tensor:
    """Plain version of K12b: the sum, in f32 left to right from 0, of the
    first float of block order[k] over the steps the chain sums
    (SWEEP_ITERS chained, SWEEP_ITERS - 1 double-buffered) -> f32[1]."""
    nc = _chunk_count(hf, blk)
    c = _blocks(order[:SWEEP_ITERS - 1 if dbuf else SWEEP_ITERS], nc)
    return _sequential_sum(hf.view(nc, blk)[c, 0])


def chunk_stream_sweep(hf, order, *, blk: int, dbuf: bool = False):
    """The bulk-copy chain of SWEEP_ITERS steps at one block size (``blk``
    floats), chained or double-buffered (the copy of step k+1 started
    before step k is waited on): kernel K12b on CUDA tensors, its plain
    version on CPU tensors. Returns (sum f32[1], kernel span i64[1] in ns
    or None)."""
    if order.numel() < SWEEP_ITERS + (1 if dbuf else 0):
        raise ValueError("order must name a block for every step started")
    if _device(hf, "chunk_stream_sweep") == "cpu":
        return chunk_stream_sweep_plain(hf, order, blk, dbuf), None
    dev = hf.device
    nc = _chunk_count(hf, blk)
    _check("hf", hf, torch.float32, dev)
    _check("order", order, torch.int32, dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    span = torch.empty(1, dtype=torch.int64, device=dev)
    rc = _lib().chunk_stream_sweep_launch(
        hf.data_ptr(), order.data_ptr(), SWEEP_ITERS, nc, blk, int(dbuf),
        out.data_ptr(), span.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "chunk_stream_sweep")
    return out, span


# ---------------------------------------------------------------------------
# K12c
# ---------------------------------------------------------------------------

def pass_through_plain(planes: Sequence[torch.Tensor]):
    """Plain version of K12c: (a0, a1 bits, a2 bits, a3, a4) as new
    tensors; a5 and a6 are read by the kernel only."""
    a0, a1, a2, a3, a4 = planes[:5]
    return (a0.clone(), a1.view(torch.int32).clone(),
            a2.view(torch.int32).clone(), a3.clone(), a4.clone())


def pass_through(planes: Sequence[torch.Tensor]):
    """Seven f32[R] ray planes -> five hit planes (f32, i32, i32, f32, f32):
    kernel K12c on CUDA tensors, its plain version on CPU tensors."""
    if len(planes) != 7:
        raise ValueError("pass_through takes seven planes")
    if _device(planes[0], "pass_through") == "cpu":
        return pass_through_plain(planes)
    dev, r = planes[0].device, planes[0].numel()
    for k, a in enumerate(planes):
        _check(f"a{k}", a, torch.float32, dev, r)
    outs = tuple(torch.empty(r, dtype=dt, device=dev) for dt in (
        torch.float32, torch.int32, torch.int32, torch.float32, torch.float32))
    rc = _lib().pass_through_launch(
        *(a.data_ptr() for a in planes), r, *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "pass_through")
    return outs


# ---------------------------------------------------------------------------
# Inputs, made with numpy from a seed as the scripts make them
# ---------------------------------------------------------------------------

def chunk_stream_inputs(device):
    """probe_smem_dma.py's hf f32[NC*BLK] (arange * 0.001), hi i32[NC*IBLK]
    (block c holds c*1000 + arange(IBLK)) and order i32[N_STEPS]."""
    hf = np.arange(NC * BLK, dtype=np.float32) * np.float32(0.001)
    hi = (np.arange(IBLK, dtype=np.int32)[None, :]
          + np.arange(NC, dtype=np.int32)[:, None] * 1000).reshape(-1)
    order = np.random.default_rng(SEED).integers(0, NC, N_STEPS).astype(
        np.int32)
    return tuple(torch.from_numpy(x).to(device) for x in (hf, hi, order))


def sweep_inputs(blk: int, device):
    """probe_smem_dma2.py's hf f32[NC*blk] (arange * 0.001) and order
    i32[SWEEP_ITERS + 1]."""
    hf = np.arange(NC * blk, dtype=np.float32) * np.float32(0.001)
    order = np.random.default_rng(SEED).integers(
        0, NC, SWEEP_ITERS + 1).astype(np.int32)
    return torch.from_numpy(hf).to(device), torch.from_numpy(order).to(device)


def pass_through_inputs(r: int, device):
    """Seven f32[r] planes of standard normal values."""
    a = np.random.default_rng(SEED).standard_normal((7, r), dtype=np.float32)
    return tuple(torch.from_numpy(a[k]).to(device) for k in range(7))


def primary_wavefront(rt, cam, paged: bool, leaf_cutout: bool = False,
                      time=None):
    """(tracer, o, d, far, lights): the tracer and the camera's primary rays
    of one RayTraceRender frame, built as render_frame_rt builds them, on
    the layout ``paged`` names; with ``time`` the unique-geometry instances
    are animated by ``rt.animate`` (re-split with ``rt.anim_resplit``)."""
    from ..ops import accel as ACC
    from ..ops import trace as TR

    instances = rt.scene.flush()
    blasset, meta, anim_rest, anim_nodes = rt.accel.blas()
    slots, masks, table, inst_mask, opaque, lights, _ = rt._device_inputs(
        instances.capacity)
    ctx = ACC.make_scene_tracer(
        blasset, meta, anim_rest, anim_nodes, instances,
        rt.accel.inst_blas(instances.capacity),
        masks, rt.accel.tri_attr(), slots, table, tlas_index=0,
        stack_size=rt.accel.stack_size(instances.capacity), paged=paged,
        inst_mask=inst_mask, inst_opaque=opaque, leaf_cutout=leaf_cutout,
        time=time, animate=rt.animate, resplit=rt.anim_resplit)
    c = cam.matrices.to(rt.device)
    o, d = TR.raygen(c, rt.width, rt.height,
                     tile_order=TR.pick_tile(rt.width, rt.height))
    far = torch.full((o.shape[0],), 1000.0, device=o.device)
    return ctx, o.contiguous(), d, far, lights


def rt_wavefronts(rt, cam):
    """The tracer and the wavefronts of one RT frame, built exactly as
    RayTraceRender.render and ops.trace.trace_frame build them."""
    from ..ops import accel as ACC
    from ..ops import trace as TR
    from . import random as rnd

    instances = rt.scene.flush()
    blasset, meta, anim_rest, anim_nodes = rt.accel.blas()
    slots, masks, table, inst_mask, opaque, lights, _ = rt._device_inputs(
        instances.capacity)
    cam = cam.matrices.to(rt.device)
    scene, roots = ACC.assemble_scene(
        blasset, meta, anim_rest, anim_nodes, instances,
        rt.accel.inst_blas(instances.capacity),
        masks, rt.accel.tri_attr(), inst_mask=inst_mask, inst_opaque=opaque)
    ctx = ACC.SceneTracer(scene, slots, table, root_code=roots[0],
                          stack_size=rt.accel.stack_size(instances.capacity))
    w, h, p = rt.width, rt.height, rt.params
    o, d = TR.raygen(cam, w, h, tile_order=TR.pick_tile(w, h))
    r = o.shape[0]
    far = torch.full((r,), 1000.0, device=o.device)
    surf = ctx.trace_resolve(o, d, far, cull_mask=p.cull_mask)
    key = rnd.fold_in(rt._key, 1)
    refl_key = rnd.fold_in(key, 7)
    origin = surf.world_pos + surf.normal * 5e-3
    dirs, caps, actives, _ = TR._occlusion_samples(
        surf, lights, key, max(1, p.shadow_samples))
    ao_ds, ao_caps = TR._ao_samples(surf, key, p.ao_samples, p.ao_radius)
    rdir = TR._reflection_dir(surf, table, cam.cam_pos, refl_key, 0)
    return dict(ctx=ctx, o=o.contiguous(), d=d, far=far, surf=surf,
                origin=origin, dirs=dirs, caps=caps, actives=actives,
                ao_ds=ao_ds, ao_caps=ao_caps, rdir=rdir, slots=slots,
                cull=p.cull_mask, roots=roots)


def leaf_wavefronts(rt, cam, paged):
    """The leaf cutout's wavefronts of one RayTraceRender frame, built as
    render_frame_rt and ops.trace build them, on the layout `paged` names:
    the tracer (leaf cutout on), the camera's primary rays, and from their
    hits (through the cutout) the reflection rays and the first AO rays."""
    from ..ops import trace as TR
    from . import random as rnd

    ctx, o, d, far, _ = primary_wavefront(rt, cam, paged, leaf_cutout=True)
    surf = ctx.trace_resolve(o, d, far, use_alpha=True)
    key = rnd.fold_in(rt._key, 1)
    ao_ds, _ = TR._ao_samples(surf, key, 1, rt.params.ao_radius)
    return dict(
        ctx=ctx, o=o, d=d, far=far, surf=surf,
        refl_o=(surf.world_pos + surf.normal * 5e-3).contiguous(),
        rdir=TR._reflection_dir(surf, ctx.materials,
                                cam.matrices.to(rt.device).cam_pos,
                                rnd.fold_in(key, 7), 0),
        ao_o=(surf.world_pos + surf.normal * 1e-3).contiguous(),
        ao_d=ao_ds[0], ao_cap=torch.full_like(far, rt.params.ao_radius))


def masked_waves(render, cam):
    """[(wrapper name, its kernel wrapper, args, kwargs)] of every traversal
    launch with an active mask (the shadow, AO and reflection rays) that one
    frame of ``render`` (a RayTraceRender or HybridRender) makes through
    K7, K8, K10 or K11, and of every K9 launch (its samples all have one),
    in launch order. The frame runs as it always does; only the calls'
    inputs are kept."""
    calls, saved = [], []
    for mod, name in ((TK, "trace_scene_kernel"), (TK, "trace_resolve_kernel"),
                      (TK, "trace_bundle_kernel"),
                      (TPG, "trace_scene_paged_kernel"),
                      (TPG, "trace_resolve_paged_kernel")):
        fn = getattr(mod, name)

        def keep(*a, name=name, fn=fn, **k):
            if k.get("active") is not None or name == "trace_bundle_kernel":
                calls.append((name, fn, a, k))
            return fn(*a, **k)

        saved.append((mod, name, fn))
        setattr(mod, name, keep)
    try:
        render.render(cam)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls


def bundle_live(o, occ_actives, ao_actives, resolve=None) -> float:
    """The share of a K9 wave's pixels with an active sample."""
    live = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for a in list(occ_actives or []) + list(ao_actives or []) + (
            [] if resolve is None else [resolve[3]]):
        live = live | (torch.ones_like(live) if a is None else a)
    return float(live.float().mean())


def adversarial_bundle(scene, o, base, active, *, walk, n: int = 30):
    """An origin-shared occlusion bundle made to trip a union walk, from
    origins ``o`` f32[R, 3], ``base`` (at least three f32[R, 3] directions
    of a frame's samples: shadow, AO, reflection) and ``active`` bool[R]:
    ``n`` samples (30, the bitmask's limit, by default) with duplicate and
    exactly opposite directions, axis directions and directions with a
    zero component (1/d at inv_dir's clamp), seeded random ones
    (ADVERSARIAL_SEED); caps of 0, of T_MIN, of exactly a direction's
    closest hit t as the plain walk gives it (``walk``: root_code,
    stack_size, cull_mask) and of the next float above it; samples
    inactive on every other pixel between active ones, one sample inactive
    everywhere, and a stretch of pixels with every sample inactive.
    Returns (dirs, caps, actives), lists of n."""
    from ..ops.accel import trace_scene

    r, dev = o.shape[0], o.device
    d0, a0, rd = base[0], base[1], base[2]

    def hit_t(d):
        rec = trace_scene(scene, o, d, 1000.0, t_min=TK.T_MIN, **walk)
        return torch.where(rec.hit, rec.t, 1000.0)

    def axis(*v):
        return torch.tensor(v, dtype=torch.float32, device=dev).expand(r, 3)

    full = torch.full((r,), 1000.0, device=dev)
    t0, tr = hit_t(d0), hit_t(rd)
    above = torch.nextafter(t0, torch.full_like(t0, float("inf")))
    zx = d0.clone()
    zx[:, 0] = 0.0
    kinds = [(d0, full), (d0, full), (-d0, full), (d0, torch.zeros_like(full)),
             (d0, torch.full_like(full, TK.T_MIN)), (d0, t0), (d0, above),
             (axis(0.0, 0.0, 1.0), full), (axis(1.0, 0.0, 0.0), full),
             (axis(0.0, -1.0, 0.0), full), (zx, full), (a0, full),
             (-a0, full), (rd, full), (rd, tr), (-rd, tr)]
    g = torch.Generator().manual_seed(ADVERSARIAL_SEED)
    while len(kinds) < n:
        d = torch.randn((r, 3), generator=g).to(dev)
        if len(kinds) % 3 == 0:
            d[:, len(kinds) % 2] = 0.0
        cap = (torch.rand((r,), generator=g) * 10.0).to(dev)
        kinds.append((d, cap))
        if len(kinds) < n:
            kinds.append((d.clone(), cap.clone()))   # a duplicate
    kinds = kinds[:n]
    idx = torch.arange(r, device=dev)
    stretch = (idx >= r // 3) & (idx < r // 3 + max(1, r // 16))
    dirs, caps, actives = [], [], []
    for s, (d, cap) in enumerate(kinds):
        act = active & ~stretch
        if s % 3 == 1:
            act = act & (idx % 2 == 1)
        if s == 13:
            act = torch.zeros_like(act)
        dirs.append(d.contiguous())
        caps.append(cap.contiguous())
        actives.append(act)
    return dirs, caps, actives


def ray_order(n: int, device) -> torch.Tensor:
    """A seeded random order of ``n`` rays (ORDER_SEED): the incoherent
    form of a wave, whose outputs put back in order must equal the
    launch-order run's bit for bit."""
    return torch.from_numpy(
        np.random.default_rng(ORDER_SEED).permutation(n)).to(device)


def tensors_of(x):
    """The tensors of a traversal result (a tensor, a HitRecord2, tuples of
    them; None for an output a call does not make), in order."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    return [t for y in x for t in tensors_of(y)]


def headline_waves(device, width: int = 1920, height: int = 1080,
                   n: int = 10_000) -> dict:
    """{case: a function that launches its traversal kernel once on its
    wave}: the waves that the traversal kernels' design is timed on, at
    ``width`` x ``height`` (1080p: the frames' shape) with ``n``
    instances a grid.

    The leaf grid (``scenes.build_leaf_rt_grid``, paged layout): K11's
    alpha form on its primary rays, in launch order and in ``ray_order``,
    and on its first AO rays; the same grid on the flat layout: K8's alpha
    form on its primary and reflection rays. Config 2's grid: K10 (paged)
    and K7 (flat) on its primary rays. The RT scene (config 3): K7 on its
    primary rays, live and all dead. Then every masked wave
    (``masked_waves``) of one frame of config 3, hybrid config 4 and the
    hybrid grid: the mostly live waves beside the sparse ones of the leaf
    grid, and K9 on both bundles of config 3's and of hybrid config 4's
    frame (the primary side's 2 or 4 shadow + 1 or 2 AO samples and the
    reflection hits'), each K9 function with ``live``, the share of its
    pixels with an active sample, and ``host`` (its issue cost is timed)."""
    from ..ops import trace as TR
    from ..scenes import (build_dynamic_scene, build_hybrid_scene,
                          build_leaf_rt_grid, build_rt_scene)
    from . import random as rnd

    out = {}
    rt, _, cam = build_leaf_rt_grid(n, width, height, device=device)[1:]
    for paged in (True, False):
        lw = leaf_wavefronts(rt, cam, paged)
        ctx, o, d, far, surf = (lw[k] for k in ("ctx", "o", "d", "far",
                                                 "surf"))
        walk = dict(root_code=ctx.root_code, stack_size=ctx.stack_size,
                    shading_model=ctx.materials.shading_model)
        sc, smat = ctx.scene, ctx.slot_materials
        if paged:
            walk["max_steps"] = ctx._step_bound()
            perm = ray_order(o.shape[0], o.device)
            po, pd = o[perm].contiguous(), d[perm].contiguous()
            k11 = functools.partial(TPG.trace_resolve_paged_kernel, sc, smat,
                                    **walk)
            out["k11_alpha_leaf_primary"] = functools.partial(k11, o, d, far)
            out["k11_alpha_leaf_primary_permuted"] = functools.partial(
                k11, po, pd, far)
            out["k11_alpha_leaf_ao"] = functools.partial(
                k11, lw["ao_o"], lw["ao_d"], lw["ao_cap"], active=surf.valid)
        else:
            k8 = functools.partial(TK.trace_resolve_kernel, sc, smat, **walk)
            out["k8_alpha_leaf_primary"] = functools.partial(k8, o, d, far)
            out["k8_alpha_leaf_reflection"] = functools.partial(
                k8, lw["refl_o"], lw["rdir"], far, active=surf.valid)

    eng, rp, gcam = build_dynamic_scene(n, width, height, device=device)
    grid = eng.create_ray_trace_render(width=width, height=height,
                                       lights=rp.lights)
    grid.add_instances_from(rp)
    for paged in (True, False):
        ctx, o, d, far, _ = primary_wavefront(grid, gcam, paged)
        out[f"k{10 if paged else 7}_grid_primary"] = functools.partial(
            ctx.trace, o, d, far)

    _, rt3, cam3 = build_rt_scene(width, height, device=device)
    w = rt_wavefronts(rt3, cam3)
    ctx, o, d, far = w["ctx"], w["o"], w["d"], w["far"]
    dead = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    out["k7_rt_primary"] = functools.partial(ctx.trace, o, d, far)
    out["k7_rt_primary_dead"] = functools.partial(ctx.trace, o, d, far,
                                                  active=dead)

    hy4, cam4 = build_hybrid_scene(width, height, device=device)[1:]
    hgrid = eng.create_hybrid_render(width=width, height=height,
                                     lights=rp.lights)
    hgrid.add_instances_from(rp)
    short = {"trace_scene_kernel": "k7", "trace_resolve_kernel": "k8",
             "trace_scene_paged_kernel": "k10",
             "trace_resolve_paged_kernel": "k11"}
    for frame, render, c in (("rt", rt3, cam3), ("hybrid4", hy4, cam4),
                             ("hybrid_grid", hgrid, gcam)):
        calls = masked_waves(render, c)
        bundles = [x for x in calls if x[0] == "trace_bundle_kernel"]
        calls = [x for x in calls if x[0] != "trace_bundle_kernel"]
        for j, (name, fn, a, k) in enumerate(calls):
            out[f"{short[name]}_{frame}_masked{j}"] = functools.partial(
                fn, *a, **k)
        # K9 (not in the grid's paged frame): the primary side's shadow +
        # AO bundle and the reflection hits' one
        for side, (_, fn, a, k) in zip(("shadow_ao", "reflection_bundle"),
                                       bundles):
            case = out[f"k9_{frame}_{side}"] = functools.partial(fn, *a, **k)
            case.live = bundle_live(a[1], a[4], a[7], k.get("resolve"))
            case.host = True   # walk_bench times its issue cost too
    return out


def warp_efficiency(steps: torch.Tensor, width: int = 32) -> float:
    """The lane share a lockstep walk keeps busy: per-ray step counts in
    launch order, cut into groups of ``width`` rays (the last one padded
    with zeros), give sum(steps) / (width x the sum of each group's
    maximum). A warp that walks its rays fixed to its lanes runs until its
    longest ray ends, so this is the share of its lane-steps that do work
    (0 when no ray steps)."""
    s = steps.detach().to("cpu", torch.float64).reshape(-1)
    pad = (-s.numel()) % width
    groups = torch.cat([s, s.new_zeros(pad)]).reshape(-1, width)
    busiest = float(groups.max(dim=1).values.sum())
    return float(s.sum()) / (width * busiest) if busiest > 0 else 0.0


def steps_kernel(ctx, o, d, far, *, any_hit=False, active=None):
    """The step-count form of the tracer's traversal kernel (K10 for a
    ``PagedSceneTracer``, else K7): its HitRecord2 with each ray's walk-loop
    trip count in ``bary[:, 0]``."""
    from ..ops.accel import PagedSceneTracer

    kw = dict(any_hit=any_hit, active=active, debug_steps=True, **ctx._walk())
    if isinstance(ctx, PagedSceneTracer):
        return TPG.trace_scene_paged_kernel(ctx.scene, o, d, far, **kw)
    return TK.trace_scene_kernel(ctx.scene, o, d, far, **kw)


# ---------------------------------------------------------------------------
# The measurements
# ---------------------------------------------------------------------------

def finish():
    """Wait for the current stream's work, raising TimeoutError after
    WAIT_S instead of hanging."""
    ev = torch.cuda.Event()
    ev.record()
    deadline = time.monotonic() + WAIT_S
    while not ev.query():
        if time.monotonic() > deadline:
            raise TimeoutError(f"a probe kernel ran past {WAIT_S} s")
        time.sleep(1e-3)


def _copy_probe(fn, n_steps: int) -> dict:
    """µs per copy step of one copy kernel: CUDA events over REPS
    launches, and the kernel's own %globaltimer span of one launch."""
    out, span = fn()
    finish()
    if int(span) < 0:
        raise RuntimeError("a bulk copy never completed (mbarrier wait timed "
                           "out)")
    ms = device_time(fn, iters=REPS, warmup=1) * 1e3
    return dict(sum=float(out), ms=ms, us_per_step_events=ms * 1e3 / n_steps,
                us_per_step_globaltimer=int(span) / 1e3 / n_steps)


def measure() -> dict:
    """The three probe scripts' measurements on the card (see the module
    docstring); raises when no card is present, a probe does not finish,
    or a dead any-hit ray counts a step."""
    from ..scenes import build_rt_scene

    dev = require_device("cuda")
    out = {}
    hf, hi, order = chunk_stream_inputs(dev)
    out["chunk_stream"] = {
        form: _copy_probe(lambda f=form: chunk_stream(hf, hi, order, form=f),
                          N_STEPS) for form in FORMS}
    sweep = {}
    for blk, dbuf in SWEEP_CASES:
        shf, sorder = sweep_inputs(blk, dev)
        sweep[f"{'dbuf' if dbuf else 'chained'}_{blk}"] = _copy_probe(
            lambda: chunk_stream_sweep(shf, sorder, blk=blk, dbuf=dbuf),
            SWEEP_ITERS - 1 if dbuf else SWEEP_ITERS)
    out["chunk_stream_sweep"] = sweep
    passes = {}
    for r in PASS_RAYS:
        planes = pass_through_inputs(r, dev)
        pass_through(planes)
        finish()
        dst = pass_through_plain(planes)

        def copies():
            for o, a in zip(dst, planes):
                o.copy_(a if o.dtype == a.dtype else a.view(o.dtype))
            return dst

        passes[f"r{r}"] = dict(
            ms=device_time(pass_through, planes, iters=REPS) * 1e3,
            copy_ms=device_time(copies, iters=REPS) * 1e3,
            host_ms=host_time(pass_through, planes, iters=REPS) * 1e3,
            copy_host_ms=host_time(copies, iters=REPS) * 1e3)
    out["pass_through"] = passes

    # prof_rt_floor2.py (b) and (c): K7 on the 1080p RT scene's primary rays
    _, rt, cam = build_rt_scene(1920, 1080, device=dev)
    ctx, o, d, far, _ = primary_wavefront(rt, cam, paged=False)
    dead = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
    out["k7_floor"] = dict(
        rays=o.shape[0],
        dead_closest_ms=device_time(
            lambda: ctx.trace(o, d, far, active=dead), iters=REPS) * 1e3,
        dead_any_hit_ms=device_time(
            lambda: ctx.trace(o, d, far, any_hit=True, active=dead),
            iters=REPS) * 1e3,
        live_ms=device_time(lambda: ctx.trace(o, d, far), iters=REPS) * 1e3,
        host_ms=host_time(lambda: ctx.trace(o, d, far, active=dead),
                          iters=REPS) * 1e3)
    dead_steps = steps_kernel(ctx, o, d, far, any_hit=True,
                              active=dead).bary[:, 0]
    if bool((dead_steps != 0).any()):
        raise RuntimeError("a dead any-hit ray counted traversal steps")
    out["k7_steps"] = dict(dead_any_hit_max=float(dead_steps.max()),
                           **_step_stats(ctx, o, d, far))
    pctx, po, pd, pfar, _ = primary_wavefront(rt, cam, paged=True)
    out["k10_steps"] = _step_stats(pctx, po, pd, pfar)
    return out


def _step_stats(ctx, o, d, far) -> dict:
    """The live closest-hit wave's step counts and what a step costs: the
    plain form's kernel ms over the steps walked."""
    steps = steps_kernel(ctx, o, d, far).bary[:, 0]
    ms = device_time(lambda: ctx.trace(o, d, far), iters=REPS) * 1e3
    total = float(steps.double().sum())
    return dict(steps_total=total, steps_mean=total / steps.numel(),
                steps_max=float(steps.max()),
                warp_efficiency=warp_efficiency(steps),
                steps_form_ms=device_time(lambda: steps_kernel(ctx, o, d, far),
                                          iters=REPS) * 1e3,
                plain_form_ms=ms, ps_per_step=ms * 1e9 / max(total, 1.0))


def main() -> int:
    """Print the card (nvidia-smi name and power limit), then one JSON line
    per measurement of ``measure()``."""
    require_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          nvidia_smi=smi)), flush=True)
    for key, value in measure().items():
        print(json.dumps({key: value}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
