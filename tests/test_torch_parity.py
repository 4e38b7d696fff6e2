"""Parity of the PyTorch port with the JAX package on the CPU: the scene
core, the static raster ops and frame, the keyed raster with the leaf
cutout, sorted translucency and supersampling, the draw-list frame, the
ray-tracing building blocks and the hybrid frame. The port runs the plain
PyTorch versions of its CUDA kernels, which a CPU tensor selects.

One section per part, each with its inputs and tolerances in the comment
that opens it. The sections share this module (and xdist's ``--dist
loadfile`` hands it to one worker), each keeping its own module-scoped
fixtures.
"""

import dataclasses
import functools
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paperrenderer_tpu as JPKG
import paperrenderer_tpu_torch as TPKG
from examples.render_rt import build_rt_scene as build_jax
from paperrenderer_tpu import core as JC
from paperrenderer_tpu.core import transforms as JT
from paperrenderer_tpu.ops import accel as JA
from paperrenderer_tpu.ops import preprocess as JP
from paperrenderer_tpu.ops import raster as JR
from paperrenderer_tpu.ops import raster_exact as JRE
from paperrenderer_tpu.ops import raster_pallas as JRP
from paperrenderer_tpu.ops import shading as JSH
from paperrenderer_tpu.ops import static_batch as JS
from paperrenderer_tpu.ops import tonemap as JTM
from paperrenderer_tpu.ops import translucency as JTL
from paperrenderer_tpu.render import RenderPass as JRenderPass
from paperrenderer_tpu_torch import (
    Camera, Material, MaterialRegistry, Model, ModelInstance, RenderEngine,
    RenderPass, Scene, make_cube,
)
from paperrenderer_tpu_torch import core as TC
from paperrenderer_tpu_torch.core import SHADE_TRANSLUCENT
from paperrenderer_tpu_torch.core import transforms as TT
from paperrenderer_tpu_torch.interop import from_numpy
from paperrenderer_tpu_torch.io import read_image, write_png
from paperrenderer_tpu_torch.ops import accel as TA
from paperrenderer_tpu_torch.ops import gather as TG
from paperrenderer_tpu_torch.ops import preprocess as TP
from paperrenderer_tpu_torch.ops import raster as TR
from paperrenderer_tpu_torch.ops import raster_exact as TRE
from paperrenderer_tpu_torch.ops import raster_pallas as TRP
from paperrenderer_tpu_torch.ops import shading as TSH
from paperrenderer_tpu_torch.ops import static_batch as TS
from paperrenderer_tpu_torch.ops import tonemap as TTM
from paperrenderer_tpu_torch.ops import trace_kernel as TK
from paperrenderer_tpu_torch.ops import translucency as TTL
from paperrenderer_tpu_torch.render.renderpass import draw_list_batch
from paperrenderer_tpu_torch.scenes import (
    build_dynamic_scene, build_example_scene, build_hybrid_scene,
    build_rt_scene, build_translucent_grid)
from paperrenderer_tpu_torch.scenes import build_rt_scene as build_port
from paperrenderer_tpu_torch.utils import random as rnd

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
# the keyed-raster and draw-list sections' image and triangle count
W, H, N_TRI = 128, 64, 300


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's tests: the tier-1 run
    puts several pytest workers on the machine's cores, and torch's default
    of one thread per core then oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(kind, obj):
    """The JAX dataclass ``obj`` as the port's ``kind`` (CPU tensors)."""
    arrays = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is not None and not isinstance(v, tuple):
            arrays[f.name] = np.asarray(v)
    return from_numpy(kind, arrays, device="cpu")


def _bands(img, ref, mean_tol=0.004, frac_tol=0.002, pix_thresh=0.06):
    """tests/test_golden_images.py's bands: mean |diff| <= mean_tol and at
    most frac_tol of the pixels off by > pix_thresh (max over channels)."""
    img = _np(img).astype(np.float32)
    ref = _np(ref).astype(np.float32)
    assert img.shape == ref.shape, (img.shape, ref.shape)
    diff = np.abs(img - ref).max(axis=-1)
    assert diff.mean() <= mean_tol, diff.mean()
    assert (diff > pix_thresh).mean() <= frac_tol, (diff > pix_thresh).mean()


# ===========================================================================
# Scene core
#
# Parity of the PyTorch port's scene core with the JAX package.
#
# Inputs come from numpy with a fixed seed and go through both packages.
# Tolerances: transforms and camera matrices 1e-6 (f32 rounding of the same
# formulas in two frameworks); scene arrays and static mappings exactly equal
# (pure host code / copies).
# ===========================================================================

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-6)


def test_transforms_match():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    pos = rng.uniform(-50, 50, (64, 3)).astype(np.float32)
    scale = rng.uniform(0.1, 3.0, (64, 3)).astype(np.float32)
    axis = rng.normal(size=(64, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, 64).astype(np.float32)
    t = torch.from_numpy
    qn_j = JT.quat_normalize(q)
    qn_t = TT.quat_normalize(t(q))
    np.testing.assert_allclose(_np(qn_t), _np(qn_j), **TOL)
    np.testing.assert_allclose(_np(TT.quat_to_mat3(qn_t)),
                               _np(JT.quat_to_mat3(qn_j)), **TOL)
    np.testing.assert_allclose(_np(TT.quat_multiply(qn_t, qn_t.flip(0))),
                               _np(JT.quat_multiply(qn_j, qn_j[::-1])), **TOL)
    np.testing.assert_allclose(_np(TT.quat_from_axis_angle(t(axis), t(ang))),
                               _np(JT.quat_from_axis_angle(axis, ang)), **TOL)
    m_j = JT.trs_to_mat34(pos, scale, qn_j)
    m_t = TT.trs_to_mat34(t(pos), t(scale), qn_t)
    np.testing.assert_allclose(_np(m_t), _np(m_j), rtol=1e-6, atol=1e-5)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(TT.apply_mat34(m_t, t(pts))),
                               _np(JT.apply_mat34(m_j, pts)),
                               rtol=1e-6, atol=1e-4)


CAMERAS = [
    dict(yfov=55.0, aspect=1.0, near=0.1, far=200.0,
         eye=(0.0, -7.5, 3.6), center=(0.0, 0.0, 0.8)),
    dict(yfov=70.0, aspect=1920 / 1080, near=0.1, far=500.0,
         eye=(0.0, -35.0, 35.0), center=(0.0, 40.0, 0.0)),
    dict(yfov=30.0, aspect=0.5, near=2.0, far=80.0,
         eye=(12.0, 3.0, -4.0), center=(-1.0, 2.0, 5.0)),
]


@pytest.mark.parametrize("spec", CAMERAS)
def test_camera_matrices_match(spec):
    cj = JPKG.Camera(yfov_deg=spec["yfov"], aspect=spec["aspect"],
                  near=spec["near"], far=spec["far"])
    cj.look_at(spec["eye"], spec["center"])
    ct = TPKG.Camera(yfov_deg=spec["yfov"], aspect=spec["aspect"],
                  near=spec["near"], far=spec["far"])
    ct.look_at(spec["eye"], spec["center"])
    mj, mt = cj.matrices, ct.matrices
    np.testing.assert_allclose(_np(mt.projection), _np(mj.projection), **TOL)
    np.testing.assert_allclose(_np(mt.view), _np(mj.view), **TOL)
    np.testing.assert_allclose(_np(mt.view_proj), _np(mj.view_proj),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_np(mt.cam_pos), _np(mj.cam_pos),
                               rtol=1e-6, atol=1e-5)


def _build_scene(mod, **scene_kw):
    """The same instance history in either package: growth past the
    128-slot floor, transform edits and a swap-remove."""
    scene = mod.Scene(**scene_kw)
    cube = mod.Model.from_mesh(scene.arena, *mod.make_cube(0.5))
    ball = mod.Model.from_mesh(scene.arena, *mod.make_icosphere(0.3, 1))
    rng = np.random.default_rng(3)
    insts = []
    for k in range(150):
        inst = mod.ModelInstance(cube if k % 3 else ball)
        inst.set_transform(pos=rng.uniform(-20, 20, 3),
                           scale=float(rng.uniform(0.5, 2.0)),
                           quat=rng.normal(size=4))
        scene.add_instance(inst)
        insts.append(inst)
    first = _snapshot(scene.flush())  # the JAX scatter donates its input
    for inst in insts[::7]:
        inst.set_transform(pos=rng.uniform(-20, 20, 3))
    scene.remove_instance(insts[10])
    scene.remove_instance(insts[-1])
    return scene, first, _snapshot(scene.flush())


def _snapshot(arrays):
    return {f.name: _np(getattr(arrays, f.name))
            for f in dataclasses.fields(arrays)}


def test_scene_flush_matches():
    sj, j0, j1 = _build_scene(JPKG, use_native=False)
    st, t0, t1 = _build_scene(TPKG, use_native=False, device="cpu")
    assert st.version == sj.version and st.count == sj.count
    for a, b in ((j0, t0), (j1, t1)):
        assert b["pos"].shape[0] == a["pos"].shape[0] == 256
        for name in a:
            np.testing.assert_array_equal(b[name], a[name], name)
    tj, tt = sj.tables(), st.tables()
    for f in dataclasses.fields(tj):
        np.testing.assert_array_equal(_np(getattr(tt, f.name)),
                                      _np(getattr(tj, f.name)))


def test_static_mapping_matches():
    from examples.render_dynamic import build_dynamic_scene as build_j
    from paperrenderer_tpu_torch.scenes import build_dynamic_scene as build_t

    _, rpj, _ = build_j(60, 64, 64)
    _, rpt, _ = build_t(60, 64, 64, device="cpu")
    mj = JS.build_static_mapping(rpj.scene)
    mt = TS.build_static_mapping(rpt.scene)
    for f in dataclasses.fields(mt):
        np.testing.assert_array_equal(_np(getattr(mt, f.name)),
                                      _np(getattr(mj, f.name)), f.name)


def test_arena_compaction_matches():
    """Free a mesh in the middle of the arena, compact, and re-expand: the
    arena arrays, the models' relocated handles and the static mapping are
    the same in both packages, and the free range is reused first."""
    def build(mod, **scene_kw):
        scene = mod.Scene(**scene_kw)
        meshes = [mod.make_cube(0.5), mod.make_uv_sphere(1.0, 6, 8),
                  mod.make_icosphere(0.3, 1), mod.make_torus(0.6, 0.2, 8, 6)]
        models = [mod.Model.from_mesh(scene.arena, *m) for m in meshes]
        for k, model in enumerate(models):
            if k != 1:
                inst = mod.ModelInstance(model)
                inst.set_transform(pos=(2.0 * k, 0.0, 0.0))
                scene.add_instance(inst)
        scene.arena.remove_mesh(models[1].lods[0].meshes[0].handle)
        refill = scene.arena.add_mesh(*mod.make_cube(0.25))   # best fit
        scene.arena.remove_mesh(refill)
        scene.compact_geometry()
        handles = [(mm.handle.vertex_offset, mm.handle.tri_offset)
                   for m in models for lod in m.lods for mm in lod.meshes]
        return scene, handles, refill

    sj, hj, rj = build(JPKG, use_native=False)
    st, ht, rt = build(TPKG, device="cpu")
    assert ht == hj and (rt.vertex_offset, rt.tri_offset) == (
        rj.vertex_offset, rj.tri_offset)
    a, b = sj.arena, st.arena
    assert (b.vertex_count, b.tri_count) == (a.vertex_count, a.tri_count)
    for name in ("_pos", "_nrm", "_uv", "_idx"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), name)
    mj, mt = JS.build_static_mapping(sj), TS.build_static_mapping(st)
    for f in dataclasses.fields(mt):
        np.testing.assert_array_equal(_np(getattr(mt, f.name)),
                                      _np(getattr(mj, f.name)), f.name)


def test_morton_matches_native():
    from paperrenderer_tpu import native

    assert native.AVAILABLE, "native/libscenecore.so did not load"
    rng = np.random.default_rng(5)
    p = np.concatenate([rng.uniform(-100, 100, (500, 3)),
                        rng.normal(size=(500, 3)) * 1e-3]).astype(np.float32)
    p[:7] = p[7]                               # duplicates
    p[-3:, 1] = 4.0                            # a flat axis among others
    want = native.morton3d(p, p.min(axis=0), p.max(axis=0))
    np.testing.assert_array_equal(TS._morton_u64(p), want)
    flat = np.zeros((9, 3), np.float32)        # zero extent on every axis
    np.testing.assert_array_equal(
        TS._morton_u64(flat), native.morton3d(flat, flat.min(0), flat.max(0)))


def test_import_leaves_jax_out():
    examples = ", ".join(
        f"paperrenderer_tpu_torch.examples.{m}" for m in (
            "render_scene", "render_rt", "render_hybrid", "render_crowd",
            "render_dynamic", "render_textured", "view_scene"))
    code = ("import sys, paperrenderer_tpu_torch, paperrenderer_tpu_torch.scenes, "
            "paperrenderer_tpu_torch.interop, paperrenderer_tpu_torch.native, "
            "paperrenderer_tpu_torch.io.gltf, paperrenderer_tpu_torch.viewer, "
            "paperrenderer_tpu_torch.parallel, "
            f"{examples}, chip_smoke; "
            "bad = [m for m in sys.modules if m in ('jax', 'PIL') or "
            "m.startswith(('jax.', 'PIL.', 'paperrenderer_tpu.')) "
            "or m == 'paperrenderer_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_model_instance_keywords():
    """``ModelInstance(model, unique_geometry=, anim_phase=)`` as the JAX
    package takes them: the phase is stored, and a unique-geometry
    (animated) instance is accepted (tests/test_torch_anim.py holds its
    BLAS and frames to the JAX package's)."""
    scene = TPKG.Scene(device="cpu")
    model = TPKG.Model.from_mesh(scene.arena, *TPKG.make_cube(size=1.0))
    inst = TPKG.ModelInstance(model, unique_geometry=False, anim_phase=0.25)
    ref = JPKG.ModelInstance(JPKG.Model.from_mesh(JPKG.Scene().arena,
                                            *JPKG.make_cube(size=1.0)),
                          anim_phase=0.25)
    assert inst.anim_phase == ref.anim_phase == 0.25
    assert inst.unique_geometry is ref.unique_geometry is False
    uniq = TPKG.ModelInstance(model, unique_geometry=True, anim_phase=0.5)
    ref = JPKG.ModelInstance(ref.model, unique_geometry=True, anim_phase=0.5)
    assert uniq.unique_geometry is ref.unique_geometry is True
    assert uniq.anim_phase == ref.anim_phase == 0.5


def test_engine_buffer_index():
    """``RenderEngine.buffer_index`` is frame % 2, as in the JAX package."""
    eng = TPKG.RenderEngine(device="cpu", device_check=False)
    ref = JPKG.RenderEngine(device_check=False)
    for _ in range(3):
        assert eng.buffer_index == ref.buffer_index == eng.frame_number % 2
        eng.end_frame()
        ref.end_frame()


# ===========================================================================
# Static raster ops
#
# Parity of the PyTorch port's raster ops with the JAX package.
#
# The JAX side runs its Pallas rasterizer in interpreter mode (as
# tests/test_raster_quarter.py does); the port runs the plain PyTorch version
# of its CUDA kernel, which is what a CPU tensor selects. Inputs are built in
# JAX from a seeded scene and carried across bit-identically through
# ``paperrenderer_tpu_torch.interop``.
#
# Tolerances:
#   * triangle_coefficients: rtol 1e-5 of each coefficient's condition scale
#     (see that test);
#   * rasterization on the SAME coefficient table: coverage differs on
#     <= 0.05% of pixels; where both cover, depth relative error <= 1e-6 and
#     tid is equal except at depth ties (each kernel breaks ties by its own
#     visiting order);
#   * rasterize_exact end to end (each package's own table): as above, with
#     depth relative error <= 5e-4 — XLA contracts the setup's products into
#     FMAs and the zn/wn rows cancel heavily near the far plane (measured max
#     2.4e-4 on this fixture, while each table's per-pixel evaluation agrees
#     with float64 to 1.3e-7);
#   * resolve / shade / tonemap: atol 1e-5 (with rtol 1e-5 for HDR values).
# ===========================================================================

RASTER_W = RASTER_H = 128


def _draw_batch(scene, cam):
    pre = JP.preprocess_instances(
        scene.flush(), scene.tables(), cam.matrices,
        max_meshes_per_lod=scene.max_meshes_per_lod)
    return JR.build_triangle_batch(pre, scene.geometry(), cam.matrices,
                                   capacity=4096)


def _twelve_instances(near, far):
    """tests/test_raster_quarter.py's 12-instance scene and camera (with a
    choice of clip planes), with random material ids so that the resolve
    and shade tests see several materials."""
    scene = JC.Scene(use_native=False)
    sphere = JC.Model.from_mesh(
        scene.arena, *JC.make_uv_sphere(radius=1.0, rings=10, sectors=14))
    cube = JC.Model.from_mesh(scene.arena, *JC.make_cube())
    rng = np.random.default_rng(7)
    for i in range(12):
        inst = JC.ModelInstance(sphere if i % 2 == 0 else cube)
        s = float(rng.uniform(0.3, 1.2))
        inst.set_transform(pos=rng.uniform(-4, 4, 3).tolist(),
                           scale=(s, s, s))
        scene.add_instance(inst)
    cam = JC.Camera(yfov_deg=60.0, aspect=1.0, near=near, far=far)
    cam.look_at((0.0, -9.0, 2.0), (0.0, 0.0, 0.0), up=(0, 0, 1))
    batch = _draw_batch(scene, cam)
    mats = np.random.default_rng(8).integers(0, 4, batch.capacity)
    return dataclasses.replace(batch, material=mats.astype(np.int32)), cam


@pytest.fixture(scope="module")
def batch_and_cam():
    return _twelve_instances(0.05, 100.0)


@pytest.fixture(scope="module")
def jax_raster(batch_and_cam):
    """JAX rasterize_exact (Pallas kernel, interpreter mode) on the fixture."""
    batch, _ = batch_and_cam
    old, JRE.INTERPRET = JRE.INTERPRET, True
    try:
        d, t, table, _ = JRE.rasterize_exact(batch, RASTER_W, RASTER_H,
                                             overflow_cond=False)
        return np.asarray(d), np.asarray(t), np.asarray(table)
    finally:
        JRE.INTERPRET = old


def test_triangle_coefficients_match(batch_and_cam):
    """Coefficients agree to rtol 1e-5 of each coefficient's CONDITION
    scale: the magnitude of the products that cancel in it (|p||q| for an
    edge row cross(p, q); sum |z_i||e_i| for a depth row). XLA contracts the
    setup's multiply-subtracts into FMAs and PyTorch does not, so a
    cancelling coefficient can differ by a few ulps of those products.
    Depth rows carry a per-triangle power-of-two scale that may differ by 2x
    between the two (both exact), so they are compared normalized."""
    batch, _ = batch_and_cam
    cj, okj, (loj, hij) = JR.triangle_coefficients(batch, RASTER_W, RASTER_H)
    ct, okt, (lot, hit) = TR.triangle_coefficients(
        _port("TriangleBatch", batch), RASTER_W, RASTER_H)
    cj, ct, okj, okt = _np(cj), _np(ct), _np(okj), _np(okt)
    np.testing.assert_array_equal(_np(lot), _np(loj))
    np.testing.assert_array_equal(_np(hit), _np(hij))

    clip = np.asarray(batch.clip).astype(np.float64)
    w = clip[..., 3]
    v = np.stack([(clip[..., 0] * 0.5 + w * 0.5) * RASTER_W,
                  (w * 0.5 - clip[..., 1] * 0.5) * RASTER_H, w], axis=-1)
    vn = np.linalg.norm(v, axis=-1)                           # [T, 3]
    e64 = np.stack([np.cross(v[:, 1], v[:, 2]), np.cross(v[:, 2], v[:, 0]),
                    np.cross(v[:, 0], v[:, 1])], axis=1)      # [T, 3, 3]
    det64 = np.einsum("ti,ti->t", v[:, 0], e64[:, 0])
    # Degenerate triangles (|det| at the f32 rounding level) may be rejected
    # by the port where XLA's FMA rounding leaves a tiny nonzero det; they
    # cover no pixel centre either way. All others must agree.
    live = np.asarray(batch.valid) & (np.abs(det64) > 1e-6 * vn.prod(axis=1))
    assert live.sum() > 500
    np.testing.assert_array_equal(okt[live], okj[live])
    both = live & okj

    escale = np.stack([vn[:, 1] * vn[:, 2], vn[:, 2] * vn[:, 0],
                       vn[:, 0] * vn[:, 1]], axis=1)[both]    # [B, 3 edges]
    for i in range(3):
        err = np.abs(ct[both, i] - cj[both, i])
        assert (err <= 1e-5 * escale[:, i, None]).all(), i
    depth_rows = ((3, clip[both, :, 2]), (4, w[both]))
    m64 = np.max([np.abs(np.einsum("tk,tkc->tc", vals, e64[both])).max(-1)
                  for _, vals in depth_rows], axis=0)
    m = lambda c: np.maximum(np.abs(c[:, 3]).max(-1), np.abs(c[:, 4]).max(-1))
    mt, mj = m(ct[both])[:, None], m(cj[both])[:, None]
    for i, vals in depth_rows:
        scale = (np.abs(vals) * escale).sum(axis=1) / m64     # normalized
        err = np.abs(ct[both, i] / mt - cj[both, i] / mj)
        assert (err <= 1e-5 * scale[:, None]).all(), i


def _compare_raster(dj, tj, dt, tt, depth_rtol):
    dj, tj, dt, tt = _np(dj), _np(tj), _np(dt), _np(tt)
    cov_j, cov_t = tj >= 0, tt >= 0
    assert cov_j.any(), "fixture renders nothing"
    assert (cov_j != cov_t).mean() <= 5e-4
    assert np.isinf(dt[~cov_t]).all()
    both = cov_j & cov_t
    rel = np.abs(dt[both] - dj[both]) / np.abs(dj[both])
    assert rel.max() <= depth_rtol, rel.max()
    # tid may differ only where the two winners' depths tie
    mism = both & (tj != tt)
    assert (np.abs(dt[mism] - dj[mism]) <= depth_rtol * np.abs(dj[mism])).all()


def test_rasterize_exact_matches_jax(batch_and_cam, jax_raster):
    batch, _ = batch_and_cam
    dj, tj, table_j = jax_raster
    dt, tt, table_t, req = TRE.rasterize_exact(_port("TriangleBatch", batch),
                                               RASTER_W, RASTER_H)
    _compare_raster(dj, tj, dt, tt, depth_rtol=5e-4)
    assert req > 0
    # same table layout: normals, uvs and materials are copies (column 15
    # is padding; ids come from the row index)
    table_t = _np(table_t)
    assert table_t.shape == table_j.shape
    np.testing.assert_array_equal(table_t[:, 16:], table_j[:, 16:])


def test_rasterize_bins_on_jax_table(batch_and_cam, jax_raster):
    """Binning + the kernel's plain version fed the JAX package's own
    coefficient table: the per-pixel rule alone is compared."""
    batch, _ = batch_and_cam
    dj, tj, table_j = jax_raster
    _, ok, (lo, hi) = JR.triangle_coefficients(batch, RASTER_W, RASTER_H)
    table = torch.from_numpy(table_j.copy())
    cell_start, cell_groups, n_pairs = TRE.bin_groups(
        torch.from_numpy(np.array(ok)), torch.from_numpy(np.array(lo)),
        torch.from_numpy(np.array(hi)), table.shape[0], RASTER_W, RASTER_H)
    assert n_pairs == cell_groups.shape[0] > 0
    # every cell's list ascends (the tie-break order)
    g = _np(cell_groups).astype(np.int64)
    list_start = np.zeros(len(g) + 1, bool)
    list_start[_np(cell_start)] = True
    assert ((np.diff(g) > 0) | list_start[1:-1]).all()
    dt, tt = TRE.rasterize_bins(cell_start, cell_groups,
                                table[:, :16].contiguous(), RASTER_W, RASTER_H)
    _compare_raster(dj, tj, dt, tt, depth_rtol=1e-6)


def test_crossz_big_world_scale(monkeypatch):
    """km-scale world: without the power-of-two depth-row normalization the
    cross-multiplied compare overflows f32 (tests/test_raster_quarter.py's
    case). The JAX divide-scheme kernel pins the expected result; far cubes
    come first, so a broken compare would keep them."""
    monkeypatch.setattr(JRE, "INTERPRET", True)
    S = 50000.0
    scene = JC.Scene(use_native=False)
    cube = JC.Model.from_mesh(scene.arena, *JC.make_cube())
    for k in range(6):
        inst = JC.ModelInstance(cube)
        inst.set_transform(pos=(0.0, (5 - k) * 2.0 * S, 0.0),
                           scale=(1.5 * S, 1.5 * S, 1.5 * S))
        scene.add_instance(inst)
    cam = JC.Camera(yfov_deg=60.0, aspect=1.0, near=0.05 * S, far=100.0 * S)
    cam.look_at((0.0, -9.0 * S, 2.0 * S), (0.0, 0.0, 0.0), up=(0, 0, 1))
    batch = _draw_batch(scene, cam)
    d_d, t_d, _, _ = JRE.rasterize_exact(batch, RASTER_W, RASTER_H, quarter=True,
                                         crossz=False, overflow_cond=False)
    d_x, t_x, _, _ = TRE.rasterize_exact(_port("TriangleBatch", batch),
                                         RASTER_W, RASTER_H)
    # the divide scheme quantizes depth to ~2^-16, inside the setup tolerance
    _compare_raster(d_d, t_d, d_x, t_x, depth_rtol=5e-4)


def test_watertight_sphere():
    """A closed sphere rendered front faces only (back faces culled) leaves
    no hole inside its silhouette: shared edges are exact negations, so a
    pixel centre on an edge is always claimed by one of the two triangles.
    The silhouette is the two-sided render, eroded by one pixel."""
    scene = JC.Scene(use_native=False)
    sphere = JC.Model.from_mesh(
        scene.arena, *JC.make_uv_sphere(radius=1.0, rings=40, sectors=56))
    inst = JC.ModelInstance(sphere)
    inst.set_transform(pos=(0.1, 0.2, -0.05), quat=(0.9, 0.3, 0.2, 0.1))
    scene.add_instance(inst)
    cam = JC.Camera(yfov_deg=40.0, aspect=1.0, near=0.1, far=50.0)
    cam.look_at((0.3, -3.5, 0.7), (0.0, 0.0, 0.0), up=(0, 0, 1))
    tb = _port("TriangleBatch", _draw_batch(scene, cam))
    n = tb.capacity
    two_sided = dataclasses.replace(tb, cull=torch.zeros(n, dtype=torch.bool))
    front = dataclasses.replace(tb, cull=torch.ones(n, dtype=torch.bool))
    _, t_all, _, _ = TRE.rasterize_exact(two_sided, RASTER_W, RASTER_H)
    _, t_front, _, _ = TRE.rasterize_exact(front, RASTER_W, RASTER_H)
    sil = _np(t_all) >= 0
    inner = sil.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            inner &= np.roll(np.roll(sil, dy, 0), dx, 1)
    assert inner.sum() > 2000
    holes = inner & (_np(t_front) < 0)
    assert not holes.any(), f"{holes.sum()} uncovered pixels inside"


@pytest.fixture(scope="module")
def materials_and_lights():
    reg = JC.MaterialRegistry()
    for a, e, r, m in [((0.9, 0.1, 0.1), (0, 0, 0), 0.35, 0.0),
                       ((1.0, 0.77, 0.34), (0, 0, 0), 0.3, 1.0),
                       ((0.1, 0.1, 0.1), (2.0, 1.2, 0.2), 0.5, 0.0)]:
        reg.register(JC.Material(albedo=a, emissive=e, roughness=r,
                                 metallic=m))
    lights = JSH.Lights.make(
        [{"position": (4.0, -4.0, 6.0), "color": (120.0, 115.0, 100.0),
          "bounds": 60.0, "radius": 0.3},
         {"position": (-5.0, -2.0, 3.0), "color": (25.0, 35.0, 60.0),
          "bounds": 40.0}],
        ambient=(0.6, 0.7, 1.0, 0.08))
    return reg.table(), lights


def test_resolve_and_shade_match(materials_and_lights):
    """Both resolves + shades on the same (depth, tid, table) — the port's
    raster output. The camera's clip planes are near=1, far=40:
    unprojecting depth through an f32 inverse(view_proj) amplifies 1-ulp
    differences between the two frameworks' 4x4 inverses by about
    far/near (at near=0.05, far=100 world positions differ by ~1e-4)."""
    batch, cam = _twelve_instances(1.0, 40.0)
    cam_t = _port("CameraMatrices", cam.matrices)
    depth, tid, attr, _ = TRE.rasterize_exact(_port("TriangleBatch", batch),
                                              RASTER_W, RASTER_H)
    table_j, lights_j = materials_and_lights
    gj = JRE.resolve_gbuffer_pairs(_np(attr), _np(depth), _np(tid), cam.matrices)
    gt = TRE.resolve_gbuffer_pairs(attr, depth, tid, cam_t)
    for f in dataclasses.fields(gj):
        np.testing.assert_allclose(_np(getattr(gt, f.name)),
                                   _np(getattr(gj, f.name)),
                                   rtol=0, atol=1e-5, err_msg=f.name)
    assert len(np.unique(_np(gt.material))) >= 3
    hj = JSH.shade_gbuffer(gj, table_j, lights_j, cam.matrices.cam_pos)
    ht = TSH.shade_gbuffer(
        gt, _port("MaterialTable", table_j), _port("Lights", lights_j),
        cam_t.cam_pos)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("params", [
    {},
    dict(exposure=1.7, wb_temp=0.3, wb_tint=-0.2, contrast=1.2,
         brightness=0.05, saturation=0.7, gamma=1.0 / 2.2,
         color_filter=(1.0, 0.9, 0.8)),
])
def test_tonemap_matches(params):
    rng = np.random.default_rng(21)
    hdr = (rng.gamma(0.6, 1.5, (64, 48, 3)) * (rng.random((64, 48, 1)) < 0.9)
           ).astype(np.float32)
    pj = dataclasses.replace(JTM.TonemapParams.default(), **{
        k: np.asarray(v, np.float32) for k, v in params.items()})
    want = JTM.tonemap(hdr, pj)
    got = TTM.tonemap(torch.from_numpy(hdr), _port("TonemapParams", pj))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


# ===========================================================================
# Static raster frame
#
# The PyTorch port's static raster frame end to end, on the CPU.
#
# ``RenderPass.render`` of the port's scenes is held to the pinned goldens
# with tests/test_golden_images.py's bands (mean |diff| <= 0.004 and at most
# 0.2% of pixels off by > 0.06; the goldens come from the JAX package's XLA
# path, so an exact match is not expected), and to the JAX package's own
# render of the same scene (mean |diff| <= 0.004).
# ===========================================================================

GOLDENS = sorted(f[:-4] for f in os.listdir(GOLDEN_DIR) if f.endswith(".png"))


def _golden(name):
    return read_image(os.path.join(GOLDEN_DIR, f"{name}.png")).astype(np.float32) / 255.0


def test_example_scene_golden_and_jax():
    from examples.render_scene import build_example_scene as build_jax

    rp, cam = build_example_scene(128, 128, device="cpu")
    ldr, aux = rp.render(cam)
    assert ldr.shape == (128, 128, 3) and torch.isfinite(ldr).all()
    _bands(ldr.numpy(), _golden("raster_example"))
    rpj, camj = build_jax(128, 128)
    ldr_j, aux_j = rpj.render(camj)
    assert np.abs(ldr.numpy() - np.asarray(ldr_j)).max(axis=-1).mean() <= 0.004
    assert int(aux["visible_count"]) == int(aux_j["visible_count"]) == 5
    assert int(aux["total_tris"]) == int(aux_j["total_tris"])
    assert abs(float(aux["coverage"]) - float(aux_j["coverage"])) <= 1e-3


def test_dynamic_scene_reduced_matches_jax():
    """Config 2's scene at 400 instances and 256x128 (the full size is
    10k instances at 1920x1080, run on the card by chip_smoke.py)."""
    from examples.render_dynamic import build_dynamic_scene as build_jax

    _, rp, cam = build_dynamic_scene(400, 256, 128, device="cpu")
    ldr, aux = rp.render(cam)
    _, rpj, camj = build_jax(400, 256, 128)
    ldr_j, aux_j = rpj.render(camj)
    _bands(ldr.numpy(), np.asarray(ldr_j))
    assert int(aux["visible_count"]) == int(aux_j["visible_count"])
    assert int(aux["total_tris"]) == int(aux_j["total_tris"])
    assert float(aux["coverage"]) > 0


def test_demand_jump_renders_complete():
    """Pair buffers are sized from each frame's own demand: a camera move
    that multiplies the demand renders the very next frame complete — the
    same image as a fresh pass that never saw the far camera."""
    def scene():
        # three cubes: few groups, so the demand follows their screen size
        rp = RenderPass(Scene(device="cpu"), MaterialRegistry(), width=128, height=128)
        cube = Model.from_mesh(rp.scene.arena, *make_cube(1.0))
        for k in range(3):
            inst = ModelInstance(cube)
            inst.set_transform(pos=(1.2 * k - 1.2, 0.0, 0.5))
            rp.add_instance(inst, {0: Material(str(k)).instance()})
        return rp, Camera(yfov_deg=60.0, near=0.1, far=500.0)

    near_eye = ((0.0, -2.5, 1.5), (0.0, 0.0, 0.5))
    rp, cam = scene()
    cam.look_at((0.0, -80.0, 40.0), (0.0, 0.0, 0.5))
    _, far = rp.render(cam)
    cam.look_at(*near_eye)
    ldr, near = rp.render(cam)
    assert near["required_work"] >= 4 * far["required_work"]
    rp2, cam2 = scene()
    cam2.look_at(*near_eye)
    ldr2, fresh = rp2.render(cam2)
    assert fresh["required_work"] == near["required_work"]
    torch.testing.assert_close(ldr, ldr2, rtol=0, atol=0)


def test_render_after_topology_and_transform_change():
    """Adding an instance bumps the scene version and rebuilds the static
    mapping; moving one re-uploads only its row. Both show in the frame."""
    rp, cam = build_example_scene(64, 64, device="cpu")
    _, a0 = rp.render(cam)
    cube = Model.from_mesh(rp.scene.arena, *make_cube(1.0))
    inst = ModelInstance(cube)
    inst.set_transform(pos=(0.0, -3.0, 1.0))
    rp.add_instance(inst, {0: Material("m", albedo=(0.2, 0.9, 0.2)).instance()})
    _, a1 = rp.render(cam)
    assert int(a1["total_tris"]) == int(a0["total_tris"]) + 12
    inst.set_transform(pos=(0.0, -30.0, 1.0))    # behind the camera
    _, a2 = rp.render(cam)
    assert int(a2["visible_count"]) == int(a1["visible_count"]) - 1


def test_textured_registry_matches_jax():
    """Registering textured materials gives the JAX package's texture-id
    columns and atlas (tests/test_texture.py::test_textured_material_table_ids):
    one image as a baseColor (sRGB) and a metallicRoughness (linear)
    texture is two atlas entries; an untextured row keeps -1."""
    img = np.zeros((4, 4, 3), np.uint8)
    occ = np.full((2, 8), 0.5, np.float32)
    tables, atlases = [], []
    for pkg in (JC, TC):
        reg = pkg.MaterialRegistry()
        reg.register(pkg.Material("plain"))
        m = pkg.Material("x", base_texture=img, mr_texture=img,
                         occlusion_texture=occ)
        reg.register(m)
        reg.register(pkg.Material("e", emissive_texture=img))
        table = reg.table(**({} if pkg is JC else {"device": "cpu"}))
        tables.append({c: _np(getattr(table, c)) for c in (
            "base_tex", "emissive_tex", "mr_tex", "occ_tex")})
        atlases.append(reg.texture_arrays(*(() if pkg is JC else ("cpu",))))
        row = reg._ids[id(m)]
        assert tables[-1]["base_tex"][row] != tables[-1]["mr_tex"][row]
        assert reg.textures.count == 3 and reg.has_textures
    for c in tables[0]:
        assert np.array_equal(tables[1][c], tables[0][c]), c
    assert list(tables[1]["base_tex"]) == [-1, -1, 0, -1]
    assert np.array_equal(_np(atlases[1].pairs), _np(atlases[0].pairs))
    assert MaterialRegistry().texture_arrays("cpu") is None


def test_supersample_draw_list_path():
    """The draw-list frame renders, and supersample applies on it too
    (tests/test_raster.py::test_supersample_draw_list_path): a rotated cube
    at 64x64, once plain and once at supersample=2, gives frames of the same
    shape and mean brightness whose edges differ."""
    def build(ss):
        rp = RenderPass(Scene(device="cpu"), MaterialRegistry(), width=64,
                        height=64, supersample=ss)
        cube = Model.from_mesh(rp.scene.arena, *make_cube(size=1.4))
        inst = ModelInstance(cube)
        inst.set_transform(quat=(0.92, 0.2, 0.3, 0.1))
        rp.add_instance(inst, {0: Material(
            f"d{ss}", albedo=(0.8, 0.2, 0.2)).instance()})
        cam = Camera(yfov_deg=60.0, aspect=1.0, near=0.1, far=100.0)
        cam.look_at((0.0, -3.0, 0.0), (0.0, 0.0, 0.0), up=(0, 0, 1))
        ldr, aux = rp.render(cam, static_path=False)
        return ldr.numpy(), aux

    img1, aux1 = build(1)
    img2, aux2 = build(2)
    assert img2.shape == img1.shape == (64, 64, 3)
    assert aux2["depth"].shape == aux1["depth"].shape == (64, 64)
    assert int(aux1["draw_count"]) == int(aux2["draw_count"]) == 1
    assert 0.1 < float(aux1["coverage"]) < 0.9
    assert abs(img2.mean() - img1.mean()) < 0.01
    assert (np.abs(img2 - img1).max(axis=-1) > 0.05).any()


def test_supersample_is_box_filtered_frame():
    """supersample=2 at 32x32 is the 64x64 frame's HDR box-filtered in 2x2
    cells (strided slices summed in row-major order, then halved twice)."""
    rp, cam = build_example_scene(64, 64, device="cpu")
    _, big = rp.render(cam)
    rp.resize(32, 32)
    rp.supersample = 2
    ldr, aux = rp.render(cam)
    h = big["hdr"]
    want = (h[0::2, 0::2] + h[0::2, 1::2] + h[1::2, 0::2] + h[1::2, 1::2]) * 0.25
    torch.testing.assert_close(aux["hdr"], want, rtol=0, atol=0)
    torch.testing.assert_close(aux["depth"], big["depth"][::2, ::2], rtol=0, atol=0)
    assert ldr.shape == (32, 32, 3) and torch.isfinite(ldr).all()


def test_translucent_layers_render():
    """The example scene's sphere rebound to a 50% red glass: the opaque
    pass leaves its triangles out, two peel layers blend it back in (a
    closed mesh with no culling gives two layers), and only pixels the
    sphere covers change."""
    rp, cam = build_example_scene(64, 64, device="cpu")
    ldr0, aux0 = rp.render(cam)
    sphere = rp.scene.instances[1]
    rp.add_instance(sphere, {0: Material(
        "glass", albedo=(0.9, 0.1, 0.1), alpha=0.5,
        shading_model=SHADE_TRANSLUCENT).instance()})
    rp.translucent_layers = 2
    ldr, aux = rp.render(cam)
    assert torch.isfinite(ldr).all()
    assert int(aux["total_tris"]) < int(aux0["total_tris"])
    changed = (ldr - ldr0).abs().amax(dim=-1) > 1e-3
    assert 0.01 < float(changed.float().mean()) < 0.5


def test_translucent_grid_renders():
    """build_translucent_grid at 400 instances and 128x64 (the card runs
    10k at 1920x1080): the glass and leaf instances leave the opaque pass,
    and the peeled layers change part of the frame."""
    _, rp, cam = build_translucent_grid(400, 128, 64, device="cpu")
    ldr, aux = rp.render(cam)
    _, rp0, cam0 = build_dynamic_scene(400, 128, 64, device="cpu")
    ldr0, aux0 = rp0.render(cam0)
    assert torch.isfinite(ldr).all()
    assert int(aux["total_tris"]) < int(aux0["total_tris"])
    changed = (ldr - ldr0).abs().amax(dim=-1) > 1e-3
    covered = float(aux0["coverage"]) * 128 * 64
    assert 0.1 * covered < int(changed.sum()) < 0.9 * covered


@pytest.mark.parametrize("name", GOLDENS)
def test_png_reader_matches_jax_reader(name, tmp_path):
    """The port's zlib PNG codec reads every golden as the JAX package's
    PIL-based reader does, and round-trips through write_png."""
    from paperrenderer_tpu.io.image import read_image as read_pil

    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    img = read_image(path)
    np.testing.assert_array_equal(img, read_pil(path))
    out = tmp_path / "rt.png"
    write_png(str(out), img)
    np.testing.assert_array_equal(read_image(str(out)), img)
    np.testing.assert_array_equal(read_pil(str(out)), img)


# ===========================================================================
# Keyed raster, leaf cutout, translucency, supersampling
#
# Parity of the port's keyed raster, leaf cutout, sorted translucency and
# supersampling with the JAX package, on the CPU.
#
# The JAX side runs its Pallas rasterizer in interpreter mode (as
# tests/test_raster_quarter.py does); the port runs the plain PyTorch version
# of its CUDA kernels, which is what a CPU tensor selects. The triangles,
# materials, opaque image and camera are made from a numpy seed and handed to
# both packages, to the port through ``paperrenderer_tpu_torch.interop``.
#
# Tolerances:
#   * the keyed rasterizers (K3: ``crossz=False``, K4: ``quarter=False``, K2
#     and K4's peel form: a peel window) fed the JAX package's own coefficient
#     table: the same
#     coverage, the same depth (it is the key), and tid equal except where
#     keys tie (each kernel breaks ties by its own visiting order);
#   * end to end (each package's own table): the static raster ops section's
#     bands, coverage differing on <= 0.05% of pixels and depth within 5e-4
#     relative (XLA contracts the setup's products into FMAs);
#   * ``leaf_alpha``: equal;
#   * ``composite_translucency`` against the JAX exact peel: atol 2e-3, the
#     tolerance of tests/test_translucency.py;
#   * RenderPass frames of tests/test_translucency.py and tests/test_leaf.py
#     against the JAX package's (whose CPU frame runs the XLA rasterizer and
#     the XLA peel): mean |diff| <= 0.004 with <= 0.2% of pixels off by
#     > 0.06, the golden bands; supersample=2 against
#     tests/goldens/raster_supersample2.png with the same bands.
# ===========================================================================

def _keys(depth):
    return _np(depth).view(np.int32) & np.int32(TRE.KEY_MASK)


@pytest.fixture(scope="module")
def peel_triangles():
    """N_TRI seeded clip-space triangles scattered over the 128x64 view
    (about 7 px across, half the pixels covered, two-sided), with unit normals,
    uvs in [0, 1] and material ids 0..3, as a JAX TriangleBatch."""
    rng = np.random.default_rng(11)
    centre = rng.uniform(-1.1, 1.1, (N_TRI, 1, 2))
    ndc_xy = centre + rng.normal(0.0, 0.12, (N_TRI, 3, 2))
    ndc_z = rng.uniform(0.2, 0.95, (N_TRI, 1)) + rng.normal(0.0, 0.02, (N_TRI, 3))
    w = rng.uniform(1.0, 4.0, (N_TRI, 3))
    clip = np.concatenate(
        [ndc_xy * w[..., None], (ndc_z * w)[..., None], w[..., None]], axis=-1)
    normal = rng.normal(size=(N_TRI, 3, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return JR.TriangleBatch(
        clip=f32(clip), world=f32(rng.normal(size=(N_TRI, 3, 3))),
        normal=f32(normal), uv=f32(rng.uniform(0.0, 1.0, (N_TRI, 3, 2))),
        material=jnp.asarray(rng.integers(0, 4, N_TRI), jnp.int32),
        valid=jnp.asarray(rng.random(N_TRI) < 0.95))


# pair-slot capacity of the JAX calls: this frame's demand (1232 quarter
# slots, 368 classic pairs; each call asserts it fits) rounded up
CAPACITY = {True: 1280, False: 512}


def _materials():
    """An opaque panel, two translucent glasses (alpha 0.5 and 0.7) and a
    leaf, as a JAX MaterialTable."""
    reg = JC.MaterialRegistry()
    for m in (JC.Material("white", albedo=(0.9, 0.9, 0.9), roughness=0.8),
              JC.Material("red-glass", albedo=(0.2, 0.0, 0.0),
                         emissive=(1.0, 0.0, 0.0), alpha=0.5,
                         shading_model=JC.SHADE_TRANSLUCENT),
              JC.Material("green-glass", albedo=(0.0, 0.3, 0.0),
                         emissive=(0.0, 0.8, 0.2), alpha=0.7,
                         shading_model=JC.SHADE_TRANSLUCENT),
              JC.Material("leaf", albedo=(0.2, 0.6, 0.1),
                         shading_model=JC.SHADE_LEAF)):
        reg.register(m)
    return reg.table()


@pytest.fixture(scope="module")
def jax_keyed(peel_triangles):
    """The JAX package's keyed rasterizers in interpreter mode at 128x64:
    rasterize_exact with ``crossz=False`` (K3) and ``quarter=False`` (K4),
    and the exact peel of composite_translucency, two layers of K2 over a
    seeded opaque image and depth (a quarter of the pixels empty). Every
    call runs at the fixed capacity above, without the in-graph 4x overflow
    branch (the capacity covers the demand, so that branch never runs;
    compiling it in the interpreter costs ~15 s), and each kernel form is
    jitted once (an eager call lowers the interpreted kernel anew, ~4 s).
    Each K2 layer's batch, window and outputs are recorded for the
    per-layer comparison."""
    rng = np.random.default_rng(12)
    hdr = rng.uniform(0.0, 2.0, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.25] = np.inf
    cam = JC.Camera(yfov_deg=60.0, aspect=W / H, near=0.1, far=100.0)
    cam.look_at((0.0, -6.0, 2.0), (0.0, 0.0, 0.5), up=(0, 0, 1))
    lights = JSH.Lights.make(
        [{"position": (3.0, -4.0, 5.0), "color": (40.0, 40.0, 40.0),
          "bounds": 100.0}])
    inputs = dict(hdr=hdr, depth=depth, camera=cam.matrices,
                  materials=_materials(), lights=lights)
    out, layers, jitted = {}, [], {}
    rasterize_exact, interpret = JRE.rasterize_exact, JRE.INTERPRET

    def run(batch, width, height, quarter=True, crossz=None, depth_window=None,
            **_):
        # one jit per kernel form: both K2 layers share one compile
        form = (width, height, quarter, crossz, depth_window is not None)
        if form not in jitted:
            jitted[form] = jax.jit(lambda b, win: rasterize_exact(
                b, width, height, quarter=quarter, crossz=crossz,
                depth_window=win, overflow_cond=False,
                pair_capacity=CAPACITY[quarter]))
        res = jitted[form](batch, depth_window)
        assert int(res[3]) <= CAPACITY[quarter]
        if depth_window is not None:
            layers.append((batch, tuple(np.asarray(p) for p in depth_window),
                           tuple(np.asarray(v) for v in res[:3])))
        return res

    JRE.INTERPRET, JRE.rasterize_exact = True, run
    try:
        for case, kw in (("k3", dict(crossz=False)), ("k4", dict(quarter=False))):
            out[case] = (peel_triangles, None, tuple(
                np.asarray(v) for v in run(peel_triangles, W, H, **kw)[:3]))
        composite, _ = JTL.composite_translucency(
            jnp.asarray(hdr), jnp.asarray(depth), peel_triangles,
            inputs["materials"], lights, cam.matrices, layers=2,
            use_exact=True)
    finally:
        JRE.INTERPRET, JRE.rasterize_exact = interpret, rasterize_exact
    out.update({f"k2_layer{i}": layer for i, layer in enumerate(layers)})
    return out, np.asarray(composite), inputs


def _key_at(table, tid, x, y):
    """Triangle ``tid``'s depth key at pixel (x, y), every product and sum
    rounded on its own in f32 (the port's and the CUDA kernels' rule)."""
    r = table[tid].astype(np.float32)
    px, py = np.float32(x + 0.5), np.float32(y + 0.5)
    plane = lambda i: np.float32(np.float32(r[i] * px) + np.float32(r[i + 1] * py)) \
        + r[i + 2]
    return np.float32(plane(9) / plane(12)).view(np.int32) & np.int32(TRE.KEY_MASK)


@pytest.mark.parametrize("case", ["k2_layer0", "k2_layer1", "k3", "k4",
                                  "k4_peel"])
def test_keyed_on_jax_table(case, jax_keyed):
    """Binning + the keyed plain version on the JAX package's coefficient
    table: the per-pixel rule alone, compared key for key. The JAX
    interpreter's XLA contracts the plane evaluations into FMAs and the port
    (like its CUDA kernels) rounds each product: that moves a quotient
    across a key bucket on a few pixels (here 0 and 1 of 8192 for K3 and
    K4, one bucket); <= 0.1% of pixels may differ, K2's windows included.
    ``k4_peel`` is K4's peel form (8x128 cells) held to the JAX package's
    first K2 layer: the same window gives the same keys."""
    batch, window, (dj, tj, table_j) = jax_keyed[0][
        "k2_layer0" if case == "k4_peel" else case]
    _, ok, (lo, hi) = JR.triangle_coefficients(batch, W, H)
    cell_w = TRE.TILE_W if case.startswith("k4") else TRE.CELL_W
    cell_start, cell_groups, _ = TRE.bin_groups(
        torch.from_numpy(np.array(ok)), torch.from_numpy(np.array(lo)),
        torch.from_numpy(np.array(hi)), table_j.shape[0], W, H, cell_w=cell_w)
    win = None if window is None else tuple(torch.from_numpy(p.copy()) for p in window)
    dt, tt = TRE.rasterize_bins(
        cell_start, cell_groups, torch.from_numpy(table_j[:, :16].copy()),
        W, H, cell_w=cell_w, keyed=True, window=win)
    dt, tt = _np(dt), _np(tt)
    cov = tj >= 0
    assert cov.mean() > {"k2_layer0": 0.1, "k2_layer1": 0.02,
                         "k4_peel": 0.1}.get(case, 0.4)
    assert np.isinf(dt[tt < 0]).all()
    # depth IS the key; a one-bucket step where the rounding differs
    kd = dt.view(np.int32).astype(np.int64) - dj.view(np.int32)
    off = (kd != 0) | ((tt >= 0) != cov)
    assert off.mean() <= 1e-3, off.sum()
    if win is None:
        np.testing.assert_array_equal(tt >= 0, cov)
        assert (np.abs(kd[kd != 0]) == 128).all()
    else:
        # the window kept what it should: keys strictly inside it
        k, c = _keys(dt), tt >= 0
        assert ((k[c] > window[0][c]) & (k[c] < window[1][c])).all()
    # equal keys, different triangles: a tie, both at the winning key
    for y, x in zip(*np.nonzero((tj != tt) & ~off)):
        assert _key_at(table_j, tt[y, x], x, y) == _key_at(table_j, tj[y, x], x, y)


@pytest.mark.parametrize("case", ["k3", "k4"])
def test_keyed_end_to_end(case, peel_triangles, jax_keyed):
    """The port's rasterize_exact on its own coefficient table."""
    dj, tj, table_j = jax_keyed[0][case][2]
    opts = dict(crossz=False) if case == "k3" else dict(quarter=False)
    dt, tt, table_t, req = TRE.rasterize_exact(
        _port("TriangleBatch", peel_triangles), W, H, **opts)
    dt, tt = _np(dt), _np(tt)
    cov_j, cov_t = tj >= 0, tt >= 0
    assert (cov_j != cov_t).mean() <= 5e-4
    both = cov_j & cov_t
    rel = np.abs(dt[both] - dj[both]) / np.abs(dj[both])
    assert rel.max() <= 5e-4, rel.max()
    assert req > 0
    np.testing.assert_array_equal(_np(table_t)[:, 16:], table_j[:, 16:])


@pytest.mark.parametrize("source", ["extremes", "chain"])
def test_peel_window_open(peel_triangles, source):
    """``peel_window_open`` (by which K2 ends a warp whose windows are all
    closed) against a brute force, "the int32 keys strictly inside (floor,
    ceil)", ``range(floor + 1, ceil)`` in Python's integers: at the int32
    extremes that the frames' windows reach (INT32_MIN, -0.0's key; INT32_MIN
    + 1, the translucent pass's first floor; 0x7F800000, +inf's key;
    SENTINEL, config 2's ceilings), where int32 arithmetic overflows; and on
    the windows of a four-layer peel chain over the fixture's triangles (an
    opaque depth with +inf and -0.0 pixels as the ceiling, each layer's
    floor the previous layer's key, as composite_translucency chains them),
    where every pixel it calls closed gets -1 from rasterize_bins_plain."""
    i32 = np.iinfo(np.int32)
    if source == "extremes":
        neg0 = int(_keys(np.float32([-0.0]))[0])
        vals = [i32.min, i32.min + 1, i32.min + 2, -129, -128, -1, 0, 1, 127,
                128, 0x3F000000, 0x7F800000 - 128, 0x7F800000 - 1, 0x7F800000,
                0x7F800001, TRE.SENTINEL - 1, TRE.SENTINEL, neg0]
        assert neg0 == i32.min
        fl, ce = (torch.tensor(v, dtype=torch.int32)
                  for v in zip(*itertools.product(vals, vals)))
        want = torch.tensor([bool(range(f + 1, c)) for f, c
                             in itertools.product(vals, vals)])
        assert torch.equal(TRE.peel_window_open(fl, ce), want)
        # the int32 difference gets some of them wrong
        assert ((ce - fl > 1) != want).any()
        return
    rng = np.random.default_rng(13)
    opaque = rng.uniform(0.3, 1.0, (H, W)).astype(np.float32)
    opaque[rng.random((H, W)) < 0.25] = np.inf
    opaque[rng.random((H, W)) < 0.02] = -0.0
    b = TRE.bin_triangles(_port("TriangleBatch", peel_triangles), W, H)
    floor = torch.full((H, W), i32.min + 1, dtype=torch.int32)
    ceil = TRE.depth_to_key(torch.from_numpy(opaque))
    closed_counts = []
    for _ in range(4):
        d, t = TRE.rasterize_bins_plain(b.cell_start, b.cell_groups, b.coef,
                                        W, H, keyed=True, window=(floor, ceil))
        open_ = TRE.peel_window_open(floor, ceil)
        k = TRE.depth_to_key(d)
        brute = torch.tensor([bool(range(f + 1, c)) for f, c in zip(
            floor.flatten().tolist(), ceil.flatten().tolist())])
        assert torch.equal(open_.flatten(), brute)
        assert (t[~open_] == -1).all() and (t >= 0).any()
        assert ((k[t >= 0] > floor[t >= 0]) & (k[t >= 0] < ceil[t >= 0])).all()
        closed_counts.append(int((~open_).sum()))
        floor = k
    # -0.0 closes layer 1's windows; each layer closes those it left empty
    assert 0 < closed_counts[0] < closed_counts[1] <= closed_counts[3], \
        closed_counts


def test_leaf_alpha_matches():
    """tests/test_leaf.py's four uvs: lens centre, beyond the half-width,
    the u edge, and inside the narrower lens at u = 0.25."""
    uv = np.asarray([[0.5, 0.5], [0.5, 0.75], [0.0, 0.5], [0.25, 0.55]],
                    np.float32)
    want = np.asarray(JSH.leaf_alpha(jnp.asarray(uv)))
    got = _np(TSH.leaf_alpha(torch.from_numpy(uv)))
    assert want.tolist() == [1.0, 0.0, 0.0, 1.0]
    np.testing.assert_array_equal(got, want)


def test_composite_matches_jax_exact_peel(peel_triangles, jax_keyed):
    """Two peel layers and the back-to-front blend over the seeded opaque
    image: the JAX package's exact peel against the port's."""
    _, want, inp = jax_keyed
    got, req = TTL.composite_translucency(
        torch.from_numpy(inp["hdr"]), torch.from_numpy(inp["depth"]),
        _port("TriangleBatch", peel_triangles), _port("MaterialTable", inp["materials"]),
        _port("Lights", inp["lights"]), _port("CameraMatrices", inp["camera"]),
        layers=2)
    assert req > 0
    assert np.abs(_np(got) - inp["hdr"]).max() > 0.1      # the layers show
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-3)


def _panel_frames(pkg, case):
    """The frames of tests/test_translucency.py and tests/test_leaf.py, all
    at 32x32 with two layers, built through package ``pkg`` (J or T)."""
    kw = {} if pkg is JC else {"device": "cpu"}
    scene, reg = pkg.Scene(**kw), pkg.MaterialRegistry()
    panel = pkg.Model.from_mesh(scene.arena, *pkg.make_plane(size=2.0))
    rp = (JRenderPass if pkg is JC else RenderPass)(
        scene, reg, width=32, height=32, translucent_layers=2)
    mats = {
        "blend_over_opaque": [
            (0.0, pkg.Material("white", albedo=(1.0, 1.0, 1.0), roughness=1.0,
                               emissive=(0.5, 0.5, 0.5))),
            (1.0, pkg.Material("red-glass", albedo=(0.0, 0.0, 0.0),
                               emissive=(1.0, 0.0, 0.0), alpha=0.5,
                               shading_model=pkg.SHADE_TRANSLUCENT))],
        "behind_opaque_hidden": [
            (2.0, pkg.Material("white", emissive=(1, 1, 1))),
            (0.0, pkg.Material("glass", emissive=(1, 0, 0), alpha=0.9,
                               shading_model=pkg.SHADE_TRANSLUCENT))],
        "two_layers_red_top": [
            (0.0, pkg.Material("g", emissive=(0, 1, 0), alpha=0.6,
                               shading_model=pkg.SHADE_TRANSLUCENT)),
            (1.0, pkg.Material("r", emissive=(1, 0, 0), alpha=0.6,
                               shading_model=pkg.SHADE_TRANSLUCENT))],
        "leaf_cutout": [
            (1.0, pkg.Material("leaf", emissive=(0.0, 1.0, 0.0),
                               shading_model=pkg.SHADE_LEAF)),
            (0.0, pkg.Material("back", emissive=(1.0, 0.0, 0.0)))],
    }[case]
    for z, mat in mats:
        inst = pkg.ModelInstance(panel)
        if z:
            inst.set_transform(pos=(0.0, 0.0, z))
        rp.add_instance(inst, {0: mat.instance()})
    cam = pkg.Camera(yfov_deg=60.0, aspect=1.0, near=0.1, far=100.0)
    cam.look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0), up=(0, 1, 0))
    return rp.render(cam)


@pytest.mark.parametrize("case", ["blend_over_opaque", "behind_opaque_hidden",
                                  "two_layers_red_top", "leaf_cutout"])
def test_renderpass_frames_match_jax(case):
    ldr_t, aux_t = _panel_frames(TC, case)
    ldr_j, aux_j = _panel_frames(JC, case)
    assert ldr_t.shape == (32, 32, 3) and torch.isfinite(ldr_t).all()
    _bands(ldr_t, ldr_j)
    assert int(aux_t["total_tris"]) == int(aux_j["total_tris"])
    c = _np(ldr_t)[16, 16]
    if case == "blend_over_opaque":      # red glass over the lit panel
        assert c[0] > c[1] and c[0] > c[2] and c[1] > 0.02
    elif case == "behind_opaque_hidden":  # no red tint through the panel
        assert abs(float(c[0]) - float(c[1])) < 1e-3
    elif case == "two_layers_red_top":
        assert c[0] > c[1]
    else:                                 # leaf opaque at the lens centre,
        k = _np(ldr_t)[12, 16]            # cut out above it
        assert c[1] > c[0] and k[0] > k[1] and k[0] > 0.05


def test_supersample2_golden():
    """The example scene at supersample=2 against raster_supersample2.png."""
    rp, cam = build_example_scene(128, 128, device="cpu")
    rp.supersample = 2
    ldr, aux = rp.render(cam)
    golden = read_image(os.path.join(GOLDEN_DIR, "raster_supersample2.png"))
    _bands(ldr, golden.astype(np.float32) / 255.0)
    assert aux["depth"].shape == (128, 128)


# ===========================================================================
# Draw-list frame
#
# Parity of the port's draw-list raster frame with the JAX package, on the
# CPU: the preprocess pass, the triangle batch, the tile rasterizers K5/K6
# (their plain PyTorch versions, which a CPU tensor selects), the reference
# rasterizer, the G-buffer resolve and ``RenderPass.render(static_path=False)``;
# and ``ops.gather``, which the frames' shading reads materials through.
#
# Inputs are built in JAX from seeded scenes and carried across bit-identically
# through ``paperrenderer_tpu_torch.interop``. The JAX tile kernel runs in the
# Pallas interpreter (``pallas_call`` patched to ``interpret=True`` for the
# call), eagerly.
#
# Tolerances:
#   * preprocess: integer arrays equal, matrices within 1e-6 relative;
#   * triangle batch: clip, world and normal within 1e-6 of each vertex's
#     magnitude (XLA's einsums sum in their own order); uv, material, valid
#     equal;
#   * K5's plain version on the JAX package's own coefficient table: tid
#     equal; depth and bary are each package's rounding of the same winner's
#     rows. The interpreter's XLA contracts each plane evaluation into an FMA,
#     fma(px, c0, py * c1) + c2, while the port (like its CUDA kernel, built
#     with -fmad=false) rounds every product; the test recomputes both
#     roundings of the winner's rows in float64 numpy and holds each side to
#     its own bit for bit;
#   * end to end (each package's own table): depth within 5e-4 relative (the
#     setup's FMAs, as in the static raster ops section), coverage differing on
#     <= 0.1% of pixels, tid equal except where depths tie;
#   * K6's plain version: bitwise equal to K5's, sorted and presorted;
#     ``required`` equal to the JAX package's;
#   * ``tile_may_cover`` (the CUDA kernels' per-warp rejection, port only):
#     exact, no footprint it rejects holds a pixel that accepts the row;
#   * the reference rasterizer against the tile kernel on one batch: depth
#     equal except on stray sliver pixels, which the tile kernel culls by
#     chunk box and the reference does not (<= 1e-4 of the pixels);
#   * resolve: atol 1e-5; frames: the golden bands (mean |diff| <= 0.004,
#     <= 0.2% of pixels off by > 0.06).
# ===========================================================================

# -- preprocess and batch ----------------------------------------------------

@pytest.fixture(scope="module")
def lod_scene():
    """A JAX scene of 24 instances of two models: a three-LOD model whose
    finest LOD has two meshes in two material slots, and a one-mesh cube;
    spread from 2 to 60 units from the camera (so every LOD is picked) and
    partly out of view; per-instance slot materials and user visibility
    from a seed."""
    scene = JC.Scene(use_native=False)
    a = scene.arena
    hi = a.add_mesh(*JC.make_uv_sphere(radius=0.8, rings=8, sectors=10))
    cap = a.add_mesh(*JC.make_cube(size=0.5))
    mid = a.add_mesh(*JC.make_icosphere(radius=0.8, subdivisions=1))
    lo = a.add_mesh(*JC.make_cube(size=1.2))
    tiered = JC.Model(a, [[JC.MaterialMesh(hi, 0), JC.MaterialMesh(cap, 1)],
                         [JC.MaterialMesh(mid, 0)], [JC.MaterialMesh(lo, 1)]])
    cube = JC.Model.from_mesh(a, *JC.make_cube(size=1.0))
    rng = np.random.default_rng(21)
    for i in range(24):
        inst = JC.ModelInstance(tiered if i % 3 else cube)
        dist = 2.0 + 58.0 * (i / 23.0)
        inst.set_transform(pos=(float(rng.uniform(-1.2, 1.2) * dist), dist,
                                float(rng.uniform(-0.3, 0.3) * dist)),
                           quat=tuple(rng.normal(size=4)))
        scene.add_instance(inst)
    cam = JC.Camera(yfov_deg=50.0, aspect=2.0, near=0.1, far=200.0)
    cam.look_at((0.0, -2.0, 0.0), (0.0, 10.0, 0.0), up=(0, 0, 1))
    n = scene.flush().capacity
    slots = rng.integers(0, 6, (n, scene.max_slots)).astype(np.int32)
    visible = rng.random(n) < 0.85
    return scene, cam, slots, visible


def _preprocess_both(lod_scene, **kw):
    scene, cam, slots, visible = lod_scene
    pj = JP.preprocess_instances(
        scene.flush(), scene.tables(), cam.matrices,
        max_meshes_per_lod=scene.max_meshes_per_lod,
        instance_visible=visible, slot_materials=slots, **kw)
    pt = TP.preprocess_instances(
        _port("InstanceArrays", scene.flush()),
        _port("SceneTables", scene.tables()),
        _port("CameraMatrices", cam.matrices),
        max_meshes_per_lod=scene.max_meshes_per_lod,
        instance_visible=torch.from_numpy(visible),
        slot_materials=torch.from_numpy(slots), **kw)
    return pj, pt


@pytest.mark.parametrize("kw", [dict(), dict(do_culling=False),
                                dict(lod_override=1)],
                         ids=["cull", "no_cull", "lod_override"])
def test_preprocess_matches_jax(lod_scene, kw):
    pj, pt = _preprocess_both(lod_scene, **kw)
    for f in dataclasses.fields(pj):
        a, b = _np(getattr(pt, f.name)), np.asarray(getattr(pj, f.name))
        if f.name == "matrices":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    lod = np.asarray(pj.lod)[np.asarray(pj.visible)]
    if "lod_override" in kw:
        assert set(lod.tolist()) == {0, 1}     # the one-LOD cube stays at 0
    else:
        assert set(lod.tolist()) == {0, 1, 2}
    assert 0 < int(pj.draw_count) < np.asarray(pj.draw_instance).size


def test_mesh_group_instance_counts(lod_scene):
    pj, pt = _preprocess_both(lod_scene)
    m = int(np.asarray(lod_scene[0].tables().mesh_slot).shape[0])
    got = _np(TP.mesh_group_instance_counts(pt, m))
    np.testing.assert_array_equal(got, np.asarray(
        JP.mesh_group_instance_counts(pj, m)))
    assert got.sum() == int(pj.draw_count)


def test_build_triangle_batch_matches_jax(lod_scene):
    scene, cam = lod_scene[:2]
    pj, _ = _preprocess_both(lod_scene)
    cap = 2304
    bj = JR.build_triangle_batch(pj, scene.geometry(), cam.matrices,
                                 capacity=cap)
    bt = TR.build_triangle_batch(
        _port("PreprocessResult", pj), _port("GeometryArrays", scene.geometry()),
        _port("CameraMatrices", cam.matrices), capacity=cap)
    assert 0 < int(pj.total_tris) < cap
    for name in ("clip", "world", "normal"):
        a, b = _np(getattr(bt, name)), np.asarray(getattr(bj, name))
        scale = np.linalg.norm(b, axis=-1, keepdims=True) + 1e-30
        assert (np.abs(a - b) <= 1e-6 * scale).all(), name
    for name in ("uv", "material", "valid"):
        np.testing.assert_array_equal(_np(getattr(bt, name)),
                                      np.asarray(getattr(bj, name)), name)


# -- the tile rasterizers ------------------------------------------------------

@pytest.fixture(scope="module")
def triangles():
    """N_TRI seeded clip-space triangles scattered over the 128x64 view
    (about 7 px across, half the pixels covered, two-sided), as a JAX
    TriangleBatch (the keyed-raster section's ``peel_triangles``)."""
    rng = np.random.default_rng(11)
    centre = rng.uniform(-1.1, 1.1, (N_TRI, 1, 2))
    ndc_xy = centre + rng.normal(0.0, 0.12, (N_TRI, 3, 2))
    ndc_z = rng.uniform(0.2, 0.95, (N_TRI, 1)) + rng.normal(0.0, 0.02, (N_TRI, 3))
    w = rng.uniform(1.0, 4.0, (N_TRI, 3))
    clip = np.concatenate(
        [ndc_xy * w[..., None], (ndc_z * w)[..., None], w[..., None]], axis=-1)
    normal = rng.normal(size=(N_TRI, 3, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    f32 = lambda x: jax.numpy.asarray(x, jax.numpy.float32)
    return JR.TriangleBatch(
        clip=f32(clip), world=f32(rng.normal(size=(N_TRI, 3, 3))),
        normal=f32(normal), uv=f32(rng.uniform(0.0, 1.0, (N_TRI, 3, 2))),
        material=jax.numpy.asarray(rng.integers(0, 4, N_TRI), jax.numpy.int32),
        valid=jax.numpy.asarray(rng.random(N_TRI) < 0.95))


@pytest.fixture(scope="module")
def jax_tiles(triangles):
    """JAX rasterize_tiles (K5) in the Pallas interpreter, eagerly, and the
    ``required`` of rasterize_tiles_binned (K6), sorted and presorted. The
    required count is computed before K6's pallas_call and does not depend
    on it, so K6 runs with pallas_call stubbed to return its state inputs:
    its interpreted frame is not a reference (it carries tile state between
    grid steps through aliased outputs, which the interpreter does not
    honour)."""
    orig = JRP.pl.pallas_call
    JRP.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        k5 = tuple(np.asarray(v) for v in JRP.rasterize_tiles(triangles, W, H))
    finally:
        JRP.pl.pallas_call = orig

    def state_only(*args, **kwargs):
        return lambda *ins: list(ins[-3:])

    JRP.pl.pallas_call = state_only
    try:
        required = {p: int(JRP.rasterize_tiles_binned(
            triangles, W, H, presorted=p)[3]) for p in (False, True)}
    finally:
        JRP.pl.pallas_call = orig
    return k5, required


def _emulate(rows, xs, ys, fused):
    """The winner rows' (depth, b1, b2) at pixels (xs, ys) in float64 numpy,
    rounded to f32 after each operation; ``fused``: each plane as XLA's
    contraction fma(px, c0, py * c1) + c2, else every product rounded."""
    r = rows.astype(np.float64)
    px, py = xs + 0.5, ys + 0.5
    f = lambda v: v.astype(np.float32).astype(np.float64)

    def plane(i):
        if fused:
            return f(f(px * r[:, i] + f(py * r[:, i + 1])) + r[:, i + 2])
        return f(f(f(px * r[:, i]) + f(py * r[:, i + 1])) + r[:, i + 2])

    e0, e1, e2, zn, wn = (plane(i) for i in (0, 3, 6, 9, 12))
    esum = np.maximum(f(f(e0 + e1) + e2), f(np.float64(1e-30)))
    return tuple(a.astype(np.float32) / b.astype(np.float32)
                 for a, b in ((zn, wn), (e1, esum), (e2, esum)))


def test_k5_plain_on_jax_table(triangles, jax_tiles):
    """K5's plain version on the JAX package's own coefficient table, against
    the interpreted JAX kernel: the same winner everywhere, and each side's
    depth and bary are its own rounding of that winner's rows, bit for bit
    (see the module docstring)."""
    (dj, tj, bj), _ = jax_tiles
    coeffs, ok, (lo, hi) = JR.triangle_coefficients(triangles, W, H)
    t = lambda a: torch.from_numpy(np.array(a))
    f = TRP.tile_setup(t(coeffs), t(ok), t(lo), t(hi), W, H)
    dp, tp, bp = TRP.rasterize_chunks(f.coef, f.chunk_aabb, W, H)
    np.testing.assert_array_equal(_np(TRP._batch_ids(tp, f.perm, N_TRI)), tj)
    ys, xs = np.nonzero(tj >= 0)
    assert 0.3 < ys.size / (W * H) < 0.8
    rows = _np(f.coef)[_np(tp)[ys, xs]]
    for got, fused in (((_np(dp), _np(bp)), False), ((dj, bj), True)):
        z, b1, b2 = _emulate(rows, xs, ys, fused)
        np.testing.assert_array_equal(got[0][ys, xs].view(np.int32), z.view(np.int32))
        np.testing.assert_array_equal(got[1][ys, xs, 0].view(np.int32), b1.view(np.int32))
        np.testing.assert_array_equal(got[1][ys, xs, 1].view(np.int32), b2.view(np.int32))
        assert np.isinf(got[0][tj < 0]).all() and (got[1][tj < 0] == 0).all()


def test_k5_end_to_end(triangles, jax_tiles):
    """The port's own setup and K5 against the JAX package's K5."""
    (dj, tj, bj), _ = jax_tiles
    dt, tt, bt = (_np(v) for v in TRP.rasterize_tiles(
        _port("TriangleBatch", triangles), W, H))
    cov_t, cov_j = tt >= 0, tj >= 0
    assert (cov_t != cov_j).mean() <= 1e-3
    both = cov_t & cov_j
    np.testing.assert_allclose(dt[both], dj[both], rtol=5e-4)
    off = both & (tt != tj)
    np.testing.assert_allclose(dt[off], dj[off], rtol=5e-4)  # ties only
    np.testing.assert_allclose(bt[both & ~off], bj[both & ~off], atol=1e-4)


@pytest.mark.parametrize("presorted", [False, True])
def test_k6_plain_matches_k5(triangles, jax_tiles, presorted):
    """K6's plain version is K5's bit for bit. Presorted: K6 on the batch
    already in K5's sorted order returns ids of that order, which map back
    to K5's through the sort. ``required`` equals the JAX package's on the
    same batch and flag."""
    _, required = jax_tiles
    batch = _port("TriangleBatch", triangles)
    req = TRP.rasterize_tiles_binned(batch, W, H, presorted=presorted)[3]
    assert req == required[presorted] > (W // 128) * (H // 8)
    d5, t5, b5 = TRP.rasterize_tiles(batch, W, H)
    perm = None
    if presorted:
        coeffs, ok, (lo, hi) = TR.triangle_coefficients(batch, W, H)
        perm = TRP.tile_setup(coeffs, ok, lo, hi, W, H).perm
        batch = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name)[perm]
            for f in dataclasses.fields(batch) if getattr(batch, f.name) is not None})
    d6, t6, b6, _ = TRP.rasterize_tiles_binned(batch, W, H,
                                               presorted=presorted)
    if presorted:
        t6 = torch.where(t6 >= 0, perm[t6.clamp(min=0).long()].to(torch.int32), -1)
    assert torch.equal(d6.view(torch.int32), d5.view(torch.int32))
    assert torch.equal(t6, t5)
    assert torch.equal(b6.view(torch.int32), b5.view(torch.int32))


def _handmade_rows():
    """Coefficient rows built to probe the rejection's corners: an accepting
    base row (every plane constant and positive) with one plane replaced by
    slivers one column or one diagonal wide, -0.0 coefficients, +-inf and
    NaN, products or sums that overflow at some pixels only, and wn just
    above, at and just below 1e-12 (constant, and sloped across a
    footprint)."""
    inf, nan = float("inf"), float("nan")
    big = np.float32(3.4e38 / 40)           # px * big overflows for px > ~40
    w12 = np.float32(1e-12)
    up, down = np.nextafter(w12, np.float32(1)), np.nextafter(w12, np.float32(0))
    base = np.array([0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0.5, 0, 0, 1, 0],
                    np.float32)
    planes = {0: [(1, 0, -20.5), (1, -1, 3.0), (0.5, -0.5, 1.5),
                  (-0.0, -0.0, 0.0), (0.0, 0.0, -0.0), (-0.0, 1.0, -0.0),
                  (inf, 0, -1), (-inf, 0, 1), (inf, -inf, 0), (0, 0, inf),
                  (0, 0, -inf), (inf, 0, -inf), (nan, 0, 0), (0, 0, nan),
                  (0, nan, -1), (big, 0, -big * 30), (-big, 0, big * 30),
                  (big, big * 4, -3.0e38), (big, -big * 8, 0.0),
                  (-big, -big, 3.3e38), (1e-30, 0, -1e-29), (3.0, 5.0, -400.0)],
              1: [(-1, 0, 20.5), (-1, 1, -3.0), (-0.5, 0.5, -1.5)],
              9: [(0, 0, -0.0), (0, 0, -1e-38), (-1, 0, 10.0), (0, -1, 5.0)],
              12: [(0, 0, w12), (0, 0, up), (0, 0, down), (0, 0, 0.0),
                   (0, 0, -0.0), (1e-14, 0, w12 - 1e-14 * 8),
                   (0, -1e-14, w12 + 1e-14 * 4), (-1e-13, 1e-13, w12),
                   (0, 0, nan), (0, 0, inf), (0, 0, -inf)]}
    rows = [base]
    for at, coefs in planes.items():
        for c in coefs:
            r = base.copy()
            r[at:at + 3] = np.asarray(c, np.float32)
            rows.append(r)
    # the slivers of plane 1 pair with the first three of plane 0
    for c0, c1 in zip(planes[0][:3], planes[1]):
        r = base.copy()
        r[0:3], r[3:6] = np.asarray(c0, np.float32), np.asarray(c1, np.float32)
        rows.append(r)
    return torch.from_numpy(np.stack(rows))


def _accepts(rows, xs, ys):
    """[P, N]: pixel (xs[p], ys[p]) accepts row n, evaluated as the plain
    tile rasterizer evaluates it."""
    px, py = (v.to(torch.float32)[:, None] + 0.5 for v in (xs, ys))
    e0, e1, e2, zn, wn = (px * rows[:, i] + py * rows[:, i + 1] + rows[:, i + 2]
                          for i in (0, 3, 6, 9, 12))
    return ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (wn > 1e-12)
            & (zn >= 0.0))


@pytest.mark.parametrize("source,foot", [
    ("fixture", (32, 4)), ("fixture", (16, 8)), ("handmade", (32, 4)),
    ("handmade", (16, 8)), ("bins", (8, 4)), ("bins", (16, 2)),
    ("bins", (32, 1)), ("bins128", (32, 8))],
    ids=["fixture-32x4", "fixture-16x8", "handmade-32x4", "handmade-16x8",
         "bins-8x4", "bins-16x2", "bins-32x1", "bins128-32x8"])
def test_tile_may_cover_is_exact(triangles, source, foot):
    """``tile_may_cover`` (the tile and binned raster kernels' per-warp
    triangle rejection) against every pixel of every footprint, evaluated
    with the kernels' rounding: a footprint it rejects holds no accepting
    pixel. On the fixture's sorted rows each 8 x 128 tile's footprints are
    tested against the rows of the chunks whose box meets the tile (the
    tile kernels' candidates), and more than half of those are rejected;
    on the fixture's ``bin_triangles`` each 8 x 32 cell's footprints (the
    binned kernels' warps: 8 x 4 is K1-K4's, 16 x 2 and 32 x 1 the
    shapes timed beside it) against the rows of the cell's groups, and
    more than half of those are rejected too (kept: 2.2% at 8 x 4, 3.2% at
    16 x 2, 7.3% at 32 x 1); on its 8 x 128 cells (K4's lists) each 32 x 8
    quarter (the box of K4's block prefilter) against the rows of the
    cell's groups (kept: 11.0%); the handmade rows are tested against every
    footprint of two 128 x 16 regions, one at the origin and one at the far
    corner of a 1920 x 1080 image."""
    fw, fh = foot
    if source in ("bins", "bins128"):
        cw = TRE.CELL_W if source == "bins" else TRE.TILE_W
        b = TRE.bin_triangles(_port("TriangleBatch", triangles), W, H, cw)
        rows = b.coef.reshape(-1, TRE.GROUP, 16)
        n_bx = TRE.grid_cells(W, H, cw)[0]
        work = []
        for c in range(b.cell_start.numel() - 1):
            gs = b.cell_groups[b.cell_start[c]:b.cell_start[c + 1]].long()
            origin = ((c % n_bx) * cw, (c // n_bx) * TRE.CELL_H)
            work.append((origin, cw, TRE.CELL_H, rows[gs].reshape(-1, 16)))
    elif source == "fixture":
        batch = _port("TriangleBatch", triangles)
        coeffs, ok, (lo, hi) = TR.triangle_coefficients(batch, W, H)
        f = TRP.tile_setup(coeffs, ok, lo, hi, W, H)
        start, chunks, _ = TRP.tile_lists(f.chunk_aabb, W, H)
        rows = f.coef.reshape(-1, TRP.CHUNK, 16)
        n_tx = W // TRP.TILE_W
        work = []
        for t in range(start.numel() - 1):
            ks = chunks[start[t]:start[t + 1]].long()
            origin = ((t % n_tx) * TRP.TILE_W, (t // n_tx) * TRP.TILE_H)
            work.append((origin, TRP.TILE_W, TRP.TILE_H, rows[ks].reshape(-1, 16)))
    else:
        rows = _handmade_rows()
        work = [(origin, 128, 16, rows) for origin in ((0, 0), (1792, 1064))]
    kept = tested = 0
    for (x0, y0), rw, rh, r in work:
        for fx in range(x0, x0 + rw, fw):
            for fy in range(y0, y0 + rh, fh):
                may = TRP.tile_may_cover(r, fx, fx + fw - 1, fy, fy + fh - 1)
                ys, xs = torch.meshgrid(torch.arange(fy, fy + fh),
                                        torch.arange(fx, fx + fw),
                                        indexing="ij")
                hit = _accepts(r, xs.reshape(-1), ys.reshape(-1)).any(dim=0)
                assert not (hit & ~may).any(), (
                    f"rejected a covering row at footprint ({fx}, {fy}): "
                    f"{torch.nonzero(hit & ~may).flatten().tolist()}")
                kept += int(may.sum())
                tested += may.numel()
    if source != "handmade":
        assert tested > 0 and kept < 0.5 * tested, (kept, tested)
    else:
        # some rows are rejected somewhere; a row with a NaN is kept
        assert kept < tested
        nan_rows = torch.isnan(rows).any(dim=1)
        assert TRP.tile_may_cover(rows[nan_rows], 0, fw - 1, 0, fh - 1).all()


def test_rasterize_matches_jax_and_tiles(triangles):
    """The reference rasterizer: against the JAX package's end to end,
    against K5 on the same batch, and a window equal to the full frame's
    crop."""
    batch = _port("TriangleBatch", triangles)
    dr, tr, br = TR.rasterize(batch, W, H)
    dj, tj, _ = (np.asarray(v) for v in JR.rasterize(triangles, W, H))
    cov = (_np(tr) >= 0) & (tj >= 0)
    assert ((_np(tr) >= 0) != (tj >= 0)).mean() <= 1e-3
    np.testing.assert_allclose(_np(dr)[cov], dj[cov], rtol=5e-4)

    d5, t5, b5 = TRP.rasterize_tiles(batch, W, H)
    stray = dr.view(torch.int32) != d5.view(torch.int32)
    assert int(stray.sum()) <= 1e-4 * W * H
    same = ~stray & (tr == t5)
    assert torch.equal(br[same].view(torch.int32), b5[same].view(torch.int32))
    tie = ~stray & (tr != t5)          # equal depth, another triangle
    assert int(tie.sum()) <= 1e-3 * W * H

    x0, y0, w, h = 40, 24, 56, 24
    dw, tw, bw = TR.rasterize(batch, w, h, full_width=W, full_height=H,
                              origin=(x0, y0))
    assert torch.equal(dw.view(torch.int32), dr[y0:y0 + h, x0:x0 + w].view(torch.int32))
    assert torch.equal(tw, tr[y0:y0 + h, x0:x0 + w])
    assert torch.equal(bw, br[y0:y0 + h, x0:x0 + w])


def test_resolve_gbuffer_matches_jax(triangles):
    dj, tj, bj = JR.rasterize(triangles, W, H)
    gj = JR.resolve_gbuffer(triangles, dj, tj, bj)
    t = lambda a: torch.from_numpy(np.array(a))
    gt = TR.resolve_gbuffer(_port("TriangleBatch", triangles), t(dj), t(tj), t(bj))
    for name in ("world_pos", "normal", "uv"):
        np.testing.assert_allclose(_np(getattr(gt, name)),
                                   np.asarray(getattr(gj, name)), atol=1e-5)
    np.testing.assert_array_equal(_np(gt.material), np.asarray(gj.material))
    assert (np.asarray(gj.tri_id) >= 0).mean() > 0.3


def test_ragged_frame_matches_rasterize():
    """The example scene's draw-list batch at 200 x 150 (ragged right and
    bottom tiles): K5 against the reference rasterizer."""
    rp, cam = build_example_scene(200, 150, device="cpu")
    _, batch = draw_list_batch(**rp.draw_list_inputs(cam))
    d5, t5, _ = TRP.rasterize_tiles(batch, 200, 150)
    dr, tr, _ = TR.rasterize(batch, 200, 150)
    assert d5.shape == (150, 200) and 0.5 < float((t5 >= 0).float().mean()) < 0.9
    assert int((d5.view(torch.int32) != dr.view(torch.int32)).sum()) <= 1e-4 * 200 * 150
    assert int((t5 != tr).sum()) <= 1e-3 * 200 * 150


def test_render_draw_list_golden_and_jax():
    """RenderPass.render(static_path=False) at 128 x 128: the golden, the
    JAX package's draw-list frame, the port's static frame and the aux
    counts."""
    from examples.render_scene import build_example_scene as build_jax

    rp, cam = build_example_scene(128, 128, device="cpu")
    ldr, aux = rp.render(cam, static_path=False)
    assert ldr.shape == (128, 128, 3) and torch.isfinite(ldr).all()
    _bands(ldr, read_image(os.path.join(GOLDEN_DIR, "raster_example.png"))
           .astype(np.float32) / 255.0)
    rpj, camj = build_jax(128, 128)
    ldr_j, aux_j = rpj.render(camj, static_path=False)
    _bands(ldr, ldr_j)
    for key in ("visible_count", "draw_count", "total_tris"):
        assert int(aux[key]) == int(aux_j[key]), key
    assert int(aux["draw_count"]) == 5
    assert abs(float(aux["coverage"]) - float(aux_j["coverage"])) <= 1e-3
    ldr_s, aux_s = rp.render(cam)
    assert int(aux_s["total_tris"]) == int(aux["total_tris"])
    _bands(ldr, ldr_s)


def test_render_draw_list_golden_512():
    """The draw-list frame of config 1 at 512 x 512 against raster_512.png."""
    rp, cam = build_example_scene(512, 512, device="cpu")
    ldr, aux = rp.render(cam, static_path=False)
    assert ldr.shape == (512, 512, 3) and int(aux["total_tris"]) == 4110
    _bands(ldr, read_image(os.path.join(GOLDEN_DIR, "raster_512.png"))
           .astype(np.float32) / 255.0)


# -- gather ------------------------------------------------------------------

@pytest.mark.parametrize("n,k,dtype", [
    (100, 1, np.float32), (100, 3, np.float32), (200, 4, np.float32),
    (77, 5, np.float32), (129, 32, np.float32), (65, 128, np.float32),
    (16, 8, np.float32), (1, 1, np.float32), (90, 4, np.int32)])
def test_gather_rows_packed(n, k, dtype):
    """tests/test_gather.py's shapes, an int table, and negative ids, which
    read row 0."""
    rng = np.random.default_rng(n * 1000 + k)
    table = rng.integers(-5, 1 << 24, size=(n, k)).astype(dtype)
    ids = rng.integers(-3, n, size=(6, 7)).astype(np.int32)
    got = TG.gather_rows_packed(torch.from_numpy(table), torch.from_numpy(ids))
    assert got.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(_np(got), table[np.maximum(ids, 0)])


# ===========================================================================
# Ray-tracing building blocks
#
# The PyTorch port's ray-tracing building blocks against the JAX package,
# on the CPU (the port runs the plain versions of its traversal kernels here).
#
# Inputs are the same in both packages: the RT example scene built through
# each package's API, rays made with numpy from a seed, and for the
# traversal tests the JAX package's own RTScene arrays handed to the port
# (``interop.from_numpy``). The JAX side runs its XLA path (``trace_scene`` /
# ``SceneTracer`` with ``use_pallas=False``).
#
# Tolerances: integer tables and the host-built BLAS are compared exactly.
# The per-frame float rows (instance matrices, TLAS boxes) at 1e-6 relative:
# XLA contracts the einsums of ``transform_aabb``/``make_instance_rows`` into
# FMAs, the port does not. Hit distances at 1e-5 relative; triangle and
# instance ids only where the two packages' t differ by more than that (a
# different id at an equal t is a tie on a shared edge, which the traversal
# order decides).
# ===========================================================================

RT_W, RT_H = 48, 32
T_REL = 1e-5


def _add_second_tlas(rt, mod):
    """TLAS 1: the sphere (mask 0x01) and the cube (mask 0x02, force
    opaque) again, bound to a new material."""
    mat = mod.Material("blue", albedo=(0.1, 0.2, 0.9)).instance()
    k = rt.add_tlas()
    insts = rt.scene.instances
    rt.add_instance(insts[1], {0: mat}, tlas=k, mask=0x01)
    rt.add_instance(insts[2], {0: mat}, tlas=k, mask=0x02, force_opaque=True)


@pytest.fixture(scope="module")
def scenes():
    """Both packages' RT scene with a second, masked TLAS: the JAX RTScene
    and root codes, and the port's own assembly of the same frame."""
    import paperrenderer_tpu as J
    import paperrenderer_tpu_torch as T

    _, rtj, camj = build_jax(RT_W, RT_H)
    _, rtt, _ = build_port(RT_W, RT_H, device="cpu")
    _add_second_tlas(rtj, J)
    _add_second_tlas(rtt, T)
    inst_j = rtj.scene.flush()
    cap = inst_j.capacity
    bj, mj, ar, an = rtj.accel.blas()
    slots_j, masks_j, table_j = rtj._device_inputs(cap)
    imask_j, opq_j = rtj._cached_inst_mask
    sj, roots_j = JA.assemble_scene(
        bj, mj, ar, an, inst_j, rtj.accel.inst_blas(cap), list(masks_j),
        rtj.accel.tri_attr(), inst_mask=imask_j, inst_opaque=opq_j)

    inst_t = rtt.scene.flush()
    bt, mt, ar_t, an_t = rtt.accel.blas()
    slots_t, masks_t, table_t, imask_t, opq_t, _, _ = rtt._device_inputs(cap)
    st, roots_t = TA.assemble_scene(
        bt, mt, ar_t, an_t, inst_t, rtt.accel.inst_blas(cap), masks_t,
        rtt.accel.tri_attr(), inst_mask=imask_t, inst_opaque=opq_t)
    port_of_jax = from_numpy(
        "RTScene", {f: np.asarray(getattr(sj, f)) for f in (
            "nodes", "codes", "leaf_rows", "leaf_prim", "inv_rows",
            "tri_attr")}, device="cpu")
    return dict(rtj=rtj, rtt=rtt, bj=bj, mj=mj, bt=bt, mt=mt, sj=sj, st=st,
                roots_j=roots_j, roots_t=roots_t, scene=port_of_jax,
                slots=np.asarray(slots_j), slots_t=slots_t, table_j=table_j,
                stack=rtj.accel.stack_size(cap),
                stack_t=rtt.accel.stack_size(cap), camj=camj)


@pytest.fixture(scope="module")
def rays(scenes):
    """The camera's primary rays (tile order, as the frame makes them) and
    random rays from inside the scene's box, with per-ray caps."""
    from paperrenderer_tpu.ops.trace import pick_tile, raygen

    o, d = raygen(scenes["camj"].matrices, RT_W, RT_H,
                  tile_order=pick_tile(RT_W, RT_H))
    rng = np.random.default_rng(5)
    n = 1024
    ro = rng.uniform((-4, -4, 0.05), (4, 4, 3), (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    o = np.concatenate([np.asarray(o), ro]).astype(np.float32)
    d = np.concatenate([np.asarray(d), rd]).astype(np.float32)
    t = np.concatenate([np.full(RT_W * RT_H, 1000.0),
                        rng.uniform(0.5, 8.0, n)]).astype(np.float32)
    active = rng.uniform(size=o.shape[0]) > 0.1
    return o, d, t, active


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("seed,data", [(0, (1, 7)), (42, (3, 1000)),
                                       (2**31 - 1, (1, 2001))])
def test_threefry_matches_jax_random(seed, data):
    kj = jax.random.PRNGKey(seed)
    kt = rnd.prng_key(seed)
    assert tuple(int(x) for x in np.asarray(kj)) == kt
    for x in data:
        kj, kt = jax.random.fold_in(kj, x), rnd.fold_in(kt, x)
        assert tuple(int(v) for v in np.asarray(kj)) == kt
    uj = np.asarray(jax.random.uniform(kj, (2, 777)))
    ut = rnd.uniform(kt, (2, 777), "cpu").numpy()
    np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))


@pytest.mark.parametrize("field", ["nodes", "codes", "leaf_rows", "leaf_prim",
                                   "root_min", "root_max", "root_code"])
def test_blas_set_equal(scenes, field):
    np.testing.assert_array_equal(getattr(scenes["bt"], field).numpy(),
                                  np.asarray(getattr(scenes["bj"], field)))
    assert scenes["mt"].max_depth == scenes["mj"].max_depth
    np.testing.assert_array_equal(scenes["mt"].blas_of_model,
                                  scenes["mj"].blas_of_model)


@pytest.mark.parametrize("field", ["nodes", "codes", "leaf_rows", "leaf_prim",
                                   "inv_rows", "tri_attr"])
def test_assemble_scene_two_masked_tlases(scenes, field):
    got = getattr(scenes["st"], field).numpy()
    want = np.asarray(getattr(scenes["sj"], field))
    assert scenes["roots_t"] == scenes["roots_j"]
    assert scenes["stack_t"] == scenes["stack"]
    if got.dtype == np.float32 and field not in ("leaf_rows", "tri_attr"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _jax_trace(scenes, root, **kw):
    return jax.jit(functools.partial(
        JA.trace_scene, root_code=root, stack_size=scenes["stack"], **kw))


def _assert_hits_match(got, want, active=None):
    """t at T_REL; prim/inst equal unless the two t tie within T_REL."""
    t_j, p_j = np.asarray(want.t), np.asarray(want.prim)
    i_j = np.asarray(want.inst)
    hit = p_j >= 0
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    t_p = got.t.numpy()
    np.testing.assert_allclose(t_p[hit], t_j[hit], rtol=T_REL)
    other = (got.prim.numpy() != p_j) | (got.inst.numpy() != i_j)
    tie = np.zeros_like(hit)
    tie[hit] = np.abs(t_p[hit] - t_j[hit]) <= T_REL * np.abs(t_j[hit])
    assert not (other & ~tie).any()
    assert other.mean() < 0.01
    if active is not None:
        assert not got.hit.numpy()[~active].any()


@pytest.mark.parametrize("tlas,cull", [(0, 0xFF), (1, 0x02), (1, 0xFF)])
def test_plain_k7_closest_matches_jax(scenes, rays, tlas, cull):
    o, d, t, active = rays
    root = scenes["roots_j"][tlas]
    want = _jax_trace(scenes, root, cull_mask=cull)(
        scenes["sj"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
        active=jnp.asarray(active))
    got = TK.trace_scene_kernel(scenes["scene"], _t(o), _t(d), _t(t),
                                root_code=root, stack_size=scenes["stack"],
                                active=_t(active), cull_mask=cull)
    _assert_hits_match(got, want, active)
    np.testing.assert_allclose(got.bary.numpy()[got.hit.numpy()],
                               np.asarray(want.bary)[got.hit.numpy()],
                               atol=1e-4)


def test_plain_k7_any_hit_matches_jax(scenes, rays):
    o, d, t, _ = rays
    root = scenes["roots_j"][0]
    want = _jax_trace(scenes, root, any_hit=True)(
        scenes["sj"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    got = TK.trace_scene_kernel(scenes["scene"], _t(o), _t(d), _t(t),
                                root_code=root, stack_size=scenes["stack"],
                                any_hit=True)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    assert got.hit.numpy().mean() > 0.3


def _jax_tracer(scenes):
    return JA.SceneTracer(scenes["sj"], jnp.asarray(scenes["slots"]),
                          scenes["table_j"], root_code=scenes["roots_j"][0],
                          stack_size=scenes["stack"])


def _port_tracer(scenes):
    return TA.SceneTracer(scenes["scene"], _t(scenes["slots"]), None,
                          root_code=scenes["roots_j"][0],
                          stack_size=scenes["stack"])


def test_plain_k8_matches_jax_trace_resolve(scenes, rays):
    o, d, t, active = rays
    want = jax.jit(lambda o, d, t, a: _jax_tracer(scenes).trace_resolve(
        o, d, t, active=a))(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                            jnp.asarray(active))
    got = _port_tracer(scenes).trace_resolve(_t(o), _t(d), _t(t),
                                             active=_t(active))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for field in ("normal", "uv", "world_pos"):
        np.testing.assert_allclose(getattr(got, field).numpy()[valid],
                                   np.asarray(getattr(want, field))[valid],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.material.numpy(),
                                  np.asarray(want.material))


def test_plain_k9_matches_jax_per_sample_path(scenes, rays):
    """Occlusion bits and AO t of an origin-shared bundle (2 shadow + 1 AO
    samples, some rays inactive) against the JAX per-sample fallback."""
    o, d, t, active = rays
    rng = np.random.default_rng(9)
    dirs = [rng.normal(size=d.shape).astype(np.float32) for _ in range(3)]
    caps = [t, t, np.full(t.shape, 2.0, np.float32)]
    acts = [active, np.ones_like(active), active]

    def jax_bundle(o, d0, d1, d2, c0, c1, c2, a0, a1, a2):
        return _jax_tracer(scenes).trace_shadow_ao_bundle(
            o, [d0, d1], [c0, c1], [d2], [c2], occ_actives=[a0, a1],
            ao_actives=[a2])

    bits_j, ao_j = jax.jit(jax_bundle)(
        *(jnp.asarray(x) for x in [o] + dirs + caps + acts))
    bits_t, ao_t, _ = TK.trace_bundle_kernel(
        scenes["scene"], _t(o), [_t(x) for x in dirs[:2]],
        [_t(x) for x in caps[:2]], [_t(x) for x in acts[:2]], [_t(dirs[2])],
        [_t(caps[2])], [_t(acts[2])], root_code=scenes["roots_j"][0],
        stack_size=scenes["stack"])
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))
    np.testing.assert_allclose(ao_t[0].numpy(), np.asarray(ao_j[0]),
                               rtol=T_REL)
    assert 0 < (bits_t.numpy() & 1).mean() < 1


@pytest.mark.parametrize("case", ["samples", "tlas1_cull2", "adversarial"])
def test_k9_union_walk_matches_per_sample_bits(scenes, rays, case,
                                               monkeypatch):
    """K9's occlusion samples walked as one union walk a group
    (``occlusion_union_plain``, the kernel's schedule) against one any-hit
    walk a sample (``trace_bundle_plain``): equal bits on the fixture's rays
    (camera rays and random rays from inside the scene) with random,
    duplicate and opposite directions, on the masked TLAS 1 with a cull
    mask that only the cube meets, and on ``probes.adversarial_bundle``'s 30
    samples (caps of 0, t_min and exactly a hit's t; axis and
    zero-component directions; inactive samples and pixels); a sample
    equal to the one before it shares its walk. A group of one sample
    walks exactly the per-sample walk: the same pops, one sample test a
    pop, and a triangle test a triangle."""
    from paperrenderer_tpu_torch.utils import probes as PR

    o, d, t, active = (_t(x) for x in rays)
    active = active.bool()
    g = np.random.default_rng(11)
    rnd_d = [_t(g.normal(size=d.shape).astype(np.float32)) for _ in range(2)]
    tlas, cull = (1, 0x02) if case == "tlas1_cull2" else (0, 0xFF)
    walk = dict(root_code=scenes["roots_j"][tlas], stack_size=scenes["stack"],
                cull_mask=cull)
    sc = scenes["scene"]
    if case == "adversarial":
        dirs, caps, acts = PR.adversarial_bundle(sc, o, [d] + rnd_d, active,
                                                 walk=walk)
    else:
        dirs = [rnd_d[0], rnd_d[0], d, -rnd_d[0], rnd_d[1]]
        caps = [t, t, t, torch.full_like(t, 2.0), t]
        acts = [None, active, active, active, ~active]
    want, _, _ = TK.trace_bundle_plain(sc, o, dirs, caps, acts, [], [], None,
                                       **walk)
    got = TK.occlusion_union_plain(sc, o, dirs, caps, acts, **walk)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert 0 < (want.numpy() & 1).mean() < 1
    if case == "samples":
        per_sample, one = {}, {}
        TK.trace_bundle_plain(sc, o, dirs, caps, acts, [], [], None,
                              counts=per_sample, **walk)
        monkeypatch.setattr(TK, "UNION_GROUP", 1)
        TK.occlusion_union_plain(sc, o, dirs, caps, acts, counts=one,
                                 **walk)
        per_sample = per_sample.pop("occlusion")
        assert {k: one[k] for k in per_sample} == per_sample
        assert [one[k + "_tests"] for k in ("box", "leaf", "inst")] == [
            one[k] for k in ("box", "leaf", "inst")]
        assert one["tri_tests"] == one["leaf_tris"] > 0


# ===========================================================================
# Hybrid frame
#
# The PyTorch port's hybrid frame, ``HybridRender.render``, on the CPU:
# the raster G-buffer through K1's plain version, the RT passes through the
# traversal kernels' plain versions on either layout.
#
# The 128x128 frame of the hybrid example is held to ``hybrid_example.png``
# with tests/test_golden_images.py's bands (mean |diff| <= 0.004, at most
# 0.2% of pixels off by > 0.06). 48x32 frames are held to the JAX package's
# ``make_hybrid_frame`` on both layouts (``paged=True, use_pallas_trace=False``
# on the CPU) with the raster tests' tolerance (the static raster frame
# section),
# a mean per-pixel |diff| <= 0.004 on the LDR image: the JAX package
# rasterizes its G-buffer through XLA on the CPU, the port through K1's
# plain version, so a depth tie on a shared edge can pick the other
# triangle, and with it the origin of that pixel's shadow, AO and reflection
# samples. Both draw the same random samples.
# ===========================================================================

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "hybrid_example.png")


def test_hybrid_golden():
    _, hy, cam = build_hybrid_scene(128, 128, device="cpu")
    ldr, aux = hy.render(cam)
    assert ldr.shape == (128, 128, 3) and torch.isfinite(aux["hdr"]).all()
    assert not aux["paged"]   # three instances: the flat layout
    _bands(ldr.numpy(), read_image(GOLDEN).astype(np.float32) / 255.0)


@pytest.fixture(scope="module")
def frames():
    """48x32 hybrid frames of the example on both layouts, in both
    packages (LDR images)."""
    from examples.render_hybrid import build_hybrid_scene as build_jax
    from paperrenderer_tpu.render.hybrid import make_hybrid_frame

    out = {}
    for paged in (False, True):
        _, hyj, camj = build_jax(48, 32)
        if paged:   # the JAX package routes paged only off the CPU
            _, meta, _, _ = hyj.accel.blas()
            hyj._frame_fn = make_hybrid_frame(meta, None, paged=True)
            hyj._frame_key = (hyj.accel._blas_key, False, hyj.bvh_wide, 1)
        out["jax", paged] = np.asarray(hyj.render(camj)[0])
        _, hy, cam = build_hybrid_scene(48, 32, device="cpu")
        ldr, aux = hy.render(cam, paged=paged)
        assert aux["paged"] == paged and torch.isfinite(aux["hdr"]).all()
        out["port", paged] = ldr.numpy()
    # the XLA route's G-buffer (use_pallas=False), traced flat as JAX does
    _, hy, cam = build_hybrid_scene(48, 32, device="cpu")
    hy.use_pallas = False
    ldr, aux = hy.render(cam)
    assert not aux["paged"] and aux["required_work"] == 0
    out["xla", False] = ldr.numpy()
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_hybrid_frame_matches_jax(frames, paged):
    """Both layouts against the JAX frame; on the flat layout also the XLA
    route's frame (use_pallas=False), which on the CPU is bitwise the
    kernel route's: K1's plain version finds the same depths and
    barycentrics as ``raster.rasterize`` on this scene (measured)."""
    diff = np.abs(frames["port", paged] - frames["jax", paged]).max(axis=-1)
    assert diff.mean() <= 0.004, diff.mean()
    if not paged:
        diff = np.abs(frames["xla", False] - frames["jax", False]).max(axis=-1)
        assert diff.mean() <= 0.004, diff.mean()
        np.testing.assert_array_equal(frames["xla", False],
                                      frames["port", False])


def test_hybrid_layouts_agree(frames):
    """The paged frame traces shadows and AO apart (no fused bundle; AO
    origins offset by 1e-3 instead of 5e-3), so it differs from the flat
    frame only where an AO ray's origin matters."""
    diff = np.abs(frames["port", True] - frames["port", False]).max(axis=-1)
    assert diff.mean() <= 0.004, diff.mean()


def test_instance_api_delegates():
    _, hy, cam = build_hybrid_scene(16, 16, device="cpu")
    rp = hy._rp
    sphere = hy.scene.instances[1]
    assert sphere.index in rp._bindings and hy.lights is rp.lights
    hy.set_instance_visibility(sphere, False)
    assert rp._visible[sphere.index] is False
    rp._cache_dirty = False
    hy.invalidate()
    assert rp._cache_dirty
    hy.remove_instance(sphere)
    assert sphere.index not in rp._bindings
    ldr, _ = hy.render(cam)
    assert ldr.shape == (16, 16, 3)
    hy2 = type(hy)(hy.scene, hy.materials, width=16, height=16)
    hy2.add_instances_from(rp)
    assert hy2._rp._bindings == rp._bindings
    assert hy2._rp._visible == rp._visible


@pytest.mark.parametrize("case", ["animate"])
def test_unported_hybrid_options_raise(case):
    """``HybridRender(animate=)``, once refused, is accepted and kept for
    the RT passes, and ``render(cam, time=)`` draws a frame."""
    eng = RenderEngine(device="cpu", device_check=False)
    animate = lambda v, t: v   # noqa: E731
    hy = eng.create_hybrid_render(animate=animate, width=8, height=8)
    assert hy.animate is animate
    _, hy, cam = build_hybrid_scene(16, 16, device="cpu")
    hy.animate = animate
    ldr, aux = hy.render(cam, time=0.5)
    assert ldr.shape == (16, 16, 3) and torch.isfinite(aux["hdr"]).all()


@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_use_pallas_keyword(use_pallas):
    """``use_pallas`` as the JAX constructors take it: None or True runs
    the port's kernels, False the XLA route; each route renders a frame
    (tests/test_torch_io.py holds the XLA route's frames to the JAX
    package's and to the goldens)."""
    from paperrenderer_tpu_torch import (
        Camera, HybridRender, Material, Model, ModelInstance, RayTraceRender,
        RenderPass, make_cube)

    eng = RenderEngine(device="cpu", device_check=False)
    cube = Model.from_mesh(eng.scene.arena, *make_cube(size=1.0))
    cam = Camera(aspect=1.0)
    cam.look_at((0.0, -4.0, 2.0), (0.0, 0.0, 0.0))
    for cls in (RenderPass, RayTraceRender, HybridRender):
        r = cls(eng.scene, eng.materials, width=8, height=8,
                use_pallas=use_pallas)
        assert r.width == 8 and r.use_pallas is (use_pallas is not False)
        r.add_instance(ModelInstance(cube), {0: Material("m").instance()})
        ldr, aux = r.render(cam)
        assert ldr.shape == (8, 8, 3) and torch.isfinite(aux["hdr"]).all()
        assert float(ldr.max()) > 0.0


def test_render_time_keyword():
    """``render(cam, time=)`` as the JAX renders take it: accepted, and
    with no animation it leaves the frame as it is."""
    _, rt, cam = build_rt_scene(16, 16, device="cpu")
    _, hy, camh = build_hybrid_scene(16, 16, device="cpu")
    for render, c in ((rt, cam), (hy, camh)):
        a = render.render(c, time=0.5)[1]["hdr"]
        render._frame = 0
        np.testing.assert_array_equal(render.render(c)[1]["hdr"].numpy(),
                                      a.numpy())


@pytest.mark.parametrize("bvh_wide", [False, True])
def test_bvh_wide_is_accepted_and_ignored(bvh_wide):
    """``bvh_wide`` (a TPU visiting-order knob) is accepted by both renders
    and leaves the RT frame as it is."""
    from paperrenderer_tpu_torch import RayTraceRender

    _, rt, cam = build_rt_scene(16, 16, device="cpu")
    wide = RayTraceRender(rt.scene, rt.materials, width=16, height=16,
                          lights=rt.lights, shadow_samples=2,
                          bvh_wide=bvh_wide)
    wide._tlas_bindings = rt._tlas_bindings
    np.testing.assert_array_equal(wide.render(cam)[1]["hdr"].numpy(),
                                  rt.render(cam)[1]["hdr"].numpy())
    eng = RenderEngine(device="cpu", device_check=False)
    assert eng.create_hybrid_render(bvh_wide=bvh_wide).width == 512
