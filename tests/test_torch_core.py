"""Parity of the PyTorch port's scene core with the JAX package.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerances: transforms and camera matrices 1e-6 (f32 rounding of the same
formulas in two frameworks); scene arrays and static mappings exactly equal
(pure host code / copies).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paperrenderer_tpu as J
import paperrenderer_tpu_torch as T
from paperrenderer_tpu.core import transforms as JT
from paperrenderer_tpu.ops import static_batch as JS
from paperrenderer_tpu_torch.core import transforms as TT
from paperrenderer_tpu_torch.ops import static_batch as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
    cj = J.Camera(yfov_deg=spec["yfov"], aspect=spec["aspect"],
                  near=spec["near"], far=spec["far"])
    cj.look_at(spec["eye"], spec["center"])
    ct = T.Camera(yfov_deg=spec["yfov"], aspect=spec["aspect"],
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
    sj, j0, j1 = _build_scene(J, use_native=False)
    st, t0, t1 = _build_scene(T, device="cpu")
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

    sj, hj, rj = build(J, use_native=False)
    st, ht, rt = build(T, device="cpu")
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
    code = ("import sys, paperrenderer_tpu_torch, paperrenderer_tpu_torch.scenes, "
            "paperrenderer_tpu_torch.interop, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'paperrenderer_tpu.')) or m == 'paperrenderer_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_model_instance_keywords():
    """``ModelInstance(model, unique_geometry=, anim_phase=)`` as the JAX
    package takes them: the phase is stored, and a unique-geometry
    (animated) instance is refused until animation is ported."""
    scene = T.Scene(device="cpu")
    model = T.Model.from_mesh(scene.arena, *T.make_cube(size=1.0))
    inst = T.ModelInstance(model, unique_geometry=False, anim_phase=0.25)
    ref = J.ModelInstance(J.Model.from_mesh(J.Scene().arena,
                                            *J.make_cube(size=1.0)),
                          anim_phase=0.25)
    assert inst.anim_phase == ref.anim_phase == 0.25
    assert inst.unique_geometry is ref.unique_geometry is False
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        T.ModelInstance(model, unique_geometry=True)


def test_engine_buffer_index():
    """``RenderEngine.buffer_index`` is frame % 2, as in the JAX package."""
    eng = T.RenderEngine(device="cpu", device_check=False)
    ref = J.RenderEngine(device_check=False)
    for _ in range(3):
        assert eng.buffer_index == ref.buffer_index == eng.frame_number % 2
        eng.end_frame()
        ref.end_frame()
