"""Parity of the port's draw-list raster frame with the JAX package, on the
CPU: the preprocess pass, the triangle batch, the tile rasterizers K5/K6
(their plain PyTorch versions, which a CPU tensor selects), the reference
rasterizer, the G-buffer resolve and ``RenderPass.render(static_path=False)``;
and ``ops.gather``, which the frames' shading reads materials through.

Inputs are built in JAX from seeded scenes and carried across bit-identically
through ``paperrenderer_tpu_torch.interop``. The JAX tile kernel runs in the
Pallas interpreter (``pallas_call`` patched to ``interpret=True`` for the
call), eagerly.

Tolerances:
  * preprocess: integer arrays equal, matrices within 1e-6 relative;
  * triangle batch: clip, world and normal within 1e-6 of each vertex's
    magnitude (XLA's einsums sum in their own order); uv, material, valid
    equal;
  * K5's plain version on the JAX package's own coefficient table: tid
    equal; depth and bary are each package's rounding of the same winner's
    rows. The interpreter's XLA contracts each plane evaluation into an FMA,
    fma(px, c0, py * c1) + c2, while the port (like its CUDA kernel, built
    with -fmad=false) rounds every product; the test recomputes both
    roundings of the winner's rows in float64 numpy and holds each side to
    its own bit for bit;
  * end to end (each package's own table): depth within 5e-4 relative (the
    setup's FMAs, as in tests/test_torch_raster.py), coverage differing on
    <= 0.1% of pixels, tid equal except where depths tie;
  * K6's plain version: bitwise equal to K5's, sorted and presorted;
    ``required`` equal to the JAX package's;
  * the reference rasterizer against the tile kernel on one batch: depth
    equal except on stray sliver pixels, which the tile kernel culls by
    chunk box and the reference does not (<= 1e-4 of the pixels);
  * resolve: atol 1e-5; frames: the golden bands (mean |diff| <= 0.004,
    <= 0.2% of pixels off by > 0.06).
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from paperrenderer_tpu import core as J
from paperrenderer_tpu.ops import preprocess as JP
from paperrenderer_tpu.ops import raster as JR
from paperrenderer_tpu.ops import raster_pallas as JRP
from paperrenderer_tpu_torch.interop import from_numpy
from paperrenderer_tpu_torch.io import read_image
from paperrenderer_tpu_torch.ops import gather as TG
from paperrenderer_tpu_torch.ops import preprocess as TP
from paperrenderer_tpu_torch.ops import raster as TR
from paperrenderer_tpu_torch.ops import raster_pallas as TRP
from paperrenderer_tpu_torch.render.renderpass import draw_list_batch
from paperrenderer_tpu_torch.scenes import build_example_scene

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
W, H, N_TRI = 128, 64, 300


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(kind, obj):
    """The JAX dataclass ``obj`` as the port's ``kind`` (CPU tensors)."""
    arrays = {f.name: np.asarray(getattr(obj, f.name))
              for f in dataclasses.fields(obj)
              if getattr(obj, f.name) is not None}
    return from_numpy(kind, arrays, device="cpu")


def _bands(img, ref, mean_tol=0.004, frac_tol=0.002, pix_thresh=0.06):
    diff = np.abs(_np(img).astype(np.float32) - _np(ref).astype(np.float32))
    diff = diff.max(axis=-1)
    assert diff.mean() <= mean_tol, diff.mean()
    assert (diff > pix_thresh).mean() <= frac_tol, (diff > pix_thresh).mean()


# -- preprocess and batch ----------------------------------------------------

@pytest.fixture(scope="module")
def lod_scene():
    """A JAX scene of 24 instances of two models: a three-LOD model whose
    finest LOD has two meshes in two material slots, and a one-mesh cube;
    spread from 2 to 60 units from the camera (so every LOD is picked) and
    partly out of view; per-instance slot materials and user visibility
    from a seed."""
    scene = J.Scene(use_native=False)
    a = scene.arena
    hi = a.add_mesh(*J.make_uv_sphere(radius=0.8, rings=8, sectors=10))
    cap = a.add_mesh(*J.make_cube(size=0.5))
    mid = a.add_mesh(*J.make_icosphere(radius=0.8, subdivisions=1))
    lo = a.add_mesh(*J.make_cube(size=1.2))
    tiered = J.Model(a, [[J.MaterialMesh(hi, 0), J.MaterialMesh(cap, 1)],
                         [J.MaterialMesh(mid, 0)], [J.MaterialMesh(lo, 1)]])
    cube = J.Model.from_mesh(a, *J.make_cube(size=1.0))
    rng = np.random.default_rng(21)
    for i in range(24):
        inst = J.ModelInstance(tiered if i % 3 else cube)
        dist = 2.0 + 58.0 * (i / 23.0)
        inst.set_transform(pos=(float(rng.uniform(-1.2, 1.2) * dist), dist,
                                float(rng.uniform(-0.3, 0.3) * dist)),
                           quat=tuple(rng.normal(size=4)))
        scene.add_instance(inst)
    cam = J.Camera(yfov_deg=50.0, aspect=2.0, near=0.1, far=200.0)
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
    TriangleBatch (tests/test_torch_translucency.py's fixture)."""
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
