"""Parity of the PyTorch port's raster ops with the JAX package.

The JAX side runs its Pallas rasterizer in interpreter mode (as
tests/test_raster_quarter.py does); the port runs the plain PyTorch version
of its CUDA kernel, which is what a CPU tensor selects. Inputs are built in
JAX from a seeded scene and carried across bit-identically through
``paperrenderer_tpu_torch.interop``.

Tolerances:
  * triangle_coefficients: rtol 1e-5 of each coefficient's condition scale
    (see that test);
  * rasterization on the SAME coefficient table: coverage differs on
    <= 0.05% of pixels; where both cover, depth relative error <= 1e-6 and
    tid is equal except at depth ties (each kernel breaks ties by its own
    visiting order);
  * rasterize_exact end to end (each package's own table): as above, with
    depth relative error <= 5e-4 — XLA contracts the setup's products into
    FMAs and the zn/wn rows cancel heavily near the far plane (measured max
    2.4e-4 on this fixture, while each table's per-pixel evaluation agrees
    with float64 to 1.3e-7);
  * resolve / shade / tonemap: atol 1e-5 (with rtol 1e-5 for HDR values).
"""

import dataclasses

import numpy as np
import pytest
import torch

from paperrenderer_tpu.core import (
    Camera, Material, MaterialRegistry, Model, ModelInstance, Scene,
    make_cube, make_uv_sphere,
)
from paperrenderer_tpu.ops import preprocess as JP
from paperrenderer_tpu.ops import raster as JR
from paperrenderer_tpu.ops import raster_exact as JRE
from paperrenderer_tpu.ops import shading as JSH
from paperrenderer_tpu.ops import tonemap as JTM
from paperrenderer_tpu_torch.interop import from_numpy
from paperrenderer_tpu_torch.ops import raster as TR
from paperrenderer_tpu_torch.ops import raster_exact as TRE
from paperrenderer_tpu_torch.ops import shading as TSH
from paperrenderer_tpu_torch.ops import tonemap as TTM

W = H = 128


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
    scene = Scene(use_native=False)
    sphere = Model.from_mesh(
        scene.arena, *make_uv_sphere(radius=1.0, rings=10, sectors=14))
    cube = Model.from_mesh(scene.arena, *make_cube())
    rng = np.random.default_rng(7)
    for i in range(12):
        inst = ModelInstance(sphere if i % 2 == 0 else cube)
        s = float(rng.uniform(0.3, 1.2))
        inst.set_transform(pos=rng.uniform(-4, 4, 3).tolist(),
                           scale=(s, s, s))
        scene.add_instance(inst)
    cam = Camera(yfov_deg=60.0, aspect=1.0, near=near, far=far)
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
        d, t, table, _ = JRE.rasterize_exact(batch, W, H, overflow_cond=False)
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
    cj, okj, (loj, hij) = JR.triangle_coefficients(batch, W, H)
    ct, okt, (lot, hit) = TR.triangle_coefficients(
        _port("TriangleBatch", batch), W, H)
    cj, ct, okj, okt = _np(cj), _np(ct), _np(okj), _np(okt)
    np.testing.assert_array_equal(_np(lot), _np(loj))
    np.testing.assert_array_equal(_np(hit), _np(hij))

    clip = np.asarray(batch.clip).astype(np.float64)
    w = clip[..., 3]
    v = np.stack([(clip[..., 0] * 0.5 + w * 0.5) * W,
                  (w * 0.5 - clip[..., 1] * 0.5) * H, w], axis=-1)
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
    dt, tt, table_t, req = TRE.rasterize_exact(_port("TriangleBatch", batch), W, H)
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
    _, ok, (lo, hi) = JR.triangle_coefficients(batch, W, H)
    table = torch.from_numpy(table_j.copy())
    cell_start, cell_groups, n_pairs = TRE.bin_groups(
        torch.from_numpy(np.array(ok)), torch.from_numpy(np.array(lo)),
        torch.from_numpy(np.array(hi)), table.shape[0], W, H)
    assert n_pairs == cell_groups.shape[0] > 0
    # every cell's list ascends (the tie-break order)
    g = _np(cell_groups).astype(np.int64)
    list_start = np.zeros(len(g) + 1, bool)
    list_start[_np(cell_start)] = True
    assert ((np.diff(g) > 0) | list_start[1:-1]).all()
    dt, tt = TRE.rasterize_bins(cell_start, cell_groups,
                                table[:, :16].contiguous(), W, H)
    _compare_raster(dj, tj, dt, tt, depth_rtol=1e-6)


def test_crossz_big_world_scale(monkeypatch):
    """km-scale world: without the power-of-two depth-row normalization the
    cross-multiplied compare overflows f32 (tests/test_raster_quarter.py's
    case). The JAX divide-scheme kernel pins the expected result; far cubes
    come first, so a broken compare would keep them."""
    monkeypatch.setattr(JRE, "INTERPRET", True)
    S = 50000.0
    scene = Scene(use_native=False)
    cube = Model.from_mesh(scene.arena, *make_cube())
    for k in range(6):
        inst = ModelInstance(cube)
        inst.set_transform(pos=(0.0, (5 - k) * 2.0 * S, 0.0),
                           scale=(1.5 * S, 1.5 * S, 1.5 * S))
        scene.add_instance(inst)
    cam = Camera(yfov_deg=60.0, aspect=1.0, near=0.05 * S, far=100.0 * S)
    cam.look_at((0.0, -9.0 * S, 2.0 * S), (0.0, 0.0, 0.0), up=(0, 0, 1))
    batch = _draw_batch(scene, cam)
    d_d, t_d, _, _ = JRE.rasterize_exact(batch, W, H, quarter=True,
                                         crossz=False, overflow_cond=False)
    d_x, t_x, _, _ = TRE.rasterize_exact(_port("TriangleBatch", batch), W, H)
    # the divide scheme quantizes depth to ~2^-16, inside the setup tolerance
    _compare_raster(d_d, t_d, d_x, t_x, depth_rtol=5e-4)


def test_watertight_sphere():
    """A closed sphere rendered front faces only (back faces culled) leaves
    no hole inside its silhouette: shared edges are exact negations, so a
    pixel centre on an edge is always claimed by one of the two triangles.
    The silhouette is the two-sided render, eroded by one pixel."""
    scene = Scene(use_native=False)
    sphere = Model.from_mesh(
        scene.arena, *make_uv_sphere(radius=1.0, rings=40, sectors=56))
    inst = ModelInstance(sphere)
    inst.set_transform(pos=(0.1, 0.2, -0.05), quat=(0.9, 0.3, 0.2, 0.1))
    scene.add_instance(inst)
    cam = Camera(yfov_deg=40.0, aspect=1.0, near=0.1, far=50.0)
    cam.look_at((0.3, -3.5, 0.7), (0.0, 0.0, 0.0), up=(0, 0, 1))
    tb = _port("TriangleBatch", _draw_batch(scene, cam))
    n = tb.capacity
    two_sided = dataclasses.replace(tb, cull=torch.zeros(n, dtype=torch.bool))
    front = dataclasses.replace(tb, cull=torch.ones(n, dtype=torch.bool))
    _, t_all, _, _ = TRE.rasterize_exact(two_sided, W, H)
    _, t_front, _, _ = TRE.rasterize_exact(front, W, H)
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
    reg = MaterialRegistry()
    for a, e, r, m in [((0.9, 0.1, 0.1), (0, 0, 0), 0.35, 0.0),
                       ((1.0, 0.77, 0.34), (0, 0, 0), 0.3, 1.0),
                       ((0.1, 0.1, 0.1), (2.0, 1.2, 0.2), 0.5, 0.0)]:
        reg.register(Material(albedo=a, emissive=e, roughness=r, metallic=m))
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
    depth, tid, attr, _ = TRE.rasterize_exact(_port("TriangleBatch", batch), W, H)
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
