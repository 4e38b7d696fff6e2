"""Parity of the port's keyed raster, leaf cutout, sorted translucency and
supersampling with the JAX package, on the CPU.

The JAX side runs its Pallas rasterizer in interpreter mode (as
tests/test_raster_quarter.py does); the port runs the plain PyTorch version
of its CUDA kernels, which is what a CPU tensor selects. The triangles,
materials, opaque image and camera are made from a numpy seed and handed to
both packages, to the port through ``paperrenderer_tpu_torch.interop``.

Tolerances:
  * the keyed rasterizers (K3: ``crossz=False``, K4: ``quarter=False``, K2
    and K4's peel form: a peel window) fed the JAX package's own coefficient
    table: the same
    coverage, the same depth (it is the key), and tid equal except where
    keys tie (each kernel breaks ties by its own visiting order);
  * end to end (each package's own table): tests/test_torch_raster.py's
    bands, coverage differing on <= 0.05% of pixels and depth within 5e-4
    relative (XLA contracts the setup's products into FMAs);
  * ``leaf_alpha``: equal;
  * ``composite_translucency`` against the JAX exact peel: atol 2e-3, the
    tolerance of tests/test_translucency.py;
  * RenderPass frames of tests/test_translucency.py and tests/test_leaf.py
    against the JAX package's (whose CPU frame runs the XLA rasterizer and
    the XLA peel): mean |diff| <= 0.004 with <= 0.2% of pixels off by
    > 0.06, the golden bands; supersample=2 against
    tests/goldens/raster_supersample2.png with the same bands.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paperrenderer_tpu import core as J
from paperrenderer_tpu.ops import raster as JR
from paperrenderer_tpu.ops import raster_exact as JRE
from paperrenderer_tpu.ops import shading as JSH
from paperrenderer_tpu.ops import translucency as JTL
from paperrenderer_tpu.render import RenderPass as JRenderPass
from paperrenderer_tpu_torch import core as T
from paperrenderer_tpu_torch.interop import from_numpy
from paperrenderer_tpu_torch.io import read_image
from paperrenderer_tpu_torch.ops import raster_exact as TRE
from paperrenderer_tpu_torch.ops import shading as TSH
from paperrenderer_tpu_torch.ops import translucency as TTL
from paperrenderer_tpu_torch.render import RenderPass
from paperrenderer_tpu_torch.scenes import build_example_scene

W, H = 128, 64
N_TRI = 300
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(kind, obj):
    """The JAX dataclass ``obj`` as the port's ``kind`` (CPU tensors)."""
    arrays = {f.name: np.asarray(getattr(obj, f.name))
              for f in dataclasses.fields(obj)
              if getattr(obj, f.name) is not None
              and not isinstance(getattr(obj, f.name), tuple)}
    return from_numpy(kind, arrays, device="cpu")


def _keys(depth):
    return _np(depth).view(np.int32) & np.int32(TRE.KEY_MASK)


def _bands(img, ref, mean_tol=0.004, frac_tol=0.002, pix_thresh=0.06):
    diff = np.abs(_np(img).astype(np.float32) - _np(ref).astype(np.float32))
    diff = diff.max(axis=-1)
    assert diff.mean() <= mean_tol, diff.mean()
    assert (diff > pix_thresh).mean() <= frac_tol, (diff > pix_thresh).mean()


@pytest.fixture(scope="module")
def triangles():
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
    reg = J.MaterialRegistry()
    for m in (J.Material("white", albedo=(0.9, 0.9, 0.9), roughness=0.8),
              J.Material("red-glass", albedo=(0.2, 0.0, 0.0),
                         emissive=(1.0, 0.0, 0.0), alpha=0.5,
                         shading_model=J.SHADE_TRANSLUCENT),
              J.Material("green-glass", albedo=(0.0, 0.3, 0.0),
                         emissive=(0.0, 0.8, 0.2), alpha=0.7,
                         shading_model=J.SHADE_TRANSLUCENT),
              J.Material("leaf", albedo=(0.2, 0.6, 0.1),
                         shading_model=J.SHADE_LEAF)):
        reg.register(m)
    return reg.table()


@pytest.fixture(scope="module")
def jax_keyed(triangles):
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
    cam = J.Camera(yfov_deg=60.0, aspect=W / H, near=0.1, far=100.0)
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
            out[case] = (triangles, None, tuple(
                np.asarray(v) for v in run(triangles, W, H, **kw)[:3]))
        composite, _ = JTL.composite_translucency(
            jnp.asarray(hdr), jnp.asarray(depth), triangles,
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
def test_keyed_end_to_end(case, triangles, jax_keyed):
    """The port's rasterize_exact on its own coefficient table."""
    dj, tj, table_j = jax_keyed[0][case][2]
    opts = dict(crossz=False) if case == "k3" else dict(quarter=False)
    dt, tt, table_t, req = TRE.rasterize_exact(
        _port("TriangleBatch", triangles), W, H, **opts)
    dt, tt = _np(dt), _np(tt)
    cov_j, cov_t = tj >= 0, tt >= 0
    assert (cov_j != cov_t).mean() <= 5e-4
    both = cov_j & cov_t
    rel = np.abs(dt[both] - dj[both]) / np.abs(dj[both])
    assert rel.max() <= 5e-4, rel.max()
    assert req > 0
    np.testing.assert_array_equal(_np(table_t)[:, 16:], table_j[:, 16:])


def test_leaf_alpha_matches():
    """tests/test_leaf.py's four uvs: lens centre, beyond the half-width,
    the u edge, and inside the narrower lens at u = 0.25."""
    uv = np.asarray([[0.5, 0.5], [0.5, 0.75], [0.0, 0.5], [0.25, 0.55]],
                    np.float32)
    want = np.asarray(JSH.leaf_alpha(jnp.asarray(uv)))
    got = _np(TSH.leaf_alpha(torch.from_numpy(uv)))
    assert want.tolist() == [1.0, 0.0, 0.0, 1.0]
    np.testing.assert_array_equal(got, want)


def test_composite_matches_jax_exact_peel(triangles, jax_keyed):
    """Two peel layers and the back-to-front blend over the seeded opaque
    image: the JAX package's exact peel against the port's."""
    _, want, inp = jax_keyed
    got, req = TTL.composite_translucency(
        torch.from_numpy(inp["hdr"]), torch.from_numpy(inp["depth"]),
        _port("TriangleBatch", triangles), _port("MaterialTable", inp["materials"]),
        _port("Lights", inp["lights"]), _port("CameraMatrices", inp["camera"]),
        layers=2)
    assert req > 0
    assert np.abs(_np(got) - inp["hdr"]).max() > 0.1      # the layers show
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-3)


def _panel_frames(pkg, case):
    """The frames of tests/test_translucency.py and tests/test_leaf.py, all
    at 32x32 with two layers, built through package ``pkg`` (J or T)."""
    kw = {} if pkg is J else {"device": "cpu"}
    scene, reg = pkg.Scene(**kw), pkg.MaterialRegistry()
    panel = pkg.Model.from_mesh(scene.arena, *pkg.make_plane(size=2.0))
    rp = (JRenderPass if pkg is J else RenderPass)(
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
    ldr_t, aux_t = _panel_frames(T, case)
    ldr_j, aux_j = _panel_frames(J, case)
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
