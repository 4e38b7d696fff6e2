"""The PyTorch port's textures against the JAX package, on the CPU.

(a) The atlas: seeded images (a 1x1, a 37 x 21 RGB, a 64 x 64 RGBA with
    alpha >= 128, an f32 grey; sRGB and linear; enough to wrap the shelves)
    through both packages' ``TextureAtlas(width=64)``: ``pairs``, ``rects``
    and ``mip_counts`` bitwise equal.
(b) Each sampler and lod function on the JAX atlas (through
    ``interop.texture_arrays_from_numpy``) at seeded uv outside [0, 1]
    (repeat wrap), ids including -1, integer and fractional lods: within
    2e-6 absolute (XLA contracts the lerps into FMAs, the port does not).
(c) ``shade_gbuffer`` with textures, each ``mip_filter``, and
    ``trace.shade_surfaces`` with textures on one seeded G-buffer and its
    pixels as surface hits: within 1e-5 relative (1e-5 absolute), the
    untextured shade's tolerance. The nearest filter truncates the lod,
    so one ulp of ``log2`` could move a pixel a whole mip: both packages
    get the JAX lod there.
(d) Frames: ``scenes.build_textured_scene`` at 128x128, static and
    draw-list, against ``tests/goldens/textured_example.png`` with
    tests/test_golden_images.py's bands; a two-layer translucent frame
    with a textured glass and a supersample=2 frame of the textured scene
    against the JAX frames at 32x32 with the same bands.
(e) ``tests/test_texture.py``'s textured checker plane through the port's
    RT frame (flat, paged) and hybrid frame (flat, paged) at 32x32: the
    checker quadrants differ as the JAX test checks, the flat RT frame is
    within the RT frames' mean |diff| of 1e-3 of the JAX frame, and each
    paged frame within 1e-3 of the port's flat one.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paperrenderer_tpu import core as JC
from paperrenderer_tpu.core import texture as JTX
from paperrenderer_tpu.ops import raster as JR
from paperrenderer_tpu.ops import shading as JSH
from paperrenderer_tpu.ops import trace as JTR
from paperrenderer_tpu.render import RayTraceRender as JRayTraceRender
from paperrenderer_tpu.render import RenderPass as JRenderPass
from paperrenderer_tpu_torch import core as TC
from paperrenderer_tpu_torch.core import texture as TTX
from paperrenderer_tpu_torch.interop import from_numpy, texture_arrays_from_numpy
from paperrenderer_tpu_torch.io import read_image
from paperrenderer_tpu_torch.ops import raster as TR
from paperrenderer_tpu_torch.ops import shading as TSH
from paperrenderer_tpu_torch.ops import trace as TTR
from paperrenderer_tpu_torch.render import HybridRender, RayTraceRender, RenderPass
from paperrenderer_tpu_torch.scenes import build_textured_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "textured_example.png")
SAMPLER_ATOL = 2e-6
SHADE_TOL = dict(rtol=1e-5, atol=1e-5)


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
    return from_numpy(kind, {f.name: np.asarray(getattr(obj, f.name))
                             for f in dataclasses.fields(obj)
                             if not isinstance(getattr(obj, f.name), tuple)},
                      device="cpu")


def _port_textures(tex_j):
    return texture_arrays_from_numpy(
        {k: np.asarray(getattr(tex_j, k)) for k in ("pairs", "rects",
                                                     "mip_counts")},
        tex_j.width, device="cpu")


def _bands(img, ref, mean_tol=0.004, frac_tol=0.002, pix_thresh=0.06):
    """tests/test_golden_images.py's bands: mean |diff| <= mean_tol and at
    most frac_tol of the pixels off by > pix_thresh (max over channels)."""
    diff = np.abs(_np(img).astype(np.float32)
                  - _np(ref).astype(np.float32)).max(axis=-1)
    assert diff.mean() <= mean_tol, diff.mean()
    assert (diff > pix_thresh).mean() <= frac_tol, (diff > pix_thresh).mean()


def _images(seed=3):
    """(image, srgb) pairs: the atlas test's and the shade test's textures."""
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (64, 64, 4)).astype(np.uint8)
    rgba[..., 3] = rng.integers(128, 256, (64, 64))       # negative words
    return [
        (rng.integers(0, 256, (1, 1, 3)).astype(np.uint8), True),
        (rng.integers(0, 256, (21, 37, 3)).astype(np.uint8), True),
        (rgba, False),
        (rng.random((16, 24)).astype(np.float32), False),  # f32 grey
        (rng.integers(0, 256, (32, 32, 3)).astype(np.uint8), True),
        (rng.integers(0, 256, (5, 64, 3)).astype(np.uint8), False),
        (rng.integers(0, 256, (8, 8, 4)).astype(np.uint8), True),
    ]


@pytest.fixture(scope="module")
def atlases():
    """The same images through both packages' atlases."""
    ja, ta = JTX.TextureAtlas(width=64), TTX.TextureAtlas(width=64)
    for img, srgb in _images():
        assert ja.add(img, srgb=srgb) == ta.add(img, srgb=srgb)
    return ja.device_arrays(), ta.device_arrays("cpu")


def test_atlas_bitwise(atlases):
    tex_j, tex_t = atlases
    assert tex_t.width == tex_j.width == 64
    assert tex_t.pairs.shape[0] > 64 * 64          # the shelves wrapped
    assert (_np(tex_t.pairs) < 0).any()            # alpha >= 128 words
    for name in ("pairs", "rects", "mip_counts"):
        got, want = _np(getattr(tex_t, name)), np.asarray(getattr(tex_j, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), name
    assert int(tex_t.mip_counts[0]) == 1           # the 1x1 texture
    assert tex_t.nbytes == sum(np.asarray(getattr(tex_j, k)).nbytes
                               for k in ("pairs", "rects", "mip_counts"))


def _lod(rng, shape):
    """Integer lods, fractional lods and lods past both ends of the chain."""
    lod = rng.uniform(-0.5, 8.5, shape).astype(np.float32)
    whole = rng.random(shape) < 0.3
    lod[whole] = np.round(lod[whole])
    return lod


@pytest.mark.parametrize("fn", ["bilinear", "bilinear_lod", "trilinear",
                                "aniso2", "uv_screen_lod",
                                "uv_screen_lod_aniso"])
def test_samplers_match_jax(atlases, fn):
    tex_j = atlases[0]
    tex_t = _port_textures(tex_j)
    rng = np.random.default_rng(11)
    h, w = 24, 20
    ids = rng.integers(-1, tex_j.count, (h, w)).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (h, w, 2)).astype(np.float32)
    lod = _lod(rng, (h, w))
    if fn.startswith("uv_screen"):
        # a smooth oblique uv image whose footprint grows down the rows
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        s = 2.0 ** (yy / 3.0) / 64.0
        uv = np.stack([xx * s + 0.3 * yy * s, yy * s * 0.25], -1)
        uv = (uv + rng.uniform(-1, 1, 2)).astype(np.float32)
        ext = rng.choice([1.0, 8.0, 37.0, 64.0], (2, h, w)).astype(np.float32)
        args = (uv, ext[0], ext[1])
        jfn, tfn = getattr(JTX, fn), getattr(TTX, fn)
        want = jfn(*(jnp.asarray(a) for a in args))
        got = tfn(*(torch.from_numpy(a) for a in args))
        if fn == "uv_screen_lod":
            want, got = (want,), (got,)
        for g, wv in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(wv), rtol=0,
                                       atol=SAMPLER_ATOL)
        lod_t = _np(got[0])
        assert lod_t.min() < 1.0 < 3.0 < lod_t.max() <= 7.0
        return
    duv = rng.uniform(-0.05, 0.05, (h, w, 2)).astype(np.float32)
    calls = {
        "bilinear": ("sample_bilinear", (ids, uv)),
        "bilinear_lod": ("sample_bilinear", (ids, uv, lod)),
        "trilinear": ("sample_trilinear", (ids, uv, lod)),
        "aniso2": ("sample_aniso2", (ids, uv, lod, duv)),
    }
    name, args = calls[fn]
    want = getattr(JTX, name)(tex_j, *(jnp.asarray(a) for a in args))
    got = getattr(TTX, name)(tex_t, *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=SAMPLER_ATOL)
    assert (_np(got)[ids < 0] == 1.0).all()


@pytest.fixture(scope="module")
def shade_inputs():
    """One seeded 32x32 G-buffer over five materials (untextured; base;
    base + mr + occlusion; emissive; all four) with both packages' tables,
    atlases and lights. The port's registry is held to the JAX one's id
    columns and atlas on the way."""
    imgs = [img for img, _ in _images(7)]
    specs = [dict(),
             dict(base_texture=imgs[1]),
             dict(base_texture=imgs[4], mr_texture=imgs[2],
                  occlusion_texture=imgs[3], metallic=0.7),
             dict(emissive_texture=imgs[6], emissive=(0.2, 0.1, 0.0)),
             dict(base_texture=imgs[2], emissive_texture=imgs[0],
                  mr_texture=imgs[5], occlusion_texture=imgs[4])]
    regs = {}
    for pkg in (JC, TC):
        reg = regs[pkg] = pkg.MaterialRegistry()
        for k, spec in enumerate(specs):
            reg.register(pkg.Material(f"m{k}", albedo=(0.8, 0.6, 0.4),
                                      roughness=0.6, **spec))
    table_j, table_t = regs[JC].table(), regs[TC].table("cpu")
    for col in ("base_tex", "emissive_tex", "mr_tex", "occ_tex"):
        assert np.array_equal(_np(getattr(table_t, col)),
                              np.asarray(getattr(table_j, col))), col
    tex_j = regs[JC].texture_arrays()
    own = regs[TC].texture_arrays("cpu")
    assert np.array_equal(_np(own.pairs), np.asarray(tex_j.pairs))

    rng = np.random.default_rng(5)
    h = w = 32
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    s = 2.0 ** (yy / 5.0) / 48.0                 # lod ~0 at the top, ~6 below
    uv = np.stack([xx * s + 0.5 * yy * s, yy * s * 0.3 + 0.1 * xx * s], -1)
    normal = np.concatenate([rng.normal(0, 0.2, (h, w, 2)),
                             np.ones((h, w, 1))], -1)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    gbuf = dict(
        depth=rng.uniform(0.1, 0.9, (h, w)).astype(np.float32),
        tri_id=np.where(rng.random((h, w)) < 0.1, -1, 1).astype(np.int32),
        world_pos=np.stack([xx * 0.1 - 1.6, yy * 0.1, rng.uniform(
            0, 0.1, (h, w))], -1).astype(np.float32),
        normal=normal.astype(np.float32),
        uv=(uv + 0.37).astype(np.float32),
        material=rng.integers(0, len(specs) + 1, (h, w)).astype(np.int32))
    lights_j = JSH.Lights.make(
        [{"position": (2.0, -3.0, 4.0), "color": (30.0, 28.0, 25.0),
          "bounds": 40.0},
         {"position": (-3.0, 2.0, 3.0), "color": (8.0, 9.0, 12.0),
          "bounds": 20.0}], ambient=(0.6, 0.7, 1.0, 0.3))
    return dict(gbuf=gbuf, table_j=table_j, table_t=table_t,
                tex_j=tex_j, tex_t=_port_textures(tex_j),
                lights_j=lights_j, lights_t=_port("Lights", lights_j),
                cam=np.asarray([0.3, -3.0, 4.0], np.float32))


@pytest.mark.parametrize("case", ["nearest", "linear", "aniso2",
                                  "shade_surfaces"])
def test_textured_shading_matches_jax(shade_inputs, case, monkeypatch):
    inp = shade_inputs
    g = inp["gbuf"]
    if case == "shade_surfaces":
        rng = np.random.default_rng(9)
        n = g["tri_id"].size
        flat = dict(world_pos=g["world_pos"].reshape(-1, 3),
                    normal=g["normal"].reshape(-1, 3),
                    uv=g["uv"].reshape(-1, 2),
                    material=g["material"].reshape(-1),
                    valid=g["tri_id"].reshape(-1) >= 0,
                    t=g["depth"].reshape(-1))
        svis = rng.random((2, n)).astype(np.float32)
        ao = rng.random(n).astype(np.float32)
        want = JTR.shade_surfaces(
            JTR.SurfaceHits(**{k: jnp.asarray(v) for k, v in flat.items()}),
            inp["table_j"], inp["lights_j"], jnp.asarray(inp["cam"]),
            jnp.asarray(svis), jnp.asarray(ao), inp["tex_j"])
        got = TTR.shade_surfaces(
            TTR.SurfaceHits(**{k: torch.from_numpy(v)
                               for k, v in flat.items()}),
            inp["table_t"], inp["lights_t"], torch.from_numpy(inp["cam"]),
            torch.from_numpy(svis), torch.from_numpy(ao), inp["tex_t"])
        untextured = TTR.shade_surfaces(
            TTR.SurfaceHits(**{k: torch.from_numpy(v)
                               for k, v in flat.items()}),
            inp["table_t"], inp["lights_t"], torch.from_numpy(inp["cam"]),
            torch.from_numpy(svis), torch.from_numpy(ao))
    else:
        gj = JR.GBuffer(**{k: jnp.asarray(v) for k, v in g.items()})
        gt = TR.GBuffer(**{k: torch.from_numpy(v) for k, v in g.items()})
        if case == "nearest":
            # one lod for both: truncation is discontinuous in the lod
            lod = JTX.uv_screen_lod(gj.uv, *jnp.moveaxis(
                inp["tex_j"].rects[:, 0, 2:4][jnp.clip(
                    inp["table_j"].base_tex[gj.material], 0,
                    inp["tex_j"].count - 1)], -1, 0))
            monkeypatch.setattr(JTX, "uv_screen_lod", lambda *a: lod)
            monkeypatch.setattr(TTX, "uv_screen_lod",
                                lambda *a: torch.from_numpy(np.array(lod)))
            assert len(np.unique(np.floor(np.asarray(lod)))) >= 4
        kw = dict(ambient_occlusion=np.random.default_rng(2).random(
            (32, 32)).astype(np.float32), background=(0.1, 0.2, 0.3))
        want = JSH.shade_gbuffer(
            gj, inp["table_j"], inp["lights_j"], jnp.asarray(inp["cam"]),
            ambient_occlusion=jnp.asarray(kw["ambient_occlusion"]),
            background=kw["background"], textures=inp["tex_j"],
            mip_filter=case)
        got = TSH.shade_gbuffer(
            gt, inp["table_t"], inp["lights_t"], torch.from_numpy(inp["cam"]),
            ambient_occlusion=torch.from_numpy(kw["ambient_occlusion"]),
            background=kw["background"], textures=inp["tex_t"],
            mip_filter=case)
        untextured = TSH.shade_gbuffer(
            gt, inp["table_t"], inp["lights_t"], torch.from_numpy(inp["cam"]),
            ambient_occlusion=torch.from_numpy(kw["ambient_occlusion"]),
            background=kw["background"])
    np.testing.assert_allclose(_np(got), np.asarray(want), **SHADE_TOL)
    # the textures changed the image where a textured material is shaded
    textured = np.isin(g["material"], [2, 3, 4, 5]) & (g["tri_id"] >= 0)
    moved = (np.abs(_np(got) - _np(untextured)).max(axis=-1) > 1e-3
             ).reshape(textured.shape)
    assert moved[textured].mean() > 0.9 and not moved[~textured].any()


def _glass_scene(pkg, ss=1):
    """A textured opaque panel behind a textured 50% glass panel (two peel
    layers), or with ``ss`` the textured example at 32x32 supersampled."""
    if ss > 1:
        if pkg is JC:
            from examples.render_textured import build_textured_scene as b
            _, _, rp, cam = b(32, 32)
        else:
            _, _, rp, cam = build_textured_scene(32, 32, device="cpu")
        rp.supersample = ss
        return rp.render(cam)
    rng = np.random.default_rng(4)
    checker = np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((8, 8, 1))).astype(np.uint8)
    stripes = np.zeros((16, 16, 4), np.uint8)
    stripes[::2] = (255, 40, 40, 255)
    stripes[1::2] = (40, 40, 255, 255)
    kw = {} if pkg is JC else {"device": "cpu"}
    scene, reg = pkg.Scene(**kw), pkg.MaterialRegistry()
    panel = pkg.Model.from_mesh(scene.arena, *pkg.make_plane(size=2.0))
    rp = (JRenderPass if pkg is JC else RenderPass)(
        scene, reg, width=32, height=32, translucent_layers=2,
        lights=(JSH if pkg is JC else TSH).Lights.make(
            [{"position": (1.0, 1.0, 5.0), "color": (20.0, 20.0, 20.0),
              "bounds": 30.0}], ambient=(1.0, 1.0, 1.0, 0.3)))
    for z, mat in ((0.0, pkg.Material("back", roughness=0.9,
                                      base_texture=checker)),
                   (1.0, pkg.Material("glass", alpha=0.5, roughness=0.2,
                                      base_texture=stripes,
                                      shading_model=pkg.SHADE_TRANSLUCENT))):
        inst = pkg.ModelInstance(panel)
        inst.set_transform(pos=(0.0, 0.0, z))
        rp.add_instance(inst, {0: mat.instance()})
    cam = pkg.Camera(yfov_deg=60.0, aspect=1.0, near=0.1, far=100.0)
    cam.look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0), up=(0, 1, 0))
    return rp.render(cam)


@pytest.mark.parametrize("case", ["golden_static", "golden_draw_list",
                                  "translucent_vs_jax", "supersample_vs_jax"])
def test_textured_frames(case):
    if case.startswith("golden"):
        _, reg, rp, cam = build_textured_scene(128, 128, device="cpu")
        ldr, aux = rp.render(cam, static_path=case == "golden_static")
        golden = read_image(GOLDEN).astype(np.float32) / 255.0
        _bands(ldr, golden)
        assert rp._cached_textures is reg.texture_arrays("cpu")
        assert reg.has_textures and reg.textures.count == 4
        return
    ss = 2 if case == "supersample_vs_jax" else 1
    ldr_t, aux_t = _glass_scene(TC, ss)
    ldr_j, aux_j = _glass_scene(JC, ss)
    assert ldr_t.shape == (32, 32, 3) and torch.isfinite(ldr_t).all()
    _bands(ldr_t, ldr_j)
    if ss == 1:   # the glass's red and blue stripes show over the panel
        img = _np(ldr_t)
        rows = img[8:24, 16]
        assert np.abs(np.diff(rows[:, 0] - rows[:, 2])).max() > 0.1


def _checker(n=8, c0=(255, 0, 0), c1=(0, 255, 0)):
    img = np.zeros((n, n, 3), np.uint8)
    img[...] = c0
    ii, jj = np.meshgrid(range(n), range(n), indexing="ij")
    img[(ii // (n // 2) + jj // (n // 2)) % 2 == 1] = c1
    return img


def _plane_frame(pkg, kind, tex):
    """tests/test_texture.py's textured plane at 32x32 (ambient light only,
    no shadow, AO or reflection samples) through ``kind``."""
    kw = {} if pkg is JC else {"device": "cpu"}
    scene, reg = pkg.Scene(**kw), pkg.MaterialRegistry()
    plane = pkg.Model.from_mesh(scene.arena, *pkg.make_plane(size=2.0))
    mat = pkg.Material("textured", albedo=(1, 1, 1), roughness=1.0,
                       base_texture=tex)
    lights = (JSH if pkg is JC else TSH).Lights.make(
        [], ambient=(1, 1, 1, 1.0))
    cls = (JRayTraceRender if pkg is JC else
           {"rt": RayTraceRender, "hybrid": HybridRender}[kind])
    r = cls(scene, reg, width=32, height=32, lights=lights, shadow_samples=0,
            reflection_samples=0, ao_samples=0)
    r.add_instance(pkg.ModelInstance(plane), {0: mat.instance()})
    cam = pkg.Camera(yfov_deg=45.0, aspect=1.0, near=0.1, far=50.0)
    cam.look_at((0.0, 0.0, 2.5), (0.0, 0.0, 0.0), up=(0, 1, 0))
    return r, cam


@pytest.mark.parametrize("case", ["rt_flat", "rt_paged", "hybrid_flat",
                                  "hybrid_paged"])
def test_textured_plane_rt_and_hybrid(case):
    tex = _checker()
    kind, layout = case.split("_")
    r, cam = _plane_frame(TC, kind, tex)
    ldr, aux = r.render(cam, paged=layout == "paged")
    img = _np(ldr)
    assert np.isfinite(img).all()
    a, b = img[8, 8], img[8, 24]                 # opposite checker quadrants
    assert abs(float(a[0]) - float(b[0])) > 0.2
    assert abs(float(a[1]) - float(b[1])) > 0.2
    if kind == "hybrid":
        assert aux["paged"] == (layout == "paged")
    if case == "rt_flat":
        rj, camj = _plane_frame(JC, "rt", tex)
        ldr_j, _ = rj.render(camj)
        diff = np.abs(img - np.asarray(ldr_j)).max(axis=-1)
        assert diff.mean() <= 1e-3, diff.mean()
    elif layout == "paged":   # the same texels on both layouts
        rf, camf = _plane_frame(TC, kind, tex)
        flat = _np(rf.render(camf, paged=False)[0])
        diff = np.abs(img - flat).max(axis=-1)
        assert diff.mean() <= 1e-3, diff.mean()
