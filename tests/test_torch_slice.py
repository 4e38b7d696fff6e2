"""The PyTorch port's static raster frame end to end, on the CPU.

``RenderPass.render`` of the port's scenes is held to the pinned goldens
with tests/test_golden_images.py's bands (mean |diff| <= 0.004 and at most
0.2% of pixels off by > 0.06; the goldens come from the JAX package's XLA
path, so an exact match is not expected), and to the JAX package's own
render of the same scene (mean |diff| <= 0.004).
"""

import os

import numpy as np
import pytest
import torch

from paperrenderer_tpu_torch import (
    Camera, Material, MaterialRegistry, Model, ModelInstance, RenderPass, Scene,
    make_cube,
)
from paperrenderer_tpu_torch.core import SHADE_TRANSLUCENT
from paperrenderer_tpu_torch.io import read_image, write_png
from paperrenderer_tpu_torch.scenes import (
    build_dynamic_scene, build_example_scene, build_translucent_grid)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDENS = sorted(f[:-4] for f in os.listdir(GOLDEN_DIR) if f.endswith(".png"))


def _bands(img, ref, mean_tol=0.004, frac_tol=0.002, pix_thresh=0.06):
    img = np.asarray(img, np.float32)
    assert img.shape == ref.shape, (img.shape, ref.shape)
    diff = np.abs(img - ref).max(axis=-1)
    assert diff.mean() <= mean_tol, diff.mean()
    assert (diff > pix_thresh).mean() <= frac_tol, (diff > pix_thresh).mean()


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


@pytest.mark.parametrize("case", ["texture"])
def test_unported_paths_raise(case):
    rp, cam = build_example_scene(32, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tex = np.zeros((4, 4, 3), np.uint8)
        rp.materials.register(Material("t", base_texture=tex))


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
