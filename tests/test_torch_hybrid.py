"""The PyTorch port's hybrid frame, ``HybridRender.render``, on the CPU:
the raster G-buffer through K1's plain version, the RT passes through the
traversal kernels' plain versions on either layout.

The 128x128 frame of the hybrid example is held to ``hybrid_example.png``
with tests/test_golden_images.py's bands (mean |diff| <= 0.004, at most
0.2% of pixels off by > 0.06). 48x32 frames are held to the JAX package's
``make_hybrid_frame`` on both layouts (``paged=True, use_pallas_trace=False``
on the CPU) with the raster tests' tolerance (tests/test_torch_slice.py),
a mean per-pixel |diff| <= 0.004 on the LDR image: the JAX package
rasterizes its G-buffer through XLA on the CPU, the port through K1's
plain version, so a depth tie on a shared edge can pick the other
triangle, and with it the origin of that pixel's shadow, AO and reflection
samples. Both draw the same random samples.
"""

import os

import numpy as np
import pytest
import torch

from paperrenderer_tpu_torch import RenderEngine
from paperrenderer_tpu_torch.io import read_image
from paperrenderer_tpu_torch.scenes import build_hybrid_scene, build_rt_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "hybrid_example.png")


def _bands(img, ref, mean_tol=0.004, frac_tol=0.002, pix_thresh=0.06):
    diff = np.abs(np.asarray(img, np.float32) - ref).max(axis=-1)
    assert diff.mean() <= mean_tol, diff.mean()
    assert (diff > pix_thresh).mean() <= frac_tol, (diff > pix_thresh).mean()


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
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_hybrid_frame_matches_jax(frames, paged):
    diff = np.abs(frames["port", paged] - frames["jax", paged]).max(axis=-1)
    assert diff.mean() <= 0.004, diff.mean()


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
    eng = RenderEngine(device="cpu", device_check=False)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        eng.create_hybrid_render(animate=lambda v, t: v)


@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_use_pallas_keyword(use_pallas):
    """``use_pallas`` as the JAX constructors take it: None or True runs
    the port's kernels, False (the XLA route) is refused."""
    from paperrenderer_tpu_torch import HybridRender, RayTraceRender, RenderPass

    eng = RenderEngine(device="cpu", device_check=False)
    for cls in (RenderPass, RayTraceRender, HybridRender):
        if use_pallas is False:
            with pytest.raises(NotImplementedError,
                               match="ROADMAP Queue 1 item 8"):
                cls(eng.scene, eng.materials, use_pallas=use_pallas)
        else:
            assert cls(eng.scene, eng.materials, width=8,
                       use_pallas=use_pallas).width == 8


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
