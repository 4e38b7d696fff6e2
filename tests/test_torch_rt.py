"""The PyTorch port's ray-traced frame, ``RayTraceRender.render``, end to end
on the CPU (the plain versions of the traversal kernels).

The 128x128 frame of the RT example scene is held to the pinned golden
``rt_example.png`` with tests/test_golden_images.py's bands (mean |diff| <=
0.004, at most 0.2% of pixels off by > 0.06; the golden comes from the JAX
package's XLA path). 48x32 frames are held to the JAX package's own HDR
images of the same scene, with the default options and with a shadow cull
mask that one instance misses (mean |diff| <= 1e-3): both draw the same
random samples, so only rounding (XLA's FMA contraction) and the rare
sample that it flips across a shadow or AO edge differ.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from paperrenderer_tpu_torch import RenderEngine, Scene
from paperrenderer_tpu_torch.io import read_image
from paperrenderer_tpu_torch.scenes import build_rt_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "rt_example.png")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's tests: the tier-1 run
    puts several pytest workers on the machine's cores, and torch's default
    of one thread per core then oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bands(img, ref, mean_tol=0.004, frac_tol=0.002, pix_thresh=0.06):
    diff = np.abs(np.asarray(img, np.float32) - ref).max(axis=-1)
    assert diff.mean() <= mean_tol, diff.mean()
    assert (diff > pix_thresh).mean() <= frac_tol, (diff > pix_thresh).mean()


def test_rt_frame_golden():
    _, rt, cam = build_rt_scene(128, 128, device="cpu")
    ldr, aux = rt.render(cam)
    assert ldr.shape == (128, 128, 3) and torch.isfinite(aux["hdr"]).all()
    _bands(ldr.numpy(), read_image(GOLDEN).astype(np.float32) / 255.0)


def _masked_shadows(rt):
    """The cube's instance mask leaves shadow rays' cull mask: it casts no
    shadow, and shadows and AO trace as separate passes."""
    rt.set_instance_mask(rt.scene.instances[2], 0x02)


@pytest.fixture(scope="module")
def small_frames():
    """48x32 RT frames in both packages: the defaults, and a shadow cull
    mask (0x01) that one instance's mask (0x02) misses; and the port's
    default frame with the bounce ray fused into the primary bundle."""
    from examples.render_rt import build_rt_scene as build_jax

    jax_hdr, port_hdr = {}, {}
    for case in ("default", "masked_shadows"):
        _, rtj, camj = build_jax(48, 32)
        _, rt, cam = build_rt_scene(48, 32, device="cpu")
        if case == "masked_shadows":
            rtj.shadow_cull_mask = 0x01
            rt.params = dataclasses.replace(rt.params, shadow_cull_mask=0x01)
            _masked_shadows(rtj)
            _masked_shadows(rt)
        jax_hdr[case] = np.asarray(rtj.render(camj)[1]["hdr"])
        port_hdr[case] = rt.render(cam)[1]["hdr"].numpy()
    _, rt, cam = build_rt_scene(48, 32, device="cpu")
    rt.params = dataclasses.replace(rt.params, fuse_bounce=True)
    port_hdr["fuse_bounce"] = rt.render(cam)[1]["hdr"].numpy()
    _, rt, cam = build_rt_scene(48, 32, device="cpu")
    rt.use_pallas = False                       # the XLA route
    port_hdr["xla"] = rt.render(cam)[1]["hdr"].numpy()
    return jax_hdr, port_hdr


@pytest.mark.parametrize("case", ["default", "masked_shadows"])
def test_rt_frame_hdr_matches_jax(small_frames, case):
    """The port's frame against the JAX package's; the default case also
    the XLA route's (use_pallas=False: the plain traversal, one trace per
    sample), which is the JAX package's CPU route too."""
    jax_hdr, port_hdr = small_frames
    assert port_hdr[case].shape == jax_hdr[case].shape == (32, 48, 3)
    assert np.abs(port_hdr[case] - jax_hdr[case]).mean() <= 1e-3
    if case == "default":
        assert port_hdr["xla"].shape == (32, 48, 3)
        assert np.abs(port_hdr["xla"] - jax_hdr[case]).mean() <= 1e-3
    if case == "masked_shadows":   # the cube's shadow is gone
        assert np.abs(port_hdr[case] - port_hdr["default"]).max() > 0.05


def test_fuse_bounce_gives_the_same_frame(small_frames):
    """The fused bundle traces the identical bounce ray (same origin offset,
    direction and samples), so the frame is bit-identical."""
    _, port_hdr = small_frames
    np.testing.assert_array_equal(port_hdr["fuse_bounce"],
                                  port_hdr["default"])


def test_entry_points_default_to_the_card():
    """Scene, RenderEngine and build_rt_scene pick the card unless asked for
    the CPU; none of them touches it before the first frame, and without a
    card that frame fails with a clear error instead of running on the CPU."""
    cuda = torch.device("cuda")
    assert Scene().device == cuda
    assert RenderEngine(device_check=False).device == cuda
    assert RenderEngine(device_check=False).scene.device == cuda
    _, rt, cam = build_rt_scene(32, 32)
    assert rt.device == rt.scene.device == cuda
    assert Scene(device="cpu").device == torch.device("cpu")
    _, rt_cpu, _ = build_rt_scene(32, 32, device="cpu")
    assert rt_cpu.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rt.render(cam)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RenderEngine()


@pytest.mark.parametrize("case", ["animate"])
def test_unported_rt_options_raise(case):
    """``RayTraceRender(animate=, anim_resplit=)``, once refused, is
    accepted and kept (tests/test_torch_anim.py renders with it)."""
    eng = RenderEngine(device="cpu", device_check=False)
    animate = lambda v, t: v   # noqa: E731
    rt = eng.create_ray_trace_render(animate=animate, anim_resplit=True)
    assert rt.animate is animate and rt.anim_resplit is True


def test_kernel_tables_must_be_aligned():
    """The traversal kernels read their scene and resolve tables in 16-byte
    vectors: the wrappers' table check refuses one that does not start
    16-byte aligned (here a view one float into its storage) and takes the
    same rows copied to a fresh tensor."""
    from paperrenderer_tpu_torch.ops import trace_kernel as TK

    cpu = torch.device("cpu")
    rows = torch.zeros(4 * 12 + 1)[1:].view(4, 12)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TK.check_table("nodes", rows, torch.float32, cpu, (4, 12))
    TK.check_table("nodes", rows.clone(), torch.float32, cpu, (4, 12))
