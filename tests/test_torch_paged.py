"""The PyTorch port's big-scene path against the JAX package, on the CPU:
BLAS chunking, the paged layout (``assemble_scene_paged``,
``paged_to_flat``), the plain versions of the paged traversal kernels K10
and K11, and the paged RT frame.

Two scenes, built through each package's API from the same seeds: the
600-instance crowd of ``examples/render_crowd.py`` (capacity 640, so 4 TLAS
chunks) and the big-model scene of ``tests/test_trace_paged.py`` (a
4,160-triangle sphere, 520 leaf rows cut into 4 BLAS chunks, among 16
cubes). The JAX side runs its CPU route for a paged scene: the flat view
(``paged_to_flat``) walked by its XLA ``trace_scene``.

Tolerances (those of tests/test_torch_parity.py's ray-tracing section):
the host-built BLAS tables and every integer table exactly; the per-frame
float rows (instance matrices, chunk and root boxes) at 1e-6 relative,
since XLA contracts ``transform_aabb``'s einsums into FMAs and the port
does not. Hit flags
exactly, t at 1e-5 relative, triangle and instance ids equal unless the two
t tie within that. The paged HDR frame within a mean |diff| of 1e-3 of the
JAX package's; the 128x128 frame within ``crowd_paged.png``'s golden bands.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paperrenderer_tpu.ops import accel as JA
from paperrenderer_tpu_torch.interop import from_numpy
from paperrenderer_tpu_torch.io import read_image
from paperrenderer_tpu_torch.ops import accel as TA
from paperrenderer_tpu_torch.ops import trace_kernel as TK
from paperrenderer_tpu_torch.ops import trace_paged as TP
from paperrenderer_tpu_torch.scenes import (
    build_big_model_scene, build_crowd_scene)

W = H = 32
T_REL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "crowd_paged.png")
PAGED_FIELDS = ("static_nodes", "static_codes", "chunk_boxes", "chunk_codes",
                "chunk_smat", "leaf_rows", "leaf_prim", "inv_rows", "tri_attr",
                "bch_nodes", "bch_codes", "bch_lpos", "bch_lprim", "bch_luv")
BCH_FIELDS = ("bch_nodes", "bch_codes", "bch_lpos", "bch_lprim", "bch_luv")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's tests: the tier-1 run
    puts several pytest workers on the machine's cores, and torch's default
    of one thread per core then oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_big_model_scene():
    """``scenes.build_big_model_scene()`` through the JAX package's API."""
    from paperrenderer_tpu.core import (
        Camera, Material, MaterialRegistry, Model, ModelInstance, Scene,
        make_cube, make_uv_sphere)
    from paperrenderer_tpu.render import RayTraceRender

    rng = np.random.default_rng(7)
    scene = Scene()
    rt = RayTraceRender(scene, MaterialRegistry(), width=W, height=H,
                        use_pallas=False)
    big = Model.from_mesh(scene.arena, *make_uv_sphere(radius=1.2, rings=40,
                                                       sectors=52))
    cube = Model.from_mesh(scene.arena, *make_cube(size=0.7))
    red = Material("red", albedo=(0.8, 0.2, 0.2), roughness=0.5)
    blue = Material("blue", albedo=(0.2, 0.2, 0.8), roughness=0.5)
    for i in range(24):
        m = ModelInstance(big if i % 3 == 0 else cube)
        m.set_transform(pos=tuple(rng.uniform(-6.0, 6.0, 3)))
        rt.add_instance(m, {0: (red if i % 2 else blue).instance()})
    cam = Camera(yfov_deg=60.0, aspect=1.0, near=0.1, far=1000.0)
    cam.look_at((0.0, -16.0, 7.0), (0, 0, 0), up=(0, 0, 1))
    return rt, cam


def _both(name):
    if name == "crowd":
        from examples.render_crowd import build_crowd_scene as build_jax

        return (build_jax(600, W, H)[2:],
                build_crowd_scene(600, W, H, device="cpu")[2:])
    return _jax_big_model_scene(), build_big_model_scene(device="cpu")[1:]


@pytest.fixture(scope="module", params=["crowd", "big_model"])
def scenes(request):
    """One scene in both packages: the JAX BLASSet and PagedScene, the
    port's own, and the JAX PagedScene handed to the port."""
    (rtj, camj), (rtt, camt) = _both(request.param)
    inst_j = rtj.scene.flush()
    cap = inst_j.capacity
    bj, mj, ar, an = rtj.accel.blas()
    slots_j, masks_j, table_j = rtj._device_inputs(cap)
    imask_j, opq_j = rtj._cached_inst_mask
    pj, root_j = jax.jit(   # ~4x faster than op by op on the CPU
        lambda b, ar, an, i, ib, m, s, t, im, io: JA.assemble_scene_paged(
            b, mj, ar, an, i, ib, m, s, t, inst_mask=im, inst_opaque=io))(
        bj, ar, an, inst_j, rtj.accel.inst_blas(cap), masks_j[0], slots_j,
        rtj.accel.tri_attr(), imask_j, opq_j)
    root_j = int(root_j)

    inst_t = rtt.scene.flush()
    bt, mt, ar_t, an_t = rtt.accel.blas()
    slots_t, masks_t, table_t, imask_t, opq_t, _, _ = rtt._device_inputs(cap)
    pt, root_t = TA.assemble_scene_paged(
        bt, mt, ar_t, an_t, inst_t, rtt.accel.inst_blas(cap), masks_t[0],
        slots_t,
        rtt.accel.tri_attr(), inst_mask=imask_t, inst_opaque=opq_t)
    port_of_jax = from_numpy("PagedScene", {f: np.asarray(getattr(pj, f))
                                            for f in PAGED_FIELDS},
                             device="cpu")
    return dict(name=request.param, rtj=rtj, camj=camj, rtt=rtt, camt=camt,
                bj=bj, mj=mj, bt=bt, mt=mt, pj=pj, root_j=root_j, pt=pt,
                root_t=root_t, scene=port_of_jax, slots=np.asarray(slots_j),
                table_j=table_j, cap=cap, stack=rtj.accel.stack_size(cap))


@pytest.fixture(scope="module")
def rays(scenes):
    """The camera's primary rays and random rays from inside the scene's
    box, with per-ray caps and an active mask."""
    from paperrenderer_tpu.ops.trace import pick_tile, raygen

    o, d = raygen(scenes["camj"].matrices, W, H, tile_order=pick_tile(W, H))
    rng = np.random.default_rng(5)
    n = 512
    ro = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    o = np.concatenate([np.asarray(o), ro]).astype(np.float32)
    d = np.concatenate([np.asarray(d), rd]).astype(np.float32)
    t = np.concatenate([np.full(W * H, 1000.0),
                        rng.uniform(0.5, 8.0, n)]).astype(np.float32)
    active = rng.uniform(size=o.shape[0]) > 0.1
    return o, d, t, active


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def test_blas_meta_and_layout_choice(scenes):
    """The chunk count, the meta counts, the layout choice and the stack
    bound are the JAX package's."""
    mj, mt, cap = scenes["mj"], scenes["mt"], scenes["cap"]
    for f in ("max_depth", "num_static_nodes", "num_static_leaves",
              "num_bchunks", "total_nodes"):
        assert getattr(mt, f) == getattr(mj, f), f
    if scenes["name"] == "big_model":
        assert mt.num_bchunks == 4
    n_slots = max(1, scenes["rtt"].scene.max_slots)
    assert TA.prefer_paged(mt, cap, n_slots) == JA.prefer_paged(mj, cap,
                                                                n_slots)
    assert scenes["rtt"].accel.stack_size(cap) == scenes["stack"]


@pytest.mark.parametrize("field", ("nodes", "codes", "leaf_rows", "leaf_prim",
                                   "root_min", "root_max", "root_code")
                         + BCH_FIELDS)
def test_blas_set_equal(scenes, field):
    np.testing.assert_array_equal(getattr(scenes["bt"], field).numpy(),
                                  np.asarray(getattr(scenes["bj"], field)))


@pytest.mark.parametrize("field", PAGED_FIELDS)
def test_assemble_scene_paged_equal(scenes, field):
    got = getattr(scenes["pt"], field).numpy()
    want = np.asarray(getattr(scenes["pj"], field))
    assert scenes["root_t"] == scenes["root_j"]
    if field in ("static_nodes", "chunk_boxes", "inv_rows"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    if field == "chunk_boxes":   # several TLAS chunks in the crowd
        assert got.size // (TA.BROWS * 12) == (
            4 if scenes["name"] == "crowd" else 1)


def test_paged_to_flat_equal(scenes):
    """The flat view of the JAX PagedScene, in both packages."""
    got, remap_t = TA.paged_to_flat(scenes["scene"])
    want, remap_j = JA.paged_to_flat(scenes["pj"])
    assert remap_t(scenes["root_j"]) == remap_j(scenes["root_j"])
    for f in ("nodes", "codes", "leaf_rows", "leaf_prim", "inv_rows",
              "tri_attr"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


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


def _tracers(scenes):
    jt = JA.PagedSceneTracer(scenes["pj"], jnp.asarray(scenes["slots"]),
                             scenes["table_j"], root_code=scenes["root_j"],
                             stack_size=scenes["stack"], use_pallas=False)
    tt = TA.PagedSceneTracer(scenes["scene"], _t(scenes["slots"]), None,
                             root_code=scenes["root_j"],
                             stack_size=scenes["stack"])
    return jt, tt


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_k10_matches_jax_paged_tracer(scenes, rays, any_hit):
    o, d, t, active = rays
    jt, tt = _tracers(scenes)
    want = jax.jit(lambda o, d, t, a: jt.trace(o, d, t, any_hit=any_hit,
                                               active=a))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(active))
    got = tt.trace(_t(o), _t(d), _t(t), any_hit=any_hit, active=_t(active))
    if any_hit:
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    else:
        _assert_hits_match(got, want, active)
    assert 0.05 < got.hit.numpy().mean() < 0.95


def test_plain_k11_matches_jax_paged_tracer(scenes, rays):
    o, d, t, active = rays
    jt, tt = _tracers(scenes)
    want = jax.jit(lambda o, d, t, a: jt.trace_resolve(o, d, t, active=a))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(active))
    got = tt.trace_resolve(_t(o), _t(d), _t(t), active=_t(active))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for field in ("normal", "uv", "world_pos"):
        np.testing.assert_allclose(getattr(got, field).numpy()[valid],
                                   np.asarray(getattr(want, field))[valid],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.material.numpy(),
                                  np.asarray(want.material))


def test_plain_k10_paged_matches_plain_k7_flat(scenes, rays):
    """The layout does not change the answer: the port's own paged scene
    through K10's plain version against its own flat scene of the same
    frame through K7's. The big model has no flat scene, so there the flat
    view stands in."""
    o, d, t, active = rays
    rtt, cap = scenes["rtt"], scenes["cap"]
    inst = rtt.scene.flush()
    bt, mt, *rest = rtt.accel.blas()
    slots, masks, _, imask, opq, _, _ = rtt._device_inputs(cap)
    stack = rtt.accel.stack_size(cap)
    tracer = TA.PagedSceneTracer(scenes["pt"], slots, None,
                                 root_code=scenes["root_t"], stack_size=stack)
    if mt.num_bchunks:
        with pytest.raises(ValueError, match="assemble_scene_paged"):
            TA.assemble_scene(bt, mt, *rest, inst, rtt.accel.inst_blas(cap),
                              masks, rtt.accel.tri_attr())
        flat, root = tracer.flat_view()
    else:
        flat, roots = TA.assemble_scene(
            bt, mt, *rest, inst, rtt.accel.inst_blas(cap), masks,
            rtt.accel.tri_attr(), inst_mask=imask, inst_opaque=opq)
        root = roots[0]
    got = tracer.trace(_t(o), _t(d), _t(t), active=_t(active))
    want = TK.trace_scene_kernel(flat, _t(o), _t(d), _t(t), root_code=root,
                                 stack_size=stack, active=_t(active))
    np.testing.assert_array_equal(got.hit.numpy(), want.hit.numpy())
    np.testing.assert_array_equal(got.t.numpy(), want.t.numpy())
    both = got.hit.numpy()
    assert (got.prim.numpy() != want.prim.numpy())[both].mean() < 0.01


def test_paged_step_bound_ends_the_walk(scenes, rays):
    """``max_steps`` ends every walk with its best hit so far, in the plain
    version as in the kernel: a bound of 1 pop leaves every ray unhit, and
    the tracer's own bound (the JAX package's formula) none."""
    o, d, t, _ = rays
    _, tt = _tracers(scenes)
    walk = dict(root_code=tt.root_code, stack_size=tt.stack_size)
    one = TP.trace_scene_paged_plain(tt.scene, _t(o), _t(d), _t(t),
                                     max_steps=1, **walk)
    assert not one.hit.any()
    assert tt._step_bound() == JA.PagedSceneTracer(
        scenes["pj"], jnp.asarray(scenes["slots"]), None,
        root_code=scenes["root_j"], stack_size=scenes["stack"])._step_bound()


@pytest.fixture(scope="module")
def crowd_frames():
    """The crowd at 48x32 through the JAX package's paged RT frame
    (``make_rt_frame(paged=True)`` on the CPU), the port's frame forced
    onto the paged layout (``render_frame_rt(paged=True)``) and its routed
    frame."""
    from examples.render_crowd import build_crowd_scene as build_jax
    from paperrenderer_tpu.render.raytrace import make_rt_frame

    _, _, rtj, camj = build_jax(600, 48, 32)
    inst = rtj.scene.flush()
    bj, mj, ar, an = rtj.accel.blas()
    slots, masks, table = rtj._device_inputs(inst.capacity)
    imask, opq = rtj._cached_inst_mask
    frame = make_rt_frame(mj, None, 1, use_pallas=False, paged=True)
    _, aux = frame(
        bj, ar, an, inst, rtj.accel.inst_blas(inst.capacity), masks,
        rtj.accel.tri_attr(), table, rtj.lights, camj.matrices, slots,
        rtj.tonemap_params, jax.random.fold_in(rtj._key, 1), jnp.float32(0),
        None, imask, opq, width=48, height=32,
        stack_size=rtj.accel.stack_size(inst.capacity), shadow_samples=1,
        reflection_samples=0, ao_samples=0, ao_radius=2.0, leaf_cutout=False,
        compact_secondary=False)

    _, _, rt, cam = build_crowd_scene(600, 48, 32, device="cpu")
    return (np.asarray(aux["hdr"]), rt.render(cam, paged=True)[1]["hdr"].numpy(),
            rt.render(cam)[1]["hdr"].numpy())


def test_paged_rt_frame_matches_jax(crowd_frames):
    jax_hdr, paged_hdr, routed_hdr = crowd_frames
    assert paged_hdr.shape == jax_hdr.shape == (32, 48, 3)
    assert np.abs(paged_hdr - jax_hdr).mean() <= 1e-3
    # the routed frame is flat (600 instances stay under prefer_paged's
    # budget) and traces the same scene
    np.testing.assert_array_equal(paged_hdr, routed_hdr)


def test_crowd_paged_golden():
    _, _, rt, cam = build_crowd_scene(600, 128, 128, device="cpu")
    ldr, aux = rt.render(cam, paged=True)
    assert torch.isfinite(aux["hdr"]).all()
    ref = read_image(GOLDEN).astype(np.float32) / 255.0
    diff = np.abs(ldr.numpy() - ref).max(axis=-1)
    assert diff.mean() <= 0.004, diff.mean()
    assert (diff > 0.06).mean() <= 0.002, (diff > 0.06).mean()


def test_big_model_routes_to_the_paged_layout():
    """A big model's scene renders through RayTraceRender on the paged
    layout (the only one that holds its BLAS chunks)."""
    _, rt, cam = build_big_model_scene(width=16, height=16, device="cpu")
    before = dict(TP.LAUNCHES)
    ldr, aux = rt.render(cam)
    assert torch.isfinite(aux["hdr"]).all() and ldr.shape == (16, 16, 3)
    assert rt.accel.prefer_paged(rt.scene.flush().capacity)
    assert TP.LAUNCHES == before   # the CPU runs the plain versions
