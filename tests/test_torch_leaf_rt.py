"""The PyTorch port's any-hit leaf cutout and half-rate reflections against
the JAX package, on the CPU (the plain versions of the traversal kernels).

The scene is ``scenes.build_leaf_scene`` built through each package's API:
a ground plane, two upright leaf panels (SHADE_LEAF; the second one
force-opaque in the RT pass), a cube behind the first and a mirror sphere
behind both, so camera, AO and reflection rays all meet the cutout.

Op level: rays straight through both panels sweep their uv. The JAX side
is ``SceneTracer.trace_resolve(use_alpha=True)`` on its XLA route (the
``alpha_test`` hook of ``accel.trace_scene``) over the port's RTScene; the
port's K8 and K11 alpha forms run their plain versions on that RTScene and
on the port's paged layout of the same scene. Hit flags, instances and
materials are equal except on rays whose uv lies within 1e-5 of the
cutout's edge: XLA contracts the uv interpolation into FMAs, the port does
not.

Frames at 48x32, both packages drawing the same random samples: the RT
frame on both layouts within the RT frames' mean |diff| of 1e-3
(tests/test_torch_rt.py). Under the cutout neither layout fuses shadows
and AO, so both trace the same rays and are held to the JAX package's flat
frame. The hybrid frame within ``test_hybrid_frame_matches_jax``'s mean
per-pixel |diff| of 0.004 on the LDR image (its G-buffer is the raster
one, without the cutout, in both packages). An RT frame with half-rate
reflections within 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paperrenderer_tpu.ops import accel as JA
from paperrenderer_tpu_torch.ops import accel as TA
from paperrenderer_tpu_torch.ops import trace_kernel as TK
from paperrenderer_tpu_torch.ops import trace_paged as TP
from paperrenderer_tpu_torch.scenes import build_leaf_scene
from paperrenderer_tpu_torch.utils import probes as PR

W, H = 48, 32
EDGE = 1e-5
PANELS = ((-1.1, -0.4, 1.1), (1.1, -0.9, 1.1))   # leaf, force-opaque leaf


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's tests: the tier-1 run
    puts several pytest workers on the machine's cores, and torch's default
    of one thread per core then oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_leaf_scene(width, height):
    """``scenes.build_leaf_scene`` through the JAX package's API."""
    from paperrenderer_tpu.core import (
        SHADE_LEAF, Camera, Material, Model, ModelInstance, RenderEngine,
        make_cube, make_plane, make_uv_sphere)
    from paperrenderer_tpu.ops.shading import Lights

    eng = RenderEngine(device_check=False)
    ground = Model.from_mesh(eng.scene.arena, *make_plane(size=30.0))
    panel = Model.from_mesh(eng.scene.arena, *make_plane(size=2.0))
    cube = Model.from_mesh(eng.scene.arena, *make_cube(size=1.0))
    sphere = Model.from_mesh(
        eng.scene.arena, *make_uv_sphere(radius=0.8, rings=12, sectors=16))
    settings = dict(
        width=width, height=height,
        lights=Lights.make(
            [{"position": (3.0, -4.0, 6.0), "color": (160.0, 150.0, 130.0),
              "bounds": 60.0, "radius": 0.4}],
            ambient=(0.6, 0.7, 1.0, 0.3)),
        shadow_samples=1, reflection_samples=1, ao_samples=1, ao_radius=2.0)
    rt = eng.create_ray_trace_render(**settings)
    hy = eng.create_hybrid_render(**settings)
    white = Material("white", albedo=(0.75, 0.75, 0.78), roughness=0.9)
    red = Material("red", albedo=(0.85, 0.1, 0.08), roughness=0.4)
    gold = Material("gold", albedo=(1.0, 0.78, 0.35), roughness=0.1,
                    metallic=1.0)
    leaf = Material("leaf", albedo=(0.25, 0.7, 0.2), roughness=0.6,
                    shading_model=SHADE_LEAF)
    upright = (0.7071068, 0.7071068, 0.0, 0.0)
    for model, pos, quat, mat, opaque in (
            (ground, (0.0, 0.0, 0.0), None, white, False),
            (cube, (-1.3, 0.9, 0.5), (0.924, 0.0, 0.0, 0.383), red, False),
            (sphere, (0.3, 1.3, 0.8), None, gold, False),
            (panel, PANELS[0], upright, leaf, False),
            (panel, PANELS[1], upright, leaf, True)):
        inst = ModelInstance(model)
        inst.set_transform(pos=pos, quat=quat)
        binds = {0: mat.instance()}
        rt.add_instance(inst, binds, force_opaque=opaque)
        hy.add_instance(inst, binds)
    cam = Camera(yfov_deg=55.0, aspect=width / height, near=0.1, far=200.0)
    cam.look_at((0.0, -6.5, 3.0), (0.0, 0.5, 0.9), up=(0, 0, 1))
    return eng, rt, hy, cam


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture(scope="module")
def jax_scene():
    """The leaf scene through the JAX package: (rt, hybrid, camera)."""
    return _jax_leaf_scene(W, H)[1:]


def _tracer(rt, paged):
    """The port's tracer of one RayTraceRender frame (leaf cutout on)."""
    inst = rt.scene.flush()
    bt, mt, ar, an = rt.accel.blas()
    slots, masks, table, imask, opq, _, _ = rt._device_inputs(inst.capacity)
    return TA.make_scene_tracer(
        bt, mt, ar, an, inst, rt.accel.inst_blas(inst.capacity), masks,
        rt.accel.tri_attr(), slots, table, tlas_index=0,
        stack_size=rt.accel.stack_size(inst.capacity), paged=paged,
        inst_mask=imask, inst_opaque=opq, leaf_cutout=True)


@pytest.fixture(scope="module")
def sweep(jax_scene):
    """Rays along +y through a 40x24 grid over both panels; the port's
    flat and paged tracers of the leaf scene; the JAX package's tracer on
    the port's RTScene (the assembly itself is held to the JAX package's by
    tests/test_torch_parity.py) and its cutout hits; each ray's signed
    distance to the first panel's cutout edge in uv."""
    rtj = jax_scene[0]
    rt = build_leaf_scene(W, H, device="cpu")[1]
    flat, paged = _tracer(rt, False), _tracer(rt, True)
    xs, zs = np.meshgrid(np.linspace(-2.05, 2.05, 40, dtype=np.float32),
                         np.linspace(0.15, 2.05, 24, dtype=np.float32))
    o = np.stack([xs.ravel(), np.full(xs.size, -5.0, np.float32),
                  zs.ravel()], -1)
    d = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (xs.size, 1))
    t = np.full(xs.size, 100.0, np.float32)
    sc = flat.scene
    sj = JA.RTScene(
        **{f: jnp.asarray(getattr(sc, f).numpy()) for f in (
            "nodes", "codes", "leaf_rows", "leaf_prim", "inv_rows",
            "tri_attr")},
        leaf_nrm=jnp.zeros((sc.leaf_rows.shape[0], 72), jnp.float32),
        fwd_rows=jnp.zeros_like(jnp.asarray(sc.inv_rows.numpy())))
    table = rtj._device_inputs(rt.scene.flush().capacity)[2]
    tracer = JA.SceneTracer(sj, jnp.asarray(flat.slot_materials.numpy()),
                            table, root_code=flat.root_code,
                            stack_size=flat.stack_size, leaf_cutout=True,
                            use_pallas=False)

    def trace_resolve(o, d, t):   # SceneTracer.trace_resolve's two steps,
        rec = tracer.trace(o, d, t, use_alpha=True)   # with instance ids
        return rec, tracer.resolve(rec, o, d)

    rec, surf = jax.jit(trace_resolve)(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(t))
    # the first panel's uv: x across, z up (make_plane's uv, turned upright)
    u = (o[:, 0].astype(np.float64) - PANELS[0][0]) / 2.0 + 0.5
    v = (o[:, 2].astype(np.float64) - PANELS[0][2]) / 2.0 + 0.5
    edge = np.abs(v - 0.5) - (1.0 - (1.0 - 2.0 * u) ** 2) * 0.2
    on_first = (u > 0.0) & (u < 1.0)
    return dict(flat=flat, paged=paged, o=o, d=d, t=t, rec=rec, surf=surf,
                edge=np.where(on_first, edge, np.inf), on_first=on_first,
                panels=[i.index for i in rt.scene.instances[3:5]])


def _assert_cutout_matches(sweep, rec, attrs):
    """Hits, instances and materials equal to the JAX package's off the
    cutout's edge, t at 1e-5 relative; the cutout both cuts and keeps on
    the first panel."""
    want, surf = sweep["rec"], sweep["surf"]
    far = np.abs(sweep["edge"]) > EDGE
    hit_j = np.asarray(want.prim) >= 0
    np.testing.assert_array_equal(rec.hit.numpy()[far], hit_j[far])
    inst = rec.inst.numpy()
    np.testing.assert_array_equal(inst[far], np.asarray(want.inst)[far])
    np.testing.assert_array_equal(attrs[2].numpy()[far],
                                  np.asarray(surf.material)[far])
    both = far & hit_j
    np.testing.assert_allclose(rec.t.numpy()[both], np.asarray(want.t)[both],
                               rtol=1e-5)
    first = sweep["panels"][0]
    on = sweep["on_first"]
    assert (inst[on] == first).any() and (inst[on] != first).any()
    assert (far | ~on).mean() > 0.95   # few rays sit on the edge


def _rays(sweep):
    return _t(sweep["o"]), _t(sweep["d"]), _t(sweep["t"])


def _assert_force_opaque_hits(sweep, ctx, rec):
    """(c) Every ray through the force-opaque leaf panel hits it, in the
    alpha form's result ``rec`` and through ``ctx.trace(use_alpha=True)``
    (K7's or K10's alpha form), though the cutout would drop part of that
    panel."""
    px, _, pz = PANELS[1]
    o = sweep["o"]
    inside = (np.abs(o[:, 0] - px) < 1.0) & (np.abs(o[:, 2] - pz) < 1.0)
    u = (o[:, 0] - px) / 2.0 + 0.5
    v = (o[:, 2] - pz) / 2.0 + 0.5
    assert inside.sum() > 100
    assert (np.abs(v - 0.5) >= (1.0 - (1.0 - 2.0 * u) ** 2) * 0.2)[
        inside].any()
    opaque = sweep["panels"][1]
    for r in (rec, ctx.trace(*_rays(sweep), use_alpha=True)):
        assert (r.inst.numpy()[inside] == opaque).all()


def test_plain_k8_alpha_matches_jax(sweep):
    """(a) K8's alpha form (plain) on the flat layout; (c) the force-opaque
    panel through K8's and K7's alpha forms."""
    ctx = sweep["flat"]
    rec, attrs = TK.trace_resolve_plain(
        ctx.scene, ctx.slot_materials, *_rays(sweep),
        shading_model=ctx.materials.shading_model, **ctx._walk())
    _assert_cutout_matches(sweep, rec, attrs)
    _assert_force_opaque_hits(sweep, ctx, rec)


def test_plain_k11_alpha_matches_jax(sweep):
    """(b) K11's alpha form (plain) on the paged layout; (c) the
    force-opaque panel through K11's and K10's alpha forms."""
    ctx = sweep["paged"]
    rec, attrs = TP.trace_resolve_paged_plain(
        ctx.scene, ctx.slot_materials, *_rays(sweep),
        shading_model=ctx.materials.shading_model, **ctx._walk())
    _assert_cutout_matches(sweep, rec, attrs)
    _assert_force_opaque_hits(sweep, ctx, rec)


@pytest.mark.parametrize("layout", ["flat", "paged"])
def test_plain_walk_ignores_ray_order(sweep, layout):
    """The plain versions of K8's (flat) or K11's (paged) alpha form and of
    K7's or K10's step-count form, on the sweep's rays with every fifth one
    dead, in ``probes.ray_order`` and put back in order, equal the
    launch-order run bit for bit, step counts included. The plain walk is
    order-free by construction, so this pins the reference that the card's
    permuted cases (chip_smoke.py's compare_trace and compare_paged) hold
    the persistent kernel to, on the same order."""
    ctx = sweep[layout]
    o, d, t = _rays(sweep)
    act = torch.arange(o.shape[0]) % 5 != 4
    resolve = (TK.trace_resolve_plain if layout == "flat"
               else TP.trace_resolve_paged_plain)

    def run(o, d, t, act):
        rec, attrs = resolve(ctx.scene, ctx.slot_materials, o, d, t,
                             active=act,
                             shading_model=ctx.materials.shading_model,
                             **ctx._walk())
        steps = PR.steps_kernel(ctx, o, d, t, active=act)
        return [rec.t, rec.prim, rec.inst, rec.bary, *attrs, steps.t,
                steps.prim, steps.inst, steps.bary]

    want = run(o, d, t, act)
    assert want[-1][:, 0].max() > 3   # the walks take several steps
    perm = PR.ray_order(o.shape[0], o.device)
    for w, g in zip(want, run(o[perm], d[perm], t[perm], act[perm])):
        back = torch.empty_like(g)
        back[perm] = g
        assert torch.equal(back.view(torch.int32), w.view(torch.int32))


@pytest.fixture(scope="module")
def frames(jax_scene):
    """48x32 frames of the leaf scene in both packages: the RT frame (HDR)
    and the hybrid frame (LDR), and the RT frame with half-rate reflections
    and no AO (HDR; one fewer wavefront to trace). Every frame is its
    render's first, so both packages draw the same samples."""
    rtj, hyj, camj = jax_scene
    out = {("jax", "rt"): np.asarray(rtj.render(camj)[1]["hdr"]),
           ("jax", "hybrid"): np.asarray(hyj.render(camj)[0])}
    rtj.reflection_half_rate, rtj.ao_samples, rtj._frame = True, 0, 0
    out["jax", "half_rate"] = np.asarray(rtj.render(camj)[1]["hdr"])
    for name, paged in (("rt", False), ("rt_paged", True), ("hybrid", None),
                        ("half_rate", None)):
        _, rt, hy, cam = build_leaf_scene(W, H, device="cpu")
        if name == "hybrid":
            out["port", name] = hy.render(cam)[0].numpy()
            continue
        if name == "half_rate":
            rt.params = dataclasses.replace(
                rt.params, reflection_half_rate=True, ao_samples=0)
        ldr, aux = rt.render(cam, paged=paged)
        assert torch.isfinite(aux["hdr"]).all()
        out["port", name] = aux["hdr"].numpy()
    return out


@pytest.mark.parametrize("layout", ["rt", "rt_paged"])
def test_leaf_rt_frame_matches_jax(frames, layout):
    """(d) The RT frame under the leaf cutout, flat and paged."""
    got, want = frames["port", layout], frames["jax", "rt"]
    assert got.shape == want.shape == (H, W, 3)
    assert np.abs(got - want).mean() <= 1e-3


def test_leaf_hybrid_frame_matches_jax(frames):
    """(e) The hybrid frame: raster G-buffer, RT lighting under the
    cutout."""
    diff = np.abs(frames["port", "hybrid"] - frames["jax", "hybrid"])
    assert diff.max(axis=-1).mean() <= 0.004, diff.max(axis=-1).mean()


def test_half_rate_rt_frame_matches_jax(frames):
    """(f) Half-rate reflections: the JAX package's frame, and not the
    full-rate one."""
    got = frames["port", "half_rate"]
    assert np.abs(got - frames["jax", "half_rate"]).mean() <= 1e-3
    assert np.abs(got - frames["port", "rt"]).max() > 0.05
