"""The PyTorch port's single-level world-BVH ray tracer, its frame factories,
the lights' static shadow flags and the public API against the JAX package,
on the CPU.

Five tests, each looping over its cases and naming every case that fails
(xdist's ``--dist loadfile`` hands a file of five tests out after
tests/test_parallel_static.py, the tier-1 run's critical path):

1. ``build_bvh``/``refit_bvh``/``pack_leaf_tris`` on tests/test_bvh.py's
   37-, 200- and 64-primitive fixtures (and the 200 one's shapes with a
   tenth of the primitives invalid): every array equal to the JAX
   package's;
2. ``bvh_trace`` (closest hit, any hit, finite ``t_max``, inactive rays,
   an alpha test) against the JAX package's on those fixtures, and on
   JAX's own BVH through ``interop``: equal hit flags, t within 1e-5
   relative, ``prim`` differing only where the two t tie;
3. ``build_world_scene`` + ``BatchTracer`` on tests/test_trace.py's sphere
   on a plane: the world batch within 1e-6, primary hits, ``resolve_hits``
   and ``make_leaf_alpha_test`` against the JAX package's on JAX's batch
   and BVH, shadows and AO (tests/test_trace.py's points) equal;
4. ``rt_frame`` at 48x48 (tests/test_trace.py's cube on a plane) against
   the JAX package's ``rt_frame``: mean |HDR diff| <= 1e-3 (both draw the
   same samples; XLA's FMA contraction is the only difference);
   ``make_rt_frame``/``make_hybrid_frame`` bitwise ``RayTraceRender.render``
   / ``HybridRender.render``;
5. ``Lights.replace`` (the port of tests/test_raster.py's
   ``test_lights_replace_refreshes_static_flags``), the shadow samples the
   static flags skip (the port of tests/test_trace.py's
   ``test_static_noncasting_light_skips_trace`` with a counting tracer),
   hybrid config 4 at 64x64 and the RT example at 48x32 with and without
   the flags bitwise, ``SceneTracer.trace_occlusion_bundle`` against the
   paged tracer's, the public helpers (``to_srgb_u8``, ``mat34_inverse``,
   ``mat34_to_mat44``, ``leaf_occlusion``, ``expand_static(lod_override=)``,
   ``build_static_mapping(spatial_sort=False, capacity=)``,
   ``select_rows``, ``NO_HIT``, ``BACKGROUND``) against the JAX package's,
   and the API comparison: every public name and keyword a JAX module
   defines exists in the port, except ROADMAP.md's "Do not port" list.
"""

import ast
import dataclasses
import importlib
import inspect
import pkgutil
import re

import numpy as np
import pytest
import torch

from paperrenderer_tpu_torch.interop import from_numpy
from paperrenderer_tpu_torch.ops import bvh as TB
from paperrenderer_tpu_torch.utils import random as rnd


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's tests: the tier-1 run
    puts several pytest workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _each(cases, fn):
    """Run ``fn`` on every case; fail naming each case that failed."""
    failed = []
    for case in cases:
        try:
            fn(case)
        except Exception as exc:  # noqa: BLE001 — collected and re-raised
            failed.append(f"{case}: {type(exc).__name__}: {exc}")
    assert not failed, "\n".join(failed)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _port(kind, obj):
    """The JAX dataclass ``obj`` as the port's ``kind`` (CPU tensors); the
    static tuples (the lights' flags) come over as tuples."""
    return from_numpy(kind, {f.name: getattr(obj, f.name)
                             for f in dataclasses.fields(obj)
                             if getattr(obj, f.name) is not None},
                      device="cpu")


# -- 1-2. the BVH ------------------------------------------------------------------


def _random_tris(rng, n, spread=10.0):
    """tests/test_bvh.py's triangles."""
    base = rng.uniform(-spread, spread, size=(n, 1, 3)).astype(np.float32)
    offs = rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.8
    return base + offs


# (seed, primitives, leaf size, share invalid): tests/test_bvh.py's
# fixtures, and one with dead primitives among small leaves
FIXTURES = {"bvh37": (0, 37, 4, 0.0), "bvh200": (1, 200, 32, 0.0),
            "bvh64": (3, 64, 32, 0.0), "bvh200_dead": (5, 200, 32, 0.1)}


@pytest.fixture(scope="module")
def bvh_pairs():
    """Per fixture: (triangles, valid, the JAX BVH, the port's BVH)."""
    import jax.numpy as jnp

    from paperrenderer_tpu.ops import bvh as JB

    import jax

    build = jax.jit(JB.build_bvh, static_argnames=("leaf_size",))
    out = {}
    for name, (seed, n, leaf, dead) in FIXTURES.items():
        rng = np.random.default_rng(seed)
        tris = _random_tris(rng, n)
        valid = rng.random(n) >= dead
        lo, hi = tris.min(axis=1), tris.max(axis=1)
        jb = build(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid),
                   leaf_size=leaf)
        tb = TB.build_bvh(_t(lo), _t(hi), _t(valid), leaf_size=leaf)
        out[name] = (tris, valid, jb, tb)
    return out


def _arrays_equal(jb, tb, what):
    for f in ("node_min", "node_max", "perm", "child_boxes"):
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} {f}")


def test_bvh_build_refit_pack_match_jax(bvh_pairs):
    import jax.numpy as jnp

    from paperrenderer_tpu.ops import bvh as JB

    import jax

    @jax.jit
    def pack_refit(jb, verts, lo, hi):
        return JB.pack_leaf_tris(jb, *verts), JB.refit_bvh(jb, lo, hi)

    def case(name):
        tris, valid, jb, tb = bvh_pairs[name]
        _arrays_equal(jb, tb, name)
        assert tb.num_leaves == jb.num_leaves and tb.depth == jb.depth
        verts = [tris[:, k] for k in range(3)]
        moved = tris + np.asarray([100.0, -3.0, 0.5], np.float32)
        lo, hi = moved.min(axis=1), moved.max(axis=1)
        jpack, jrefit = pack_refit(jb, [jnp.asarray(v) for v in verts],
                                   jnp.asarray(lo), jnp.asarray(hi))
        np.testing.assert_array_equal(
            TB.pack_leaf_tris(tb, *map(_t, verts)).numpy(), np.asarray(jpack))
        _arrays_equal(jrefit, TB.refit_bvh(tb, _t(lo), _t(hi)),
                      name + " refit")

    _each(FIXTURES, case)


def _hits_agree(jr, tr, what):
    """Equal hit flags, t within 1e-5 relative, prim equal unless t ties."""
    jh, th = np.asarray(jr.hit), tr.hit.numpy()
    np.testing.assert_array_equal(th, jh, err_msg=f"{what} hit")
    jt, tt = np.asarray(jr.t)[jh], tr.t.numpy()[th]
    np.testing.assert_allclose(tt, jt, rtol=1e-5, err_msg=f"{what} t")
    assert np.isinf(tr.t.numpy()[~th]).all(), what
    off = np.asarray(jr.prim)[jh] != tr.prim.numpy()[th]
    assert (np.abs(tt - jt)[off] <= 1e-5 * np.abs(jt[off])).all(), what


def test_bvh_trace_matches_jax(bvh_pairs):
    """Closest and any hit, ``t_max`` 12, a fifth of the rays inactive, an
    alpha test rejecting odd primitives; also on JAX's BVH through
    ``interop``."""
    import jax
    import jax.numpy as jnp

    from paperrenderer_tpu.ops import bvh as JB

    j_trace = jax.jit(JB.bvh_trace, static_argnames=("any_hit",
                                                      "alpha_test"))
    odd_out = lambda p, u, v: p % 2 == 0   # noqa: E731 — an any-hit shader

    def case(c):
        name, any_hit = c
        tris, _valid, jb, tb = bvh_pairs[name]
        rng = np.random.default_rng(11)
        o = rng.uniform(-15, 15, size=(96, 3)).astype(np.float32)
        d = rng.normal(size=(96, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t_max = np.where(rng.random(96) < 0.5, np.inf, 12.0).astype(np.float32)
        active = rng.random(96) >= 0.2
        verts = [tris[:, k] for k in range(3)]
        jr = j_trace(jb, *map(jnp.asarray, verts), jnp.asarray(o),
                     jnp.asarray(d), jnp.asarray(t_max), any_hit=any_hit,
                     active=jnp.asarray(active))
        args = (*map(_t, verts), _t(o), _t(d), _t(t_max))
        tr = TB.bvh_trace(tb, *args, any_hit=any_hit, active=_t(active))
        _hits_agree(jr, tr, f"{name} any_hit={any_hit}")
        assert not tr.hit.numpy()[~active].any()
        jbvh = from_numpy("BVH", {f.name: np.asarray(getattr(jb, f.name))
                                  for f in dataclasses.fields(jb)},
                          device="cpu")
        on_jax = TB.bvh_trace(jbvh, *args, any_hit=any_hit, active=_t(active))
        _hits_agree(jr, on_jax, f"{name} on JAX's BVH")
        if name == "bvh200" and not any_hit:   # odd primitives cut out
            jr = j_trace(jb, *map(jnp.asarray, verts), jnp.asarray(o),
                         jnp.asarray(d), jnp.asarray(t_max),
                         alpha_test=odd_out)
            tr = TB.bvh_trace(tb, *args, alpha_test=odd_out)
            _hits_agree(jr, tr, f"{name} alpha")
            assert (tr.prim.numpy()[tr.hit.numpy()] % 2 == 0).all()

    _each([(n, a) for n in FIXTURES for a in (False, True)], case)


# -- 3. the world scene and its tracer ---------------------------------------------


def _sphere_on_plane(P):
    """tests/test_trace.py's scene in package ``P``; (scene, registry, cam)."""
    kw = {} if P.__name__ == "paperrenderer_tpu" else dict(device="cpu")
    scene = P.Scene(**kw)
    registry = P.MaterialRegistry()
    ground = P.Model.from_mesh(scene.arena, *P.make_plane(size=20.0))
    sphere = P.Model.from_mesh(
        scene.arena, *P.make_uv_sphere(radius=0.8, rings=12, sectors=16))
    scene.add_instance(P.ModelInstance(ground))
    s = scene.add_instance(P.ModelInstance(sphere))
    s.set_transform(pos=(0.0, 0.0, 0.8))
    cam = P.Camera(yfov_deg=60.0, aspect=1.0, near=0.1, far=100.0)
    cam.look_at((0.0, -4.0, 2.0), (0.0, 0.0, 0.5), up=(0, 0, 1))
    return scene, registry, cam


@pytest.fixture(scope="module")
def world():
    """The sphere on a plane in both packages: JAX's world batch and BVH,
    the port's own, and the port's copies of JAX's."""
    import jax.numpy as jnp

    import paperrenderer_tpu as JP
    import paperrenderer_tpu_torch as TP
    from paperrenderer_tpu.render import build_world_scene as j_world
    from paperrenderer_tpu_torch.render import build_world_scene as t_world

    import jax

    scene, registry, cam = _sphere_on_plane(JP)
    inst = scene.flush()
    j_world = jax.jit(j_world, static_argnames=("max_meshes_per_lod",
                                                "tri_capacity"))
    jbatch, jbvh = j_world(inst, scene.tables(), scene.geometry(),
                           cam.matrices, jnp.zeros((inst.capacity, 1),
                                                   jnp.int32),
                           max_meshes_per_lod=1, tri_capacity=1024)
    tscene, treg, tcam = _sphere_on_plane(TP)
    tinst = tscene.flush()
    tbatch, tbvh = t_world(tinst, tscene.tables(), tscene.geometry(),
                           tcam.matrices.to("cpu"),
                           torch.zeros((tinst.capacity, 1), dtype=torch.int32),
                           max_meshes_per_lod=1, tri_capacity=1024)
    return dict(jbatch=jbatch, jbvh=jbvh, tbatch=tbatch, tbvh=tbvh,
                batch=_port("TriangleBatch", jbatch), bvh=_port("BVH", jbvh),
                cam=cam, tcam=tcam, table=registry.table(),
                ttable=treg.table("cpu"))


def _points(P):
    """tests/test_trace.py's surface points: under the sphere and open."""
    if P == "jax":
        import jax.numpy as jnp

        from paperrenderer_tpu.ops import trace as T
        a, z = jnp.asarray, jnp.zeros
    else:
        from paperrenderer_tpu_torch.ops import trace as T
        a, z = (lambda v: torch.tensor(v, dtype=torch.float32)), torch.zeros
    return T.SurfaceHits(
        world_pos=a([[0.0, 0.0, 0.0], [5.0, 5.0, 0.0], [8.0, 8.0, 0.0]]),
        normal=a([[0.0, 0.0, 1.0]] * 3), uv=z((3, 2)),
        material=(a([0, 0, 0]).int() if P != "jax"
                  else jnp.zeros((3,), jnp.int32)),
        valid=(torch.ones(3, dtype=torch.bool) if P != "jax"
               else jnp.ones((3,), bool)),
        t=(torch.ones(3) if P != "jax" else jnp.ones((3,))))


def test_world_scene_tracer_matches_jax(world):
    import jax
    import jax.numpy as jnp

    from paperrenderer_tpu.ops import trace as JT
    from paperrenderer_tpu.ops.shading import Lights as JLights
    from paperrenderer_tpu_torch.core.material import SHADE_LEAF
    from paperrenderer_tpu_torch.ops import trace as TT
    from paperrenderer_tpu_torch.ops.shading import Lights as TLights

    size = 48
    o, d = JT.raygen(world["cam"].matrices, size, size)
    o, d = np.asarray(o), np.asarray(d)
    soft = [{"position": (0.0, 0.0, 10.0), "color": (100, 100, 100),
             "bounds": 50.0, "radius": 0.3}]
    jtab = world["table"]
    shading = np.asarray(jtab.shading_model).copy()
    shading[0] = SHADE_LEAF                 # the batch's material 0: a leaf
    jleaf = dataclasses.replace(jtab, shading_model=jnp.asarray(shading))
    tleaf = dataclasses.replace(_port("MaterialTable", jtab),
                                shading_model=_t(shading))
    rng = np.random.default_rng(4)
    prims = rng.integers(0, world["jbatch"].capacity, (64, 8))
    u = rng.random((64, 8)).astype(np.float32) * 0.5
    v = rng.random((64, 8)).astype(np.float32) * 0.5

    @jax.jit
    def jax_side(batch, bvh, o, d, prims, u, v):
        ctx = JT.BatchTracer(batch, bvh)
        rec = ctx.trace(o, d, jnp.full((size * size,), 1000.0))
        pts = _points("jax")
        return (rec, JT.resolve_hits(batch, rec, o, d),
                JT.make_leaf_alpha_test(batch, jleaf)(prims, u, v),
                JT.shadow_visibility(pts, ctx, JLights.make(soft),
                                     jax.random.PRNGKey(0), 4),
                JT.ambient_occlusion(pts, ctx, jtab, jax.random.PRNGKey(1),
                                     8, 2.0))

    jrec, js, jalpha, jvis, jao = jax_side(
        world["jbatch"], world["jbvh"], o, d, prims, u, v)

    def batch(_):
        jb, tb = world["jbatch"], world["tbatch"]
        for f in ("world", "normal", "uv"):
            np.testing.assert_allclose(getattr(tb, f).numpy(),
                                       np.asarray(getattr(jb, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        for f in ("material", "valid"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)))

    def primary(which):
        b, bvh = ((world["batch"], world["bvh"]) if which == "on_jax_bvh"
                  else (world["tbatch"], world["tbvh"]))
        rec = TT.BatchTracer(b, bvh).trace(_t(o), _t(d),
                                           torch.full((size * size,), 1000.0))
        _hits_agree(jrec, rec, which)
        assert rec.hit.float().mean() > 0.3
        ts = TT.resolve_hits(b, rec, _t(o), _t(d))
        same = (np.asarray(jrec.prim) == rec.prim.numpy()) & rec.hit.numpy()
        for f in ("world_pos", "normal", "uv"):
            np.testing.assert_allclose(getattr(ts, f).numpy()[same],
                                       np.asarray(getattr(js, f))[same],
                                       rtol=2e-5, atol=2e-5, err_msg=f)
        np.testing.assert_array_equal(ts.material.numpy(),
                                      np.asarray(js.material))
        np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))

    def alpha(_):
        got = TT.make_leaf_alpha_test(world["batch"], tleaf)(
            _t(prims), _t(u), _t(v)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jalpha))
        assert 0 < got.mean() < 1

    def lighting(_):
        tctx = TT.BatchTracer(world["tbatch"], world["tbvh"])
        tv = TT.shadow_visibility(_points("port"), tctx, TLights.make(soft),
                                  rnd.prng_key(0), 4).numpy()
        np.testing.assert_array_equal(tv, np.asarray(jvis))
        assert tv[0, 0] < 1.0 and tv[0, 1] == 1.0
        ta = TT.ambient_occlusion(_points("port"), tctx, world["ttable"],
                                  rnd.prng_key(1), 8, 2.0).numpy()
        np.testing.assert_allclose(ta, np.asarray(jao), rtol=1e-6, atol=1e-6)
        assert ta[0] < ta[2]

    _each(["batch", "on_jax_bvh", "own_bvh", "alpha", "lighting"],
          lambda c: {"batch": batch, "alpha": alpha,
                     "lighting": lighting}.get(c, primary)(c))


# -- 4. the frames -------------------------------------------------------------------


def _cube_on_plane(P, RT, Lights):
    """tests/test_trace.py's RT frame scene (a mirror cube on a plane, a soft
    light, 2 shadow samples, AO, a reflection) at 48x48."""
    kw = {} if P.__name__ == "paperrenderer_tpu" else dict(device="cpu")
    scene = P.Scene(**kw)
    registry = P.MaterialRegistry()
    ground = P.Model.from_mesh(scene.arena, *P.make_plane(size=20.0))
    cube = P.Model.from_mesh(scene.arena, *P.make_cube(size=1.0))
    rt = RT(scene, registry, width=48, height=48,
            lights=Lights.make([
                {"position": (0.0, -1.0, 6.0), "color": (150, 150, 150),
                 "bounds": 50.0, "radius": 0.2}], ambient=(1, 1, 1, 0.15)),
            shadow_samples=2, reflection_samples=1, ao_samples=1,
            ao_radius=1.5)
    white = P.Material("white", albedo=(0.8, 0.8, 0.8), roughness=0.8)
    mirror = P.Material("mirror", albedo=(0.9, 0.9, 0.9), roughness=0.05,
                        metallic=1.0)
    rt.add_instance(P.ModelInstance(ground), {0: white.instance()})
    c = P.ModelInstance(cube)
    c.set_transform(pos=(0.0, 0.0, 0.5))
    rt.add_instance(c, {0: mirror.instance()})
    cam = P.Camera(yfov_deg=60.0, aspect=1.0, near=0.1, far=100.0)
    cam.look_at((0.0, -5.0, 3.0), (0.0, 0.0, 0.5), up=(0, 0, 1))
    return scene, rt, cam


def test_world_rt_frame_and_factories():
    import jax

    import paperrenderer_tpu as JP
    import paperrenderer_tpu_torch as TP
    from paperrenderer_tpu.ops.shading import Lights as JLights
    from paperrenderer_tpu.render import RayTraceRender as JRT
    from paperrenderer_tpu.render.raytrace import rt_frame as j_rt_frame
    from paperrenderer_tpu_torch.ops.shading import Lights as TLights
    from paperrenderer_tpu_torch.render import (
        make_hybrid_frame, make_rt_frame, rt_frame)
    from paperrenderer_tpu_torch.render.raytrace import AccelCache
    from paperrenderer_tpu_torch.scenes import (build_hybrid_scene,
                                                build_rt_scene)

    def world_frame(_):
        scene, rtj, camj = _cube_on_plane(JP, JRT, JLights)
        inst = scene.flush()
        _, aux = j_rt_frame(
            inst, scene.tables(), scene.geometry(), rtj.materials.table(),
            rtj.lights, camj.matrices,
            rtj._slot_material_array(inst.capacity), rtj.tonemap_params,
            jax.random.PRNGKey(3), width=48, height=48,
            max_meshes_per_lod=1, tri_capacity=2048, shadow_samples=2,
            reflection_samples=1, ao_samples=1, ao_radius=1.5)
        _, rt, cam = _cube_on_plane(TP, TP.RayTraceRender, TLights)
        args, kw = rt.world_inputs(cam, rnd.prng_key(3))
        assert kw["tri_capacity"] == 2048 and kw["max_meshes_per_lod"] == 1
        ldr, taux = rt_frame(*args, **kw)
        want = np.asarray(aux["hdr"])
        got = taux["hdr"].numpy()
        assert got.shape == want.shape == (48, 48, 3)
        assert np.abs(got - want).mean() <= 1e-3, np.abs(got - want).mean()
        assert int(taux["total_tris"]) == int(aux["total_tris"])
        assert want.std() > 0.05 and torch.isfinite(ldr).all()

    def rt_factory(case):
        _, rt, cam = build_rt_scene(48, 32, device="cpu")
        if case == "rt_xla":
            rt.use_pallas = False
        want, _ = rt.render(cam)
        inst = rt.scene.flush()
        blasset, meta, anim_rest, anim_nodes = rt.accel.blas()
        slots, masks, table, imask, opaque, lights, tm = rt._device_inputs(
            inst.capacity)
        p = rt.params
        frame = make_rt_frame(meta, None, rt.num_tlas,
                              use_pallas=rt.use_pallas)
        got, _ = frame(
            blasset, anim_rest, anim_nodes, inst,
            rt.accel.inst_blas(inst.capacity), masks, rt.accel.tri_attr(),
            table, lights, cam.matrices.to("cpu"), slots, tm,
            rnd.fold_in(rt._key, 1), torch.tensor(0.0), rt._cached_textures,
            imask, opaque, width=48, height=32,
            stack_size=rt.accel.stack_size(inst.capacity),
            shadow_samples=p.shadow_samples,
            reflection_samples=p.reflection_samples,
            ao_samples=p.ao_samples, ao_radius=p.ao_radius,
            leaf_cutout=False, compact_secondary=False)
        assert torch.equal(got, want), case

    def hybrid_factory(_):
        _, hy, cam = build_hybrid_scene(48, 32, device="cpu")
        want, _ = hy.render(cam)
        rp = hy._rp
        mapping, inst, tables, table, cm, slots, visible = rp.frame_inputs(
            cam)
        blasset, meta, anim_rest, anim_nodes = hy.accel.blas()
        cap = inst.capacity
        frame = make_hybrid_frame(meta, None, use_pallas_trace=True,
                                  paged=AccelCache(hy.scene).prefer_paged(cap))
        got, aux = frame(
            mapping, blasset, anim_rest, anim_nodes, inst,
            hy.accel.inst_blas(cap), hy.accel.tri_attr(), tables, table,
            rp.lights, cm, slots, visible, rp.tonemap_params,
            rnd.fold_in(hy._key, 1), torch.tensor(0.0), rp._cached_textures,
            width=48, height=32, stack_size=hy.accel.stack_size(cap),
            use_pallas=True, work_capacity=123, shadow_samples=2,
            reflection_samples=1, ao_samples=2, ao_radius=2.0)
        assert torch.equal(got, want)
        assert aux["coverage"] > 0.5

    _each(["world_frame", "rt", "rt_xla", "hybrid"],
          lambda c: {"world_frame": world_frame,
                     "hybrid": hybrid_factory}.get(c, rt_factory)(c))


# -- 5. static light flags, item 11's helpers, the API ------------------------------


def _static_flags(_):
    """tests/test_raster.py's test_lights_replace_refreshes_static_flags."""
    from paperrenderer_tpu_torch.ops.shading import Lights

    lights = Lights.make([{"position": (0, 0, 5), "cast_shadow": False,
                           "radius": 0.0}])
    assert lights.shadow_flags == (False,) and lights.hard_flags == (True,)
    on = lights.replace(cast_shadow=np.array([True]),
                        radius=np.array([0.5], np.float32))
    assert on.shadow_flags == (True,) and on.hard_flags == (False,)
    assert bool(on.cast_shadow[0]) and isinstance(on.radius, torch.Tensor)
    moved = on.replace(position=torch.zeros((1, 3)))
    assert moved.shadow_flags == (True,) and moved.hard_flags == (False,)
    assert on.to("cpu").shadow_flags == (True,)


def _skips_traces(world):
    """tests/test_trace.py's test_static_noncasting_light_skips_trace on the
    port's BatchTracer: one trace for the hard light, none for the
    non-casting one, the visibility of the mirror-less paths."""
    from paperrenderer_tpu_torch.ops import trace as TT
    from paperrenderer_tpu_torch.ops.shading import Lights

    class Counting:
        def __init__(self, inner):
            self.inner = inner
            self.calls = 0

        def trace(self, *a, **k):
            self.calls += 1
            return self.inner.trace(*a, **k)

    lights = Lights.make([
        {"position": (0.0, 0.0, 10.0), "color": (100, 100, 100),
         "bounds": 50.0, "radius": 0.0},
        {"position": (3.0, 0.0, 5.0), "color": (10, 10, 10),
         "bounds": 50.0, "cast_shadow": False}])
    assert lights.shadow_flags == (True, False)
    surf = _points("port")
    runs = []
    for lt, calls in ((lights, 1),
                      (dataclasses.replace(lights, shadow_flags=None), 2),
                      (dataclasses.replace(lights, shadow_flags=None,
                                           hard_flags=None), 4)):
        ctx = Counting(TT.BatchTracer(world["tbatch"], world["tbvh"]))
        runs.append(TT.shadow_visibility(surf, ctx, lt, rnd.prng_key(0), 2))
        assert ctx.calls == calls, (ctx.calls, calls)
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    assert runs[0][0, 0] == 0.0 and runs[0][0, 1] == 1.0
    assert (runs[0][1] == 1.0).all()


def _frames_bitwise(case):
    """A frame with the lights' flags bitwise the frame without them (every
    sample traced): hybrid config 4 at 64x64 (its second light casts no
    shadow), the RT example at 48x32 (its light soft)."""
    from paperrenderer_tpu_torch.scenes import build_hybrid_scene, build_rt_scene

    frames = []
    for flags in (True, False):
        if case == "hybrid4":
            _, r, cam = build_hybrid_scene(64, 64, device="cpu")
            if not flags:
                r._rp.lights = dataclasses.replace(
                    r._rp.lights, shadow_flags=None, hard_flags=None)
            assert r.lights.shadow_flags in ((True, False), None)
        else:
            _, r, cam = build_rt_scene(48, 32, device="cpu")
            if not flags:
                r.lights = dataclasses.replace(r.lights, shadow_flags=None,
                                               hard_flags=None)
        frames.append(r.render(cam)[1]["hdr"])
    assert torch.equal(frames[0], frames[1]), case


def _occlusion_bundle(_):
    """The flat tracer's ``trace_occlusion_bundle`` (plain K9, and the XLA
    route) against the paged tracer's, on the RT example's G-buffer-like
    surfaces: equal bits."""
    from paperrenderer_tpu_torch.ops import accel as TA
    from paperrenderer_tpu_torch.ops import trace as TT
    from paperrenderer_tpu_torch.scenes import build_rt_scene

    _, rt, cam = build_rt_scene(32, 16, device="cpu")
    inst = rt.scene.flush()
    blasset, meta, anim_rest, anim_nodes = rt.accel.blas()
    slots, masks, table, _m, _o, lights, _tm = rt._device_inputs(
        inst.capacity)
    common = (blasset, meta, anim_rest, anim_nodes, inst,
              rt.accel.inst_blas(inst.capacity), masks, rt.accel.tri_attr(),
              slots, table)
    kw = dict(tlas_index=0, stack_size=rt.accel.stack_size(inst.capacity))
    flat = TA.make_scene_tracer(*common, **kw)
    paged = TA.make_scene_tracer(*common, paged=True, **kw)
    xla = TA.make_scene_tracer(*common, use_pallas=False, **kw)
    o, d = TT.raygen(cam.matrices.to("cpu"), 32, 16)
    surf = flat.trace_resolve(o, d, torch.full((512,), 1000.0))
    origin = surf.world_pos + surf.normal * 5e-3
    dirs, caps, actives, slots_ = TT._occlusion_samples(
        surf, lights, rnd.prng_key(2), 3)
    active = actives[0]
    want = paged.trace_occlusion_bundle(origin, dirs, caps, active=active)
    for tracer in (flat, xla):
        got = tracer.trace_occlusion_bundle(origin, dirs, caps, active=active)
        assert torch.equal(got, want)
    assert 0 < ((want & 1) * active).sum() < active.sum()


def _helpers(_):
    """Item 11's helpers against the JAX package's."""
    import jax
    import jax.numpy as jnp

    import paperrenderer_tpu as JP
    import paperrenderer_tpu_torch as TP
    from paperrenderer_tpu.core import texture as JX, transforms as JTR
    from paperrenderer_tpu.ops import raster as JR, shading as JS
    from paperrenderer_tpu.ops import static_batch as JSB, tonemap as JTM
    from paperrenderer_tpu.ops import trace as JT
    from paperrenderer_tpu_torch.core import texture as TX, transforms as TTR
    from paperrenderer_tpu_torch.ops import raster as TR, shading as TS
    from paperrenderer_tpu_torch.ops import static_batch as TSB
    from paperrenderer_tpu_torch.ops import tonemap as TTM, trace as TT

    rng = np.random.default_rng(5)
    x = rng.uniform(-0.2, 1.2, (4096, 3)).astype(np.float32)
    x[:4, 0] = [0.0, 0.0031308, 1.0, 0.5]
    m = rng.normal(size=(16, 3, 4)).astype(np.float32)
    m[:, :, :3] += 3.0 * np.eye(3, dtype=np.float32)
    uv = rng.random((64, 2)).astype(np.float32)
    tables = [rng.normal(size=(n, 3)).astype(np.float32) for n in (64, 65)]
    ids = [rng.integers(-3, n + 3, (50,)).astype(np.int32) for n in (64, 65)]

    @jax.jit
    def jax_side(x, m, uv, tables, ids):
        return (JTM.to_srgb_u8(x), JTR.mat34_inverse(m),
                JTR.mat34_to_mat44(m), JS.leaf_occlusion(uv),
                [JX.select_rows(t, i) for t, i in zip(tables, ids)])

    srgb, inv, m44, occ, rows = jax_side(x, m, uv, tables, ids)
    np.testing.assert_array_equal(TTM.to_srgb_u8(_t(x)).numpy(),
                                  np.asarray(srgb))
    np.testing.assert_allclose(TTR.mat34_inverse(_t(m)).numpy(),
                               np.asarray(inv), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(TTR.mat34_to_mat44(_t(m)).numpy(),
                                  np.asarray(m44))
    np.testing.assert_array_equal(TS.leaf_occlusion(_t(uv)).numpy(),
                                  np.asarray(occ))
    for t, i, want in zip(tables, ids, rows):
        np.testing.assert_array_equal(
            TX.select_rows(_t(t), _t(i), exact=True).numpy(),
            np.asarray(want))
    assert TR.NO_HIT == int(JR.NO_HIT) == -1
    np.testing.assert_array_equal(TT.BACKGROUND.numpy(),
                                  np.asarray(JT.BACKGROUND))
    # a scene of three models with two LODs each, out of morton order
    scenes = []
    for P in (JP, TP):
        scene = P.Scene() if P is JP else P.Scene(device="cpu")
        two = []   # models of two LODs: a sphere, then a cube
        for r in (0.5, 0.3):
            hs = [scene.arena.add_mesh(*P.make_uv_sphere(radius=r, rings=6,
                                                         sectors=8)),
                  scene.arena.add_mesh(*P.make_cube(size=r))]
            two.append(P.Model(scene.arena, [[P.MaterialMesh(h, 0)]
                                             for h in hs]))
        models = two + [P.Model.from_mesh(scene.arena, *P.make_cube(size=0.5))]
        for i, pos in enumerate(((3, 0, 0), (-2, 1, 0), (0, -4, 1),
                                 (1, 1, 1), (-3, -3, 0))):
            inst = scene.add_instance(P.ModelInstance(models[i % len(models)]))
            inst.set_transform(pos=pos)
        scenes.append(scene)
    jscene, tscene = scenes
    for sort in (False, True):
        jm = JSB.build_static_mapping(jscene, capacity=4096,
                                      spatial_sort=sort)
        tm = TSB.build_static_mapping(tscene, capacity=4096,
                                      spatial_sort=sort)
        for f in ("v_obj", "valid", "run_inst", "run_lod", "run_slot",
                  "run_id"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                          np.asarray(getattr(jm, f)),
                                          err_msg=f"{f} sort={sort}")
    with pytest.raises(ValueError, match="overflow"):
        TSB.build_static_mapping(tscene, capacity=8)
    jinst, tinst = jscene.flush(), tscene.flush()
    cam = JP.Camera(yfov_deg=60.0, aspect=1.0, near=0.1, far=100.0)
    cam.look_at((0.0, -9.0, 4.0), (0.0, 0.0, 0.0), up=(0, 0, 1))
    tcam = _port("CameraMatrices", cam.matrices)
    jslots = jnp.zeros((jinst.capacity, 1), jnp.int32)
    jm = JSB.build_static_mapping(jscene)
    tm = TSB.build_static_mapping(tscene)
    expand = jax.jit(JSB.expand_static, static_argnames=("lod_override",))
    for lod in (0, 1):
        jb, jv = expand(jm, jinst, jscene.tables(), cam.matrices, jslots,
                        lod_override=lod)
        tb, tv = TSB.expand_static(tm, tinst, tscene.tables(), tcam,
                                   torch.zeros((tinst.capacity, 1),
                                               dtype=torch.int32),
                                   lod_override=lod, use_runs=False)
        np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
        np.testing.assert_allclose(tb.world.numpy(), np.asarray(jb.world),
                                   rtol=1e-6, atol=1e-6)


# "Do not port" (ROADMAP.md), as data: each entry is a JAX name the port
# leaves out, with the reason ROADMAP.md gives.
DO_NOT_PORT_MODULES = {
    "ops.compaction": "packet compaction for the TPU kernels' dead packets",
}
DO_NOT_PORT_NAMES = {
    "render.renderpass.measure_frame_demand": "TPU capacity tier",
    "ops.raster_exact.measure_pair_demand": "TPU capacity tier",
    "ops.raster_exact.default_pair_capacity": "TPU capacity tier",
    "ops.accel.BCH_NRM": "leaf-normal rows only the TPU kernels read",
}
DO_NOT_PORT_KEYWORDS = {
    "ops.accel.assemble_scene_paged(order_override=)": "measured loss",
    "ops.accel.trace_scene(alpha_test=)": "the cutout is data "
                                          "(shading_model=), not a callable",
    "ops.accel.make_instance_rows(mats=)": "inverted from the TRS in "
                                           "closed form",
    "parallel.make_tile_mesh(devices=)": "a rank owns one device",
    "parallel.mesh.make_tile_mesh(devices=)": "a rank owns one device",
}
# fields only the TPU kernels read
DO_NOT_PORT_FIELDS = {"leaf_nrm", "bch_lnrm", "fwd_rows", "anim_leaf_nrm",
                      "tri_instance", "tri_lod", "tri_slot", "run_starts",
                      "start_mask", "fill_takes", "max_run"}
# the TPU kernel modules: their constants and Pallas wrappers, by pattern
KERNEL_MODULES = {"ops.raster_exact", "ops.raster_pallas", "ops.trace_kernel",
                  "ops.trace_paged"}
TPU_CONSTANT = re.compile(r"^[A-Z][A-Z0-9_]*$")
PALLAS_WRAPPER = re.compile(r"pallas|_ok$|^traversal_step_bound$")


def _modules(pkg):
    out = {"": pkg}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[m.name[len(pkg.__name__) + 1:]] = importlib.import_module(m.name)
    return out


def _defined(mod):
    """The public names a module's source defines (and, in a package's
    ``__init__``, the names it re-exports)."""
    tree = ast.parse(open(mod.__file__).read())
    init = mod.__file__.endswith("__init__.py")
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
        elif init and isinstance(node, ast.ImportFrom) and node.level:
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.startswith("_")]


def _keywords(f):
    try:
        ps = inspect.signature(f).parameters
    except (TypeError, ValueError):
        return None, False
    var = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    return ([k for k, p in ps.items()
             if k not in ("self", "cls") and p.kind not in var],
            any(p.kind == p.VAR_KEYWORD for p in ps.values()))


def _members(cls):
    out = set(dir(cls))
    if dataclasses.is_dataclass(cls):
        out |= {f.name for f in dataclasses.fields(cls)}
    return out


def api_gaps():
    """Every public name, member and keyword of a JAX module that the port
    lacks, less the "Do not port" list: a list of strings."""
    import paperrenderer_tpu as JP
    import paperrenderer_tpu_torch as TP

    gaps = []
    jm, tm = _modules(JP), _modules(TP)
    for name, jmod in sorted(jm.items()):
        if name in DO_NOT_PORT_MODULES:
            continue
        if name not in tm:
            gaps.append(f"module {name}")
            continue
        tmod = tm[name]
        for attr in _defined(jmod):
            obj = getattr(jmod, attr)
            where = f"{name}.{attr}" if name else attr
            if inspect.ismodule(obj) or where in DO_NOT_PORT_NAMES or (
                    name in KERNEL_MODULES and (TPU_CONSTANT.match(attr)
                                                or PALLAS_WRAPPER.search(attr))):
                continue
            if not hasattr(tmod, attr):
                gaps.append(f"name {where}")
                continue
            tobj = getattr(tmod, attr)
            funcs = []
            if inspect.isfunction(obj):
                funcs.append((where, obj, tobj))
            elif inspect.isclass(obj) and inspect.isclass(tobj):
                have = _members(tobj)
                for mem in sorted(_members(obj) - set(dir(object))):
                    if mem.startswith("_") or mem in DO_NOT_PORT_FIELDS:
                        continue
                    if mem not in have:
                        gaps.append(f"member {where}.{mem}")
                    elif inspect.isfunction(getattr(obj, mem, None)):
                        funcs.append((f"{where}.{mem}", getattr(obj, mem),
                                      getattr(tobj, mem)))
                funcs.append((f"{where}.__init__", obj.__init__,
                              tobj.__init__))
            for w, f, tf in funcs:
                jk, _ = _keywords(f)
                tk, var = _keywords(tf)
                if jk is None or tk is None or var:
                    continue
                for k in jk:
                    label = f"{w.removesuffix('.__init__')}({k}=)"
                    if (k not in tk and k not in DO_NOT_PORT_FIELDS
                            and label not in DO_NOT_PORT_KEYWORDS):
                        gaps.append(f"keyword {label}")
    return gaps


def test_static_flags_helpers_and_api(world):
    _each(["static_flags", "skips_traces", "hybrid4", "rt_example",
           "occlusion_bundle", "helpers", "api"],
          lambda c: {"static_flags": _static_flags,
                     "skips_traces": lambda _: _skips_traces(world),
                     "occlusion_bundle": _occlusion_bundle,
                     "helpers": _helpers,
                     "api": lambda _: _no_gaps()}.get(c, _frames_bitwise)(c))


def _no_gaps():
    gaps = api_gaps()
    assert not gaps, "the port lacks:\n" + "\n".join(gaps)
