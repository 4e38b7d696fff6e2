"""The PyTorch port's ray-tracing building blocks against the JAX package,
on the CPU (the port runs the plain versions of its traversal kernels here).

Inputs are the same in both packages: the RT example scene built through
each package's API, rays made with numpy from a seed, and for the
traversal tests the JAX package's own RTScene arrays handed to the port
(``interop.from_numpy``). The JAX side runs its XLA path (``trace_scene`` /
``SceneTracer`` with ``use_pallas=False``).

Tolerances: integer tables and the host-built BLAS are compared exactly.
The per-frame float rows (instance matrices, TLAS boxes) at 1e-6 relative:
XLA contracts the einsums of ``transform_aabb``/``make_instance_rows`` into
FMAs, the port does not. Hit distances at 1e-5 relative; triangle and
instance ids only where the two packages' t differ by more than that (a
different id at an equal t is a tie on a shared edge, which the traversal
order decides).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.render_rt import build_rt_scene as build_jax
from paperrenderer_tpu.ops import accel as JA
from paperrenderer_tpu_torch.interop import from_numpy
from paperrenderer_tpu_torch.ops import accel as TA
from paperrenderer_tpu_torch.ops import trace_kernel as TK
from paperrenderer_tpu_torch.scenes import build_rt_scene as build_port
from paperrenderer_tpu_torch.utils import random as rnd

W, H = 48, 32
T_REL = 1e-5


def _add_second_tlas(rt, mod):
    """TLAS 1: the sphere (mask 0x01) and the cube (mask 0x02, force
    opaque) again, bound to a new material."""
    mat = mod.Material("blue", albedo=(0.1, 0.2, 0.9)).instance()
    k = rt.add_tlas()
    insts = rt.scene.instances
    rt.add_instance(insts[1], {0: mat}, tlas=k, mask=0x01)
    rt.add_instance(insts[2], {0: mat}, tlas=k, mask=0x02, force_opaque=True)


@pytest.fixture(scope="module")
def scenes():
    """Both packages' RT scene with a second, masked TLAS: the JAX RTScene
    and root codes, and the port's own assembly of the same frame."""
    import paperrenderer_tpu as J
    import paperrenderer_tpu_torch as T

    _, rtj, camj = build_jax(W, H)
    _, rtt, _ = build_port(W, H, device="cpu")
    _add_second_tlas(rtj, J)
    _add_second_tlas(rtt, T)
    inst_j = rtj.scene.flush()
    cap = inst_j.capacity
    bj, mj, ar, an = rtj.accel.blas()
    slots_j, masks_j, table_j = rtj._device_inputs(cap)
    imask_j, opq_j = rtj._cached_inst_mask
    sj, roots_j = JA.assemble_scene(
        bj, mj, ar, an, inst_j, rtj.accel.inst_blas(cap), list(masks_j),
        rtj.accel.tri_attr(), inst_mask=imask_j, inst_opaque=opq_j)

    inst_t = rtt.scene.flush()
    bt, mt = rtt.accel.blas()
    slots_t, masks_t, table_t, imask_t, opq_t, _, _ = rtt._device_inputs(cap)
    st, roots_t = TA.assemble_scene(
        bt, mt, inst_t, rtt.accel.inst_blas(cap), masks_t,
        rtt.accel.tri_attr(), inst_mask=imask_t, inst_opaque=opq_t)
    port_of_jax = from_numpy(
        "RTScene", {f: np.asarray(getattr(sj, f)) for f in (
            "nodes", "codes", "leaf_rows", "leaf_prim", "inv_rows",
            "tri_attr")}, device="cpu")
    return dict(rtj=rtj, rtt=rtt, bj=bj, mj=mj, bt=bt, mt=mt, sj=sj, st=st,
                roots_j=roots_j, roots_t=roots_t, scene=port_of_jax,
                slots=np.asarray(slots_j), slots_t=slots_t, table_j=table_j,
                stack=rtj.accel.stack_size(cap),
                stack_t=rtt.accel.stack_size(cap), camj=camj)


@pytest.fixture(scope="module")
def rays(scenes):
    """The camera's primary rays (tile order, as the frame makes them) and
    random rays from inside the scene's box, with per-ray caps."""
    from paperrenderer_tpu.ops.trace import pick_tile, raygen

    o, d = raygen(scenes["camj"].matrices, W, H, tile_order=pick_tile(W, H))
    rng = np.random.default_rng(5)
    n = 1024
    ro = rng.uniform((-4, -4, 0.05), (4, 4, 3), (n, 3)).astype(np.float32)
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


@pytest.mark.parametrize("seed,data", [(0, (1, 7)), (42, (3, 1000)),
                                       (2**31 - 1, (1, 2001))])
def test_threefry_matches_jax_random(seed, data):
    kj = jax.random.PRNGKey(seed)
    kt = rnd.prng_key(seed)
    assert tuple(int(x) for x in np.asarray(kj)) == kt
    for x in data:
        kj, kt = jax.random.fold_in(kj, x), rnd.fold_in(kt, x)
        assert tuple(int(v) for v in np.asarray(kj)) == kt
    uj = np.asarray(jax.random.uniform(kj, (2, 777)))
    ut = rnd.uniform(kt, (2, 777), "cpu").numpy()
    np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))


@pytest.mark.parametrize("field", ["nodes", "codes", "leaf_rows", "leaf_prim",
                                   "root_min", "root_max", "root_code"])
def test_blas_set_equal(scenes, field):
    np.testing.assert_array_equal(getattr(scenes["bt"], field).numpy(),
                                  np.asarray(getattr(scenes["bj"], field)))
    assert scenes["mt"].max_depth == scenes["mj"].max_depth
    np.testing.assert_array_equal(scenes["mt"].blas_of_model,
                                  scenes["mj"].blas_of_model)


@pytest.mark.parametrize("field", ["nodes", "codes", "leaf_rows", "leaf_prim",
                                   "inv_rows", "tri_attr"])
def test_assemble_scene_two_masked_tlases(scenes, field):
    got = getattr(scenes["st"], field).numpy()
    want = np.asarray(getattr(scenes["sj"], field))
    assert scenes["roots_t"] == scenes["roots_j"]
    assert scenes["stack_t"] == scenes["stack"]
    if got.dtype == np.float32 and field not in ("leaf_rows", "tri_attr"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _jax_trace(scenes, root, **kw):
    return jax.jit(functools.partial(
        JA.trace_scene, root_code=root, stack_size=scenes["stack"], **kw))


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


@pytest.mark.parametrize("tlas,cull", [(0, 0xFF), (1, 0x02), (1, 0xFF)])
def test_plain_k7_closest_matches_jax(scenes, rays, tlas, cull):
    o, d, t, active = rays
    root = scenes["roots_j"][tlas]
    want = _jax_trace(scenes, root, cull_mask=cull)(
        scenes["sj"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
        active=jnp.asarray(active))
    got = TK.trace_scene_kernel(scenes["scene"], _t(o), _t(d), _t(t),
                                root_code=root, stack_size=scenes["stack"],
                                active=_t(active), cull_mask=cull)
    _assert_hits_match(got, want, active)
    np.testing.assert_allclose(got.bary.numpy()[got.hit.numpy()],
                               np.asarray(want.bary)[got.hit.numpy()],
                               atol=1e-4)


def test_plain_k7_any_hit_matches_jax(scenes, rays):
    o, d, t, _ = rays
    root = scenes["roots_j"][0]
    want = _jax_trace(scenes, root, any_hit=True)(
        scenes["sj"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    got = TK.trace_scene_kernel(scenes["scene"], _t(o), _t(d), _t(t),
                                root_code=root, stack_size=scenes["stack"],
                                any_hit=True)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    assert got.hit.numpy().mean() > 0.3


def _jax_tracer(scenes):
    return JA.SceneTracer(scenes["sj"], jnp.asarray(scenes["slots"]),
                          scenes["table_j"], root_code=scenes["roots_j"][0],
                          stack_size=scenes["stack"])


def _port_tracer(scenes):
    return TA.SceneTracer(scenes["scene"], _t(scenes["slots"]), None,
                          root_code=scenes["roots_j"][0],
                          stack_size=scenes["stack"])


def test_plain_k8_matches_jax_trace_resolve(scenes, rays):
    o, d, t, active = rays
    want = jax.jit(lambda o, d, t, a: _jax_tracer(scenes).trace_resolve(
        o, d, t, active=a))(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                            jnp.asarray(active))
    got = _port_tracer(scenes).trace_resolve(_t(o), _t(d), _t(t),
                                             active=_t(active))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for field in ("normal", "uv", "world_pos"):
        np.testing.assert_allclose(getattr(got, field).numpy()[valid],
                                   np.asarray(getattr(want, field))[valid],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.material.numpy(),
                                  np.asarray(want.material))


def test_plain_k9_matches_jax_per_sample_path(scenes, rays):
    """Occlusion bits and AO t of an origin-shared bundle (2 shadow + 1 AO
    samples, some rays inactive) against the JAX per-sample fallback."""
    o, d, t, active = rays
    rng = np.random.default_rng(9)
    dirs = [rng.normal(size=d.shape).astype(np.float32) for _ in range(3)]
    caps = [t, t, np.full(t.shape, 2.0, np.float32)]
    acts = [active, np.ones_like(active), active]

    def jax_bundle(o, d0, d1, d2, c0, c1, c2, a0, a1, a2):
        return _jax_tracer(scenes).trace_shadow_ao_bundle(
            o, [d0, d1], [c0, c1], [d2], [c2], occ_actives=[a0, a1],
            ao_actives=[a2])

    bits_j, ao_j = jax.jit(jax_bundle)(
        *(jnp.asarray(x) for x in [o] + dirs + caps + acts))
    bits_t, ao_t, _ = TK.trace_bundle_kernel(
        scenes["scene"], _t(o), [_t(x) for x in dirs[:2]],
        [_t(x) for x in caps[:2]], [_t(x) for x in acts[:2]], [_t(dirs[2])],
        [_t(caps[2])], [_t(acts[2])], root_code=scenes["roots_j"][0],
        stack_size=scenes["stack"])
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))
    np.testing.assert_allclose(ao_t[0].numpy(), np.asarray(ao_j[0]),
                               rtol=T_REL)
    assert 0 < (bits_t.numpy() & 1).mean() < 1
