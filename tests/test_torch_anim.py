"""The PyTorch port's animation against the JAX package, on the CPU:
``ops/animation.py``, unique-geometry BLASes (build, refit, re-split), the
anim rows of both scene layouts, and the animated RT, paged, hybrid and
config-5 frames.

Inputs come from seeds through numpy (or from the same scene built through
each package's API); each JAX frame is jitted once. Tolerances:

* animation ops (400 instances, 3 frames, each frame's instances fed to
  the next; the JAX function jitted, as the example's loop runs it): both
  packages evaluate the golden-ratio phase and the bob's sine argument in
  f32, and jitted XLA folds the phase's constants and contracts the
  argument into an FMA where the port rounds each product, so each is off
  a float64 evaluation by up to 0.5 x (the phase's f32 error, ~1.5e-4 rad
  at slot 399) a frame: measured 1.5e-4 for both after 3 frames and
  1.2e-4 between them; POS_TOL = 2.5e-4 bounds all three. The quaternions
  (XLA's FMAs in dq * q): 1.1e-7 / 1.5e-7 off float64, 1.8e-7 apart;
  QUAT_TOL = 3e-7. At 100k instances the phase reaches 3.9e5 rad and the
  same errors grow with it: 4.2e-2 (JAX) and 5.7e-2 (the port) off float64,
  4.7e-2 apart after 3 frames. Vertices: 2.4e-7 apart at t = 0.7 and 123.4
  (VERT_TOL = 5e-7);
* host-built tables (anim rows, codes, prims, AnimBLAS fields) exactly;
  with an animate that is exact in f32 the refit and re-split rows and
  the permutation are bitwise with the JAX functions run op by op (jitted
  XLA turns the centroid's / 3.0 into * (1/3), which regroups
  near-tied centroids); with the swirl (sin/cos) 1e-6 relative; the
  batched refit and re-split bitwise against one BLAS at a time;
* assembled node rows 1e-6 relative, codes exactly; the plain K7/K10 hits
  against JAX's ``trace_scene``: hit flags exactly, t at 1e-5 relative to
  max(t, 1) (the animated vertices differ by ulps: XLA contracts the
  sine's argument into an FMA), prim and instance equal except where t
  ties;
* frames: RT HDR mean |diff| <= 1e-3 (tests/test_torch_rt.py's bound),
  hybrid LDR mean <= 0.004 and the raster frame within the golden bands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paperrenderer_tpu as JPKG
import paperrenderer_tpu_torch as TPKG
from paperrenderer_tpu.ops import accel as JA
from paperrenderer_tpu.ops import animation as JAN
from paperrenderer_tpu.ops import static_batch as JS
from paperrenderer_tpu_torch import scenes as TSC
from paperrenderer_tpu_torch.interop import from_numpy
from paperrenderer_tpu_torch.ops import accel as TA
from paperrenderer_tpu_torch.ops import animation as TAN
from paperrenderer_tpu_torch.ops import static_batch as TS
from paperrenderer_tpu_torch.ops import trace_kernel as TK

POS_TOL, QUAT_TOL, VERT_TOL = 2.5e-4, 3e-7, 5e-7
REL = 1e-6
T_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's tests: the tier-1 run
    puts several pytest workers on the machine's cores, and torch's default
    of one thread per core then oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=rel,
                               atol=rel * max(1.0, np.abs(want[fin]).max()))


def _bands(img, ref, mean_tol=0.004, frac_tol=0.002, pix_thresh=0.06):
    diff = np.abs(np.asarray(img, np.float32) - ref).max(axis=-1)
    assert diff.mean() <= mean_tol, diff.mean()
    assert (diff > pix_thresh).mean() <= frac_tol, (diff > pix_thresh).mean()


def _each(cases, check):
    """``check(case)`` for every case, reporting each one that fails. The
    cases share one collected test so that the file counts five tests:
    xdist's ``--dist loadfile`` then hands it out after
    tests/test_parallel_static.py, the tier-1 run's critical path."""
    failed = []
    for case in cases:
        try:
            check(case)
        except AssertionError as exc:
            failed.append(f"{case}: {exc}")
    assert not failed, "\n".join(failed)


# -- (a) the animation ops ---------------------------------------------------

def _f64_instances(pos, quat, alive, t):
    """animate_instances in float64 (t the f32 time)."""
    idx = np.arange(pos.shape[0], dtype=np.float64)
    phase = idx * 0.618034 * 2.0 * np.pi
    pos = pos.copy()
    pos[:, 2] += np.where(alive, np.sin(2.0 * t + phase) * 0.5, 0.0)
    dw, dz = np.cos(0.5 * t), np.sin(0.5 * t)
    w, x, y, z = quat.T
    q = np.stack([dw * w - dz * z, dw * x - dz * y, dw * y + dz * x,
                  dw * z + dz * w], -1)
    return pos, np.where(alive[:, None], q, quat)


def test_animation_ops_match_jax():
    """animate_instances over 3 compounding frames (400 slots, 5% dead),
    animate_vertices, and expand_static(animate=) against the JAX package
    and float64."""
    n = 400
    rng = np.random.default_rng(0)
    pos = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    mid = np.where(rng.uniform(size=n) < 0.95, rng.integers(0, 2, n),
                   -1).astype(np.int32)
    arrays = dict(pos=pos, scale=np.ones((n, 3), np.float32), quat=quat,
                  model_id=mid)
    ji = JPKG.core.scene.InstanceArrays(
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    ti = from_numpy("InstanceArrays", arrays, device="cpu")
    f_pos, f_quat = pos.astype(np.float64), quat.astype(np.float64)
    step = jax.jit(JAN.animate_instances)
    for k in range(3):
        t = 0.05 * (k + 1)
        ji, ti = step(ji, jnp.float32(t)), TAN.animate_instances(ti, t)
        f_pos, f_quat = _f64_instances(f_pos, f_quat, mid >= 0,
                                       float(np.float32(t)))
        for got in (ti.pos.numpy(), np.asarray(ji.pos)):
            np.testing.assert_allclose(got, f_pos, rtol=0, atol=POS_TOL)
        for got in (ti.quat.numpy(), np.asarray(ji.quat)):
            np.testing.assert_allclose(got, f_quat, rtol=0, atol=QUAT_TOL)
        np.testing.assert_allclose(ti.pos.numpy(), np.asarray(ji.pos),
                                   rtol=0, atol=POS_TOL)
        np.testing.assert_allclose(ti.quat.numpy(), np.asarray(ji.quat),
                                   rtol=0, atol=QUAT_TOL)
    dead = mid < 0     # dead slots keep their rows, bit for bit
    np.testing.assert_array_equal(ti.pos.numpy()[dead], pos[dead])
    np.testing.assert_array_equal(ti.quat.numpy()[dead], quat[dead])
    np.testing.assert_array_equal(ti.model_id.numpy(), mid)

    v = rng.uniform(-3, 3, (2000, 3)).astype(np.float32)
    for t in (0.7, 123.4):
        want = np.asarray(jax.jit(JAN.animate_vertices)(jnp.asarray(v),
                                                        jnp.float32(t)))
        got = TAN.animate_vertices(_t(v), t).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=VERT_TOL)
        np.testing.assert_array_equal(got[:, :2], v[:, :2])

    # expand_static moves the object-space vertices before the transform
    from examples.render_dynamic import build_dynamic_scene as build_jax

    _, rp, cam = TSC.build_dynamic_scene(64, 64, 32, device="cpu")
    _, rpj, camj = build_jax(64, 64, 32)
    mapping, inst, tables, _, cmat, slots, vis = rp.frame_inputs(cam)
    inst_j = rpj.scene.flush()
    slots_j, vis_j, _ = rpj._device_inputs(inst_j.capacity)
    want, _ = jax.jit(lambda m, i, tb, c, s, v, t: JS.expand_static(
        m, i, tb, c, s, v, animate_time=t, animate=JAN.animate_vertices))(
        rpj._current_mapping(), inst_j, rpj.scene.tables(), camj.matrices,
        slots_j, vis_j, jnp.float32(0.7))
    got, _ = TS.expand_static(mapping, inst, tables, cmat, slots, vis,
                              animate_time=0.7,
                              animate=TAN.animate_vertices)
    still, _ = TS.expand_static(mapping, inst, tables, cmat, slots, vis)
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_allclose(got.world.numpy()[valid],
                               np.asarray(want.world)[valid], rtol=1e-6,
                               atol=2e-5)
    assert np.abs(got.world.numpy() - still.world.numpy())[valid].max() > 0.05


# -- (b) unique-geometry BLASes: build, refit, re-split -----------------------

UNIQUE = (1, 2, 3, 5, 6, 7)


def _unique_scene(pkg, device=None):
    """Nine instances of four models (a cube, an icosphere: 16 implicit
    leaves, a 2-triangle plane: 1 leaf, a 12 x 12 sheet: 64 leaves), seeded
    transforms; instances 1, 2, 3, 5, 6 and 7 unique-geometry with phase
    0.3 i: leaf counts 16 (twice), 1 (twice) and 64 (twice)."""
    rng = np.random.RandomState(3)
    scene = (pkg.Scene(use_native=False) if device is None
             else pkg.Scene(device=device))
    arena = scene.arena
    models = [pkg.Model.from_mesh(arena, *pkg.make_cube(1.0)),
              pkg.Model.from_mesh(arena, *pkg.make_icosphere(0.6, 1)),
              pkg.Model.from_mesh(arena, *pkg.make_plane(2.0, 1)),
              pkg.Model.from_mesh(arena, *pkg.make_plane(4.0, 12))]
    for i in range(9):
        inst = pkg.ModelInstance(models[i % 4], unique_geometry=i in UNIQUE,
                                 anim_phase=0.3 * i)
        q = rng.randn(4).astype(np.float32)
        inst.set_transform(pos=rng.uniform(-3, 3, 3).astype(np.float32),
                           scale=rng.uniform(0.5, 1.5, 3).astype(np.float32),
                           quat=q / np.linalg.norm(q))
        scene.add_instance(inst)
    return scene


def _exact_jax(v, t):
    """An animate that is exact in f32: adds and multiplies by powers of
    two (t = 0.5 + phase, phases multiples of 0.3 rounded once)."""
    return v * 2.0 + t * 0.25


def _exact_port(v, t):
    return v * 2.0 + t * 0.25   # under torch.vmap: v [M, 3], t []


def _swirl_jax(v, t):
    """tests/test_accel.py's radius-proportional swirl."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    th = 2.5 * jnp.sqrt(x * x + y * y) + 0.0 * t
    return jnp.stack([x * jnp.cos(th) - y * jnp.sin(th),
                      x * jnp.sin(th) + y * jnp.cos(th), z], axis=-1)


def _swirl_port(v, t):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    th = 2.5 * torch.sqrt(x * x + y * y) + 0.0 * t
    return torch.stack([x * torch.cos(th) - y * torch.sin(th),
                        x * torch.sin(th) + y * torch.cos(th), z], dim=-1)


ANIMATE = {"exact": (_exact_jax, _exact_port),
           "swirl": (_swirl_jax, _swirl_port)}


@pytest.fixture(scope="module")
def blas_sets():
    """The unique-instance scene's BLAS set in both packages."""
    sj = _unique_scene(JPKG)
    st = _unique_scene(TPKG, device="cpu")
    return sj, st, JA.build_blas_set(sj), TA.build_blas_set(st, "cpu")


def _node_sa(nodes):
    """Total surface area of the child boxes of node rows f32[N, 12]."""
    rows = np.asarray(nodes, np.float64)
    sa = 0.0
    for lo, hi in ((rows[:, 0:3], rows[:, 3:6]), (rows[:, 6:9], rows[:, 9:12])):
        e = np.maximum(hi - lo, 0.0)
        ok = np.all(np.isfinite(e), axis=-1)
        sa += float(np.where(ok, e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                             + e[:, 0] * e[:, 2], 0.0).sum())
    return sa


def test_anim_blas_refit_resplit(blas_sets):
    """build_blas_set's anim part equals the JAX package's exactly and
    leaves the static part as it was; the refit and re-split follow JAX
    (bitwise with an exact animate, 1e-6 relative with the swirl, whose
    re-split boxes are under 0.8x the refit's); the batched refit and
    re-split equal one BLAS at a time, bit for bit."""
    _each(["tables", "exact", "swirl", "batched"],
          lambda case: _blas_case(blas_sets, case))


def _blas_case(blas_sets, case):
    sj, st, (bj, mj, arj, anj), (bt, mt, art, ant) = blas_sets
    t0 = 0.5
    if case == "tables":
        assert len(mt.anim) == len(mj.anim) == len(UNIQUE)
        for f in ("max_depth", "num_static_nodes", "num_static_leaves",
                  "num_anim_nodes", "num_anim_leaves", "num_blas",
                  "num_bchunks", "total_nodes"):
            assert getattr(mt, f) == getattr(mj, f), f
        np.testing.assert_array_equal(mt.blas_of_model, mj.blas_of_model)
        np.testing.assert_array_equal(mt.anim_node_codes, mj.anim_node_codes)
        np.testing.assert_array_equal(mt.anim_leaf_prim, mj.anim_leaf_prim)
        for a, b in zip(mt.anim, mj.anim):
            for f in ("blas_id", "instance_index", "node_off", "node_count",
                      "leaf_off", "num_leaves", "phase"):
                assert getattr(a, f) == getattr(b, f), f
            for f in ("rest_rows", "rest_prim", "node_codes"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(art.numpy(), np.asarray(arj))
        np.testing.assert_array_equal(ant.numpy(), np.asarray(anj))
        for f in ("nodes", "codes", "leaf_rows", "leaf_prim", "root_min",
                  "root_max", "root_code"):
            np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                          np.asarray(getattr(bj, f)))
        # the static part is what a scene without unique instances builds
        for inst in st.instances:
            inst.unique_geometry = False
        b0, m0, ar0, an0 = TA.build_blas_set(st, "cpu")
        for inst in st.instances:
            inst.unique_geometry = inst.index in UNIQUE
        assert ar0.shape[0] == an0.shape[0] == 0 and not m0.anim
        assert m0.num_static_nodes == mt.num_static_nodes
        for f in ("nodes", "codes", "leaf_rows", "leaf_prim"):
            np.testing.assert_array_equal(getattr(b0, f).numpy(),
                                          getattr(bt, f).numpy())
        return
    if case == "batched":
        for anim in (TAN.animate_vertices, _swirl_port):
            one = TA.refit_anim_blases(mt, art, t0, anim, batched=False)
            many = TA.refit_anim_blases(mt, art, t0, anim)
            for x, y in zip(one, many):
                np.testing.assert_array_equal(x.numpy(), y.numpy())
            one = TA.resplit_anim_tables(mt, art, t0, anim, batched=False)
            many = TA.resplit_anim_tables(mt, art, t0, anim)
            for x, y in zip(one, many):
                np.testing.assert_array_equal(x.numpy(), y.numpy())
        return
    fj, ft = ANIMATE[case]
    close = ((lambda a, b: np.testing.assert_array_equal(a, b))
             if case == "exact" else _rel_close)
    refit_j = JA.refit_anim_blases(mj, arj, jnp.float32(t0), fj)
    refit_t = TA.refit_anim_blases(mt, art, t0, ft)
    for x, y in zip(refit_t, refit_j):
        close(x.numpy(), np.asarray(y))
    rs_j = JA.resplit_anim_tables(mj, arj, jnp.float32(t0), fj)
    rs_t = TA.resplit_anim_tables(mt, art, t0, ft)
    if case == "exact":
        np.testing.assert_array_equal(rs_t[0].numpy(), np.asarray(rs_j[0]))
        np.testing.assert_array_equal(rs_t[1].numpy(), np.asarray(rs_j[1]))
    else:   # the same triangles in each leaf (a tie may swap two slots)
        got = np.sort(rs_t[1].numpy(), axis=1)
        np.testing.assert_array_equal(got, np.sort(np.asarray(rs_j[1]),
                                                   axis=1))
    nodes_rs = TA.refit_anim_blases(mt, rs_t[0], t0, ft,
                                    anim_prim=rs_t[1])[0]
    nodes_rs_j = JA.refit_anim_blases(mj, rs_j[0], jnp.float32(t0), fj,
                                      anim_prim=rs_j[1])[0]
    close(nodes_rs.numpy(), np.asarray(nodes_rs_j))
    if case == "swirl":   # the sheets (64 leaves) deform most
        sheet = [a for a in mt.anim if a.num_leaves == 64]
        rows = np.concatenate([np.arange(a.node_off, a.node_off + a.node_count)
                               for a in sheet])
        assert (_node_sa(nodes_rs.numpy()[rows])
                < 0.8 * _node_sa(refit_t[0].numpy()[rows]))


# -- (c) the anim rows of both layouts, traced ---------------------------------

@pytest.fixture(scope="module")
def rays(blas_sets):
    """Rays from random points of the unique-instance scene's box, each
    aimed near an instance (a unique one three times in four)."""
    rng = np.random.default_rng(5)
    n = 384
    st = blas_sets[1]
    pos = np.stack([i.position for i in st.instances])
    pick = np.where(rng.uniform(size=n) < 0.75,
                    rng.choice(UNIQUE, n), rng.integers(0, len(pos), n))
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = (pos[pick] + rng.normal(scale=0.4, size=(n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, 100.0, np.float32)


# one compile for each (table shapes, root, stack): the rest and refit
# cases share it
_jax_trace = jax.jit(JA.trace_scene, static_argnames=("root_code",
                                                      "stack_size"))


def _inst_blas(scene, meta):
    cap = scene.flush().capacity
    arr = np.zeros(cap, np.int32)
    for inst in scene.instances:
        arr[inst.index] = meta.blas_of_model[inst.model.model_id]
    for a in meta.anim:
        arr[a.instance_index] = a.blas_id
    return arr


def test_anim_scene_assembly_and_hits(blas_sets, rays):
    """assemble_scene / assemble_scene_paged at the rest pose (no animate),
    refit, and re-split then refit (animate_vertices at t = 0.7): the node
    rows at 1e-6 relative and every code and prim as the JAX package's
    (its functions op by op); the port's plain K7 (flat) or K10 (paged)
    hits against JAX's trace_scene on its own scene (the paged one through
    paged_to_flat)."""
    _each([(mode, paged) for mode in ("rest", "refit", "resplit")
           for paged in (False, True)],
          lambda case: _assembly_case(blas_sets, rays, *case))


def _assembly_case(blas_sets, rays, mode, paged):
    sj, st, (bj, mj, arj, anj), (bt, mt, art, ant) = blas_sets
    ij, it = sj.flush(), st.flush()
    cap = it.capacity
    ib = _inst_blas(st, mt)
    kw_j = kw_t = {}
    if mode != "rest":
        kw_j = dict(time=jnp.float32(0.7), animate=JAN.animate_vertices,
                    resplit=mode == "resplit")
        kw_t = dict(time=0.7, animate=TAN.animate_vertices,
                    resplit=mode == "resplit")
    tri_j, tri_t = JA.build_tri_attr(sj), TA.build_tri_attr(st, "cpu")
    masks = [np.ones(cap, bool)]
    if paged:
        slots = np.zeros((cap, 1), np.int32)
        pj, root_j = JA.assemble_scene_paged(
            bj, mj, arj, anj, ij, jnp.asarray(ib), jnp.asarray(masks[0]),
            jnp.asarray(slots), tri_j, **kw_j)
        pt, root_t = TA.assemble_scene_paged(
            bt, mt, art, ant, it, _t(ib), _t(masks[0]), _t(slots), tri_t,
            **kw_t)
        assert root_t == root_j
        fields = ("static_nodes", "chunk_boxes", "leaf_rows")
        exact = ("static_codes", "chunk_codes", "leaf_prim")
        flat_j, remap = JA.paged_to_flat(pj)
        root_j = remap(root_j)
    else:
        flat_j, roots_j = JA.assemble_scene(
            bj, mj, arj, anj, ij, jnp.asarray(ib),
            [jnp.asarray(m) for m in masks], tri_j, **kw_j)
        pt, roots_t = TA.assemble_scene(bt, mt, art, ant, it, _t(ib),
                                        [_t(m) for m in masks], tri_t, **kw_t)
        assert roots_t == roots_j
        root_j = roots_j[0]
        fields, exact = ("nodes", "leaf_rows"), ("codes", "leaf_prim")
        pj = flat_j
    for f in fields:
        _rel_close(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)))
    for f in exact:
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)))
    if mode == "rest":   # the rest rows are the host build's
        nb, lb = mt.num_static_nodes, mt.num_static_leaves
        nodes = pt.static_nodes if paged else pt.nodes
        np.testing.assert_array_equal(
            nodes[nb:nb + mt.num_anim_nodes].numpy(), ant.numpy())
        np.testing.assert_array_equal(
            pt.leaf_rows[lb:lb + mt.num_anim_leaves].numpy(), art.numpy())

    stack = TA.required_stack_size(mt, cap)
    assert stack == JA.required_stack_size(mj, cap)
    o, d, t = rays
    want = _jax_trace(flat_j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                      root_code=root_j, stack_size=stack)
    if paged:
        got = TA.PagedSceneTracer(pt, _t(slots), None, root_code=root_t,
                                  stack_size=stack).trace(_t(o), _t(d), _t(t))
    else:
        got = TK.trace_scene_kernel(pt, _t(o), _t(d), _t(t),
                                    root_code=roots_t[0], stack_size=stack)
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert 0.2 < hit.mean() < 1.0
    tj = np.asarray(want.t)
    np.testing.assert_allclose(got.t.numpy()[hit], tj[hit], rtol=T_REL,
                               atol=T_REL)
    differ = ((got.prim.numpy() != np.asarray(want.prim))
              | (got.inst.numpy() != np.asarray(want.inst)))
    for k in np.nonzero(differ)[0]:   # another triangle at the same t
        assert abs(got.t.numpy()[k] - tj[k]) <= T_REL * max(1.0, tj[k]), k
    assert differ.mean() < 0.02


# -- (d) animated frames ---------------------------------------------------------

def _jax_unique(render, indices, phases=None, resplit=False):
    """``scenes._make_unique`` on a JAX package render."""
    for k, i in enumerate(indices):
        inst = render.scene.instances[i]
        inst.unique_geometry = True
        inst.anim_phase = 0.0 if phases is None else float(phases[k])
    render.animate = JAN.animate_vertices
    if hasattr(render, "anim_resplit"):
        render.anim_resplit = resplit
    return render


def _frame_pair(case):
    """(JAX image, port image) of one animated frame at 48x32, t = 0.7 (the
    dynamic loop: 400 instances at 128x64, 3 frames after its t = 0
    frame)."""
    if case == "rt_flat_resplit":
        from examples.render_rt import build_rt_scene as build_jax

        _, rtj, camj = build_jax(48, 32)
        _jax_unique(rtj, [1], resplit=True)
        _, rt, cam = TSC.build_animated_rt_scene(48, 32, resplit=True,
                                                 device="cpu")
        ldr, aux = rt.render(cam, time=0.7)
        assert not rt.accel.prefer_paged(rt.scene.flush().capacity)
        return (np.asarray(rtj.render(camj, time=0.7)[1]["hdr"]),
                aux["hdr"].numpy())
    if case == "crowd_paged":
        from examples.render_crowd import build_crowd_scene as build_jax

        _, _, rtj, camj = build_jax(600, 48, 32)
        ids = list(range(0, 600, 64))
        _jax_unique(rtj, ids, [0.1 * i for i in ids])
        _, _, rt, cam = TSC.build_animated_crowd_scene(600, 48, 32,
                                                       device="cpu")
        assert rt.accel.blas()[1].num_anim_leaves == 10 * 16
        return (np.asarray(rtj.render(camj, time=0.7)[1]["hdr"]),
                rt.render(cam, time=0.7, paged=True)[1]["hdr"].numpy())
    if case == "hybrid":
        from examples.render_hybrid import build_hybrid_scene as build_jax

        _, hyj, camj = build_jax(48, 32)
        _jax_unique(hyj, [1])
        _, hy, cam = TSC.build_animated_hybrid_scene(48, 32, device="cpu")
        ldr, aux = hy.render(cam, time=0.7)
        assert not aux["paged"]
        return np.asarray(hyj.render(camj, time=0.7)[0]), ldr.numpy()
    from examples.render_dynamic import run

    _, _, ldr_j, aux_j = run(400, 128, 64, frames=3)
    ms, ldr, aux = TSC.run_dynamic(400, 128, 64, frames=3, device="cpu")
    assert len(ms) == 3
    assert int(aux["visible_count"]) == int(aux_j["visible_count"])
    assert int(aux["total_tris"]) == int(aux_j["total_tris"])
    return np.asarray(ldr_j), ldr.numpy()


def test_animated_frames_match_jax():
    """The animated RT scene (flat, re-split every frame), the 600-instance
    crowd with one instance in 64 animated (forced onto the paged layout;
    the JAX package traces it flat on the CPU), the animated hybrid
    example, and config 5's loop, each against the JAX package's frame."""
    _each(["rt_flat_resplit", "crowd_paged", "hybrid", "dynamic"],
          _frame_case)


def _frame_case(case):
    want, got = _frame_pair(case)
    assert got.shape == want.shape and np.isfinite(got).all()
    if case in ("rt_flat_resplit", "crowd_paged"):
        assert np.abs(got - want).mean() <= 1e-3, np.abs(got - want).mean()
    elif case == "hybrid":
        diff = np.abs(got - want).max(axis=-1)
        assert diff.mean() <= 0.004, diff.mean()
    else:
        _bands(got, want)


# -- (e) the API -------------------------------------------------------------------

def test_animation_api():
    """Adding or removing a unique-geometry instance rebuilds the BLAS set
    (and the instances' BLAS ids) as the JAX package's AccelCache does; a
    unique instance with no ``animate`` traces at its rest pose, the same
    frame bit for bit as the model's own BLAS; ``use_pallas=False`` (the
    XLA route, ROADMAP Queue 1 item 8) still raises."""
    _each(["rebuild", "rest_pose", "use_pallas"], _api_case)


def _api_case(case):
    if case == "use_pallas":
        eng = TPKG.RenderEngine(device="cpu", device_check=False)
        for make in (eng.create_ray_trace_render, eng.create_hybrid_render):
            make(animate=TAN.animate_vertices)   # accepted
            with pytest.raises(NotImplementedError, match="item 8"):
                make(animate=TAN.animate_vertices, use_pallas=False)
        return
    if case == "rest_pose":
        _, rt, cam = TSC.build_animated_rt_scene(48, 32, device="cpu")
        rt.animate = None
        rest = rt.render(cam, time=0.7)[1]["hdr"].numpy()
        _, rt0, cam0 = TSC.build_rt_scene(48, 32, device="cpu")
        np.testing.assert_array_equal(rest,
                                      rt0.render(cam0)[1]["hdr"].numpy())
        assert rt.accel.blas()[1].num_anim_leaves == 128
        return
    from paperrenderer_tpu.render.raytrace import AccelCache as JAccel
    from paperrenderer_tpu_torch.render.raytrace import AccelCache as TAccel

    sj, st = _unique_scene(JPKG), _unique_scene(TPKG, device="cpu")
    caches = JAccel(sj), TAccel(st)

    def same():
        (_, mj, arj, _), (_, mt, art, _) = caches[0].blas(), caches[1].blas()
        assert [a.instance_index for a in mt.anim] == [
            a.instance_index for a in mj.anim]
        assert mt.num_anim_leaves == mj.num_anim_leaves
        np.testing.assert_array_equal(art.numpy(), np.asarray(arj))
        cap = st.flush().capacity
        assert sj.flush().capacity == cap
        np.testing.assert_array_equal(caches[1].inst_blas(cap).numpy(),
                                      np.asarray(caches[0].inst_blas(cap)))
        return mt

    first = same()
    for sc, pkg in ((sj, JPKG), (st, TPKG)):   # one more unique sphere
        sc.add_instance(pkg.ModelInstance(sc.instances[1].model,
                                          unique_geometry=True))
    grown = same()
    assert len(grown.anim) == len(first.anim) + 1
    assert caches[1].blas()[1] is grown        # cached while unchanged
    for sc in (sj, st):                        # remove unique instance 2
        sc.remove_instance(sc.instances[2])
    shrunk = same()
    assert len(shrunk.anim) == len(first.anim)
    assert shrunk is not grown
