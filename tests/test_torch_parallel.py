"""The PyTorch port's screen-tile rendering (``paperrenderer_tpu_torch.parallel``)
on the CPU: four gloo ranks in a 2x2 mesh, spawned once for the module.

Each rank renders every case and rank 0 writes the gathered frames
(``gather_tiles``); the tests hold them to the port's single-device frames
and to the JAX package's sharded frames, and the windowed ops beneath them
to the JAX package's and to the single-device run. Five tests, so that
xdist hands this file out after ``tests/test_parallel_static.py``.

Tolerances: the static frames, the windowed K1 / G-buffer / K2 peel and the
windowed rays are bitwise the port's own single-device results (the
coefficients are the full viewport's and the origin enters in integers).
Against the JAX package: the windowed K1 on JAX's own table to the per-pixel
rule's 1e-6 depth (tid differing only on depth ties), and the port's whole
windowed raster to the setup's 5e-4 (``test_rasterize_exact_matches_jax``'s
bounds); the windowed rays to 2e-6 (XLA's FMA contraction in the matrix
products); the sharded RT frames, flat and paged, to a mean LDR |diff| of
1e-3 (measured 1.9e-5 on both, max 0.0039), the world-BVH frame
(``sharded_rt_frame``) to the same 1e-3 (measured 4.5e-8, max 2.2e-6),
and the hybrid frame to the golden band's mean 0.004 (measured 1.5e-4,
max 0.023): ROADMAP Queue 3's pinned RT and hybrid divergences (XLA's
FMAs, and JAX's hybrid G-buffer from ``raster.rasterize``); the tile keys
bitwise equal.
"""

import dataclasses
import functools
import json
import os
import threading

import numpy as np
import pytest
import torch

RT_W, RT_H = 64, 32          # the RT and hybrid frames (JAX's 4-device cut)
SIZE = 64                    # the static frames
STATIC_CASES = dict(
    xla=dict(use_pallas=False),
    k1=dict(use_pallas=True),
    peel2=dict(use_pallas=True, translucent_layers=2),
    peel2_xla=dict(use_pallas=False, translucent_layers=2),
    ss2=dict(use_pallas=True, supersample=2),
    textured=dict(use_pallas=True),
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's tests: the tier-1 run
    puts several pytest workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _static_scene(case):
    """The textured example, or the example scene with its second instance
    a 50% glass and its fourth a leaf cutout (both peeled)."""
    from paperrenderer_tpu_torch import Material
    from paperrenderer_tpu_torch.core import SHADE_LEAF, SHADE_TRANSLUCENT
    from paperrenderer_tpu_torch.scenes import (build_example_scene,
                                                build_textured_scene)

    if case == "textured":
        _, _, rp, cam = build_textured_scene(SIZE, SIZE, device="cpu")
        return rp, cam
    rp, cam = build_example_scene(SIZE, SIZE, device="cpu")
    glass = Material("glass", albedo=(0.6, 0.8, 0.95), roughness=0.1,
                     alpha=0.5, shading_model=SHADE_TRANSLUCENT)
    leaf = Material("leaf", albedo=(0.25, 0.7, 0.2), roughness=0.6,
                    shading_model=SHADE_LEAF)
    rp.add_instance(rp.scene.instances[1], {0: glass.instance()})
    rp.add_instance(rp.scene.instances[3], {0: leaf.instance()})
    return rp, cam


def _rank_body(rank, world, out_dir):
    """One rank of the module's 2x2 mesh: every case, its tile gathered."""
    torch.set_num_threads(1)
    from paperrenderer_tpu_torch.parallel import (
        gather_tiles, make_sharded_hybrid_frame, make_sharded_rt_frame,
        make_tile_mesh, sharded_render_frame, sharded_render_frame_static)
    from paperrenderer_tpu_torch.parallel import tiles as PT
    from paperrenderer_tpu_torch.scenes import (build_example_scene,
                                                build_hybrid_scene,
                                                build_rt_scene)
    from paperrenderer_tpu_torch.utils import random as rnd

    mesh = make_tile_mesh()
    out = {}
    for case, kw in STATIC_CASES.items():
        rp, cam = _static_scene(case)
        args, frame_kw = PT.static_inputs(rp, cam)
        ldr, req, aux = sharded_render_frame_static(
            mesh, *args, **frame_kw, **kw, return_required=True,
            return_aux=True)
        out[case] = dict(ldr=gather_tiles(ldr, mesh), required=req,
                         depth=gather_tiles(aux["depth"], mesh),
                         tri_id=gather_tiles(aux["tri_id"], mesh))
    rp, cam = _static_scene("xla")
    draw = rp.draw_list_inputs(cam)
    out["draw_list"] = gather_tiles(sharded_render_frame(
        mesh, draw["instances"], draw["tables"], draw["geo"],
        draw["materials"], rp.lights, draw["camera"], draw["slot_materials"],
        draw["instance_visible"], rp.tonemap_params, width=SIZE,
        height=SIZE, max_meshes_per_lod=draw["max_meshes_per_lod"],
        tri_capacity=draw["tri_capacity"]), mesh)
    rp, cam = build_example_scene(128, 128, device="cpu")
    args, kw = PT.static_inputs(rp, cam)
    out["golden"] = gather_tiles(sharded_render_frame_static(
        mesh, *args, **kw), mesh)           # the XLA route, JAX's default
    key = rnd.prng_key(7)
    _, rt, cam = build_rt_scene(RT_W, RT_H, device="cpu")
    for paged in (False, True):
        meta, args, kw = PT.rt_inputs(rt, cam, key)
        frame = make_sharded_rt_frame(mesh, meta, use_pallas=True,
                                      paged=paged)
        out["rt", paged] = gather_tiles(frame(*args, **kw), mesh)
    _, hy, cam = build_hybrid_scene(RT_W, RT_H, device="cpu")
    meta, args, kw = PT.hybrid_inputs(hy, cam, key)
    ldr, aux = make_sharded_hybrid_frame(mesh, meta, use_pallas_trace=True)(
        *args, **kw, use_pallas=True)
    out["hybrid"] = gather_tiles(ldr, mesh)
    out["hybrid_required"] = aux["required_work"]
    _, rt, cam = build_rt_scene(RT_W, RT_H, device="cpu")
    out["world_rt"] = gather_tiles(_world_rt_tile(mesh, rt, cam, key), mesh)
    with open(os.path.join(out_dir, f"mesh{rank}.json"), "w") as f:
        json.dump(dict(shape=mesh.shape, coords=mesh.coords,
                       index=mesh.index, backend=mesh.backend,
                       axes=mesh.axis_names), f)
    if rank == 0:
        torch.save(out, os.path.join(out_dir, "gathered.pt"))


def _world_rt_tile(mesh, rt, cam, key):
    """The rank's tile of the legacy world-BVH RT frame
    (``sharded_rt_frame``) of a RayTraceRender's scene and samples."""
    from paperrenderer_tpu_torch.ops.trace import RTParams
    from paperrenderer_tpu_torch.parallel import sharded_rt_frame

    args, kw = rt.world_inputs(cam, key)
    params = RTParams(shadow_samples=kw["shadow_samples"],
                      reflection_samples=kw["reflection_samples"],
                      ao_samples=kw["ao_samples"], ao_radius=kw["ao_radius"])
    return sharded_rt_frame(
        mesh, *args[:9], width=kw["width"], height=kw["height"],
        max_meshes_per_lod=kw["max_meshes_per_lod"],
        tri_capacity=kw["tri_capacity"], params=params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks, started at once in the background; calling the
    fixture's value joins them (a rank that raises or outlives the
    timeout fails the test) and returns (gathered frames, mesh records)."""
    from paperrenderer_tpu_torch.parallel import spawn_ranks

    d = tmp_path_factory.mktemp("ranks")
    state = {}

    def run():
        try:
            spawn_ranks(_rank_body, 4, backend="gloo",
                        init_file=str(d / "store"), args=(str(d),),
                        timeout=240)
        except BaseException as exc:   # re-raised in the joining test
            state["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "error" in state:
            raise state["error"]
        if "out" not in state:
            state["out"] = (torch.load(d / "gathered.pt"),
                            [json.load(open(d / f"mesh{r}.json"))
                             for r in range(4)])
        return state["out"]

    return result


def test_tile_mesh_matches_jax(ranks):
    """(i) ``make_tile_mesh`` over 1-8 ranks (torch's fake process group,
    one process) against JAX's ``make_tile_mesh(jax.devices()[:n])``: the
    shape and every rank's tile, row-major as JAX reshapes its device
    list. The 2x2 gloo ranks' own meshes are checked in test (iii)."""
    import jax
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from paperrenderer_tpu.parallel import make_tile_mesh as jax_mesh
    from paperrenderer_tpu_torch.parallel import make_tile_mesh
    from paperrenderer_tpu_torch.parallel.mesh import _factor2

    with pytest.raises(RuntimeError, match="initialized process group"):
        make_tile_mesh()
    devices = jax.devices()
    for n in range(1, 9):
        jm = jax_mesh(devices[:n])
        assert _factor2(n) == jm.devices.shape
        for r in range(n):
            dist.init_process_group("fake", store=FakeStore(), rank=r,
                                    world_size=n)
            try:
                m = make_tile_mesh()
            finally:
                dist.destroy_process_group()
            (row,), (col,) = np.nonzero(jm.devices == devices[r])
            assert m.shape == jm.devices.shape, (n, r)
            assert m.coords == (row, col) and m.index == r, (n, r)
            assert m.axis_names == tuple(jm.axis_names)


def _cam(width, height):
    from paperrenderer_tpu import core as JC

    cam = JC.Camera(yfov_deg=50.0, aspect=width / height, near=0.05,
                    far=100.0)
    cam.look_at((0.0, -9.0, 1.0), (0.0, 0.0, 0.0), up=(0, 0, 1))
    return cam


def _twelve_instances(width, height):
    """Twelve spheres and cubes in a wide strip (a 256x16 viewport's):
    (JAX scene, its RenderPass, camera)."""
    from paperrenderer_tpu import core as JC
    from paperrenderer_tpu.render import RenderPass as JRenderPass

    scene = JC.Scene(use_native=False)
    sphere = JC.Model.from_mesh(
        scene.arena, *JC.make_uv_sphere(radius=1.0, rings=10, sectors=14))
    cube = JC.Model.from_mesh(scene.arena, *JC.make_cube())
    rp = JRenderPass(scene, JC.MaterialRegistry(), width=width,
                     height=height)
    rng = np.random.default_rng(7)
    for i in range(12):
        inst = JC.ModelInstance(sphere if i % 2 == 0 else cube)
        s = float(rng.uniform(0.3, 1.2))
        inst.set_transform(pos=(float(rng.uniform(-9, 9)),
                                float(rng.uniform(-2, 2)),
                                float(rng.uniform(-0.6, 0.6))),
                           scale=(s, s, s))
        rp.add_instance(inst)
    cam = JC.Camera(yfov_deg=50.0, aspect=width / height, near=0.05,
                    far=100.0)
    cam.look_at((0.0, -9.0, 1.0), (0.0, 0.0, 0.0), up=(0, 0, 1))
    return scene, rp, cam


def _jax_window(scene, cam, w, h, win):
    """The JAX package's draw-list batch of ``scene``, its windowed
    ``rasterize_exact`` (interpret mode), the full viewport's coefficient
    flags and boxes, and the window's rays (row-major and in 8x32 tiles),
    as one jitted call."""
    import jax

    from paperrenderer_tpu.ops import preprocess as JP
    from paperrenderer_tpu.ops import raster as JR
    from paperrenderer_tpu.ops import raster_exact as JRE
    from paperrenderer_tpu.ops.trace import raygen

    mm = scene.max_meshes_per_lod

    @jax.jit
    def run(arrays, tables, geo, cm):
        pre = JP.preprocess_instances(arrays, tables, cm,
                                      max_meshes_per_lod=mm)
        batch = JR.build_triangle_batch(pre, geo, cm, capacity=2048)
        d, t, table, _ = JRE.rasterize_exact(batch, w, h,
                                             overflow_cond=False, **win)
        _, ok, (lo, hi) = JR.triangle_coefficients(
            batch, win["full_width"], win["full_height"])
        rays = [raygen(cm, w, h, tile_order=tile, **win)
                for tile in (None, (8, 32))]
        return batch, d, t, table, ok, lo, hi, rays

    old, JRE.INTERPRET = JRE.INTERPRET, True
    try:
        return run(scene.flush(), scene.tables(), scene.geometry(),
                   cam.matrices)
    finally:
        JRE.INTERPRET = old


def _compare_raster(dj, tj, dt, tt, depth_rtol):
    """``test_rasterize_bins_on_jax_table``'s compare."""
    dj, tj, dt, tt = (np.asarray(a) for a in (dj, tj, dt, tt))
    cov_j, cov_t = tj >= 0, tt >= 0
    assert cov_j.any(), "the window renders nothing"
    assert (cov_j != cov_t).mean() <= 5e-4
    assert np.isinf(dt[~cov_t]).all()
    both = cov_j & cov_t
    rel = np.abs(dt[both] - dj[both]) / np.abs(dj[both])
    assert rel.max() <= depth_rtol, rel.max()
    mism = both & (tj != tt)
    assert (np.abs(dt[mism] - dj[mism]) <= depth_rtol * np.abs(dj[mism])).all()


def test_windowed_raster_and_raygen():
    """(ii) The window's raster and rays. K1's plain version, binned in
    window space, on JAX's own coefficient table against JAX's windowed
    ``rasterize_exact`` (interpret mode) on the 128x8 window at (128, 8)
    of a 256x16 viewport; the port's own windowed ``rasterize_exact``
    against it too. The windowed ``raygen`` against JAX's and bitwise the
    full frame's rows. Every 32x32 window of a 64x64 frame bitwise the
    single-device frame's depth, tid and G-buffer (K1, resolve) and K2's
    two peel layers. A window outside its viewport is refused."""
    from paperrenderer_tpu_torch.interop import from_numpy
    from paperrenderer_tpu_torch.ops import raster_exact as TRE
    from paperrenderer_tpu_torch.ops.trace import raygen
    from paperrenderer_tpu_torch.ops.raster import attach_cull

    fw, fh, org, (w, h) = 256, 16, (128, 8), (128, 8)
    win = dict(full_width=fw, full_height=fh, origin=org)
    scene, _, cam = _twelve_instances(fw, fh)
    batch, dj, tj, table_j, ok, lo, hi, rays_j = _jax_window(scene, cam, w,
                                                             h, win)
    table = torch.from_numpy(np.array(table_j))
    cell_start, cell_groups, n_pairs = TRE.bin_groups(
        torch.from_numpy(np.array(ok)), torch.from_numpy(np.array(lo)),
        torch.from_numpy(np.array(hi)), table.shape[0], w, h, **win)
    assert n_pairs == cell_groups.shape[0] > 0
    dt, tt = TRE.rasterize_bins(cell_start, cell_groups,
                                table[:, :16].contiguous(), w, h, **win)
    _compare_raster(dj, tj, dt, tt, depth_rtol=1e-6)
    arrays = {f.name: np.asarray(getattr(batch, f.name))
              for f in dataclasses.fields(batch)
              if getattr(batch, f.name) is not None}
    tbatch = from_numpy("TriangleBatch", arrays, device="cpu")
    dp, tp, _, _ = TRE.rasterize_exact(tbatch, w, h, **win)
    _compare_raster(dj, tj, dp, tp, depth_rtol=5e-4)

    # rays: the window against JAX's and against the full frame's rows
    tcam = from_numpy("CameraMatrices", {
        f.name: np.asarray(getattr(cam.matrices, f.name))
        for f in dataclasses.fields(cam.matrices)}, device="cpu")
    for tile, (oj, djr) in zip((None, (8, 32)), rays_j):
        o, d = raygen(tcam, w, h, tile_order=tile, **win)
        np.testing.assert_allclose(d.numpy(), np.asarray(djr), rtol=0,
                                   atol=2e-6)
        np.testing.assert_array_equal(o.numpy(), np.asarray(oj))
    _, d_full = raygen(tcam, fw, fh)
    _, d_win = raygen(tcam, w, h, **win)
    assert torch.equal(d_win, d_full.reshape(fh, fw, 3)[8:, 128:].reshape(-1, 3))

    # every window of a 64x64 frame: K1 + resolve and K2's two layers
    rp, cam64 = _static_scene("xla")
    from paperrenderer_tpu_torch.ops.static_batch import expand_static

    from paperrenderer_tpu_torch.ops.translucency import non_opaque_mask

    mapping, inst, tables, mats, c64, slots, vis = rp.frame_inputs(cam64)
    full, _ = expand_static(mapping, inst, tables, c64, slots, vis)
    full = attach_cull(full, mats)
    glass = non_opaque_mask(mats, full.material)
    opaque = dataclasses.replace(full, valid=full.valid & ~glass)
    full = dataclasses.replace(full, valid=full.valid & glass)
    d_f, t_f, tab_f, _ = TRE.rasterize_exact(opaque, SIZE, SIZE)
    g_f = TRE.resolve_gbuffer_pairs(tab_f, d_f, t_f, c64)

    def peel(bins, ceil, n, **window):
        h_, w_ = ceil.shape
        floor = torch.full((h_, w_), torch.iinfo(torch.int32).min + 1,
                           dtype=torch.int32)
        out = []
        for _ in range(n):
            d, t = TRE.rasterize_bins(bins.cell_start, bins.cell_groups,
                                      bins.coef, w_, h_, keyed=True,
                                      window=(floor, ceil), **window)
            out.append((d, t))
            floor = TRE.depth_to_key(d)
        return out

    peel_f = peel(TRE.bin_triangles(full, SIZE, SIZE),
                  TRE.depth_to_key(d_f), 2)
    half = SIZE // 2
    for y0 in (0, half):
        for x0 in (0, half):
            win = dict(full_width=SIZE, full_height=SIZE, origin=(x0, y0))
            crop = (slice(y0, y0 + half), slice(x0, x0 + half))
            d, t, tab, _ = TRE.rasterize_exact(opaque, half, half, **win)
            g = TRE.resolve_gbuffer_pairs(tab, d, t, c64, **win)
            for f in dataclasses.fields(g):
                assert torch.equal(getattr(g, f.name),
                                   getattr(g_f, f.name)[crop]), (x0, y0, f)
            layers = peel(TRE.bin_triangles(full, half, half, **win),
                          TRE.depth_to_key(d), 2, **win)
            for (dw, tw), (df, tf) in zip(layers, peel_f):
                assert torch.equal(dw, df[crop]) and torch.equal(tw, tf[crop])
    assert (t_f >= 0).any() and (peel_f[0][1] >= 0).any()

    for bad in ((-32, 0), (40, 0), (0, 33)):
        with pytest.raises(ValueError, match="does not lie inside"):
            TRE.rasterize_bins(cell_start, cell_groups,
                               table[:, :16].contiguous(), w, h,
                               full_width=w + 32, full_height=h + 32,
                               origin=bad)


def _single_static(case):
    rp, cam = _static_scene(case)
    kw = STATIC_CASES[case]
    rp.use_pallas = kw["use_pallas"]
    rp.translucent_layers = kw.get("translucent_layers", 0)
    rp.supersample = kw.get("supersample", 1)
    ldr, aux = rp.render(cam)
    return rp, cam, ldr, aux


def test_sharded_static_frames(ranks):
    """(iii) The 2x2 gloo ranks' gathered static frames (the XLA route, K1,
    two peel layers on K2 and on the XLA peel, supersample 2, textured)
    and draw-list frame bitwise the port's single-device frames (textured:
    but on the tile seams, whose mip lod is the window's own), with the
    opaque pass's depth and tid; the 128x128 example sharded on the XLA
    route in the JAX package's gate, ``sharded_raster.png``'s bands; ``required`` equal to
    ``measure_sharded_demand`` (one process, no kernel) and, with the
    peel, the larger of the two passes' window counts. Against JAX's
    ``measure_sharded_demand`` at 256x16: the JAX probe counts quarter-tile
    round SLOTS (``max(slots, pairs)``), the port (no capacity tiers)
    pairs: the port's window binning of JAX's own boxes gives JAX's pair
    count exactly, and the port's probe stays within JAX's."""
    from paperrenderer_tpu_torch.parallel import measure_sharded_demand
    from paperrenderer_tpu_torch.render.renderpass import render_frame

    gathered, meshes = ranks()
    for r, m in enumerate(meshes):
        assert m["shape"] == [2, 2] and m["coords"] == [r // 2, r % 2]
        assert m["index"] == r and m["backend"] == "gloo"
        assert m["axes"] == ["rows", "cols"]
    for case, kw in STATIC_CASES.items():
        rp, cam, ldr, aux = _single_static(case)
        got = gathered[case]
        if case == "textured":
            # the mip lod takes forward uv differences inside the window, so
            # the last row and column of a tile with a neighbour below or to
            # its right sample their own lod (the JAX sharded frame's rule)
            seam = torch.zeros(SIZE, SIZE, dtype=torch.bool)
            seam[SIZE // 2 - 1] = seam[:, SIZE // 2 - 1] = True
            same = (got["ldr"] == ldr).all(dim=-1)
            assert same[~seam].all() and not same[seam].all()
        else:
            assert torch.equal(got["ldr"], ldr), case
        ss = kw.get("supersample", 1)
        assert torch.equal(got["depth"][::ss, ::ss], aux["depth"]), case
        m, inst, tables, mats, c, slots, vis = rp.frame_inputs(cam)
        probe = measure_sharded_demand(
            m, inst, tables, c, slots, vis, mats, width=SIZE, height=SIZE,
            rows=2, cols=2, translucent_layers=kw.get("translucent_layers", 0),
            supersample=ss)
        if kw["use_pallas"]:
            assert got["required"] == probe > 0, case
        else:
            assert got["required"] == 0
    # the opaque pass's tid: the single-device K1 at the same resolution
    rp, cam, _, _ = _single_static("k1")
    from paperrenderer_tpu_torch.ops.raster import attach_cull
    from paperrenderer_tpu_torch.ops.raster_exact import rasterize_exact
    from paperrenderer_tpu_torch.ops.static_batch import expand_static

    m, inst, tables, mats, c, slots, vis = rp.frame_inputs(cam)
    full, _ = expand_static(m, inst, tables, c, slots, vis)
    d, t, _, _ = rasterize_exact(attach_cull(full, mats), SIZE, SIZE)
    assert torch.equal(gathered["k1"]["tri_id"], t)
    assert torch.equal(gathered["k1"]["depth"], d)
    assert (t >= 0).float().mean() > 0.05
    rp.use_pallas = False
    ldr, _ = render_frame(lights=rp.lights, tonemap_params=rp.tonemap_params,
                          width=SIZE, height=SIZE, use_pallas=False,
                          **rp.draw_list_inputs(cam))
    assert torch.equal(gathered["draw_list"], ldr)
    # the JAX package's sharded gate: its 128x128 example frame (XLA route)
    # in tests/goldens/sharded_raster.png's bands (tests/test_golden_images.py)
    from paperrenderer_tpu_torch.io import read_image

    gate = read_image(os.path.join(os.path.dirname(__file__), "goldens",
                                   "sharded_raster.png")) / 255.0
    diff = np.abs(gathered["golden"].numpy() - gate).max(axis=-1)
    assert diff.mean() <= 0.004 and (diff > 0.06).mean() <= 0.002

    # the probe against JAX's at 256x16 (2x2 windows of 128x8)
    import jax
    import jax.numpy as jnp

    from paperrenderer_tpu.ops import raster as JR
    from paperrenderer_tpu.ops import raster_exact as JRE
    from paperrenderer_tpu.ops import static_batch as JS
    from paperrenderer_tpu.parallel import measure_sharded_demand as jax_probe
    from paperrenderer_tpu_torch.interop import from_numpy
    from paperrenderer_tpu_torch.ops import raster_exact as TRE

    scene, jrp, cam = _twelve_instances(256, 16)
    arrays = scene.flush()
    slots_j, vis_j, table_j = jrp._device_inputs(arrays.capacity)
    mapping_j = JS.build_static_mapping(scene)
    j_req = int(jax_probe(mapping_j, arrays, scene.tables(), cam.matrices,
                          slots_j, vis_j, table_j, width=256, height=16,
                          rows=2, cols=2))

    windows = ((0, 0), (128, 0), (0, 8), (128, 8))

    @jax.jit
    def window_pairs(mapping, arrays, tables, cm, slots, vis, table):
        """The pair count of JAX's own window binning, the most of the
        four windows, and the viewport's coefficient flags and boxes."""
        jb, _ = JS.expand_static(mapping, arrays, tables, cm, slots, vis,
                                 use_runs=False)
        jb = JR.attach_cull(jb, table)
        _, ok, (lo, hi) = JR.triangle_coefficients(jb, 256, 16)
        t = jb.capacity
        t_pad = -(-t // JRE.GROUP) * JRE.GROUP
        return jnp.max(jnp.stack([
            jnp.sum(JRE._bin_spans(ok, lo, hi, t, t_pad, t_pad // JRE.GROUP,
                                   128, 8, jnp.asarray(o, jnp.float32),
                                   JRE.QTILE_W, 1)[-1])
            for o in windows])), ok, lo, hi

    jax_pairs, ok, lo, hi = window_pairs(mapping_j, arrays, scene.tables(),
                                         cam.matrices, slots_j, vis_j,
                                         table_j)
    ok, lo, hi = (torch.from_numpy(np.array(a)) for a in (ok, lo, hi))
    t_pad = -(-ok.shape[0] // TRE.GROUP) * TRE.GROUP
    assert int(jax_pairs) == max(
        int(TRE._bin_spans(ok, lo, hi, t_pad, 256, 16, TRE.CELL_W,
                           o + (128, 8))[4].sum())
        for o in windows) > 0

    def port(kind, obj):
        return from_numpy(kind, {
            f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None
            and not isinstance(getattr(obj, f.name), (tuple, int))},
            device="cpu")

    probe = measure_sharded_demand(
        port("StaticMapping", mapping_j), port("InstanceArrays", arrays),
        port("SceneTables", scene.tables()), port("CameraMatrices",
                                                  cam.matrices),
        torch.from_numpy(np.array(slots_j)),
        torch.from_numpy(np.array(vis_j)), port("MaterialTable", table_j),
        width=256, height=16, rows=2, cols=2)
    # the port's own setup rounds a box corner apart from XLA's FMAs now
    # and then, moving a group's span by a cell (85 against 86 here)
    assert abs(probe - int(jax_pairs)) <= 0.02 * int(jax_pairs)
    assert probe <= j_req


def test_sharded_rt_hybrid_match_jax(ranks):
    """(iv) The 2x2 ranks' RT frames (flat and paged; K7-K11's plain
    versions) and hybrid frame (K1's plain version) against JAX's sharded
    frames on a 4-device sub-mesh at 64x32, soft light (radius 0.4), AO
    and reflections on, the same seed: each tile's key is bitwise JAX's
    ``fold_in(key, row * cols + col)``. The legacy world-BVH frame
    (``sharded_rt_frame``) against JAX's on the same sub-mesh (mean
    |diff| <= 1e-3, ``rt_frame``'s bound: the same samples, XLA's FMA
    contraction the only difference), and each of its tiles bitwise a
    one-process trace of its window with its folded key."""
    import jax

    from examples.render_hybrid import build_hybrid_scene as jax_hybrid
    from examples.render_rt import build_rt_scene as jax_rt
    from paperrenderer_tpu.parallel import (
        make_sharded_hybrid_frame, make_sharded_rt_frame, make_tile_mesh)
    from paperrenderer_tpu_torch.utils import random as rnd

    key = jax.random.PRNGKey(7)
    for i in range(4):
        assert tuple(int(v) for v in np.asarray(jax.random.key_data(
            jax.random.fold_in(key, i)))) == rnd.fold_in(rnd.prng_key(7), i)
    mesh = make_tile_mesh(jax.devices()[:4])
    gathered, _ = ranks()
    _, rtj, camj = jax_rt(RT_W, RT_H)
    inst = rtj.scene.flush()
    blasset, meta, anim_rest, anim_nodes = rtj.accel.blas()
    slots, masks, table = rtj._device_inputs(inst.capacity)
    for paged in (False, True):
        frame = make_sharded_rt_frame(mesh, meta, use_pallas=False,
                                      paged=paged)
        ldr = np.asarray(frame(
            blasset, anim_rest, anim_nodes, inst,
            rtj.accel.inst_blas(inst.capacity), masks, rtj.accel.tri_attr(),
            table, rtj.lights, camj.matrices, slots, rtj.tonemap_params, key,
            np.float32(0.0), rtj._cached_textures, width=RT_W, height=RT_H,
            stack_size=rtj.accel.stack_size(inst.capacity),
            shadow_samples=rtj.shadow_samples,
            reflection_samples=rtj.reflection_samples,
            ao_samples=rtj.ao_samples, ao_radius=rtj.ao_radius,
            leaf_cutout=False))
        port = gathered["rt", paged].numpy()
        assert port.shape == ldr.shape == (RT_H, RT_W, 3)
        diff = np.abs(port - ldr)
        assert diff.mean() <= 1e-3, (paged, diff.mean())
        assert ldr.std() > 0.05
    _, hyj, camj = jax_hybrid(RT_W, RT_H)
    rp = hyj._rp
    inst = hyj.scene.flush()
    blasset, meta, anim_rest, anim_nodes = hyj.accel.blas()
    slots, visible, table = rp._device_inputs(inst.capacity)
    from paperrenderer_tpu.ops.static_batch import build_static_mapping

    frame = make_sharded_hybrid_frame(mesh, meta, use_pallas_trace=False)
    ldr, aux = frame(
        build_static_mapping(hyj.scene), blasset, anim_rest, anim_nodes, inst,
        hyj.accel.inst_blas(inst.capacity), hyj.accel.tri_attr(),
        hyj.scene.tables(), table, rp.lights, camj.matrices, slots, visible,
        rp.tonemap_params, key, np.float32(0.0), rp._cached_textures,
        width=RT_W, height=RT_H,
        stack_size=hyj.accel.stack_size(inst.capacity),
        shadow_samples=hyj.shadow_samples,
        reflection_samples=hyj.reflection_samples, ao_samples=hyj.ao_samples,
        ao_radius=hyj.ao_radius, leaf_cutout=False)
    diff = np.abs(gathered["hybrid"].numpy() - np.asarray(ldr)).max(axis=-1)
    assert diff.mean() <= 0.004, diff.mean()
    assert gathered["hybrid_required"] > 0
    # the legacy world-BVH frame against JAX's sharded_rt_frame on the
    # same sub-mesh, scene, key and samples
    from paperrenderer_tpu.ops.trace import RTParams as JRTParams
    from paperrenderer_tpu.parallel import sharded_rt_frame as j_world_frame
    from paperrenderer_tpu_torch.ops import trace as TT
    from paperrenderer_tpu_torch.ops.tonemap import tonemap
    from paperrenderer_tpu_torch.render import build_world_scene
    from paperrenderer_tpu_torch.scenes import build_rt_scene

    _, rt, cam = build_rt_scene(RT_W, RT_H, device="cpu")
    args, kw = rt.world_inputs(cam, rnd.prng_key(7))
    world = gathered["world_rt"]
    assert world.shape == (RT_H, RT_W, 3) and world.std() > 0.05
    _, rtj, camj = jax_rt(RT_W, RT_H)
    inst = rtj.scene.flush()
    slots, _, table = rtj._device_inputs(inst.capacity)
    assert (rtj.shadow_samples, rtj.reflection_samples, rtj.ao_samples,
            rtj.ao_radius) == (kw["shadow_samples"], kw["reflection_samples"],
                               kw["ao_samples"], kw["ao_radius"])
    j_world = jax.jit(functools.partial(   # eager shard_map: minutes
        j_world_frame, mesh, width=RT_W, height=RT_H,
        max_meshes_per_lod=kw["max_meshes_per_lod"],
        tri_capacity=kw["tri_capacity"], params=JRTParams(
            shadow_samples=kw["shadow_samples"],
            reflection_samples=kw["reflection_samples"],
            ao_samples=kw["ao_samples"], ao_radius=kw["ao_radius"])))
    ldr = np.asarray(j_world(
        inst, rtj.scene.tables(), rtj.scene.geometry(), table, rtj.lights,
        camj.matrices, slots, rtj.tonemap_params, key))
    assert ldr.shape == (RT_H, RT_W, 3) and ldr.std() > 0.05
    diff = np.abs(world.numpy() - ldr)
    assert diff.mean() <= 1e-3, diff.mean()
    # and each tile bitwise a one-process trace of its window (world BVH,
    # BatchTracer) with the folded key
    batch, bvh = build_world_scene(
        *args[:3], args[5], args[6],
        max_meshes_per_lod=kw["max_meshes_per_lod"],
        tri_capacity=kw["tri_capacity"])
    params = TT.RTParams(shadow_samples=kw["shadow_samples"],
                         reflection_samples=kw["reflection_samples"],
                         ao_samples=kw["ao_samples"],
                         ao_radius=kw["ao_radius"])
    tw, th = RT_W // 2, RT_H // 2
    for r in range(2):
        for c in range(2):
            hdr = TT.trace_frame(
                TT.BatchTracer(batch, bvh, args[3]), args[3], args[4],
                args[5], rnd.fold_in(rnd.prng_key(7), r * 2 + c), width=tw,
                height=th, params=params, full_width=RT_W, full_height=RT_H,
                origin=(c * tw, r * th))
            assert torch.equal(world[r * th:(r + 1) * th, c * tw:(c + 1) * tw],
                               tonemap(hdr, args[7])), (r, c)


def _failing_rank(rank, world):
    """Rank 1 raises; rank 0 outlives any short timeout."""
    import time

    if rank == 1:
        raise ValueError("rank 1 fails")
    time.sleep(60)


def test_unaligned_windows_world1_and_failures(tmp_path):
    """(v) Windows whose origins are not cell-aligned (100x60 in 2x2, the
    origins 50 and 30 inside the 8x32 cells) bitwise the single-device
    depth, tid, G-buffer and K2 peel (the odd triangle groups peeled in
    front of the even ones): a window's cells are the viewport's.
    A one-rank mesh (torch's fake process group) gives the single-device
    static frame, and the hybrid frame of the paged layout with the key
    ``fold_in(key, 0)`` (no fused bundle there, so the same passes). A rank
    that raises, and one that outlives the timeout, fail ``spawn_ranks``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from paperrenderer_tpu_torch.ops import raster_exact as TRE
    from paperrenderer_tpu_torch.ops.raster import attach_cull
    from paperrenderer_tpu_torch.ops.static_batch import expand_static
    from paperrenderer_tpu_torch.parallel import (
        make_sharded_hybrid_frame, make_tile_mesh,
        sharded_render_frame_static, spawn_ranks)
    from paperrenderer_tpu_torch.parallel import tiles as PT
    from paperrenderer_tpu_torch.render.hybrid import render_frame_hybrid
    from paperrenderer_tpu_torch.scenes import (build_example_scene,
                                                build_hybrid_scene)
    from paperrenderer_tpu_torch.utils import random as rnd

    W, H = 100, 60
    rp, cam = build_example_scene(W, H, device="cpu")
    m, inst, tables, mats, cm, slots, vis = rp.frame_inputs(cam)
    batch, _ = expand_static(m, inst, tables, cm, slots, vis)
    batch = attach_cull(batch, mats)
    back = (torch.arange(batch.capacity) // 8) % 2 == 1   # odd groups
    opaque = dataclasses.replace(batch, valid=batch.valid & ~back)
    peeled = dataclasses.replace(batch, valid=batch.valid & back)
    d_f, t_f, tab_f, _ = TRE.rasterize_exact(opaque, W, H)
    g_f = TRE.resolve_gbuffer_pairs(tab_f, d_f, t_f, cm)
    floor_f = torch.full((H, W), torch.iinfo(torch.int32).min + 1,
                         dtype=torch.int32)
    pb = TRE.bin_triangles(peeled, W, H)
    p_f, pt_f = TRE.rasterize_bins(pb.cell_start, pb.cell_groups, pb.coef,
                                   W, H, keyed=True,
                                   window=(floor_f, TRE.depth_to_key(d_f)))
    assert (t_f >= 0).float().mean() > 0.2 and (pt_f >= 0).float().mean() > 0.02
    for y0 in (0, 30):
        for x0 in (0, 50):
            win = dict(full_width=W, full_height=H, origin=(x0, y0))
            crop = (slice(y0, y0 + 30), slice(x0, x0 + 50))
            d, t, tab, _ = TRE.rasterize_exact(opaque, 50, 30, **win)
            g = TRE.resolve_gbuffer_pairs(tab, d, t, cm, **win)
            for f in dataclasses.fields(g):
                assert torch.equal(getattr(g, f.name),
                                   getattr(g_f, f.name)[crop]), (x0, y0, f)
            b = TRE.bin_triangles(peeled, 50, 30, **win)
            p, pt = TRE.rasterize_bins(
                b.cell_start, b.cell_groups, b.coef, 50, 30, keyed=True,
                window=(floor_f[crop].contiguous(), TRE.depth_to_key(d)),
                **win)
            assert torch.equal(p, p_f[crop]) and torch.equal(pt, pt_f[crop])

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = make_tile_mesh()
        args, kw = PT.static_inputs(rp, cam)
        ldr, req = sharded_render_frame_static(
            mesh, *args, **kw, use_pallas=True, return_required=True)
        ref, aux = rp.render(cam)
        assert torch.equal(ldr, ref) and req == aux["required_work"] > 0
        key = rnd.prng_key(3)
        _, hy, hcam = build_hybrid_scene(32, 16, device="cpu")
        meta, args, kw = PT.hybrid_inputs(hy, hcam, key)
        ldr, _ = make_sharded_hybrid_frame(mesh, meta, use_pallas_trace=True,
                                           paged=True)(*args, **kw,
                                                       use_pallas=True)
        blasset, meta, anim_rest, anim_nodes = hy.accel.blas()
        mapping, instances, tables, table, c, slots, visible = (
            hy._rp.frame_inputs(hcam))
        cap = instances.capacity
        ref, _ = render_frame_hybrid(
            mapping, blasset, meta, anim_rest, anim_nodes, instances,
            hy.accel.inst_blas(cap), hy.accel.tri_attr(), tables, table,
            hy._rp.lights, c, slots, visible, hy._rp.tonemap_params,
            rnd.fold_in(key, 0), args[15], width=32, height=16,
            stack_size=hy.accel.stack_size(cap), paged=True,
            shadow_samples=hy.shadow_samples,
            reflection_samples=hy.reflection_samples,
            ao_samples=hy.ao_samples, ao_radius=hy.ao_radius)
        assert torch.equal(ldr, ref)
    finally:
        dist.destroy_process_group()

    with pytest.raises(RuntimeError, match=r"timed out .*\[0\].*failed .*\[1\]"):
        spawn_ranks(_failing_rank, 2, backend="gloo",
                    init_file=str(tmp_path / "store"), timeout=8)
