"""K12's plain versions against the TPU probe kernels, the plain walk's step
counts, and the profiling helpers, on the CPU.

The TPU kernels of ``scripts/probe_smem_dma.py``, ``probe_smem_dma2.py`` and
``prof_rt_floor2.py`` run in the Pallas interpreter on the same inputs the
port makes (numpy, seed 0). All comparisons are bitwise: the probes only
add f32 in one order or move bits.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from paperrenderer_tpu_torch import (
    Camera, Material, Model, ModelInstance, RenderEngine, make_plane)
from paperrenderer_tpu_torch.ops.accel import CHUNK
from paperrenderer_tpu_torch.utils import device_time, trace
from paperrenderer_tpu_torch.utils import probes as PR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's tests: the tier-1 run
    puts several pytest workers on the machine's cores, and torch's default
    of one thread per core then oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def test_k12a_plain_matches_jax_kernel():
    """probe_smem_dma.py's kernel, interpreted, against chunk_stream's
    plain version: 8516938.0 at seed 0, bit for bit."""
    spec = importlib.util.spec_from_file_location(
        "probe_smem_dma", os.path.join(ROOT, "scripts", "probe_smem_dma.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hf, hi, order = PR.chunk_stream_inputs("cpu")
    fn = pl.pallas_call(
        mod.kernel, grid=(),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1,), jnp.float32),
        scratch_shapes=[pltpu.SMEM((mod.BLK,), jnp.float32),
                        pltpu.SMEM((mod.IBLK,), jnp.int32),
                        pltpu.SemaphoreType.DMA(()),
                        pltpu.SemaphoreType.DMA(())],
        interpret=True)
    want = fn(jnp.asarray(hf.numpy()), jnp.asarray(hi.numpy()),
              jnp.asarray(order.numpy()))
    got, span = PR.chunk_stream(hf, hi, order)
    assert span is None
    assert float(got[0]) == 8516938.0
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _sweep_kernel(blk, mode, n_iters):
    """probe_smem_dma2.py's run_case kernel (:23-70), restated: it is a
    closure there."""

    def kernel(hbm_f, order_ref, out_ref, s2, sem):
        def chained(k, acc):
            c = order_ref[k]
            d = pltpu.make_async_copy(
                hbm_f.at[pl.ds(c * blk, blk)], s2.at[pl.ds(0, blk)], sem.at[0])
            d.start()
            d.wait()
            return acc + s2[0]

        def dbuf(k, acc):
            c_next = order_ref[k + 1]
            cur = k % 2
            nxt = 1 - cur
            dn = pltpu.make_async_copy(
                hbm_f.at[pl.ds(c_next * blk, blk)],
                s2.at[pl.ds(nxt * blk, blk)], sem.at[nxt])
            dn.start()
            dw = pltpu.make_async_copy(
                hbm_f.at[pl.ds(order_ref[k] * blk, blk)],
                s2.at[pl.ds(cur * blk, blk)], sem.at[cur])
            dw.wait()
            return acc + s2[cur * blk]

        if mode == "chained":
            acc = jax.lax.fori_loop(0, n_iters, chained, jnp.float32(0.0))
        else:
            d0 = pltpu.make_async_copy(
                hbm_f.at[pl.ds(order_ref[0] * blk, blk)],
                s2.at[pl.ds(0, blk)], sem.at[0])
            d0.start()
            acc = jax.lax.fori_loop(0, n_iters - 1, dbuf, jnp.float32(0.0))
        out_ref[0] = acc

    return pl.pallas_call(
        kernel, grid=(),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1,), jnp.float32),
        scratch_shapes=[pltpu.SMEM((2 * blk,), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)


def test_k12b_plain_matches_jax_kernel():
    """probe_smem_dma2.py's chain, interpreted, against
    chunk_stream_sweep's plain version: chained at 1024 floats and
    double-buffered at 6144, bit for bit."""
    for blk, dbuf in ((1024, False), (6144, True)):
        hf, order = PR.sweep_inputs(blk, "cpu")
        fn = _sweep_kernel(blk, "dbuf" if dbuf else "chained", PR.SWEEP_ITERS)
        want = fn(jnp.asarray(hf.numpy()), jnp.asarray(order.numpy()))
        got, _ = PR.chunk_stream_sweep(hf, order, blk=blk, dbuf=dbuf)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_k12c_plain_matches_jax_ident():
    """prof_rt_floor2.py's ident (:73-87, sub=1), interpreted at R = 2048,
    against pass_through's plain version: every output, bit for bit."""
    r = 2048
    planes = PR.pass_through_inputs(r, "cpu")

    def ident(a0, a1, a2, a3, a4, a5, a6, o0, o1, o2, o3, o4):
        o0[...] = a0[...]
        o1[...] = pltpu.bitcast(a1[...], jnp.int32)
        o2[...] = pltpu.bitcast(a2[...], jnp.int32)
        o3[...] = a3[...]
        o4[...] = a4[...]

    g = r // 1024
    spec = pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0),
                        memory_space=pltpu.VMEM)
    dts = [jnp.float32, jnp.int32, jnp.int32, jnp.float32, jnp.float32]
    call = pl.pallas_call(
        ident, grid=(g,), in_specs=[spec] * 7, out_specs=[spec] * 5,
        out_shape=[jax.ShapeDtypeStruct((g, 8, 128), dt) for dt in dts],
        interpret=True)
    want = call(*(jnp.asarray(a.numpy()).reshape(g, 8, 128) for a in planes))
    got = PR.pass_through(planes)
    assert [x.dtype for x in got] == [torch.float32, torch.int32, torch.int32,
                                      torch.float32, torch.float32]
    for w, x in zip(want, got):
        np.testing.assert_array_equal(
            np.asarray(w).reshape(-1).view(np.int32),
            x.numpy().view(np.int32))


@pytest.fixture(scope="module")
def plane_walk():
    """A one-instance scene (a 2-triangle plane, one BLAS leaf) and three
    rays: one that hits the plane, one pointing away, one dead. -> (rt,
    camera, o, d, far, active)."""
    eng = RenderEngine(device="cpu", device_check=False)
    plane = Model.from_mesh(eng.scene.arena, *make_plane(size=2.0))
    rt = eng.create_ray_trace_render(width=8, height=8)
    rt.add_instance(ModelInstance(plane), {0: Material("w").instance()})
    cam = Camera(yfov_deg=55.0, aspect=1.0, near=0.1, far=100.0)
    cam.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), up=(0, 1, 0))
    o = torch.tensor([[0.1, 0.2, 5.0]] * 3)
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    far = torch.full((3,), 1000.0)
    act = torch.tensor([True, True, False])
    return rt, cam, o, d, far, act


def _levels(rt, paged: bool) -> int:
    """The TLAS levels above a leaf: log2 of the leaf count's power of two
    (the capacity's flat, CHUNK paged)."""
    leaves = CHUNK if paged else rt.scene.flush().capacity
    return (leaves - 1).bit_length()


def test_plain_walk_step_counts(plane_walk):
    """The step-count forms of K7 and K10 on the CPU (the plain walk): on
    the plane scene a ray that hits the plane pops the TLAS boxes down to
    its leaf, the instance and the BLAS leaf; a ray pointing away pops the
    root only; a dead ray counts 0. The other outputs are the plain
    form's."""
    rt, cam, o, d, far, act = plane_walk
    for paged in (False, True):
        ctx = PR.primary_wavefront(rt, cam, paged)[0]
        levels = _levels(rt, paged)
        for any_hit in (False, True):
            rec = PR.steps_kernel(ctx, o, d, far, any_hit=any_hit, active=act)
            plain = ctx.trace(o, d, far, any_hit=any_hit, active=act)
            assert rec.bary[:, 0].tolist() == [levels + 2, 1.0, 0.0]
            assert rec.prim.tolist() == plain.prim.tolist()
            assert rec.prim[0] >= 0
            for a, b in ((rec.t, plain.t), (rec.inst, plain.inst),
                         (rec.bary[:, 1], plain.bary[:, 1])):
                assert torch.equal(a, b)


def test_warp_efficiency_hand_made():
    """warp_efficiency on hand-made counts: width 2 cuts (1, 2, 3, 4, 5)
    into (1, 2), (3, 4), (5, 0), whose maxima sum to 11: 15 / (2 x 11).
    One lane a group wastes nothing; no step gives 0."""
    steps = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    assert PR.warp_efficiency(steps, width=2) == 15 / 22
    assert PR.warp_efficiency(steps, width=1) == 1.0
    assert PR.warp_efficiency(torch.zeros(7)) == 0.0


def test_warp_efficiency_of_plain_steps(plane_walk):
    """warp_efficiency of the plain walk's step counts on the plane scene:
    (levels + 2, 1, 0) in one 32-lane warp busies its lanes for levels + 2
    steps, and a 3-lane group for the same."""
    rt, cam, o, d, far, act = plane_walk
    for paged in (False, True):
        ctx = PR.primary_wavefront(rt, cam, paged)[0]
        steps = PR.steps_kernel(ctx, o, d, far, active=act).bary[:, 0]
        n = _levels(rt, paged) + 2
        assert PR.warp_efficiency(steps) == (n + 1) / (32 * n)
        assert PR.warp_efficiency(steps, width=3) == (n + 1) / (3 * n)


def test_headline_waves_on_cpu():
    """headline_waves at 32x24 with 16 instances a grid: every headline
    case and a masked wave of each frame (config 3's and hybrid config 4's
    K8 reflection rays) launch on the CPU; the masked waves carry their
    active masks, the dead wave none live; the frame's kernel wrappers are
    restored after their launches are captured."""
    from paperrenderer_tpu_torch.ops import trace_kernel as TK

    wrapper = TK.trace_resolve_kernel
    waves = PR.headline_waves("cpu", 32, 24, n=16)
    assert TK.trace_resolve_kernel is wrapper
    for name in ("k11_alpha_leaf_primary", "k11_alpha_leaf_primary_permuted",
                 "k11_alpha_leaf_ao", "k8_alpha_leaf_primary",
                 "k8_alpha_leaf_reflection", "k10_grid_primary",
                 "k7_grid_primary", "k7_rt_primary", "k7_rt_primary_dead",
                 "k9_rt_shadow_ao", "k8_rt_masked0", "k8_hybrid4_masked0"):
        assert name in waves, name
    for name, fn in waves.items():
        out = PR.tensors_of(fn())
        assert out and all(t.shape[0] == 32 * 24 for t in out), name
    assert not waves["k7_rt_primary_dead"].keywords["active"].any()
    for name in ("k8_rt_masked0", "k8_hybrid4_masked0"):
        act = waves[name].keywords["active"]
        assert 0 < int(act.sum()) < act.numel()


def test_profiling_helpers_on_cpu(tmp_path):
    """device_time times CPU outputs with the host clock; trace writes a
    Chrome trace into its directory."""
    x = torch.arange(1024, dtype=torch.float32)
    s = device_time(torch.cumsum, x, 0, iters=3, warmup=1)
    assert 0.0 < s < 1.0
    with trace(str(tmp_path / "trace")) as prof:
        torch.cumsum(x, 0)
    assert prof.key_averages()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
