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


def test_plain_walk_step_counts():
    """The step-count forms of K7 and K10 on the CPU (the plain walk): on a
    one-instance scene (a 2-triangle plane, one BLAS leaf) a ray that hits
    the plane pops the TLAS boxes down to its leaf (log2 of the leaf count:
    the capacity's power of two flat, CHUNK paged), the instance and the
    BLAS leaf; a ray pointing away pops the root only; a dead ray counts 0.
    The other outputs are the plain form's."""
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
    capacity = rt.scene.flush().capacity
    for paged, leaves in ((False, capacity), (True, CHUNK)):
        ctx = PR.primary_wavefront(rt, cam, paged)[0]
        levels = (leaves - 1).bit_length()   # log2 of its power of two
        for any_hit in (False, True):
            rec = PR.steps_kernel(ctx, o, d, far, any_hit=any_hit, active=act)
            plain = ctx.trace(o, d, far, any_hit=any_hit, active=act)
            assert rec.bary[:, 0].tolist() == [levels + 2, 1.0, 0.0]
            assert rec.prim.tolist() == plain.prim.tolist()
            assert rec.prim[0] >= 0
            for a, b in ((rec.t, plain.t), (rec.inst, plain.inst),
                         (rec.bary[:, 1], plain.bary[:, 1])):
                assert torch.equal(a, b)


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
