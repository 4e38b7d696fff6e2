"""Device profiling helpers: the port of
``paperrenderer_tpu/utils/profiling.py``.

``trace`` wraps ``torch.profiler`` and writes a Chrome/Perfetto trace;
``device_time`` measures the steady-state time of one call: with CUDA events
on the current stream when the call's outputs are CUDA tensors, with the host
clock when they lie on the CPU; ``host_time`` what a call costs the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import torch

SM_CYCLES_PER_S = 2.0e9   # above an H100's highest SM clock (1.98 GHz)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU activity, and CUDA activity where a card is
    present) and write ``log_dir/trace.json``, viewable in Perfetto or
    ``chrome://tracing``. Yields the profiler, whose ``key_averages()``
    holds the per-operator times."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _on_cuda(out) -> bool:
    """Whether any tensor in ``out`` (a tensor, a sequence or dict of them,
    or a dataclass holding them) lies on a CUDA device."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(x) for x in out)
    if isinstance(out, dict):
        return any(_on_cuda(x) for x in out.values())
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        return any(_on_cuda(getattr(out, f.name))
                   for f in dataclasses.fields(out))
    return False


def host_time(fn: Callable, *args, iters: int = 10) -> float:
    """Host seconds per call of ``fn(*args)``, the device's queue drained
    before and not waited for after: on the card, what a call costs the
    host to issue, its launch rate while the device keeps up."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def device_time(fn: Callable, *args, iters: int = 10,
                warmup: int = 2) -> float:
    """Steady-state seconds per call of ``fn(*args)``. At least one warm-up
    call runs; its outputs say where to time: CUDA events around ``iters``
    calls on the current stream when they are CUDA tensors, else the host
    clock (the calls then run eagerly on the CPU). On the card the timed
    calls queue behind a sleep kernel that outlasts their host-side
    enqueue, so the events time the device's work alone, not the host's
    launch rate (``host_time`` gives that)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    if _on_cuda(out):
        host = host_time(fn, *args, iters=2)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        # 2 GHz is above the card's SM clock, so the sleep lasts at least
        # twice the enqueue time of the timed calls
        torch.cuda._sleep(int(2 * (iters + 1) * host * SM_CYCLES_PER_S))
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters
