"""Starting the ranks of a tile mesh: one process each, spawned.

``spawn_ranks(fn, world_size, backend=..., init_file=...)`` runs
``fn(rank, world_size, *args)`` in ``world_size`` fresh processes, each in
a process group initialized from a ``FileStore`` at ``init_file`` (no
network address). NCCL gives rank r the card ``cuda:r``; gloo leaves the
device to ``fn`` (the CPU, or one card that the ranks share). The call
fails, and stops the others, when a rank raises or when the ranks outlive
``timeout`` seconds; the process group's own timeout is the same, so a
collective whose peer died ends too.
"""

from __future__ import annotations

import datetime
import multiprocessing
import time

import torch
import torch.distributed as dist


def _rank_main(fn, rank, world_size, backend, init_file, timeout, args):
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, store=dist.FileStore(init_file, world_size), rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, *, backend: str, init_file: str,
                args=(), timeout: float = 300.0) -> None:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    (``fn`` importable by name); RuntimeError naming the ranks that failed
    or timed out. ``init_file`` must not exist yet."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, backend, init_file, timeout,
                               tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [r for r, p in enumerate(procs)
              if r not in hung and p.exitcode != 0]
    if hung or failed:
        raise RuntimeError(
            f"ranks timed out after {timeout} s: {hung}; ranks failed "
            f"(exit codes {[procs[r].exitcode for r in failed]}): {failed}")
