"""Shared pieces of the example CLIs: the device flag and frame timing."""

from __future__ import annotations

import argparse
import time

import torch


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    return p


def device(args) -> str:
    return "cpu" if args.cpu else "cuda"


def sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def time_frames(render, dev: str, frames: int):
    """The first frame's seconds (kernel builds included), then the mean ms
    of ``frames`` more; returns (first s, steady ms, the first frame's
    (ldr, aux)). The first frame is the one written: an RT or hybrid
    frame's samples follow the frame count, and the goldens hold the
    first frame's."""
    t0 = time.perf_counter()
    out = render()
    sync(dev)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(frames):
        render()
    sync(dev)
    return first, (time.perf_counter() - t0) / max(frames, 1) * 1e3, out
