"""Card times of the traversal, tile and binned raster kernels on their
headline inputs, for timing two checkouts against each other.

  python paperrenderer_tpu_torch/utils/walk_bench.py \\
      [--root DIR] [--group all|trace|tiles|raster|lighting] [--rounds N]
      [--out FILE] [--same-as FILE]

times, in the checkout at ``--root`` (default: the one that holds this
file) and with that checkout's own builds of ``csrc/trace.cu``,
``csrc/raster_tiles.cu`` and ``csrc/raster_exact.cu``, every case of
``probes.headline_waves`` (the traversal kernels at 1080p), of
``tile_cases`` (K5 on the draw-list inputs of config 1, config 2 and the
ragged 200x150 image; K6 on config 2's sorted and presorted setups, and on
its longest lists alone; the inputs by ``tile_inputs``, which
``chip_smoke.py`` checks the kernels on) and of ``raster_cases`` (K1 on
configs 1 and 2, config 2 at supersample 2 and the ragged image; K2 on the
translucent grid's four peel layers and config 2's two-layer chain; K3 on
config 2; K4 and its peel form on config 2 and on ``classic_inputs``'
cases; the inputs by ``raster_inputs``, which ``chip_smoke.py``'s
``compare`` and ``compare_keyed`` check):
``rounds`` times each, ``profiling.device_time`` (CUDA events behind a
sleep kernel), and the frames of config 3, hybrid config 4 (``frame_cases``:
each launches K9 twice), the draw-list frames of configs 1 and 2 and the
raster frames of config 2 and the translucent grid (median host ms of 20
synchronized frames). ``--group`` picks one of the three sets, or
``lighting``: hybrid config 4's 1080p frame (``lighting_cases``) with
what its shadow and AO samples cost: K9's launches, its occlusion and AO
samples and their active rays, and, from ``torch.profiler`` over one
frame, K9's device ms and the device ms of the threefry draws
(``utils.random.uniform``); the lighting group is not part of ``all``.
Two checkouts (e.g. a parent commit unpacked with ``git archive``) are
compared by running this on each in turns on one card (parent, change,
change, parent), each run with ``--same-as`` the first run's ``--out``:
every case's outputs must then hash to the same digest, or the run fails.

Prints one JSON line per case ({case: [ms per round], "live": the share of
its rays (K9: of its pixels) that are live (traversal), "host_ms": the
host's ms to issue one call (tiles, raster, K9), "lists": the mean, p99
and max of its tiles' chunk-list lengths (K6) or of its cells' group-list
lengths (raster), "trace": K4's block records (``classic_trace``, where
the checkout has the probe form), "digest": sha256 of its outputs'
bytes}),
one with the registers, spills, stack frame and shared memory of each
kernel of the builds (ptxas), the card (nvidia-smi name and power limit),
and last {"ok": ...}.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":   # run as a file: its folder (utils/, with its
    here = os.path.dirname(os.path.abspath(__file__))   # own logging and
    sys.path[:] = [p for p in sys.path   # random) must not shadow the
                   if os.path.abspath(p or ".") != here]   # standard library

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

REPS = 10           # timed launches a measurement


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--group", choices=("all", "trace", "tiles", "raster",
                                        "lighting"),
                    default="all", help="the kernels timed")
    ap.add_argument("--root", default=None,
                    help="the checkout whose package is timed")
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--same-as", default=None,
                    help="an earlier run's --out: every case must match "
                         "its digest")
    return ap.parse_args()


def ptxas_table(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, stack, smem}} from a
    ptxas -v log; a kernel is named by its function and template flags
    (e.g. trace_kernel<10110>, raster_tiles_kernel<0>; with an int
    argument comma-separated, raster_keyed_kernel<32,1>), or by its mangled
    name where that is not a ..._kernel function."""
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel(?:_[a-z]+)?)(I((?:L[bi]\d+E)+)E)?",
                          m.group(1))
            args = re.findall(r"L([bi])(\d+)E", k.group(3) or "") if k else []
            flags = ("".join if all(t == "b" for t, _ in args) else
                     ",".join)(v for _, v in args)
            name = (k.group(1) if k else m.group(1)) + \
                (f"<{flags}>" if flags else "")
            table[name] = {}
        elif name and "stack frame" in line:
            n = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            table[name].update(stack=n[0], spill_stores=n[1], spill_loads=n[2])
        elif name and "Used" in line and "registers" in line:
            table[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            table[name]["smem"] = int(sm.group(1)) if sm else 0
    return table


def _first(fn, *args, **kwargs):
    return fn(*args, **kwargs)[0]


def wall_ms(fn, frames: int = 20, warmup: int = 3) -> float:
    """Median host ms of one synchronized call of ``fn`` (a frame)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def length_stats(lens) -> dict:
    """{mean, p99, max} of list lengths (an integer tensor or array)."""
    import numpy as np

    v = np.asarray(lens.cpu() if hasattr(lens, "cpu") else lens, np.int64)
    return dict(mean=float(v.mean()), p99=float(np.percentile(v, 99)),
                max=int(v.max()))


@dataclasses.dataclass
class TileInputs:
    """One setup of the tile kernels: ``coef`` and ``chunk_aabb`` from
    ``tile_setup``, the lists of ``tile_lists`` (``n_pairs`` (tile, chunk)
    pairs), the image size and the triangle batch they come from (None
    for a table made by hand)."""
    batch: object
    coef: object
    chunk_aabb: object
    tile_start: object
    tile_chunks: object
    n_pairs: int
    width: int
    height: int

    @property
    def lens(self):
        """Each tile's list length."""
        return self.tile_start[1:] - self.tile_start[:-1]

    @property
    def lists(self) -> dict:
        return length_stats(self.lens)


def tile_scenes(device) -> dict:
    """{name: (RenderPass, camera)} of the tile kernels' headline inputs:
    config 1 (512x512), config 2 (10k instances at 1080p) and the example
    scene at 200x150 (ragged right and bottom tiles)."""
    from paperrenderer_tpu_torch.scenes import (build_dynamic_scene,
                                                build_example_scene)

    return dict(config1=build_example_scene(512, 512, device=device),
                config2=build_dynamic_scene(10_000, 1920, 1080,
                                            device=device)[1:],
                ragged=build_example_scene(200, 150, device=device))


def tile_inputs(scenes: dict) -> dict:
    """{setup: TileInputs}: the inputs the tile kernels are timed and
    checked on, built once for this script and ``chip_smoke.py``'s
    ``compare_tiles``. ``scenes``: {name: (RenderPass, camera)}
    (``tile_scenes``); each scene's draw-list batch
    (``RenderPass.draw_list_inputs``, ``draw_list_batch``) through
    ``triangle_coefficients``, ``tile_setup`` and ``tile_lists``, and
    config2's also with ``tile_setup(presorted=True)`` (the batch as it
    comes) as ``config2_presorted``."""
    from paperrenderer_tpu_torch.ops import raster_pallas as TP
    from paperrenderer_tpu_torch.ops.raster import triangle_coefficients
    from paperrenderer_tpu_torch.render.renderpass import draw_list_batch

    out = {}
    for name, (rp, cam) in scenes.items():
        w, h = rp.width, rp.height
        batch = draw_list_batch(**rp.draw_list_inputs(cam))[1]
        coeffs, ok, (lo, hi) = triangle_coefficients(batch, w, h)
        for setup, presorted in ((name, False), (name + "_presorted", True)):
            if presorted and name != "config2":
                continue
            f = TP.tile_setup(coeffs, ok, lo, hi, w, h, presorted=presorted)
            out[setup] = TileInputs(batch, f.coef, f.chunk_aabb,
                                    *TP.tile_lists(f.chunk_aabb, w, h), w, h)
    return out


def tile_cases(device) -> dict:
    """{case: a function that launches its tile kernel once}: K5 on the
    ``tile_inputs`` of config 1, config 2 and the ragged image; K6 on config
    2's sorted and presorted setups, and on its sorted lists with every
    list shorter than the 99th percentile emptied (the longest tiles alone:
    the tail of the full launch); the draw-list frames of configs 1 and 2
    (``RenderPass.render(static_path=False)``, their LDR image; ``wall``:
    timed by ``wall_ms``). Each K6 function has ``lists``, the mean, p99
    and max of its tiles' list lengths."""
    import torch
    from paperrenderer_tpu_torch.ops import raster_pallas as TP

    def k6(t, tile_start, tile_chunks):
        fn = functools.partial(TP.rasterize_chunk_lists, t.coef, tile_start,
                               tile_chunks, t.width, t.height)
        fn.lists = length_stats(tile_start[1:] - tile_start[:-1])
        return fn

    scenes = tile_scenes(device)
    ins = tile_inputs(scenes)
    out = {}
    for name in ("config1", "config2", "ragged"):
        t = ins[name]
        out[f"k5_{name}"] = functools.partial(TP.rasterize_chunks, t.coef,
                                              t.chunk_aabb, t.width, t.height)
    for name in ("config1", "config2"):
        rp, cam = scenes[name]
        frame = functools.partial(_first, rp.render, cam, static_path=False)
        frame.wall = True
        out[f"frame_{name}_draw_list"] = frame
    t, p = ins["config2"], ins["config2_presorted"]
    out["k6_config2"] = k6(t, t.tile_start, t.tile_chunks)
    out["k6_config2_presorted"] = k6(p, p.tile_start, p.tile_chunks)
    lens = t.lens
    keep = lens >= torch.quantile(lens.double(), 0.99)
    tail_start = torch.nn.functional.pad(
        torch.cumsum(lens * keep, 0), (1, 0)).to(torch.int32)
    tail = torch.repeat_interleave(keep, lens.long())
    out["k6_config2_tail"] = k6(t, tail_start,
                                t.tile_chunks[tail].contiguous())
    return out


def frame_batch(rp, cam):
    """The triangle batch ``RenderPass.render`` rasterizes: every valid
    triangle of the frame, translucent ones included (the opaque pass of a
    translucent frame drops those; its peel keeps only them)."""
    from paperrenderer_tpu_torch.ops.raster import attach_cull
    from paperrenderer_tpu_torch.ops.static_batch import expand_static

    mapping, inst, tables, mats, cm, slots, vis = rp.frame_inputs(cam)
    batch, _ = expand_static(mapping, inst, tables, cm, slots, vis,
                             do_culling=rp.do_culling)
    return attach_cull(batch, mats)


@dataclasses.dataclass
class RasterCase:
    """One launch of a binned raster kernel: ``rasterize_bins`` on ``bins``
    (a ``BinnedFrame``) at ``width`` x ``height``; K1 unless ``keyed``, and
    then K2 (or K4's peel form on 8x128 bins) inside ``window`` = (floor,
    ceil) i32 key planes when it is given; ``full`` = (full_width,
    full_height) places the image as the window at ``origin`` of that
    viewport."""
    bins: object
    width: int
    height: int
    keyed: bool = False
    window: object = None
    full: tuple = None
    origin: tuple = (0, 0)

    def args(self):
        b = self.bins
        kw = dict(cell_w=b.cell_w, keyed=self.keyed, window=self.window)
        if self.full is not None:
            kw.update(full_width=self.full[0], full_height=self.full[1],
                      origin=self.origin)
        return (b.cell_start, b.cell_groups, b.coef, self.width,
                self.height), kw

    def __call__(self):
        from paperrenderer_tpu_torch.ops.raster_exact import rasterize_bins

        a, kw = self.args()
        return rasterize_bins(*a, **kw)

    @property
    def lists(self) -> dict:
        """The mean, p99 and max of its cells' list lengths."""
        b = self.bins
        return length_stats(b.cell_start[1:] - b.cell_start[:-1])


def raster_scenes(device) -> dict:
    """{name: (RenderPass, camera)} of the binned raster kernels' headline
    inputs: config 1 (512x512), config 2 (10k instances at 1080p), the
    example scene at 200x150 (ragged right and bottom cells) and the
    translucent grid (config 2's with four peel layers)."""
    from paperrenderer_tpu_torch.scenes import (build_dynamic_scene,
                                                build_example_scene,
                                                build_translucent_grid)

    return dict(config1=build_example_scene(512, 512, device=device),
                config2=build_dynamic_scene(10_000, 1920, 1080,
                                            device=device)[1:],
                ragged=build_example_scene(200, 150, device=device),
                translucent=build_translucent_grid(10_000, 1920, 1080,
                                                   device=device)[1:])


def raster_inputs(scenes: dict) -> dict:
    """{case: RasterCase}: the inputs the binned raster kernels are timed
    and checked on, built once for this script and ``chip_smoke.py``'s
    ``compare`` and ``compare_keyed``, from ``raster_scenes``.

    K1 (``k1_*``) on the bins ``RenderPass.render`` gives it: configs 1 and
    2, config 2 at ``supersample=2`` (3840x2160) and the ragged image. On
    config 2's triangles: K3 on the 8x32 bins, K4 on the 8x128 ones, K2 in
    a two-layer peel chain from K3's depth (no ceiling) and K4's peel form
    in the chain's first window. On the translucent grid: K2's four peel
    layers exactly as ``composite_translucency`` chains them, on the
    non-opaque set's bins with the opaque depth's key as the ceiling. The
    chains' windows come from the kernels themselves (the checkout's)."""
    import torch
    from paperrenderer_tpu_torch.ops import raster_exact as RE
    from paperrenderer_tpu_torch.ops.translucency import non_opaque_mask

    out = {}
    for name in ("config1", "config2", "ragged"):
        rp, cam = scenes[name]
        batch = frame_batch(rp, cam)
        for ss in (1, 2) if name == "config2" else (1,):
            w, h = rp.width * ss, rp.height * ss
            key = f"k1_ss2_{name}" if ss == 2 else f"k1_{name}"
            out[key] = RasterCase(RE.bin_triangles(batch, w, h), w, h)
    rp, cam = scenes["config2"]
    w, h = rp.width, rp.height
    bins = out["k1_config2"].bins
    batch = frame_batch(rp, cam)
    tiles = RE.bin_triangles(batch, w, h, RE.TILE_W)
    out["k3_config2"] = RasterCase(bins, w, h, keyed=True)
    out["k4_config2"] = RasterCase(tiles, w, h, keyed=True)
    depth = out["k3_config2"]()[0]
    ceil = torch.full((h, w), RE.SENTINEL, dtype=torch.int32,
                      device=depth.device)
    for layer in (1, 2):
        window = (RE.depth_to_key(depth), ceil)
        out[f"k2_config2_layer{layer}"] = RasterCase(bins, w, h, True, window)
        depth = out[f"k2_config2_layer{layer}"]()[0]
        if layer == 1:
            out["k4_peel_config2"] = RasterCase(tiles, w, h, True, window)
    out.update(classic_inputs(out, tiles, batch, scenes))

    # the translucent frame's own K2 inputs, built as render_frame_static
    # and composite_translucency build them
    rp, cam = scenes["translucent"]
    w, h = rp.width, rp.height
    full = frame_batch(rp, cam)
    clear = non_opaque_mask(rp.frame_inputs(cam)[3], full.material)
    opaque_depth = RE.rasterize_exact(
        dataclasses.replace(full, valid=full.valid & ~clear), w, h)[0]
    peel_bins = RE.bin_triangles(
        dataclasses.replace(full, valid=full.valid & clear), w, h)
    floor = torch.full((h, w), torch.iinfo(torch.int32).min + 1,
                       dtype=torch.int32, device=opaque_depth.device)
    ceil = RE.depth_to_key(opaque_depth)
    for layer in range(1, rp.translucent_layers + 1):
        case = RasterCase(peel_bins, w, h, True, (floor, ceil))
        out[f"k2_translucent_layer{layer}"] = case
        floor = RE.depth_to_key(case()[0])
    return out


def behind(case) -> tuple:
    """The depth window behind ``case``'s output: (its depth's key, no
    ceiling)."""
    import torch
    from paperrenderer_tpu_torch.ops import raster_exact as RE

    key = RE.depth_to_key(case()[0])
    return key, torch.full_like(key, RE.SENTINEL)


def closed_quarters(window) -> tuple:
    """``window`` with some of its 32 x 8 quarters closed (ceil = floor):
    every quarter whose column plus row is 0 mod 3 wholly, and the left
    16 columns of those where it is 1 mod 3 (two warps of four a row)."""
    import torch

    floor, ceil = window
    h, w = floor.shape
    x = torch.arange(w, device=floor.device)
    y = torch.arange(h, device=floor.device)[:, None]
    turn = (x // 32 + y // 8) % 3
    closed = (turn == 0) | ((turn == 1) & (x % 32 < 16))
    return floor, torch.where(closed, floor, ceil)


def long_list_bins(device, groups: int = 1024, width: int = 256,
                   height: int = 16, seed: int = 5):
    """A synthetic ``BinnedFrame`` of 8 x 128 cells whose every list holds
    all ``groups`` groups: rows that cover the whole image and rows cut by
    a vertical and a horizontal half plane, depth planes sloped or constant
    at a few values (so keys tie across the list), made from ``seed``. Far
    more of each quarter's triangles survive its prefilter than K4's
    shared buffer holds."""
    import numpy as np
    import torch
    from paperrenderer_tpu_torch.ops import raster_exact as RE

    rng = np.random.default_rng(seed)
    n = groups * RE.GROUP
    rows = np.zeros((n, 16), np.float32)
    rows[:, [2, 5, 8, 14]] = 1.0             # e0, e1, e2, wn constant 1
    cut = rng.random(n) < 0.25
    sx, sy = (rng.choice([-1.0, 1.0], n) for _ in range(2))
    rows[cut, 0], rows[cut, 2] = sx[cut], -sx[cut] * rng.uniform(0, width, n)[cut]
    rows[cut, 4], rows[cut, 5] = sy[cut], -sy[cut] * rng.uniform(0, height, n)[cut]
    flat = rng.random(n) < 0.4
    rows[:, 9:11] = np.where(flat[:, None], 0.0,
                             rng.uniform(-1e-3, 1e-3, (n, 2)))
    rows[:, 11] = np.where(flat, rng.choice([0.25, 0.5], n),
                           rng.uniform(0.2, 0.9, n))
    rows[:, 14] = np.where(rng.random(n) < 0.2, 2.0, 1.0)
    n_bx, n_by = RE.grid_cells(width, height, RE.TILE_W)
    cells = n_bx * n_by
    coef = torch.from_numpy(rows).to(device)
    return RE.BinnedFrame(
        coef, coef,
        torch.arange(cells + 1, dtype=torch.int32, device=device) * groups,
        torch.arange(groups, dtype=torch.int32, device=device).repeat(cells),
        groups * cells, RE.TILE_W)


def classic_inputs(out: dict, tiles, batch, scenes) -> dict:
    """K4's cases beside config 2's (``raster_inputs``): config 2's 8 x 128
    lists with every list shorter than the longest 1% emptied (``tail``);
    both forms on the ragged 200x150 image (its right and bottom cells
    partial; the window behind K3's depth) and on config 2's 960x540 window
    at (960, 540), whose origin lies inside a cell (the window behind K4's
    depth there); the peel form in config 2's first window with some
    quarters wholly closed; and both forms on ``long_list_bins``, whose
    lists outgrow the survivor buffer."""
    import torch
    from paperrenderer_tpu_torch.ops import raster_exact as RE

    new = {}
    b = tiles
    lens = b.cell_start[1:] - b.cell_start[:-1]
    keep = lens >= torch.quantile(lens.double(), 0.99)
    tail_start = torch.nn.functional.pad(
        torch.cumsum(lens * keep, 0), (1, 0)).to(torch.int32)
    tail = torch.repeat_interleave(keep, lens.long())
    w, h = out["k4_config2"].width, out["k4_config2"].height
    new["k4_config2_tail"] = RasterCase(
        b._replace(cell_start=tail_start,
                   cell_groups=b.cell_groups[tail].contiguous(),
                   n_pairs=int(tail.sum())), w, h, keyed=True)
    rp, cam = scenes["ragged"]
    rw, rh = rp.width, rp.height
    ragged = RE.bin_triangles(frame_batch(rp, cam), rw, rh, RE.TILE_W)
    new["k4_ragged"] = RasterCase(ragged, rw, rh, keyed=True)
    new["k4_peel_ragged"] = RasterCase(ragged, rw, rh, True, behind(
        RasterCase(out["k1_ragged"].bins, rw, rh, keyed=True)))
    win = dict(full=(w, h), origin=(w // 2, h // 2))
    wbins = RE.bin_triangles(batch, w // 2, h // 2, RE.TILE_W,
                             full_width=w, full_height=h,
                             origin=win["origin"])
    new["k4_window"] = RasterCase(wbins, w // 2, h // 2, keyed=True, **win)
    new["k4_peel_window"] = RasterCase(wbins, w // 2, h // 2, True,
                                       behind(new["k4_window"]), **win)
    new["k4_peel_closed"] = RasterCase(
        tiles, w, h, True, closed_quarters(out["k4_peel_config2"].window))
    long = long_list_bins(b.coef.device)
    new["k4_long"] = RasterCase(long, 256, 16, keyed=True)
    new["k4_peel_long"] = RasterCase(long, 256, 16, True,
                                     behind(new["k4_long"]))
    return new


def classic_trace(case) -> dict:
    """What K4's probe form (``raster_exact.classic_probe``) records on
    RasterCase ``case``, summed up: the launch's span on ``%globaltimer``
    (us); its blocks and those that prefiltered a list (a nonempty list
    and a live pixel); each block's time (us:
    mean, p50, p99, max) and the longest one's share of the span; the
    longest one's time, list length, rounds, survivors and the shares of
    its cycles in the prefilter and the walks; the tail, from the 99th percentile of the blocks' ends to
    the last; the blocks resident on an SM (mean over the span, and the
    most at once); the shares of the blocks' clock64 cycles spent in the
    survivor prefilter and in the warps' walks; the prefilter rounds (mean,
    max) and the share of the tested triangles that survived."""
    import numpy as np
    import torch
    from paperrenderer_tpu_torch.ops import raster_exact as RE

    a, kw = case.args()
    del kw["cell_w"], kw["keyed"]
    RE.classic_probe(*a, **kw)
    rec = RE.classic_probe(*a, **kw)[2]
    torch.cuda.synchronize()
    sm, t0, t1, cyc, pre, walk, rounds, surv = rec.cpu().numpy().T
    b = case.bins
    lens = np.repeat((b.cell_start[1:] - b.cell_start[:-1]).cpu().numpy(),
                     RE.TILE_W // RE.CELL_W)
    span = float(t1.max() - t0.min())
    dur = (t1 - t0).astype(np.float64)
    live = rounds > 0
    # blocks resident on one SM at once: +1 at a start, -1 at an end
    most = 0
    for s in np.unique(sm):
        ev = np.concatenate([np.stack([t0[sm == s], np.ones((sm == s).sum())], 1),
                             np.stack([t1[sm == s], -np.ones((sm == s).sum())], 1)])
        ev = ev[np.lexsort((ev[:, 1], ev[:, 0]))]
        most = max(most, int(np.cumsum(ev[:, 1]).max()))
    i = int(np.argmax(dur))
    return dict(
        longest=dict(us=float(dur[i]) / 1e3, list=int(lens[i]),
                     rounds=int(rounds[i]), survivors=int(surv[i]),
                     prefilter=float(pre[i] / cyc[i]),
                     walk=float(walk[i] / cyc[i])),
        span_us=span / 1e3, blocks=int(len(t0)), live_blocks=int(live.sum()),
        block_us=dict(mean=float(dur.mean()) / 1e3,
                      p50=float(np.percentile(dur, 50)) / 1e3,
                      p99=float(np.percentile(dur, 99)) / 1e3,
                      max=float(dur.max()) / 1e3),
        longest_share=float(dur.max()) / span,
        tail_us=float(t1.max() - np.percentile(t1, 99)) / 1e3,
        resident=dict(mean=float(dur.sum()) / span / len(np.unique(sm)),
                      most=most),
        cycles=dict(prefilter=float(pre.sum() / cyc.sum()),
                    walk=float(walk.sum() / cyc.sum())),
        rounds=dict(mean=float(rounds[live].mean()) if live.any() else 0.0,
                    max=int(rounds.max())),
        survived=float(surv.sum()) / max(float(lens[live].sum()) * RE.GROUP,
                                         1.0))


def raster_cases(device) -> dict:
    """{case: a function that launches its binned raster kernel once}: every
    ``raster_inputs`` case, and the raster frames of config 2 and the
    translucent grid (``RenderPass.render``, their LDR image; ``wall``:
    timed by ``wall_ms``). Each kernel case has ``lists``, the mean, p99
    and max of its cells' list lengths."""
    scenes = raster_scenes(device)
    out = dict(raster_inputs(scenes))
    for name in ("config2", "translucent"):
        rp, cam = scenes[name]
        out[f"frame_{name}"] = functools.partial(_first, rp.render, cam)
        out[f"frame_{name}"].wall = True
    return out


def frame_cases(device) -> dict:
    """{case: one frame of config 3 (RayTraceRender) or of hybrid config 4
    (HybridRender) at 1080p, their LDR image; ``wall``: timed by
    ``wall_ms``}: the frames that launch K9 twice each."""
    from paperrenderer_tpu_torch.scenes import (build_hybrid_scene,
                                                build_rt_scene)

    out = {}
    for name, (render, cam) in (
            ("frame_rt_config3", build_rt_scene(1920, 1080,
                                                device=device)[1:]),
            ("frame_hybrid4", build_hybrid_scene(1920, 1080,
                                                 device=device)[1:])):
        out[name] = functools.partial(_first, render.render, cam)
        out[name].wall = True
    return out


def lighting_cases(device) -> dict:
    """{"lighting_hybrid4": one hybrid config 4 frame at 1080p}, timed by
    ``wall_ms``, with ``profile()``: its sample counts and profiled ms."""
    from paperrenderer_tpu_torch.scenes import build_hybrid_scene

    hy, cam = build_hybrid_scene(1920, 1080, device=device)[1:]
    fn = functools.partial(_first, hy.render, cam)
    fn.wall = True
    fn.profile = functools.partial(lighting_profile, hy, cam)
    return {"lighting_hybrid4": fn}


def lighting_profile(render, cam) -> dict:
    """What one frame of ``render`` spends on shadow and AO samples: K9's
    launches, occlusion and AO samples and their active rays (counted in
    a frame of their own: the counts read the card), and from
    ``torch.profiler`` over a further frame K9's device ms, the threefry
    draws' device ms (every call of ``utils.random.uniform``) and all
    kernels' device ms. The checkout's functions are wrapped, not edited,
    so a parent checkout is measured the same way."""
    import torch

    from paperrenderer_tpu_torch.ops import trace_kernel as TK
    from paperrenderer_tpu_torch.utils import random as rnd

    counts = dict(k9_launches=0, occlusion_samples=0, ao_samples=0,
                  occlusion_active_rays=0, ao_active_rays=0)
    uniform, bundle = rnd.uniform, TK.trace_bundle_kernel

    def counted(scene, o, dirs, caps, occ_actives, ao_dirs, ao_caps,
                ao_actives, **kw):
        counts["k9_launches"] += 1
        counts["occlusion_samples"] += len(dirs)
        counts["ao_samples"] += len(ao_dirs)
        for key, acts, n in (("occlusion_active_rays", occ_actives,
                              len(dirs)),
                             ("ao_active_rays", ao_actives, len(ao_dirs))):
            for a in (acts or [None] * n):
                counts[key] += o.shape[0] if a is None else int(a.sum())
        return bundle(scene, o, dirs, caps, occ_actives, ao_dirs, ao_caps,
                      ao_actives, **kw)

    def ranged(name, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call

    try:
        TK.trace_bundle_kernel = counted
        render.render(cam)
        torch.cuda.synchronize()
        TK.trace_bundle_kernel = ranged("k9", bundle)
        rnd.uniform = ranged("threefry", uniform)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            render.render(cam)
            torch.cuda.synchronize()
    finally:
        TK.trace_bundle_kernel, rnd.uniform = bundle, uniform

    def dev_us(e, total=True):
        for name in (("device_time_total", "cuda_time_total") if total else
                     ("self_device_time_total", "self_cuda_time_total")):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    avg = {e.key: e for e in prof.key_averages()}
    counts.update(
        k9_device_ms=dev_us(avg["k9"]) / 1e3 if "k9" in avg else None,
        threefry_device_ms=(dev_us(avg["threefry"]) / 1e3
                            if "threefry" in avg else None),
        all_kernels_device_ms=sum(dev_us(e, total=False)
                                  for e in avg.values()) / 1e3)
    return counts


def main() -> int:
    args = _args()
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("walk_bench: no CUDA device", file=sys.stderr)
        return 2
    from paperrenderer_tpu_torch.ops import raster_exact as RE
    from paperrenderer_tpu_torch.ops import raster_pallas as TP
    from paperrenderer_tpu_torch.ops import trace_kernel as TK
    from paperrenderer_tpu_torch.utils import cuda_build
    from paperrenderer_tpu_torch.utils import probes as PR
    from paperrenderer_tpu_torch.utils.profiling import device_time, host_time

    want = {}
    if args.same_as:
        for line in open(args.same_as):
            j = json.loads(line) if line.startswith("{") else {}
            if "digest" in j:
                want[next(iter(j))] = j["digest"]
    out = open(args.out, "a") if args.out else None

    def emit(line):
        """Print a line (a JSON object or text), and append it to --out
        at once, so a run cut short keeps what it measured."""
        line = line if isinstance(line, str) else json.dumps(line)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    groups = dict(trace=(TK._lib, "trace",
                         lambda dev: {**PR.headline_waves(dev),
                                      **frame_cases(dev)}),
                  tiles=(TP._lib, "raster_tiles", tile_cases),
                  raster=(RE._lib, "raster_exact", raster_cases))
    if args.group == "lighting":
        groups = dict(lighting=(TK._lib, "trace", lighting_cases))
    elif args.group != "all":
        groups = {args.group: groups[args.group]}
    ptxas = {}
    for lib, name, _ in groups.values():
        lib()
        ptxas.update(ptxas_table(cuda_build.BUILD_INFO[name]["log"]))
    emit({"root": root, "ptxas": ptxas})
    ok = True
    for group, (_, _, cases) in groups.items():
        for case, fn in cases("cuda").items():
            digest = hashlib.sha256()
            for t in PR.tensors_of(fn()):
                digest.update(t.contiguous().view(torch.uint8).cpu().numpy())
            act = getattr(fn, "keywords", {}).get("active")
            timer = (wall_ms if getattr(fn, "wall", False) else
                     lambda f: device_time(f, iters=REPS) * 1e3)
            line = {case: [timer(fn) for _ in range(args.rounds)]}
            if group == "trace" and not getattr(fn, "wall", False):
                line["live"] = getattr(fn, "live", None) or (
                    1.0 if act is None else float(act.float().mean()))
            if group in ("tiles", "raster") or getattr(fn, "host", False):
                # what a call costs the host to issue
                line["host_ms"] = host_time(fn, iters=REPS) * 1e3
                if hasattr(fn, "lists"):
                    line["lists"] = fn.lists
            if hasattr(fn, "profile"):
                line.update(fn.profile())
            if case.startswith("k4_") and hasattr(RE, "classic_probe"):
                line["trace"] = classic_trace(fn)
            same = want.get(case, digest.hexdigest()) == digest.hexdigest()
            ok &= same
            emit(dict(line, digest=digest.hexdigest(), same=same))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    emit(smi)
    emit({"ok": ok, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    if out is not None:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
