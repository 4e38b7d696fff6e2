"""Card times of the traversal, tile and binned raster kernels on their
headline inputs, for timing two checkouts against each other.

  python paperrenderer_tpu_torch/utils/walk_bench.py \\
      [--root DIR] [--group all|trace|tiles|raster] [--rounds N]
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
translucent grid's four peel layers and config 2's two-layer chain; K3, K4
and K4's peel form on config 2; the inputs by ``raster_inputs``, which
``chip_smoke.py``'s ``compare`` and ``compare_keyed`` check):
``rounds`` times each, ``profiling.device_time`` (CUDA events behind a
sleep kernel), and the frames of config 3, hybrid config 4 (``frame_cases``:
each launches K9 twice), the draw-list frames of configs 1 and 2 and the
raster frames of config 2 and the translucent grid (median host ms of 20
synchronized frames). ``--group`` picks one of the three sets.
Two checkouts (e.g. a parent commit unpacked with ``git archive``) are
compared by running this on each in turns on one card (parent, change,
change, parent), each run with ``--same-as`` the first run's ``--out``:
every case's outputs must then hash to the same digest, or the run fails.

Prints one JSON line per case ({case: [ms per round], "live": the share of
its rays (K9: of its pixels) that are live (traversal), "host_ms": the
host's ms to issue one call (tiles, raster, K9), "lists": the mean, p99
and max of its tiles' chunk-list lengths (K6) or of its cells' group-list
lengths (raster), "digest": sha256 of its outputs' bytes}),
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
    ap.add_argument("--group", choices=("all", "trace", "tiles", "raster"),
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
    ceil) i32 key planes when it is given."""
    bins: object
    width: int
    height: int
    keyed: bool = False
    window: object = None

    def args(self):
        b = self.bins
        return ((b.cell_start, b.cell_groups, b.coef, self.width,
                 self.height),
                dict(cell_w=b.cell_w, keyed=self.keyed, window=self.window))

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
    tiles = RE.bin_triangles(frame_batch(rp, cam), w, h, RE.TILE_W)
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
    if args.group != "all":
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
