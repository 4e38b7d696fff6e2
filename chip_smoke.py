#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (paperrenderer_tpu_torch) on one card.

Phases, each reported as one JSON line:
  device   the card (nvidia-smi name and power limit), torch and CUDA versions;
  build    every CUDA kernel of the static raster frame, built from csrc/;
  compare  each kernel against its plain PyTorch version on the inputs the
           main path gives it at config 1, config 2 and a ragged image size
           (bitwise equality), both timed with CUDA events;
  config1  the example scene through RenderPass.render at 512x512 and
           128x128, held to tests/goldens/raster_512.png and
           raster_example.png with the golden bands; median frame time;
  config2  10k instances at 1920x1080: median frame time over 20 frames,
           counts, and a reduced copy of the scene checked against the CPU;
  launches every kernel of the path was launched by the config1/config2
           frames (launch counters reset just before them);
  sync     cost of the frame's one device-to-host read (the pair count):
           frame time as is vs. with the count supplied.

Usage: python3 chip_smoke.py            (all phases; needs one CUDA card)
       python3 chip_smoke.py --profile  (also a torch.profiler breakdown of
                                         both configs by stage, with the
                                         tables written to chiprun_out/)
Exit code 0 only when every phase passed; the last line of stdout is then
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
this script, it exits 2 and prints no result.
"""

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "tests", "goldens")
KERNELS = [dict(name="raster_exact", route="cuda",
                source="paperrenderer_tpu_torch/csrc/raster_exact.cu",
                replaces="paperrenderer_tpu/ops/raster_exact.py:231")]


def emit(**fields):
    print(json.dumps(fields), flush=True)


def bands(img, ref, mean_tol=0.004, frac_tol=0.002, pix_thresh=0.06):
    """tests/test_golden_images.py's tolerance bands -> (ok, mean, frac)."""
    import numpy as np

    diff = np.abs(np.asarray(img, np.float32) - ref).max(axis=-1)
    mean, frac = float(diff.mean()), float((diff > pix_thresh).mean())
    return mean <= mean_tol and frac <= frac_tol, mean, frac


def golden(name):
    from paperrenderer_tpu_torch.io import read_image

    return read_image(os.path.join(GOLDENS, f"{name}.png")).astype("float32") / 255.0


def frame_ms(rp, cam, frames=20, warmup=5):
    """Median wall time of one synchronized frame (ms)."""
    import torch

    for _ in range(warmup):
        rp.render(cam)
    torch.cuda.synchronize()
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        rp.render(cam)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_inputs(rp, cam):
    """The raster kernel's inputs exactly as RenderPass.render builds them."""
    from paperrenderer_tpu_torch.ops.raster import attach_cull
    from paperrenderer_tpu_torch.ops.raster_exact import bin_triangles
    from paperrenderer_tpu_torch.ops.static_batch import expand_static

    mapping, inst, tables, mats, cm, slots, vis = rp.frame_inputs(cam)
    batch, _ = expand_static(mapping, inst, tables, cm, slots, vis,
                             do_culling=rp.do_culling)
    return bin_triangles(attach_cull(batch, mats), rp.width, rp.height)


def compare_raster(rp, cam, reps=20):
    """K1 vs its plain version on the main path's inputs; bitwise check."""
    import torch
    from paperrenderer_tpu_torch.ops import raster_exact as RE

    b = kernel_inputs(rp, cam)
    w, h = rp.width, rp.height
    args = (b.cell_start, b.cell_groups, b.coef, w, h)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    d_k, t_k = RE.rasterize_bins(*args)        # the wrapper: launches K1
    d_p, t_p = RE.rasterize_bins_plain(*args)
    torch.cuda.synchronize()
    start.record()                              # second, warm plain run
    RE.rasterize_bins_plain(*args)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    bitwise = (torch.equal(t_k, t_p)
               and torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)))
    both = (t_k >= 0) & (t_p >= 0)
    err = float((d_k[both] - d_p[both]).abs().max()) if both.any() else 0.0
    for _ in range(3):
        RE.rasterize_bins(*args)
    start.record()
    for _ in range(reps):
        RE.rasterize_bins(*args)
    end.record()
    torch.cuda.synchronize()
    counts = (b.cell_start[1:] - b.cell_start[:-1])
    return dict(bitwise=bool(bitwise), max_abs_err=err,
                tid_mismatch=int((t_k != t_p).sum()),
                ms=start.elapsed_time(end) / reps, plain_ms=plain_ms,
                n_pairs=b.n_pairs, max_list=int(counts.max()),
                coverage=float((t_k >= 0).float().mean()))


def sync_cost(rp, cam, frames=20, rounds=4):
    """Frame time with the per-frame pair-count read vs. with the count
    supplied (same camera, so the count is known): loops of `frames`
    back-to-back frames, synchronized at the loop ends only, in `rounds`
    rounds of the order read, known, known, read."""
    import torch
    from paperrenderer_tpu_torch.ops import raster_exact as RE

    orig = RE.bin_groups
    _, aux = rp.render(cam)
    known = aux["required_work"]

    def loop(supply):
        if supply:
            RE.bin_groups = functools.partial(orig, n_pairs=known)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(frames):
                rp.render(cam)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / frames * 1e3
        finally:
            RE.bin_groups = orig

    diffs, runs = [], []
    for _ in range(rounds):
        a1, b1, b2, a2 = loop(False), loop(True), loop(True), loop(False)
        diffs.append((a1 + a2 - b1 - b2) / 2)
        runs.append([a1, b1, b2, a2])
    flat = [r for rnd in runs for r in rnd]
    return dict(ms_with_read=statistics.mean(flat[0::4] + flat[3::4]),
                ms_count_supplied=statistics.mean(flat[1::4] + flat[2::4]),
                sync_cost_ms=statistics.mean(diffs),
                sync_cost_ms_per_round=diffs, runs=runs)


def profile_frames(rp, cam, out_path, frames=5):
    """torch.profiler over `frames` frames: the device's busy share of the
    window (kernel time only), and host and device ms per frame of each
    stage of the frame (labelled by wrapping the stage functions)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from paperrenderer_tpu_torch.ops import raster_exact as RE
    from paperrenderer_tpu_torch.render import renderpass as RP

    stages = [(RP, "expand_static"), (RP, "attach_cull"),
              (RE, "triangle_coefficients"), (RE, "bin_groups"),
              (RE, "rasterize_bins"), (RP, "resolve_gbuffer_pairs"),
              (RP, "shade_gbuffer"), (RP, "tonemap")]

    def labelled(fn, name):
        @functools.wraps(fn)
        def run(*a, **k):
            with record_function("stage:" + name):
                return fn(*a, **k)
        return run

    originals = [getattr(mod, name) for mod, name in stages]
    for (mod, name), fn in zip(stages, originals):
        setattr(mod, name, labelled(fn, name))
    try:
        rp.render(cam)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(frames):
                rp.render(cam)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (mod, name), fn in zip(stages, originals):
            setattr(mod, name, fn)
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    dev_total = lambda e: getattr(e, "device_time_total",
                                  getattr(e, "cuda_time_total", 0))
    # device-side kernels only: the stage labels also appear on the device
    # timeline, as spans that would count their kernels twice
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("stage:")]
    busy_ms = sum(dev(e) for e in kernels) / 1e3
    per_frame = lambda us: us / 1e3 / frames
    # per stage: host time inside the stage's call, and the device time of
    # the kernels launched from it
    stage_rows = {}
    for e in prof.events():
        if e.name.startswith("stage:") and e.device_type == DeviceType.CPU:
            row = stage_rows.setdefault(e.name[len("stage:"):],
                                        dict(host_ms=0.0, kernel_ms=0.0))
            row["host_ms"] += per_frame(e.cpu_time_total)
            row["kernel_ms"] += per_frame(dev_total(e))
    top = sorted(kernels, key=dev, reverse=True)[:8]
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    return dict(frames=frames, wall_ms_per_frame=wall_ms / frames,
                kernel_ms_per_frame=busy_ms / frames,
                device_busy_share=busy_ms / wall_ms if wall_ms else None,
                stages=stage_rows,
                top_kernels=[(e.key[:80], per_frame(dev(e)), e.count // frames)
                             for e in top])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "paperrenderer_tpu_torch")):
        print("chip_smoke: paperrenderer_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    failures = []
    results = {}

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
            ok = out.pop("ok", True)
        except Exception as exc:  # report and go on: every phase runs
            out, ok = {"error": repr(exc), "trace": traceback.format_exc()}, False
        out["seconds"] = round(time.perf_counter() - t0, 3)
        if not ok:
            failures.append(name)
        results[name] = out
        emit(phase=name, ok=ok, **out)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit(phase="device", ok=True, nvidia_smi=smi,
         name=torch.cuda.get_device_name(0), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    import paperrenderer_tpu_torch  # noqa: F401  (sets the precision flags)
    from paperrenderer_tpu_torch.ops import raster_exact as RE
    from paperrenderer_tpu_torch.scenes import build_dynamic_scene, build_example_scene
    from paperrenderer_tpu_torch.utils import cuda_build

    def build():
        cuda_build.load_library("raster_exact")
        info = cuda_build.BUILD_INFO["raster_exact"]
        ptxas = [l.strip() for l in info["log"].splitlines() if "ptxas" in l]
        return dict(kernel="raster_exact", build_seconds=info["seconds"],
                    cached=info["seconds"] == 0.0, ptxas=ptxas)

    phase("build", build)

    scenes = {}

    def get(cfg):
        if cfg not in scenes:
            if cfg == 1:
                scenes[cfg] = build_example_scene(512, 512, device="cuda")
            else:
                _, rp, cam = build_dynamic_scene(10_000, 1920, 1080, device="cuda")
                scenes[cfg] = (rp, cam)
        return scenes[cfg]

    def compare():
        out = {f"config{c}": compare_raster(*get(c)) for c in (1, 2)}
        # ragged right and bottom bin cells (200 = 6.25 x 32, 150 = 18.75 x 8)
        out["ragged"] = compare_raster(*build_example_scene(200, 150, device="cuda"))
        out["ok"] = all(v["bitwise"] for v in out.values())
        return out

    phase("compare", compare)

    RE.LAUNCHES["raster_exact"] = 0     # count only the main path's launches

    def config1():
        rp, cam = get(1)
        ldr, aux = rp.render(cam)
        img = ldr.cpu().numpy()
        ok512, mean512, frac512 = bands(img, golden("raster_512"))
        rp128, cam128 = build_example_scene(128, 128, device="cuda")
        ok128, mean128, frac128 = bands(rp128.render(cam128)[0].cpu().numpy(),
                                        golden("raster_example"))
        finite = bool(torch.isfinite(ldr).all()) and img.shape == (512, 512, 3)
        return dict(ok=ok512 and ok128 and finite,
                    golden512=dict(mean=mean512, frac=frac512, ok=ok512),
                    golden128=dict(mean=mean128, frac=frac128, ok=ok128),
                    frame_ms=frame_ms(rp, cam),
                    visible_count=int(aux["visible_count"]),
                    total_tris=int(aux["total_tris"]),
                    coverage=float(aux["coverage"]),
                    required_work=aux["required_work"])

    def config2():
        rp, cam = get(2)
        ldr, aux = rp.render(cam)
        finite = bool(torch.isfinite(ldr).all()) and tuple(ldr.shape) == (1080, 1920, 3)
        # a reduced copy of the scene, card vs the plain CPU path
        _, rp_s, cam_s = build_dynamic_scene(400, 256, 128, device="cuda")
        _, rp_c, cam_c = build_dynamic_scene(400, 256, 128, device="cpu")
        ok_s, mean_s, frac_s = bands(rp_s.render(cam_s)[0].cpu().numpy(),
                                     rp_c.render(cam_c)[0].numpy())
        cov = float(aux["coverage"])
        return dict(ok=finite and ok_s and cov > 0,
                    frame_ms=frame_ms(rp, cam, warmup=3),
                    visible_count=int(aux["visible_count"]),
                    total_tris=int(aux["total_tris"]), coverage=cov,
                    required_work=aux["required_work"],
                    reduced_vs_cpu=dict(mean=mean_s, frac=frac_s, ok=ok_s))

    phase("config1", config1)
    phase("config2", config2)
    launches = dict(RE.LAUNCHES)
    phase("launches", lambda: dict(ok=all(n > 0 for n in launches.values()),
                                   counts=launches))
    phase("sync", lambda: {f"config{c}": sync_cost(*get(c)) for c in (1, 2)})
    if args.profile:
        for c in (1, 2):
            phase(f"profile{c}", lambda c=c: profile_frames(*get(c), os.path.join(
                HERE, "chiprun_out", f"profile_config{c}.txt")))

    cmp = results.get("compare", {})
    cmp1, cmp2 = cmp.get("config1", {}), cmp.get("config2", {})
    emit(kernels=[dict(
        k, launches=launches.get(k["name"], 0),
        max_abs_err=max(cmp.get(c, {}).get("max_abs_err", float("nan"))
                        for c in ("config1", "config2", "ragged")),
        ms=cmp2.get("ms"), plain_ms=cmp2.get("plain_ms"),
        ms_config1=cmp1.get("ms"), plain_ms_config1=cmp1.get("plain_ms"))
        for k in KERNELS])
    print(smi, flush=True)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    emit(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
