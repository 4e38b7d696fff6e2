#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (paperrenderer_tpu_torch) on one card.

Phases, each reported as one JSON line:
  device   the card (nvidia-smi name and power limit), torch and CUDA versions;
  build    every CUDA kernel (csrc/raster_exact.cu, csrc/raster_tiles.cu,
           csrc/trace.cu, csrc/probes.cu), one nvcc per source, all started
           together; ptxas registers/spills/smem;
  compare  K1 against its plain PyTorch version on the inputs the main path
           gives it at config 1, config 2, config 2 at supersample 2
           (3840x2160) and a ragged image size (bitwise equality), both
           timed with CUDA events; each case with its cells' list lengths,
           the exact per-warp rejection's tests and the share it keeps
           (raster_pallas.tile_may_cover on the card), and the bound of that
           work beside the plain version's candidates (the inputs from
           walk_bench.raster_inputs);
  compare_keyed  the keyed raster kernels against their plain versions at
           1920x1080 (bitwise): on config 2's triangles K3 (8x32 cells), K4
           (8x128 cells), K2 on a two-layer depth-peel chain built from
           K3's own output, and K4's peel form on the chain's first window;
           on the translucent grid K2's four peel layers with the frame's
           own bins and windows (ceiling: the opaque depth's key); K4 and
           its peel form also on config 2's longest 1% of lists alone, the
           ragged 200x150 image, config 2's 960x540 window at (960, 540),
           a window with wholly closed quarters (peel) and synthetic lists
           longer than K4's survivor buffer; kernel and plain ms,
           candidates, the rejection's work as in compare, the share of
           warps K2 skips (no open window), bound;
  compare_tiles  the tile kernels against their plain versions on the
           draw-list batches (bitwise): K5 at config 1, config 2 and a ragged
           image size; K6 at config 2 on the morton-sorted batch and on the
           batch as it comes (presorted form), each also against K5 on the
           same setup; K5 and K6 on an adversarial coefficient table (the
           CPU rejection test's kinds of rows, every list split, depth ties
           across ranges); K6's required work against a numpy count of the
           (tile, chunk) pairs; kernel and plain ms, pairs, the plain
           versions' candidates, the tile lists' and their split ranges'
           lengths (mean, p99, max), the exact per-warp rejection's tests
           and the candidates it keeps (raster_pallas.tile_may_cover on the
           card), and the bound of that work (the inputs from
           walk_bench.tile_inputs);
  compare_trace  the traversal kernels against their plain versions on the
           wavefronts of the 1920x1080 RT frame (bitwise): K7 closest and any
           hit on primary rays, K8 on primary and reflection rays, K9 on the
           shadow+AO bundle without and with the resolve sample, on the
           reflection hits' bundle of config 3's frame and on both bundles
           of hybrid config 4's (the four K9 waves of the frames, each with
           its live share), and on an adversarial bundle (30 occlusion
           samples: duplicate, opposite, axis and zero-component
           directions, caps of 0, t_min and exactly a hit's t, inactive
           samples between active ones, an all-inactive stretch; with the
           AO and resolve samples), each also holding the plain union walk
           (trace_kernel.occlusion_union_plain) to the per-sample bits,
           bounded by the bytes of its active samples and the union's
           work, and the plain union's group held to the kernel's; and the
           alpha forms (the any-hit leaf cutout) on the 1920x1080 leaf grid's
           flat layout: K8 on its primary and reflection rays, K7 on its
           primary rays, and K8 on the primary rays in a seeded random
           order, put back in order and held bitwise to the launch-order
           run (and timed: incoherent rays); kernel and plain ms, rays,
           mismatches, the box/leaf visits of the walk and the candidates
           the cutout rejected;
  config1  the example scene through RenderPass.render at 512x512 and
           128x128, held to tests/goldens/raster_512.png and
           raster_example.png with the golden bands; median frame time;
  config2  10k instances at 1920x1080: median frame time over 20 frames,
           counts, and a reduced copy of the scene checked against the CPU;
  translucent  config 2's grid with one instance in four a 50% glass and one
           in sixteen a leaf cutout (scenes.build_translucent_grid), four
           peel layers: median frame time, finite output that differs from
           the opaque frame, and a 256x128 copy on the card against the CPU
           with the golden bands;
  supersample  supersample=2: the 128x128 example scene held to
           tests/goldens/raster_supersample2.png with the golden bands, and
           the median frame time of config 1 (512x512) and config 2
           (1920x1080) at twice the resolution on each axis;
  keyed_entry  config 2's triangles through rasterize_exact(crossz=False)
           (K3), rasterize_exact(quarter=False) (K4) and both with a depth
           window (K2, K4's peel form): K3 covers what the default path (K1)
           covers, with K1's exact depth in K3's key bucket; K4 finds K3's
           depth, and K4's peel form K2's, except on <= 1e-5 of the pixels;
  draw_list  RenderPass.render(cam, static_path=False), the draw-list frame
           (preprocess, triangle batch, K5): config 1 at 512x512 and 128x128
           held to the raster goldens; config 2 at 1920x1080: median frame
           time, draw/visible/triangle counts (total_tris equal to the static
           frame's), the frame against the static frame with the golden
           bands; a reduced copy (400 instances, 256x128) against the CPU;
  rt_frame the RT scene through RayTraceRender.render: 128x128 held to
           tests/goldens/rt_example.png with the golden bands, 96x64 on the
           card against the CPU, and at 1920x1080 the median frame time
           (fuse_bounce off and on), config 3's primary Mrays/s through K7
           and its TLAS-assemble ms;
  rt_grid10k  config 2's 10k-instance grid mirrored into a RayTraceRender:
           K7 primary Mrays/s at 1920x1080 on the flat layout, and K7
           against its plain version on every 64th ray (bitwise);
  compare_paged  the paged traversal kernels against their plain versions
           (bitwise) on the main path's wavefronts: K11 on the 10k crowd's
           primary rays and K10 any hit on its shadow rays (1024x1024), K10
           on config 2's grid at 1920x1080 with K7 on the flat layout of the
           same rays beside it, K10 and K11 on the big model's primary rays,
           and the alpha forms on the leaf grid's paged layout: K11 on its
           primary and AO rays, K10 on its primary rays, and K11 on the
           primary rays in a seeded random order (held bitwise to the
           launch-order run, timed); kernel and plain ms, rays, mismatches,
           visits, candidates the cutout rejected, bound;
  crowd    the 10k crowd through RayTraceRender.render at 1024x1024 (paged
           by prefer_paged): median frame ms, Mrays/s with the nominal 2WH
           rays and with the live rays; the 600-instance crowd at 128x128
           held to tests/goldens/crowd_paged.png through the paged and the
           routed (flat) frame; 96x64 paged on the card against the CPU;
  hybrid   HybridRender: the 128x128 example held to
           tests/goldens/hybrid_example.png; config 4 at 1920x1080 (flat:
           K1, K9, K8) and config 2's grid at 1920x1080 (paged: K1, K10,
           K11): median frame ms and one frame's launches; a reduced copy of
           each on the card against the CPU;
  big_model  a 224 x 224 uv sphere (100,352 triangles, BLAS chunks) among
           cubes in a RayTraceRender at 1920x1080: BLAS build seconds, chunk
           count, primary Mrays/s through K11, median frame ms;
  leaf_rt  the leaf grid (scenes.build_leaf_rt_grid: the translucent grid,
           one instance in sixteen a leaf cutout; 1 shadow, AO and
           reflection sample) at 1920x1080 through RayTraceRender.render
           (routed paged: K10, K11 alpha) and forced flat (K9, K8 alpha), and
           through HybridRender.render (K1, K10, K11 alpha), and config 3
           with half-rate reflections off and on: median frame ms and one
           frame's launches; a reduced copy of each (400 instances or the RT
           scene, 96x64) on the card against the CPU with the golden bands;
  textured textures (core/texture.py's atlas and samplers, plain tensor
           ops): the 128x128 textured example (scenes.build_textured_scene)
           held to tests/goldens/textured_example.png through the static and
           the draw-list frame, and its static frame, a two-layer textured
           glass frame (K2), the flat RT frame and the hybrid frame on the
           card against the port's CPU frames (mean and max |diff|, golden
           bands), every frame's atlas on the card; config 2's grid with
           textured materials (scenes.build_textured_grid, a ~65 MB atlas) at
           1920x1080: the static, draw-list, RT (paged) and hybrid frame ms
           beside their untextured twins (config 2, the RT grid, the hybrid
           grid) in the order untextured, textured, textured, untextured,
           shade_gbuffer alone on its G-buffer untextured and with each
           mip_filter (CUDA events), the atlas bytes, a frame's peak CUDA
           memory, and a 400-instance copy on the card against the CPU; its
           K1, K2, K5 and K8-K11 launches join the kernels line;
  animation  animation (ops/animation.py, the unique-geometry BLAS refit
           and re-split, scenes.run_dynamic): config 5, 100k instances of
           build_dynamic_scene at 1920x1080 (~4.4 M triangles): the static
           frame and run_dynamic's animated loop (median ms of 20 frames),
           the visible, triangle and coverage counts, the TLAS refit of the
           animated instances (animate_instances + assemble_scene_paged,
           the layout prefer_paged picks; ms a frame), a 400-instance
           256x128 copy animated 3 frames on the card against the CPU;
           config 3's RT scene at 1920x1080 with its sphere a
           unique-geometry instance (animate_vertices; flat), re-split off
           and on, beside its unanimated twin, with its refit + assemble ms
           and a 96x64 copy against the CPU; the 10k crowd at 1024x1024
           with one instance in 64 animated (157 spheres, 2,512 anim leaves;
           paged), re-split off and on, its assemble_scene_paged ms, the
           refit's and re-split's host ops and ms batched by leaf count and
           one BLAS at a time (bitwise the same), the 600-instance crowd at
           96x64 against the CPU; hybrid config 4 with its sphere animated
           (the RT passes; the G-buffer keeps the rest pose) and a 96x64
           copy; each frame's launches; then, uncounted, K1 on config 5's
           bins, K8 on the animated RT frame's primary rays and K10/K11 on
           the animated crowd's, bitwise against their plain versions;
  probes   the profiling path (paperrenderer_tpu_torch.utils.probes.measure,
           the counterpart of scripts/probe_smem_dma.py, probe_smem_dma2.py
           and prof_rt_floor2.py), its launches counted: K12a's three copy
           forms and K12b's five cases (us per copy step by CUDA events and
           by the kernel's own %globaltimer), K12c at 2,073,600 and 1,024
           rays beside five Tensor.copy_ calls of the same bytes, K7 on the
           1080p RT scene's primary rays all dead (closest, any hit) and
           live, and the step-count forms of K7 and K10 (every dead any-hit
           ray counts 0 steps); then, uncounted, every K12 form bitwise
           against its plain version, and the step forms of K7 (the 1080p
           primary rays) and K10 (config 2's grid on the paged layout),
           live and dead, and of both on the leaf grid's primary rays
           (without the cutout), bitwise in every output against the plain
           walk, each with the warp efficiency of its step counts in launch
           order (utils.probes.warp_efficiency); plain ms and bounds;
  native   the native scene core (paperrenderer_tpu_torch.native): the
           library loaded (shipped, or built with g++ into build/native/);
           config 5's scene (build_dynamic_scene(100_000, 1920, 1080)) with
           the native packer and a Python-mirror twin, the flushed
           InstanceArrays bitwise on live rows after 1,000 edits, 500
           swap-removes and a grow; morton3d bitwise the numpy formula;
           host ms of a full flush, a 1,000-row flush and
           build_static_mapping, each way;
  gltf     config 2's textured grid written as a .glb (write_glb: four
           meshes, the grid's materials with embedded PNG textures, one
           BLEND, 10,000 nodes under an identity root), loaded with
           io.load_gltf + instantiate on the card, rendered at 1920x1080
           through the static frame (two peel layers), the draw list,
           RayTraceRender (paged) and HybridRender: each in the golden
           bands of, and bitwise against, the directly built scene's frame
           (else its first differing input), load seconds, frame ms; a
           400-node copy at 128x64 on the card against the CPU (mean
           <= 1e-5); the grid again with its images in the rarer forms
           (GLTF_FORMS: arithmetic-coded progressive, lossless, CMYK and
           YCCK, 4:1:1 and 4:4:0 JPEGs, a block-smoothed progressive one,
           4-bit and 1-bit gray PNGs, written by numpy-only writers), its
           four frames bitwise the scene built from read_image of the same
           bytes, each form's decode seconds at its size beside the card's
           name and power limit; and again in the container formats
           (GLTF_CONTAINERS: lossy WebP, lossy WebP with alpha and lossless
           WebP from tests/data/webp/, BMP RLE8, 5-6-5 and V5 with an
           alpha mask, 32-bit run-length and 8-bit gray TGA, an
           interlaced GIF with a transparency index), the same way; and
           in the second part's (GLTF_CONTAINERS2: DDS BC1, BC3 with
           alpha, BC7 mode 6 and BC4, an LZW TIFF with predictor 2, a
           tiled deflate RGBA TIFF, a PackBits 16-bit gray BigTIFF, a
           binary PPM and an RGBA QOI, by numpy-only writers), the same
           way; and in the third part's (GLTF_CONTAINERS3: PSD RLE RGBA
           and raw CMYK, a tiled 4:2:0 YCbCr JPEG TIFF, an LZMA TIFF with
           predictor 2, BLP2 DXT5, BLP1 JPEG, FTEX DXT1, SGI RLE RGBA and
           24-bit PCX, by numpy-only writers), the same way; its launches
           join the kernels line;
  viewer   Viewer over the example scene at 512x512 (raster, RT, hybrid;
           each rendered once first, so no build runs in its thread):
           over 127.0.0.1 each mode's /frame.png bitwise a direct render
           of the same frame (the loop paused before its next frame), a
           material edit and a mode switch change the frames, /stats
           without an error, fps per mode; launches read after stop();
  xla_route  use_pallas=False on the card: the example scene at 512x512
           and 128x128, supersample=2, the RT, hybrid and textured examples
           against their goldens, no kernel launched (the hybrid frame's
           RT passes follow the device), ms beside the kernel route's;
  examples every paperrenderer_tpu_torch.examples module in a subprocess
           at its golden's size, four at a time, its PNG against the golden
           (render_dynamic at 1920x1080, view_scene 5 frames served);
  launches every kernel was launched by the phases of its path (K1: config1,
           config2, translucent, supersample, textured; K2: translucent,
           keyed_entry, textured; K3/K4: keyed_entry; K5: draw_list,
           textured; K6: compare_tiles; traversal: rt_frame, rt_grid10k and
           textured; K1 and K8-K11: animation), with the launch counters
           reset just
           before each and read just after; the kernels line counts K1/K2
           from the frame phases, K3/K4 from keyed_entry, K5 from draw_list,
           K6 from compare_tiles (no frame runs it), K7-K9 from rt_frame,
           K10/K11 from crowd, hybrid and big_model, K1, K2, K5 and K8-K11
           also from textured, the alpha forms of K8 and K11 from leaf_rt,
           K12 and the step forms of K7/K10 from probes, K1, K8-K11 also
           from animation, K1, K2 and K7-K11 also from parallel (its four
           ranks' main-path pass; K1's and K2's rows also carry their
           windowed form's compare);
  parallel the sharded frames (paperrenderer_tpu_torch.parallel): the
           windowed K1 on config 2's and the translucent grid's opaque
           triangles and K2's first peel layer on the bottom-right 960x540
           window of 1920x1080 (origin (960, 540), inside the 8x32 cells),
           bitwise against their plain versions; (a) NCCL at world size 1
           in this process: config 2 through sharded_render_frame_static
           (K1) bitwise RenderPass.render, hybrid config 4 through
           make_sharded_hybrid_frame bitwise the single-device hybrid frame
           (paged with the tile key fold_in(key, 0); flat on a deterministic
           copy); (b) four gloo ranks sharing the card in a 2x2 mesh
           (960x540 windows, collectives staged through host memory):
           config 2, the translucent grid (4 layers), config 2 at
           supersample 2 and the 128x128 example through
           sharded_render_frame_static(use_pallas=True), gathered and held
           to the single-device frames (depth bitwise, tid, LDR where tid
           is equal), measure_sharded_demand == required, the example in
           tests/goldens/sharded_raster.png's bands; config 3's RT frame (flat, paged) and config 4's hybrid
           frame, each tile bitwise a one-process call on its window with
           its folded key, and deterministic copies (radius-0 lights, no AO
           or reflections) gathered bitwise the single-device frames;
           per-rank frame ms beside the single-device ms (four ranks on one
           card: no scaling number); the ranks' launches of one pass join
           the kernels line (K1, K2, K7 from the hybrid frame's AO pass,
           K8-K11); the legacy world-BVH RT frame (sharded_rt_frame), each
           tile bitwise a one-process trace of its window, and the gathered
           frame in the golden bands of the two-level one (config3_flat,
           the same tile keys);
  world_rt the single-level world-BVH path (ops.bvh, plain PyTorch on the
           card, no kernel) on config 3's scene at 1920x1080: build_bvh on
           the card equal to the CPU build of the same boxes;
           BatchTracer's primary surfaces against the two-level tracer's
           (K8): hit flags, material ids and world positions (1e-4
           relative) equal except on rays that graze a triangle edge
           (barycentric margin < 1e-3 on the side that hits: ties of the
           two tracers' arithmetic); rt_frame's image against
           render_frame_rt's (RayTraceRender.render, the same key) in the
           golden bands; all of it on the scene as built (its primary
           surfaces reported: config 3's cube quaternion is not unit, so
           the world batch and the TLAS place the cube 0.093% apart) and
           with its quaternions normalized (every check held); the world
           frame's ms and bvh_trace's steps and host reads a frame;
  sync     cost of the raster frame's one device-to-host read (the pair
           count): frame time as is vs. with the count supplied.

Usage: python3 chip_smoke.py            (all phases; needs one CUDA card)
       python3 chip_smoke.py --profile  (also a torch.profiler breakdown of
                                         configs 1, 2, the translucent grid,
                                         config 2 at supersample=2, config
                                         2's draw-list frame, the 1080p
                                         RT frame, the crowd frame and the
                                         1080p hybrid frames and the
                                         leaf grid's RT frame and the
                                         textured grid's static and
                                         hybrid frames by stage, with
                                         the tables written to
                                         chiprun_out/)
Exit code 0 only when every phase passed; the last line of stdout is then
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
this script, it exits 2 and prints no result.
"""

import argparse
import dataclasses
import functools
import json
import os
import statistics
import struct
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "tests", "goldens")
TRACE_CU = "paperrenderer_tpu_torch/csrc/trace.cu"
RASTER_CU = "paperrenderer_tpu_torch/csrc/raster_exact.cu"
TILES_CU = "paperrenderer_tpu_torch/csrc/raster_tiles.cu"
PROBES_CU = "paperrenderer_tpu_torch/csrc/probes.cu"
KERNELS = [dict(name="raster_exact", route="cuda", source=RASTER_CU,
                replaces="paperrenderer_tpu/ops/raster_exact.py:231"),
           dict(name="raster_peel", route="cuda", source=RASTER_CU,
                replaces="paperrenderer_tpu/ops/raster_exact.py:231"),
           dict(name="raster_keyed", route="cuda", source=RASTER_CU,
                replaces="paperrenderer_tpu/ops/raster_exact.py:231"),
           dict(name="raster_classic", route="cuda", source=RASTER_CU,
                replaces="paperrenderer_tpu/ops/raster_exact.py:116"),
           dict(name="raster_tiles", route="cuda", source=TILES_CU,
                replaces="paperrenderer_tpu/ops/raster_pallas.py:47"),
           dict(name="raster_tiles_binned", route="cuda", source=TILES_CU,
                replaces="paperrenderer_tpu/ops/raster_pallas.py:215"),
           dict(name="trace_scene", route="cuda", source=TRACE_CU,
                replaces="paperrenderer_tpu/ops/trace_kernel.py:228"),
           dict(name="trace_resolve", route="cuda", source=TRACE_CU,
                replaces="paperrenderer_tpu/ops/trace_kernel.py:506"),
           dict(name="trace_bundle", route="cuda", source=TRACE_CU,
                replaces="paperrenderer_tpu/ops/trace_kernel.py:1012"),
           dict(name="trace_scene_paged", route="cuda", source=TRACE_CU,
                replaces="paperrenderer_tpu/ops/trace_paged.py:214"),
           dict(name="trace_resolve_paged", route="cuda", source=TRACE_CU,
                replaces="paperrenderer_tpu/ops/trace_paged.py:575"),
           dict(name="chunk_stream", route="cuda", source=PROBES_CU,
                replaces="scripts/probe_smem_dma.py:25"),
           dict(name="chunk_stream_sweep", route="cuda", source=PROBES_CU,
                replaces="scripts/probe_smem_dma2.py:23"),
           dict(name="pass_through", route="cuda", source=PROBES_CU,
                replaces="scripts/prof_rt_floor2.py:73")]

# Least-time bounds (published H100 SXM peaks):
# bytes at the HBM rate, FP32 operations at the published FP32 peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations (add/sub/mul/div/min/max) of the plain versions, counted
# from their expressions:
RASTER_OPS_PER_CANDIDATE = 22   # 5 planes x (2 mul + 2 add) + 2 mul (depth)
KEYED_OPS_PER_CANDIDATE = 20    # 5 planes x (2 mul + 2 add); the divide of
#                                 the few covering candidates is left out
TILE_OPS_PER_CANDIDATE = 20     # 5 planes x (2 mul + 2 add); the depth
#                                 divide, esum and the 2 bary divides of the
#                                 few covering candidates are left out; as
#                                 many in a rejection test (5 planes at one
#                                 corner of a warp's footprint)
SLAB_OPS_PER_BOX_ROW = 49       # 3 div + 2 x (6 sub, 6 mul, 6 min/max,
#                                 4 min/max reductions, 1 max)
MT_OPS_PER_LEAF = 8 * 46        # 8 x (two crosses 18, four dots 20, 3 sub,
#                                 3 mul, 1 div, 1 add)
INST_OPS = 33                   # origin 3 x 6, direction 3 x 5
# K9's bound counts what each piece of the work needs once: 1/d once a
# walking sample and once an instance pop a sample; a union's box pop the
# planes less the shared origin once and the rest a sample; a union's
# triangle s, q and e2.q once and the rest a sample
INV_OPS = 3
SLAB_SHARED_OPS = 12            # b - o
SLAB_SAMPLE_OPS = SLAB_OPS_PER_BOX_ROW - INV_OPS - SLAB_SHARED_OPS
INST_ORIGIN_OPS = 18
MT_SHARED_OPS = 17              # s 3 sub, q 6 mul + 3 sub, e2.q 5
MT_SAMPLE_OPS = MT_OPS_PER_LEAF // 8 - MT_SHARED_OPS
RESOLVE_OPS = 42                # w0 2, normal 15 + 15, uv 10


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


def frame_ms(rp, cam, frames=20, warmup=5, **kw):
    """Median wall time of one synchronized frame (ms); `kw` goes to
    render."""
    import torch

    for _ in range(warmup):
        rp.render(cam, **kw)
    torch.cuda.synchronize()
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        rp.render(cam, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def raster_work(case, bins=None):
    """The work of the binned raster kernels' exact per-warp rejection on
    RasterCase `case` (walk_bench.raster_inputs), counted on `bins` (default
    the case's own; K4's cases count the 8x32 bins' work, which the
    function needs): `warps`, the warps of the cells; with a window,
    `skipped`, those none of whose pixels has an open window
    (raster_exact.peel_window_open), which test nothing; `tested`, the
    (warp footprint, triangle) pairs the other warps test, every triangle
    of the cell's list; `kept`, those the test keeps
    (raster_pallas.tile_may_cover on the card; with a window over the box
    of the warp's open pixels), each of whose footprint's 32 pixels is then
    a candidate evaluated."""
    import torch
    from paperrenderer_tpu_torch.ops import raster_exact as RE
    from paperrenderer_tpu_torch.ops import raster_pallas as TP

    b = case.bins if bins is None else bins
    fw, fh = RE.WARP_FOOT
    x0, y0 = case.origin   # the cells are the viewport's: (ax, ay) inside
    ax, ay = x0 % b.cell_w, y0 % RE.CELL_H
    n_bx, n_by = RE.grid_cells(case.width, case.height, b.cell_w, (x0, y0))
    dev = b.coef.device
    hh, ww = n_by * RE.CELL_H, n_bx * b.cell_w
    if case.window is None:      # no window: every footprint whole
        open_ = torch.ones((hh, ww), dtype=torch.bool, device=dev)
    else:                        # outside the image the window is (0, 0)
        open_ = torch.nn.functional.pad(
            RE.peel_window_open(*case.window),
            (ax, ww - case.width - ax, ay, hh - case.height - ay))

    def warps(img):   # [hh, ww] -> [cell, warp of the cell, 32 pixels]
        img = img.reshape(n_by, RE.CELL_H // fh, fh, n_bx, b.cell_w // fw, fw)
        return img.permute(0, 3, 1, 4, 2, 5).reshape(n_by * n_bx, -1, fh * fw)

    op = warps(open_)   # the viewport's pixel coordinates
    xs = warps(torch.arange(ww, device=dev).expand(hh, ww) + (x0 - ax))
    ys = warps(torch.arange(hh, device=dev)[:, None].expand(hh, ww)
               + (y0 - ay))
    box = [f(torch.where(op, v, fill), -1) for v in (xs, ys)
           for f, fill in ((torch.amin, 1 << 30), (torch.amax, -1))]
    live = op.any(-1)                                   # [cell, warp]
    lens = (b.cell_start[1:] - b.cell_start[:-1]).long()
    cell_of = torch.repeat_interleave(
        torch.arange(lens.numel(), device=dev), lens)   # each pair's cell
    rows = b.coef.view(-1, RE.GROUP, 16)
    tested = kept = 0
    for s in range(0, b.n_pairs, 4096):
        c = cell_of[s:s + 4096]
        r = rows[b.cell_groups[s:s + 4096].long()]     # [pairs, 8, 16]
        for wi in range(live.shape[1]):
            lv = live[c, wi]
            x0, x1, y0, y1 = (v[c, wi, None] for v in box)
            may = TP.tile_may_cover(r, x0, x1, y0, y1) & lv[:, None]
            kept += int(may.sum())
            tested += int(lv.sum()) * RE.GROUP
    return dict(warps=live.numel(), skipped=int((~live).sum()),
                skipped_share=float((~live).float().mean()),
                tested=tested, kept=kept, kept_share=kept / max(tested, 1),
                candidates_evaluated=kept * fw * fh)


def compare_raster(case, needed=None, reps=20):
    """One binned raster kernel (K1-K4, by RasterCase `case`) against its
    plain version on the same inputs: bitwise check, kernel ms (CUDA
    events), plain ms (one call), the cells' list lengths, the per-warp
    rejection's work (raster_work, on `needed`'s bins for K4) and the bound
    of that work: its plane tests x 20 and its kept candidates x 22 (K1's
    cross-multiplied compare) or x 20 (keyed), beside `candidates`, the
    plain version's whole count; bytes: the inputs read once (the window
    planes too), depth and tid written once."""
    import torch
    from paperrenderer_tpu_torch.ops import raster_exact as RE

    a, kw = case.args()
    b, w, h = case.bins, case.width, case.height
    d_k, t_k = RE.rasterize_bins(*a, **kw)       # the wrapper: its kernel
    plain_kw = {k: v for k, v in kw.items()
                if k not in ("full_width", "full_height")}
    (d_p, t_p), plain_ms = timed_once(
        lambda: RE.rasterize_bins_plain(*a, **plain_kw))
    both = (t_k >= 0) & (t_p >= 0)
    work = raster_work(case, None if needed is None else needed.bins)
    per_candidate = (KEYED_OPS_PER_CANDIDATE if case.keyed
                     else RASTER_OPS_PER_CANDIDATE)
    nbytes = ((b.cell_start.numel() + b.cell_groups.numel() + b.coef.numel())
              * 4 + w * h * (16 if case.window is not None else 8))
    b_ms, b_by = bound(nbytes, work["tested"] * TILE_OPS_PER_CANDIDATE
                       + work["candidates_evaluated"] * per_candidate)
    out = dict(
        bitwise=same_bits(d_k, d_p) and torch.equal(t_k, t_p),
        max_abs_err=(float((d_k[both] - d_p[both]).abs().max())
                     if both.any() else 0.0),
        tid_mismatch=int((t_k != t_p).sum()),
        ms=timed(case, reps), plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, n_pairs=b.n_pairs, lists=case.lists,
        candidates=b.n_pairs * RE.GROUP * RE.CELL_H * b.cell_w, **work,
        coverage=float((t_k >= 0).float().mean()))
    if case.window is not None:
        out["finite_ceiling"] = bool((case.window[1] != RE.SENTINEL).any())
    return out


def pair_count_numpy(chunk_aabb, width, height):
    """The (tile, chunk) overlap count from the chunk boxes on the host: the
    kernels' inclusive compares against every 8 x 128 tile rect in float32
    numpy (an independent count of the list K6 walks)."""
    import numpy as np

    b = chunk_aabb.cpu().numpy()
    n_tx, n_ty = -(-width // 128), -(-height // 8)
    tx0 = (np.arange(n_tx) * 128).astype(np.float32)
    ty0 = (np.arange(n_ty) * 8).astype(np.float32)
    in_x = (b[None, :, 0] <= tx0[:, None] + np.float32(128)) \
        & (b[None, :, 2] >= tx0[:, None])                     # [n_tx, K]
    in_y = (b[None, :, 1] <= ty0[:, None] + np.float32(8)) \
        & (b[None, :, 3] >= ty0[:, None])                     # [n_ty, K]
    return int((in_y[:, None, :] & in_x[None, :, :]).sum())


def adversarial_tiles(width=400, height=100, n_chunks=24, seed=9):
    """(coef, chunk_aabb): a coefficient table of the kinds of rows that
    the CPU test of the tile kernels' rejection probes
    (tests/test_torch_parity.py, test_tile_may_cover_is_exact), made from
    `seed`: small triangles around warp-footprint and tile corners (some
    degenerate: +-inf or NaN coefficients), slivers one column wide on
    footprint borders, and rows with one plane replaced by -0.0
    coefficients, +-inf, NaN, products that overflow at some pixels only,
    or wn near 1e-12. Every chunk's box covers the image but the last one's,
    which is inverted: its rows cover every pixel nearest, and no kernel may
    visit it. So every tile's list is longer than a split range: chunks 16
    to 19 repeat chunks 0 to 3 (depth ties between ranges), and chunk 21
    repeats 16 small triangles of chunk 2 at depth -0.0 where chunk 2 has
    them at +0.0 (a -0.0 depth after an equal +0.0 one)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = n_chunks * 128
    f32 = np.float32

    def triangles(m):
        """e0, e1, e2 planes of m small triangles around footprint corners
        (a degenerate one gives +-inf or NaN coefficients)."""
        c = np.stack([rng.integers(0, width // 16 + 1, m) * 16.0,
                      rng.integers(0, height // 8 + 1, m) * 8.0], -1)
        v = np.round((c[:, None] + rng.normal(0.0, 5.0, (m, 3, 2))) * 2) / 2
        e = np.zeros((m, 9))
        with np.errstate(divide="ignore", invalid="ignore"):
            det = ((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
                   - (v[:, 1, 1] - v[:, 0, 1]) * (v[:, 2, 0] - v[:, 0, 0]))
            for i in range(3):    # edge function opposite vertex i, 1 at it
                a, b = v[:, (i + 1) % 3], v[:, (i + 2) % 3]
                e[:, 3 * i] = -(b[:, 1] - a[:, 1]) / det
                e[:, 3 * i + 1] = (b[:, 0] - a[:, 0]) / det
                e[:, 3 * i + 2] = ((b[:, 1] - a[:, 1]) * a[:, 0]
                                   - (b[:, 0] - a[:, 0]) * a[:, 1]) / det
        return e

    rows = np.zeros((n, 16), np.float64)
    rows[:, 0:9] = triangles(n)
    rows[:, 9:12] = np.stack([rng.normal(0, 1e-3, n), rng.normal(0, 1e-3, n),
                              rng.uniform(0.2, 0.9, n)], -1)
    rows[:, 12:15] = np.stack([rng.normal(0, 1e-3, n), rng.normal(0, 1e-3, n),
                               rng.uniform(1.0, 4.0, n)], -1)
    rows = rows.astype(f32)
    big = f32(3.4e38 / 400)             # px * big overflows past px ~400
    w12 = f32(1e-12)
    special = [(-0.0, -0.0, 0.0), (0.0, 0.0, -0.0), (float("inf"), 0, -1),
               (float("-inf"), 0, 1), (float("inf"), float("-inf"), 0),
               (float("nan"), 0, 0), (0, 0, float("nan")),
               (big, 0, -big * 200), (-big, 0, big * 200),
               (big, -big * 2, 0), (0, 0, w12),
               (0, 0, np.nextafter(w12, f32(1))),
               (0, 0, np.nextafter(w12, f32(0))),
               (1e-14, 0, w12 - 1e-14 * 64)]
    for r in rng.choice(n, n // 3, replace=False):
        at = 12 if rng.random() < 0.25 else 3 * rng.integers(0, 4)
        rows[r, at:at + 3] = np.asarray(special[rng.integers(len(special))],
                                        f32)
    for r in rng.choice(n, n // 8, replace=False):   # one-column slivers
        x = f32(rng.integers(1, width // 16) * 16 - rng.integers(0, 2)) + 0.5
        rows[r, 0:9] = (1, 0, -x, -1, 0, x, 0, 0, 1)
    chunk = rows.reshape(n_chunks, 128, 16)
    chunk[16:20] = chunk[0:4]
    chunk[2, :16, 0:9] = triangles(16)
    chunk[2, :16, 9:12] = (0, 0, 0.0)
    chunk[21, :16] = chunk[2, :16]
    chunk[21, :16, 11] = -0.0
    rows[-128:] = (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0.01, 0, 0, 1, 0)
    boxes = np.tile(np.asarray([-1, -1, width + 1, height + 1], f32),
                    (n_chunks, 1))
    boxes[-1] = (1e9, 1e9, -1e9, -1e9)
    return (torch.from_numpy(rows).cuda().contiguous(),
            torch.from_numpy(boxes).cuda().contiguous())


def tile_work(t):
    """The tile lists' length stats (mean, p99, max) of TileInputs `t`, the
    same of the ranges the kernels' blocks walk once each list is split, and
    the work of the kernels' exact per-warp rejection: `tested`, the
    (warp footprint, triangle) pairs it tests (every triangle of a tile's
    listed chunks against each footprint of the tile), and `kept`, those it
    keeps (raster_pallas.tile_may_cover on the card), each of whose
    footprint's pixels is then a candidate evaluated."""
    import numpy as np
    import torch
    from paperrenderer_tpu_torch.ops import raster_pallas as TP
    from paperrenderer_tpu_torch.utils.walk_bench import length_stats

    fw, fh = TP.WARP_FOOT
    tile_of = torch.repeat_interleave(
        torch.arange(t.lens.numel(), device=t.lens.device), t.lens.long())
    rows = t.coef.view(-1, TP.CHUNK, 16)
    n_tx = -(-t.width // TP.TILE_W)
    kept = 0
    for s in range(0, t.tile_chunks.numel(), 2048):
        tile = tile_of[s:s + 2048, None]
        r = rows[t.tile_chunks[s:s + 2048].long()]
        for fx in range(0, TP.TILE_W, fw):
            for fy in range(0, TP.TILE_H, fh):
                x0 = (tile % n_tx) * TP.TILE_W + fx
                y0 = (tile // n_tx) * TP.TILE_H + fy
                kept += int(TP.tile_may_cover(r, x0, x0 + fw - 1, y0,
                                              y0 + fh - 1).sum())
    tested = t.n_pairs * TP.CHUNK * (TP.TILE_W * TP.TILE_H // (fw * fh))
    n = t.lens.cpu().numpy().astype(np.int64)
    split = TP.split_ranges(n.size)
    rl = np.maximum(TP.RANGE_MIN, -(-n // split))   # the kernels' range_len
    full = n // rl
    ranges = np.concatenate([np.repeat(rl, full), (n % rl)[n % rl > 0],
                             np.zeros(int((n == 0).sum()), np.int64)])
    return dict(lists=t.lists, split=split, ranges=length_stats(ranges),
                split_tiles=int((n > rl).sum()), tested=tested, kept=kept,
                kept_share=kept / max(tested, 1),
                candidates_evaluated=kept * fw * fh)


def compare_tiles(scenes, reps=10):
    """K5 and K6 against their plain versions on the draw-list batches and
    on an adversarial coefficient table; bitwise checks, kernel ms (CUDA
    events), plain ms (one call), pairs, `candidates` (the plain version's
    (pixel, triangle) candidates: every triangle of every listed chunk at
    every pixel of its tile), list lengths, the rejection's work
    (`tile_work`) and the least-time bound of that work. `scenes`: name ->
    (RenderPass, camera) as walk_bench.tile_scenes, whose inputs
    walk_bench.tile_inputs builds; K6 runs on config2 (sorted and
    presorted) and the adversarial table."""
    import torch
    from paperrenderer_tpu_torch.ops import raster_pallas as TP
    from paperrenderer_tpu_torch.utils.walk_bench import (TileInputs,
                                                          tile_inputs)

    out = {}

    def check(got, ref):
        """(bitwise, tid mismatches, the largest difference where the bits
        differ: 0 when they do not; NaN bary of an adversarial row, equal
        on both sides, counts as no difference)."""
        (dk, tk, bk), (dp, tp, bp) = got, ref

        def err(a, b):
            d = torch.where(a.view(torch.int32) == b.view(torch.int32), 0.0,
                            (a - b).abs())
            return float(d.max()) if d.numel() else 0.0

        both = (tk >= 0) & (tp >= 0)
        return (same_bits(dk, dp) and torch.equal(tk, tp)
                and same_bits(bk, bp)), int((tk != tp).sum()), \
            max(err(dk[both], dp[both]), err(bk, bp))

    def case(name, t):
        w, h = t.width, t.height
        if name.startswith("k6"):
            args = (t.coef, t.tile_start, t.tile_chunks, w, h)
            kernel, plain = TP.rasterize_chunk_lists, TP.rasterize_chunk_lists_plain
            extra = (t.tile_start.numel() + t.tile_chunks.numel()) * 4
        else:
            args = (t.coef, t.chunk_aabb, w, h)
            kernel, plain = TP.rasterize_chunks, TP.rasterize_chunks_plain
            extra = t.chunk_aabb.numel() * 4
        got = kernel(*args)
        ref, plain_ms = timed_once(lambda: plain(*args))
        ok, mism, err = check(got, ref)
        work = tile_work(t)
        # the work the kernels cannot skip: the rejection's plane tests and
        # the candidates it keeps, each as dear as a candidate of the plain
        # version; each input read once, the outputs written once
        b_ms, b_by = bound(t.coef.numel() * 4 + extra + w * h * 16,
                           (work["tested"] + work["candidates_evaluated"])
                           * TILE_OPS_PER_CANDIDATE)
        out[name] = dict(bitwise=ok, tid_mismatch=mism, max_abs_err=err,
                         ms=timed(lambda: kernel(*args), reps),
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         n_pairs=t.n_pairs,
                         candidates=t.n_pairs * TP.CHUNK * TP.TILE_H * TP.TILE_W,
                         chunks=t.chunk_aabb.shape[0],
                         coverage=float((got[1] >= 0).float().mean()),
                         **work)
        return got

    ins = tile_inputs(scenes)
    k5 = {name: case(f"k5_{name}", ins[name]) for name in scenes}
    t, p = ins["config2"], ins["config2_presorted"]
    out["k6_config2"]["equals_k5"] = check(case("k6_config2", t),
                                           k5["config2"])[0]
    k5p = TP.rasterize_chunks(p.coef, p.chunk_aabb, p.width, p.height)
    out["k6_config2_presorted"]["equals_k5"] = check(
        case("k6_config2_presorted", p), k5p)[0]
    # required work: the wrapper's against the host count
    n_tiles = t.lens.numel()
    out["required"] = dict(
        k6=TP.rasterize_tiles_binned(t.batch, t.width, t.height)[3],
        numpy=n_tiles + pair_count_numpy(t.chunk_aabb, t.width, t.height),
        k6_presorted=TP.rasterize_tiles_binned(t.batch, t.width, t.height,
                                               presorted=True)[3],
        numpy_presorted=n_tiles + pair_count_numpy(p.chunk_aabb, p.width,
                                                   p.height))
    # the adversarial table, ragged 400 x 100
    coef, boxes = adversarial_tiles()
    adv = TileInputs(None, coef, boxes, *TP.tile_lists(boxes, 400, 100),
                     400, 100)
    out["k6_adversarial"]["equals_k5"] = check(
        case("k6_adversarial", adv), case("k5_adversarial", adv))[0]
    req = out.get("required", {})
    out["ok"] = (all(v["bitwise"] for k, v in out.items() if k != "required")
                 and all(out[k]["equals_k5"] for k in (
                     "k6_config2", "k6_config2_presorted", "k6_adversarial"))
                 and out["k5_adversarial"]["coverage"] > 0.0
                 and req.get("k6") == req.get("numpy")
                 and req.get("k6_presorted") == req.get("numpy_presorted"))
    return out


def compare_keyed(ins):
    """K3, K4 and K2 against their plain versions, bitwise, on the keyed
    cases of walk_bench.raster_inputs `ins`: on config 2's triangles K3
    and K4 on the frame's 8x32 and 8x128 bins, K2 on the 8x32 bins in a
    two-layer peel chain (each layer's floor is the previous layer's key,
    starting from K3's depth; no ceiling) and K4's peel form on the 8x128
    bins in the chain's first window; on the translucent grid K2 on all
    four peel layers exactly as composite_translucency runs them, on the
    non-opaque set's bins with the opaque depth's key as the ceiling; and
    K4's further cases (walk_bench.classic_inputs): config 2's longest 1%
    of lists alone, both forms on the ragged 200x150 image and on config
    2's 960x540 window at (960, 540), the peel form with some quarters
    wholly closed, and both forms on lists that outgrow the survivor
    buffer.

    Each case as compare_raster reports it; K4's bound on config 2 counts
    the work of the 8x32 bins, which the function needs (its 8x128 cells
    test more); its other cases count their own 8x128 bins' work."""
    needed = dict(k4_config2=ins["k3_config2"],
                  k4_peel_config2=ins["k2_config2_layer1"])
    out = {name: compare_raster(case, needed.get(name))
           for name, case in ins.items() if case.keyed}
    out["ok"] = all(v["bitwise"] for v in out.values())
    return out


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn, reps):
    """Mean ms of `fn()` over `reps` launches after 2 warm-up calls (CUDA
    events around the whole run)."""
    import torch

    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(result, ms) of one call, CUDA events around it."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def same_bits(a, b):
    """Bitwise equality of two tensors of one dtype."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def rec_check(rk, rp):
    """Kernel vs plain HitRecord2: (bitwise, mismatching rays, max |t|)."""
    import torch

    diff = ((rk.t.view(torch.int32) != rp.t.view(torch.int32))
            | (rk.prim != rp.prim) | (rk.inst != rp.inst)
            | (rk.bary.view(torch.int32) != rp.bary.view(torch.int32)).any(-1))
    both = rk.hit & rp.hit
    err = float((rk.t[both] - rp.t[both]).abs().max()) if both.any() else 0.0
    return int(diff.sum()) == 0, int(diff.sum()), err


def hit_flags(a, b):
    """Any-hit records: the hit flag is the contract."""
    mism = int((a.hit != b.hit).sum())
    return mism == 0, mism, rec_check(a, b)[2]


def resolve_check(a, b):
    """Kernel vs plain (HitRecord2, (uv, normal, material))."""
    ok, mism, err = rec_check(a[0], b[0])
    same = all(same_bits(x, y) for x, y in zip(a[1], b[1]))
    return ok and same, mism + (0 if same else 1), err


def permuted_case(kernel, o, d, t_max, reps, active=None):
    """`kernel(o, d, t_max, active)` on the rays in a seeded random order
    (utils.probes.ray_order), its outputs put back in launch order, against
    the same kernel in launch order: the order in which the rays reach the
    card must not leak into any output bit. The permuted run is timed
    (incoherent rays)."""
    import torch
    from paperrenderer_tpu_torch.utils import probes as PR

    r = o.shape[0]
    perm = PR.ray_order(r, o.device)
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=o.device).expand(r)
    rays = [x if x is None else x[perm].contiguous()
            for x in (o, d, t_max, active)]
    want = PR.tensors_of(kernel(o, d, t_max, active))
    mism = 0
    for w, g in zip(want, PR.tensors_of(kernel(*rays))):
        back = torch.empty_like(g)
        back[perm] = g
        diff = back.view(torch.int32) != w.view(torch.int32)
        mism += int(diff.reshape(r, -1).any(-1).sum())
    return dict(bitwise=mism == 0, mismatches=mism, max_abs_err=0.0
                if mism == 0 else float("nan"), rays=r,
                ms=timed(lambda: kernel(*rays), reps))


def walk_bytes(scene, n_rays, per_ray_bytes):
    """Bytes a traversal must move: the scene tables once, and each ray's
    inputs and outputs once."""
    tables = sum(t.numel() * t.element_size() for t in (
        scene.nodes, scene.codes, scene.leaf_rows, scene.leaf_prim))
    return tables + n_rays * per_ray_bytes


def k9_bytes(scene, args, resolve):
    """(bytes, [active occlusion, AO, resolve samples]) of a K9 call: the
    scene tables once; each pixel's activity flags and outputs; the origin
    of a pixel with an active sample, and the direction and cap of each
    active sample."""
    import torch

    o, dirs, _, occ_act, _, _, ao_act = args
    r, n_a = o.shape[0], len(args[4])
    ones = torch.ones(r, dtype=torch.bool, device=o.device)
    acts = [[ones if a is None else a.bool()
             for a in (occ_act or [None] * len(dirs))],
            [ones if a is None else a.bool()
             for a in (ao_act or [None] * n_a)],
            [] if resolve is None else
            [ones if resolve[3] is None else resolve[3].bool()]]
    walks = [int(sum(int(a.sum()) for a in kind)) for kind in acts]
    live = torch.zeros(r, dtype=torch.bool, device=o.device)
    for a in acts[0] + acts[1] + acts[2]:
        live = live | a
    flags = len(dirs) + n_a + len(acts[2])
    outputs = 4 + 4 * n_a + 44 * len(acts[2])
    nbytes = (walk_bytes(scene, r, flags + outputs)
              + 12 * int(live.sum()) + 16 * sum(walks))
    return nbytes, walks


def union_ops(u):
    """FP32 operations of K9's union walks (TK.occlusion_union_plain's
    counts)."""
    return (u.get("walks", 0) * INV_OPS + u.get("box", 0) * SLAB_SHARED_OPS
            + u.get("box_tests", 0) * SLAB_SAMPLE_OPS
            + u.get("inst", 0) * INST_ORIGIN_OPS
            + u.get("inst_tests", 0) * (INST_OPS - INST_ORIGIN_OPS + INV_OPS)
            + u.get("leaf_tris", 0) * MT_SHARED_OPS
            + u.get("tri_tests", 0) * MT_SAMPLE_OPS)


def k9_walk_ops(counts, walks, n_resolved=0):
    """FP32 operations of `walks` one-sample walks (trace_scene's counts),
    1/d once a walk and once an instance pop."""
    return (walks * INV_OPS
            + counts.get("box", 0) * (SLAB_OPS_PER_BOX_ROW - INV_OPS)
            + counts.get("leaf", 0) * MT_OPS_PER_LEAF
            + counts.get("inst", 0) * (INST_OPS + INV_OPS)
            + n_resolved * RESOLVE_OPS)


def walk_ops(counts, n_resolved=0):
    return (counts.get("box", 0) * SLAB_OPS_PER_BOX_ROW
            + counts.get("leaf", 0) * MT_OPS_PER_LEAF
            + counts.get("inst", 0) * INST_OPS + n_resolved * RESOLVE_OPS)


def compare_trace(rt, cam, leaf, reps=10):
    """K7/K8/K9 vs their plain versions on the 1080p RT frame's wavefronts
    (K9 also on the reflection hits' bundle of config 3's frame, both
    bundles of hybrid config 4's and an adversarial bundle), and K8's and
    K7's alpha forms on the 1080p leaf grid's (`leaf` = (rt,
    camera); flat layout, forced): bitwise checks, kernel ms (CUDA events),
    plain ms (one call), the walk's visits and the candidates the cutout
    rejected (from the plain version) and the least-time bound."""
    import torch
    from paperrenderer_tpu_torch.ops import trace_kernel as TK
    from paperrenderer_tpu_torch.scenes import build_hybrid_scene, build_rt_scene
    from paperrenderer_tpu_torch.utils import probes as PR

    wf = PR.rt_wavefronts(rt, cam)
    ctx, sc = wf["ctx"], wf["ctx"].scene
    walk = dict(root_code=ctx.root_code, stack_size=ctx.stack_size,
                cull_mask=wf["cull"])
    o, r = wf["o"], wf["o"].shape[0]
    res_bytes = sum(t.numel() * t.element_size()
                    for t in (sc.tri_attr, sc.inv_rows, wf["slots"]))
    out = {}

    def walk_case(name, kernel, plain, check, per_ray_bytes, resolved=0,
                  extra_bytes=0, scene=sc, rays=r):
        counts = {}
        got = kernel()
        ref, plain_ms = timed_once(lambda: plain(counts))
        ok, mism, err = check(got, ref)
        b, by = bound(walk_bytes(scene, rays, per_ray_bytes) + extra_bytes,
                      walk_ops(counts, resolved))
        out[name] = dict(bitwise=ok, mismatches=mism, max_abs_err=err,
                         rays=rays, ms=timed(kernel, reps), plain_ms=plain_ms,
                         visits=counts, bound_ms=b, bound_by=by)

    # K7 closest / any hit on the primary rays, and closest on the second
    # TLAS with a cull mask that only the cube's instance mask meets
    for name, any_hit, w in (
            ("k7_closest_primary", False, walk),
            ("k7_any_primary", True, walk),
            ("k7_closest_tlas1_cull2", False,
             dict(walk, root_code=wf["roots"][1], cull_mask=0x02))):
        walk_case(
            name,
            lambda any_hit=any_hit, w=w: TK.trace_scene_kernel(
                sc, o, wf["d"], wf["far"], any_hit=any_hit, **w),
            lambda counts, any_hit=any_hit, w=w: TK.trace_scene(
                sc, o, wf["d"], wf["far"], any_hit=any_hit, t_min=TK.T_MIN,
                counts=counts, **w),
            hit_flags if any_hit else rec_check, 48)

    # K8 on the primary rays and on the reflection wavefront
    surf = wf["surf"]
    for name, ro, rd, act in (
            ("k8_primary", o, wf["d"], None),
            ("k8_reflection", wf["origin"].contiguous(), wf["rdir"], surf.valid)):
        walk_case(
            name,
            lambda ro=ro, rd=rd, act=act: TK.trace_resolve_kernel(
                sc, wf["slots"], ro, rd, wf["far"], active=act, **walk),
            lambda counts, ro=ro, rd=rd, act=act: TK.trace_resolve_plain(
                sc, wf["slots"], ro, rd, wf["far"], active=act,
                counts=counts, **walk),
            resolve_check, 48 + 24, resolved=r, extra_bytes=res_bytes)

    # K9: the primary-side shadow+AO bundle, without and with the bounce;
    # the reflection hits' bundle of config 3's frame and both bundles of
    # hybrid config 4's (each captured from one frame); an adversarial
    # bundle (30 occlusion samples, PR.adversarial_bundle) with the AO and
    # resolve samples. Bound: k9_bytes, and the union walk's work
    # (occlusion, TK.occlusion_union_plain) with the AO and resolve walks'
    # (k9_walk_ops); the plain walk's (one walk a sample) beside it.
    def bundle_check(a, b):
        ok = same_bits(a[0], b[0]) and all(
            same_bits(x, y) for x, y in zip(a[1], b[1]))
        mism = int((a[0] != b[0]).sum()) + sum(
            int((x.view(torch.int32) != y.view(torch.int32)).sum())
            for x, y in zip(a[1], b[1]))
        err = max([float((x - y).abs().max()) for x, y in zip(a[1], b[1])]
                  or [0.0])
        if a[2] is not None:
            ok2, m2, e2 = resolve_check(a[2], b[2])
            ok, mism, err = ok and ok2, mism + m2, max(err, e2)
        return ok, mism, err

    def bundle_case(name, bsc, args, bwalk, rs=None):
        bo, dirs, caps, occ_act, ao_ds, ao_caps, ao_act = args
        counts, union = {}, {}
        got = TK.trace_bundle_kernel(bsc, *args, resolve=rs, **bwalk)
        ref, plain_ms = timed_once(lambda: TK.trace_bundle_plain(
            bsc, *args, resolve=rs, counts=counts, **bwalk))
        ok, mism, err = bundle_check(got, ref)
        ubits = TK.occlusion_union_plain(bsc, bo, dirs, caps, occ_act,
                                         counts=union, **bwalk)
        nbytes, walks = k9_bytes(bsc, args, rs)
        nbytes += 0 if rs is None else res_bytes
        rest = {k: v for k, v in counts.items() if k != "occlusion"}
        resolved = 0 if rs is None else int(walks[2])
        bb, by = bound(nbytes, union_ops(union)
                       + k9_walk_ops(rest, walks[1] + walks[2], resolved))
        plain_ops = k9_walk_ops(counts["occlusion"], walks[0]) + k9_walk_ops(
            rest, walks[1] + walks[2], resolved)
        out[name] = dict(
            bitwise=ok, mismatches=mism, max_abs_err=err, rays=bo.shape[0],
            samples=[len(dirs), len(ao_ds), int(rs is not None)],
            live=PR.bundle_live(bo, occ_act, ao_act, rs),
            active_samples=walks, bytes=nbytes,
            ms=timed(lambda: TK.trace_bundle_kernel(bsc, *args, resolve=rs,
                                                    **bwalk), reps),
            plain_ms=plain_ms, visits=counts, union_visits=union,
            union_bits_equal=same_bits(ubits, ref[0]), bound_ms=bb,
            bound_by=by, plain_walk_bound_ms=bound(nbytes, plain_ops)[0],
            plain_walk_bound_by=bound(nbytes, plain_ops)[1])
        out[name]["bitwise"] = ok and out[name]["union_bits_equal"]

    # the union walks' partition: the plain walk's counts are the kernel's
    # only if both take the same group
    group = TK._lib().trace_union_group()
    out["union_group"] = dict(kernel=group, plain=TK.UNION_GROUP,
                              bitwise=group == TK.UNION_GROUP)
    n_s, n_a = len(wf["dirs"]), len(wf["ao_ds"])
    acts = [surf.valid] * n_a
    primary = (wf["origin"].contiguous(), wf["dirs"], wf["caps"],
               wf["actives"], wf["ao_ds"], wf["ao_caps"], acts)
    bundle_case("k9_shadow_ao", sc, primary, walk)
    bundle_case("k9_shadow_ao_resolve", sc, primary, walk,
                (wf["slots"], wf["rdir"], wf["far"], surf.valid))
    size = dict(width=rt.width, height=rt.height, device=o.device)
    for frame, (render, fcam) in (("rt", build_rt_scene(**size)[1:]),
                                  ("hybrid4", build_hybrid_scene(**size)[1:])):
        bundles = [c for c in PR.masked_waves(render, fcam)
                   if c[0] == "trace_bundle_kernel"]
        for side, (_, _, a, k) in zip(("shadow_ao", "reflection_bundle"),
                                      bundles):
            if (frame, side) != ("rt", "shadow_ao"):
                bundle_case(f"k9_{frame}_{side}", a[0], a[1:], k)
    adv = PR.adversarial_bundle(
        sc, wf["origin"].contiguous(),
        [wf["dirs"][0], wf["ao_ds"][0], wf["rdir"]], surf.valid, walk=walk)
    bundle_case("k9_adversarial", sc,
                (wf["origin"].contiguous(), *adv, wf["ao_ds"], wf["ao_caps"],
                 acts), walk, (wf["slots"], wf["rdir"], wf["far"], surf.valid))

    # the alpha forms on the leaf grid (flat): K8 on the primary rays and
    # on the reflection rays of their hits, K7 (closest) on the primary rays
    lw = PR.leaf_wavefronts(*leaf, paged=False)
    lc = lw["ctx"]
    lsc, smat, sm = lc.scene, lc.slot_materials, lc.materials.shading_model
    lwalk = dict(root_code=lc.root_code, stack_size=lc.stack_size)
    alpha_bytes = sum(t.numel() * t.element_size()
                      for t in (lsc.tri_attr, smat, sm))
    lr = lw["o"].shape[0]
    # (k8_leaf_primary: the plain form on the same rays, for its cost)
    for name, ro, rd, act, asm in (
            ("k8_alpha_leaf_primary", lw["o"], lw["d"], None, sm),
            ("k8_leaf_primary", lw["o"], lw["d"], None, None),
            ("k8_alpha_leaf_reflection", lw["refl_o"], lw["rdir"],
             lw["surf"].valid, sm)):
        walk_case(
            name,
            lambda ro=ro, rd=rd, act=act, asm=asm: TK.trace_resolve_kernel(
                lsc, smat, ro, rd, lw["far"], active=act, shading_model=asm,
                **lwalk),
            lambda counts, ro=ro, rd=rd, act=act, asm=asm:
                TK.trace_resolve_plain(
                    lsc, smat, ro, rd, lw["far"], active=act,
                    shading_model=asm, counts=counts, **lwalk),
            resolve_check, 48 + 24, resolved=lr,
            extra_bytes=alpha_bytes + lsc.inv_rows.numel() * 4, scene=lsc,
            rays=lr)
    walk_case(
        "k7_alpha_leaf_primary",
        lambda: TK.trace_scene_kernel(lsc, lw["o"], lw["d"], lw["far"],
                                      slot_materials=smat, shading_model=sm,
                                      **lwalk),
        lambda counts: TK.trace_scene(lsc, lw["o"], lw["d"], lw["far"],
                                      t_min=TK.T_MIN, slot_materials=smat,
                                      shading_model=sm, counts=counts,
                                      **lwalk),
        rec_check, 48, extra_bytes=alpha_bytes, scene=lsc, rays=lr)
    # K8's alpha form on the primary rays in a random order
    out["k8_alpha_leaf_primary_permuted"] = permuted_case(
        lambda ro, rd, t, act: TK.trace_resolve_kernel(
            lsc, smat, ro, rd, t, active=act, shading_model=sm, **lwalk),
        lw["o"], lw["d"], lw["far"], reps)
    for name in ("k8_alpha_leaf_primary", "k8_alpha_leaf_reflection",
                 "k7_alpha_leaf_primary"):
        out[name]["alpha_rejected"] = out[name]["visits"].get(
            "alpha_rejected", 0)
    out["ok"] = all(v["bitwise"] for v in out.values())
    return out


def primary_rays_mrays(rt, cam, reps=10, check_every=0):
    """Config 3's primary-ray traversal: SceneTracer.trace (K7, closest hit)
    on the RT pass's primary rays. Returns Mrays/s and kernel ms (CUDA
    events), the TLAS-assemble ms (host clock, synchronized), and with
    `check_every` the kernel against its plain version on every n-th ray."""
    import torch
    from paperrenderer_tpu_torch.ops import accel as ACC
    from paperrenderer_tpu_torch.ops import trace as TR
    from paperrenderer_tpu_torch.ops import trace_kernel as TK

    instances = rt.scene.flush()
    blasset, meta, anim_rest, anim_nodes = rt.accel.blas()
    slots, masks, table, inst_mask, opaque, _, _ = rt._device_inputs(
        instances.capacity)
    inst_blas, tri_attr = rt.accel.inst_blas(instances.capacity), rt.accel.tri_attr()

    def assemble():
        return ACC.assemble_scene(blasset, meta, anim_rest, anim_nodes,
                                  instances, inst_blas, masks, tri_attr,
                                  inst_mask=inst_mask, inst_opaque=opaque)

    assemble_times = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene, roots = assemble()
        torch.cuda.synchronize()
        assemble_times.append((time.perf_counter() - t0) * 1e3)
    ctx = ACC.SceneTracer(scene, slots, table, root_code=roots[0],
                          stack_size=rt.accel.stack_size(instances.capacity))
    c = cam.matrices.to(rt.device)
    o, d = TR.raygen(c, rt.width, rt.height,
                     tile_order=TR.pick_tile(rt.width, rt.height))
    o = o.contiguous()
    r = o.shape[0]
    far = torch.full((r,), 1000.0, device=o.device)
    rec = ctx.trace(o, d, far)
    ms = timed(lambda: ctx.trace(o, d, far), reps)
    out = dict(rays=r, kernel_ms=ms, mrays_per_s=r / ms / 1e3,
               hit_fraction=float(rec.hit.float().mean()),
               tlas_assemble_ms=statistics.median(assemble_times[2:]),
               instances=len(rt.scene.instances),
               stack_size=ctx.stack_size)
    if check_every:
        sel = torch.arange(0, r, check_every, device=o.device)
        ref = TK.trace_scene(scene, o[sel], d[sel], far[sel],
                             root_code=ctx.root_code, stack_size=ctx.stack_size)
        sub_rec = ACC.HitRecord2(rec.t[sel], rec.prim[sel], rec.inst[sel],
                                 rec.bary[sel])
        ok, mism, err = rec_check(sub_rec, ref)
        out.update(subset_rays=int(sel.numel()), subset_bitwise=ok,
                   subset_mismatches=mism, subset_max_abs_err=err)
    return out


def paged_bytes(scene, n_rays, per_ray_bytes, resolve=False):
    """Bytes a paged traversal must move: its tables once (+ the resolve
    tables), each ray's inputs and outputs once."""
    tables = [scene.static_nodes, scene.static_codes, scene.leaf_rows,
              scene.leaf_prim, scene.chunk_boxes, scene.chunk_codes,
              scene.bch_nodes, scene.bch_codes, scene.bch_lpos,
              scene.bch_lprim]
    if resolve:
        tables += [scene.chunk_smat, scene.tri_attr, scene.inv_rows]
    return sum(t.numel() * t.element_size() for t in tables) \
        + n_rays * per_ray_bytes


def compare_paged(crowd, grid, big, leaf, reps=10):
    """K10/K11 against their plain versions (bitwise) on the main path's
    wavefronts: K11 on the 10k crowd's primary rays and K10 any hit on its
    shadow rays (1024x1024); K10 closest on config 2's 10k grid at
    1920x1080, with K7 on the flat layout of the same rays beside it; K10
    and K11 on the big model's primary rays (1920x1080); the alpha forms on
    the 10k leaf grid (`leaf` = (rt, camera), 1920x1080): K11 on its
    primary rays and its first AO rays, K10 on its primary rays. Kernel ms
    (CUDA events), plain ms (one call, the flat view prebuilt), rays,
    mismatches, the walk's visits and the candidates the cutout rejected
    (from the plain version) and the bound."""
    import torch
    from paperrenderer_tpu_torch.ops import trace as TR
    from paperrenderer_tpu_torch.ops import trace_kernel as TK
    from paperrenderer_tpu_torch.ops import trace_paged as TPG
    from paperrenderer_tpu_torch.utils import random as rnd
    from paperrenderer_tpu_torch.utils import probes as PR
    from paperrenderer_tpu_torch.utils.probes import primary_wavefront

    out = {}

    def case(name, ctx, o, d, t, kind, active=None, alpha=False):
        walk = dict(root_code=ctx.root_code, stack_size=ctx.stack_size,
                    max_steps=ctx._step_bound())
        sc, r = ctx.scene, o.shape[0]
        sm = ctx.materials.shading_model if alpha else None
        if kind == "k11":
            kernel = lambda: TPG.trace_resolve_paged_kernel(
                sc, ctx.slot_materials, o, d, t, active=active,
                shading_model=sm, **walk)
            plain = lambda counts: TPG.trace_resolve_paged_plain(
                sc, ctx.slot_materials, o, d, t, active=active,
                counts=counts, flat=ctx.flat_view(), shading_model=sm,
                **walk)
            check, per_ray, resolved = resolve_check, 48 + 24, r
        else:
            any_hit = kind == "k10_any"
            kernel = lambda: TPG.trace_scene_paged_kernel(
                sc, o, d, t, any_hit=any_hit, active=active,
                slot_materials=ctx.slot_materials, shading_model=sm, **walk)
            plain = lambda counts: TPG.trace_scene_paged_plain(
                sc, o, d, t, any_hit=any_hit, active=active, counts=counts,
                flat=ctx.flat_view(), slot_materials=ctx.slot_materials,
                shading_model=sm, **walk)
            check = hit_flags if any_hit else rec_check
            per_ray, resolved = 48, 0
        counts = {}
        got = kernel()
        ref, plain_ms = timed_once(lambda: plain(counts))
        ok, mism, err = check(got, ref)
        b, by = bound(paged_bytes(sc, r, per_ray,
                                  resolve=kind == "k11" or alpha),
                      walk_ops(counts, resolved))
        rec = got[0] if kind == "k11" else got
        out[name] = dict(bitwise=ok, mismatches=mism, max_abs_err=err,
                         rays=r, ms=timed(kernel, reps), plain_ms=plain_ms,
                         visits=counts, bound_ms=b, bound_by=by,
                         hit_fraction=float(rec.hit.float().mean()),
                         tlas_chunks=sc.chunk_boxes.numel() // (512 * 12),
                         blas_chunks=sc.bch_codes.numel() // 1024)
        if alpha:
            out[name]["alpha_rejected"] = counts.get("alpha_rejected", 0)
        return got

    # the crowd: primary rays (K11), then its shadow wavefront (K10 any hit)
    rt, cam = crowd
    ctx, o, d, far, lights = primary_wavefront(rt, cam, paged=True)
    rec, attrs = case("k11_crowd_primary", ctx, o, d, far, "k11")
    surf = ctx.trace_resolve(o, d, far)
    dirs, caps, actives, _ = TR._occlusion_samples(
        surf, lights, rnd.fold_in(rt._key, 1), max(1, rt.params.shadow_samples))
    origin = (surf.world_pos + surf.normal * 5e-3).contiguous()
    case("k10_any_crowd_shadow", ctx, origin, dirs[0], caps[0], "k10_any",
         active=actives[0])
    out["k10_any_crowd_shadow"]["active_rays"] = int(actives[0].sum())

    # config 2's grid: K10 closest, and K7 on the flat layout of the rays
    rt, cam = grid
    ctx, o, d, far, _ = primary_wavefront(rt, cam, paged=True)
    k10 = case("k10_grid_primary", ctx, o, d, far, "k10")
    flat, o, d, far, _ = primary_wavefront(rt, cam, paged=False)
    k7 = TK.trace_scene_kernel(flat.scene, o, d, far,
                               root_code=flat.root_code,
                               stack_size=flat.stack_size)
    out["k7_grid_primary_flat"] = dict(
        ms=timed(lambda: TK.trace_scene_kernel(
            flat.scene, o, d, far, root_code=flat.root_code,
            stack_size=flat.stack_size), reps),
        rays=o.shape[0], same_hits_as_k10=bool(torch.equal(k7.hit, k10.hit)),
        same_t_as_k10=same_bits(k7.t, k10.t),
        prim_differs_on=int((k7.prim != k10.prim).sum()))

    # the big model: K10 and K11 on the primary rays
    rt, cam = big
    ctx, o, d, far, _ = primary_wavefront(rt, cam, paged=True)
    case("k10_big_primary", ctx, o, d, far, "k10")
    case("k11_big_primary", ctx, o, d, far, "k11")

    # the leaf grid: the alpha forms of K11 (primary rays, and the first AO
    # rays of their hits, which trace_resolve(use_alpha=True) carries) and
    # of K10 (primary rays); K11's plain form on the same primary rays
    lw = PR.leaf_wavefronts(*leaf, paged=True)
    ctx = lw["ctx"]
    case("k11_alpha_leaf_primary", ctx, lw["o"], lw["d"], lw["far"], "k11",
         alpha=True)
    case("k11_leaf_primary", ctx, lw["o"], lw["d"], lw["far"], "k11")
    case("k11_alpha_leaf_ao", ctx, lw["ao_o"], lw["ao_d"], lw["ao_cap"],
         "k11", active=lw["surf"].valid, alpha=True)
    case("k10_alpha_leaf_primary", ctx, lw["o"], lw["d"], lw["far"], "k10",
         alpha=True)
    # K11's alpha form on the primary rays in a random order
    out["k11_alpha_leaf_primary_permuted"] = permuted_case(
        lambda ro, rd, t, act: TPG.trace_resolve_paged_kernel(
            ctx.scene, ctx.slot_materials, ro, rd, t, active=act,
            shading_model=ctx.materials.shading_model,
            root_code=ctx.root_code, stack_size=ctx.stack_size,
            max_steps=ctx._step_bound()),
        lw["o"], lw["d"], lw["far"], reps)
    out["ok"] = all(v["bitwise"] for k, v in out.items() if "bitwise" in v)
    return out


def compare_probes(rt_cam, grid, leaf, reps=3):
    """K12a-c and the step-count forms of K7/K10 against their plain
    versions, bitwise, on the profiling path's inputs: K12a in each copy
    form, K12b in each case, K12c at both ray counts; K7's step form on the
    1080p RT scene's primary rays (`rt_cam`) and K10's on config 2's grid
    (`grid`, paged), live and dead, and both on the leaf grid's primary
    rays (`leaf` = (rt, camera), without the cutout), in every output, each
    with the warp efficiency of its step counts in launch order. Plain ms
    (CUDA events) and the bound: the bytes of the blocks the order touches
    (K12a/b), 48 B a ray (K12c)."""
    import torch
    from paperrenderer_tpu_torch.ops import trace_kernel as TK
    from paperrenderer_tpu_torch.ops import trace_paged as TPG
    from paperrenderer_tpu_torch.utils import probes as PR

    out = {}

    def copy_case(name, got, ref, plain, n_steps, touched_bytes):
        val, span = got
        b, by = bound(touched_bytes + 4 * (n_steps + 1), 3 * n_steps)
        out[name] = dict(bitwise=same_bits(val, ref), sum=float(val),
                         max_abs_err=float((val - ref).abs().max()),
                         completed=int(span) >= 0,
                         plain_ms=timed(plain, reps), bound_ms=b, bound_by=by)

    hf, hi, order = PR.chunk_stream_inputs("cuda")
    touched = int(order.unique().numel()) * (PR.BLK + PR.IBLK) * 4
    ref = PR.chunk_stream_plain(hf, hi, order)
    for form in PR.FORMS:
        got = PR.chunk_stream(hf, hi, order, form=form)
        PR.finish()
        copy_case(f"k12a_{form}", got, ref,
                  lambda: PR.chunk_stream_plain(hf, hi, order), PR.N_STEPS,
                  touched)
    for blk, dbuf in PR.SWEEP_CASES:
        shf, sorder = PR.sweep_inputs(blk, "cuda")
        n = PR.SWEEP_ITERS - 1 if dbuf else PR.SWEEP_ITERS
        got = PR.chunk_stream_sweep(shf, sorder, blk=blk, dbuf=dbuf)
        PR.finish()
        plain = functools.partial(PR.chunk_stream_sweep_plain, shf, sorder,
                                  blk, dbuf)
        # the blocks started: the double-buffered chain also fetches one
        started = sorder[:n + 1] if dbuf else sorder[:n]
        copy_case(f"k12b_{'dbuf' if dbuf else 'chained'}_{blk}", got,
                  plain(), plain, n, int(started.unique().numel()) * blk * 4)
    for r in PR.PASS_RAYS:
        planes = PR.pass_through_inputs(r, "cuda")
        got = PR.pass_through(planes)
        PR.finish()
        ref = PR.pass_through_plain(planes)
        mism = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                   for a, b in zip(got, ref))
        b, by = bound(48 * r, 0)
        out[f"k12c_r{r}"] = dict(
            bitwise=mism == 0, mismatches=mism, max_abs_err=0.0 if mism == 0
            else float("nan"), rays=r,
            plain_ms=timed(lambda: PR.pass_through_plain(planes), reps),
            bound_ms=b, bound_by=by)

    def steps_case(name, ctx, o, d, far, plain, **kw):
        got = PR.steps_kernel(ctx, o, d, far, **kw)
        counts = {}
        ref, plain_ms = timed_once(lambda: plain(counts=counts, **kw))
        ok, mism, err = rec_check(got, ref)
        steps = got.bary[:, 0]
        out[name] = dict(bitwise=ok, mismatches=mism, max_abs_err=err,
                         rays=o.shape[0], steps_max=float(steps.max()),
                         steps_mean=float(steps.double().mean()),
                         warp_efficiency=PR.warp_efficiency(steps),
                         plain_ms=plain_ms, visits=counts,
                         ms=timed(lambda: PR.steps_kernel(ctx, o, d, far,
                                                          **kw), reps))
        return steps

    rt, cam = rt_cam
    ctx, o, d, far, _ = PR.primary_wavefront(rt, cam, paged=False)
    dead = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    k7 = functools.partial(TK.trace_scene, ctx.scene, o, d, far,
                           root_code=ctx.root_code, stack_size=ctx.stack_size,
                           debug_steps=True)
    steps_case("k7_steps_primary", ctx, o, d, far, k7)
    steps_case("k7_steps_any_primary", ctx, o, d, far, k7, any_hit=True)
    dead_steps = steps_case("k7_steps_any_dead", ctx, o, d, far, k7,
                            any_hit=True, active=dead)
    out["k7_steps_any_dead"]["all_zero"] = bool((dead_steps == 0).all())
    b, by = bound(walk_bytes(ctx.scene, o.shape[0], 48),
                  walk_ops(out["k7_steps_primary"]["visits"]))
    out["k7_steps_primary"].update(bound_ms=b, bound_by=by)

    rt, cam = grid
    ctx, o, d, far, _ = PR.primary_wavefront(rt, cam, paged=True)
    k10 = functools.partial(TPG.trace_scene_paged_plain, ctx.scene, o, d,
                            far, root_code=ctx.root_code,
                            stack_size=ctx.stack_size,
                            max_steps=ctx._step_bound(),
                            flat=ctx.flat_view(), debug_steps=True)
    steps_case("k10_steps_grid_primary", ctx, o, d, far, k10)
    steps_case("k10_steps_grid_dead", ctx, o, d, far, k10, active=dead)
    b, by = bound(paged_bytes(ctx.scene, o.shape[0], 48),
                  walk_ops(out["k10_steps_grid_primary"]["visits"]))
    out["k10_steps_grid_primary"].update(bound_ms=b, bound_by=by)

    # the leaf grid's primary rays (the walk of K8's and K11's alpha forms,
    # without the cutout, which the step form does not take)
    rt, cam = leaf
    for paged in (False, True):
        ctx, o, d, far, _ = PR.primary_wavefront(rt, cam, paged=paged)
        if paged:
            plain = functools.partial(
                TPG.trace_scene_paged_plain, ctx.scene, o, d, far,
                root_code=ctx.root_code, stack_size=ctx.stack_size,
                max_steps=ctx._step_bound(), flat=ctx.flat_view(),
                debug_steps=True)
        else:
            plain = functools.partial(
                TK.trace_scene, ctx.scene, o, d, far, root_code=ctx.root_code,
                stack_size=ctx.stack_size, debug_steps=True)
        steps_case(f"k{10 if paged else 7}_steps_leaf_primary", ctx, o, d,
                   far, plain)
    out["ok"] = (all(v["bitwise"] for v in out.values())
                 and all(v.get("completed", True) for v in out.values())
                 and out["k7_steps_any_dead"]["all_zero"])
    return out


def mrays(n_rays, ms):
    return n_rays / ms / 1e3


def hybrid_grid(n, width, height, device):
    """Config 2's grid (scenes.build_dynamic_scene) mirrored into a
    HybridRender -> (hybrid render, camera)."""
    from paperrenderer_tpu_torch.scenes import build_dynamic_scene

    eng, rp, cam = build_dynamic_scene(n, width, height, device=device)
    hy = eng.create_hybrid_render(width=width, height=height,
                                  lights=rp.lights)
    hy.add_instances_from(rp)
    return hy, cam


def textured_example(width, height, device):
    """The textured example (scenes.build_textured_scene) as the raster
    pass, the RT and the hybrid frame (1 shadow, AO and reflection sample,
    the example's --rt settings) and a second raster pass with the ball a
    50% textured glass over two peel layers -> (rp, rt, hybrid, glass,
    camera)."""
    from paperrenderer_tpu_torch import HybridRender, RayTraceRender, RenderPass
    from paperrenderer_tpu_torch.core import SHADE_TRANSLUCENT, Material
    from paperrenderer_tpu_torch.scenes import build_textured_scene

    scene, reg, rp, cam = build_textured_scene(width, height, device=device)
    samples = dict(width=width, height=height, lights=rp.lights,
                   shadow_samples=1, reflection_samples=1, ao_samples=1)
    rt = RayTraceRender(scene, reg, **samples)
    rt.add_instances_from(rp)
    hy = HybridRender(scene, reg, **samples)
    hy.add_instances_from(rp)
    glass = RenderPass(scene, reg, width=width, height=height,
                       lights=rp.lights, translucent_layers=2)
    glass._bindings = {i: dict(b) for i, b in rp._bindings.items()}
    ball = scene.instances[1]
    tex = reg.rows()[rp._bindings[ball.index][0]]["base_texture"]
    glass.add_instance(ball, {0: Material(
        "glass", alpha=0.5, roughness=0.2, base_texture=tex,
        shading_model=SHADE_TRANSLUCENT).instance()})
    return rp, rt, hy, glass, cam


def textured_phase(twins, keep, device="cuda", n=10_000, width=1920,
                   height=1080, small=(400, 256, 128)):
    """The textured phase: the 128x128 textured example on `device`
    against textured_example.png (static and draw-list frames) and
    against the port's CPU frames of the same scene (static, a
    two-layer textured glass, RT flat, hybrid); config 2's grid with
    textured materials (scenes.build_textured_grid) of `n` instances at
    `width` x `height`: each frame's ms beside its untextured twin in
    `twins` ((render, camera) of config 2's raster pass, the grid's RT
    and hybrid renders) in the order untextured, textured, textured,
    untextured, shade_gbuffer alone on its G-buffer untextured and with
    each mip filter, the atlas bytes and a frame's peak CUDA memory; a
    `small` (n, width, height) copy on `device` against the CPU. The
    textured grid's raster and hybrid renders go into `keep`."""
    import torch

    from paperrenderer_tpu_torch.ops.raster_exact import (
        rasterize_exact, resolve_gbuffer_pairs)
    from paperrenderer_tpu_torch.ops.shading import shade_gbuffer
    from paperrenderer_tpu_torch.scenes import build_textured_grid
    from paperrenderer_tpu_torch.utils.walk_bench import frame_batch

    out, ok = {}, True
    frames, on_card = {}, []
    for dev in (device, "cpu"):
        rp, rt, hy, glass, cam = textured_example(128, 128, dev)
        frames[dev] = dict(
            static=rp.render(cam)[0],
            draw_list=rp.render(cam, static_path=False)[0],
            rt_flat=rt.render(cam, paged=False)[0],
            hybrid=hy.render(cam)[0],
            translucent=glass.render(cam)[0])
        if dev == device:   # every frame sampled the card's atlas
            on_card = [r.pairs.device.type for r in (
                rp._cached_textures, rt._cached_textures,
                hy._rp._cached_textures, glass._cached_textures)]
    ok &= on_card == [torch.device(device).type] * 4
    card = {k: v.cpu().numpy() for k, v in frames[device].items()}
    for name in ("static", "draw_list"):
        good, mean, frac = bands(card[name], golden("textured_example"))
        out[f"golden128_{name}"] = dict(mean=mean, frac=frac, ok=good)
        ok &= good
    for name in ("static", "translucent", "rt_flat", "hybrid"):
        ref = frames["cpu"][name].numpy()
        good, mean, frac = bands(card[name], ref)
        out[f"card_vs_cpu_{name}"] = dict(
            mean=mean, frac=frac, ok=good,
            max=float(abs(card[name] - ref).max()))
        ok &= good

    # the textured grid and its untextured twins, timed in turns
    eng, rp_t, cam = build_textured_grid(n, width, height, device=device)
    mirror = dict(width=width, height=height, lights=rp_t.lights)
    rt_t = eng.create_ray_trace_render(**mirror)
    rt_t.add_instances_from(rp_t)
    hy_t = eng.create_hybrid_render(**mirror)
    hy_t.add_instances_from(rp_t)
    pairs = dict(static=(twins["static"], (rp_t, cam), {}),
                 draw_list=(twins["static"], (rp_t, cam),
                            dict(static_path=False)),
                 rt=(twins["rt"], (rt_t, cam), {}),
                 hybrid=(twins["hybrid"], (hy_t, cam), {}))
    grid = {}
    for name, (plain, tex, kw) in pairs.items():
        reps = 10 if name in ("static", "draw_list") else 5
        ldr_p = plain[0].render(plain[1], **kw)[0]
        ldr_t = tex[0].render(tex[1], **kw)[0]
        ms = {"plain": [], "textured": []}
        for which in ("plain", "textured", "textured", "plain"):
            r, c = plain if which == "plain" else tex
            ms[which].append(frame_ms(r, c, frames=reps, warmup=2, **kw))
        changed = float(((ldr_t - ldr_p).abs().amax(dim=-1) > 1e-3)
                        .float().mean())
        finite = (bool(torch.isfinite(ldr_t).all())
                  and tuple(ldr_t.shape) == (height, width, 3))
        ok &= finite and changed > 0
        grid[name] = dict(
            textured_ms=ms["textured"], untextured_ms=ms["plain"],
            textured_over_untextured=sum(ms["textured"])
            / sum(ms["plain"]), changed_share=changed)
    grid["rt"]["paged"] = rt_t.accel.prefer_paged(
        rt_t.scene.flush().capacity)
    tex = rp_t._cached_textures
    ok &= tex.pairs.device.type == torch.device(device).type
    grid["atlas"] = dict(bytes=tex.nbytes, texels=tex.pairs.shape[0],
                         textures=tex.count,
                         height=tex.pairs.shape[0] // tex.width)
    # a frame's peak CUDA memory, textured and untextured
    for name, (r, c) in (("static", (rp_t, cam)),
                         ("static_untextured", twins["static"]),
                         ("hybrid", (hy_t, cam)),
                         ("hybrid_untextured", twins["hybrid"])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        r.render(c)
        torch.cuda.synchronize()
        grid.setdefault("peak_mib", {})[name] = (
            torch.cuda.max_memory_allocated() - base) / 2 ** 20
    # shade_gbuffer alone on the textured grid's G-buffer
    batch = frame_batch(rp_t, cam)
    mapping, inst, tables, mats, cm, slots, vis = rp_t.frame_inputs(cam)
    depth, tid, attr, _ = rasterize_exact(batch, width, height)
    gbuf = resolve_gbuffer_pairs(attr, depth, tid, cm)
    shade = {"untextured": timed(lambda: shade_gbuffer(
        gbuf, mats, rp_t.lights, cm.cam_pos), 20)}
    for f in ("nearest", "linear", "aniso2"):
        shade[f] = timed(lambda f=f: shade_gbuffer(
            gbuf, mats, rp_t.lights, cm.cam_pos, textures=tex,
            mip_filter=f), 20)
    grid["shade_gbuffer_ms"] = shade
    out[f"grid{n}_{width}x{height}"] = grid
    keep.update(static=(rp_t, cam), hybrid=(hy_t, cam))
    # a reduced copy of the textured grid, card against CPU
    copies = [build_textured_grid(*small, device=dev)
              for dev in (device, "cpu")]
    good, mean, frac = bands(
        copies[0][1].render(copies[0][2])[0].cpu().numpy(),
        copies[1][1].render(copies[1][2])[0].numpy())
    out["card_vs_cpu_grid%d_%dx%d" % small] = dict(mean=mean, frac=frac,
                                                   ok=good)
    return dict(ok=ok and good, **out)


def count_ops(fn):
    """(result, aten ops dispatched by `fn()`): each op issues at most one
    kernel from the host; views issue none but are counted too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def host_ms(fn, reps=10, warmup=2):
    """Median host ms of `fn()`, synchronized after each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def animation_phase(read_counts, keep, reps=10):
    """Animation (ops/animation.py, the unique-geometry refit and re-split
    of ops/accel.py, scenes.run_dynamic): config 5 (100k instances of
    build_dynamic_scene at 1920x1080): its static frame, run_dynamic's
    animated loop (20 frames), the counts, the TLAS refit of the animated
    instances on the layout prefer_paged picks, and a 400-instance 256x128
    copy animated 3 frames on the card against the CPU; the animated RT
    scene (config 3, its sphere a unique instance) at 1920x1080 with the
    re-split off and on beside its unanimated twin, its refit + assemble ms,
    a 96x64 copy on the card against the CPU; the animated crowd (10k at
    1024x1024, 157 unique spheres, paged) with the re-split off and on, its
    assemble_scene_paged ms, the refit's host ops batched and one BLAS at a
    time, the 600-instance crowd at 96x64 on the card against the CPU;
    animated hybrid config 4 at 1920x1080 and a 96x64 copy. Each frame's
    launches; the launches of the phase's frames (`launches`) are read
    before its uncounted kernel checks: K1 at config 5's bins, K8 on the
    animated RT frame's primary rays and K10/K11 on the animated crowd's,
    each bitwise against its plain version. Frames are timed in turns
    beside their unanimated twins; `keep` gets the frames' renders for
    --profile."""
    import torch
    from paperrenderer_tpu_torch import scenes as SC
    from paperrenderer_tpu_torch.ops import accel as ACC
    from paperrenderer_tpu_torch.ops import animation as AN
    from paperrenderer_tpu_torch.ops import raster_exact as RE
    from paperrenderer_tpu_torch.ops import trace_kernel as TK
    from paperrenderer_tpu_torch.ops import trace_paged as TPG
    from paperrenderer_tpu_torch.render.raytrace import AccelCache
    from paperrenderer_tpu_torch.utils.probes import primary_wavefront
    from paperrenderer_tpu_torch.utils.walk_bench import RasterCase, frame_batch

    out, ok = {}, True
    t_anim = 0.7

    def one_frame(fn):
        """(result, launches of one call)."""
        before = read_counts()
        res = fn()
        torch.cuda.synchronize()
        return res, {k: v - before.get(k, 0) for k, v in read_counts().items()
                     if v > before.get(k, 0)}

    def card_vs_cpu(make, render):
        imgs = [render(*make(dev)).cpu().numpy() for dev in ("cuda", "cpu")]
        good, mean, frac = bands(*imgs)
        return dict(ok=good, mean=mean, frac=frac,
                    max=float(abs(imgs[0] - imgs[1]).max()))

    # -- config 5: 100k instances, static and animated ----------------------
    t0 = time.perf_counter()
    built = SC.build_dynamic_scene(100_000, 1920, 1080, device="cuda")
    _, rp5, cam5 = built
    keep["config5"] = (rp5, cam5)
    (ldr, aux), one = one_frame(lambda: rp5.render(cam5))
    c5 = dict(build_s=time.perf_counter() - t0,
              static_frame_ms=frame_ms(rp5, cam5, frames=20, warmup=3),
              static_launches_one_frame=one,
              visible=int(aux["visible_count"]), tris=int(aux["total_tris"]),
              coverage=float(aux["coverage"]),
              finite=bool(torch.isfinite(aux["hdr"]).all()))
    ms, ldr, aux = SC.run_dynamic(frames=20, built=built)
    c5.update(animated_frame_ms=statistics.median(ms), animated_frame_ms_all=ms,
              animated_visible=int(aux["visible_count"]),
              animated_tris=int(aux["total_tris"]),
              animated_coverage=float(aux["coverage"]),
              animated_finite=bool(torch.isfinite(aux["hdr"]).all()))
    _, c5["animated_launches_one_frame"] = one_frame(
        lambda: SC.run_dynamic(frames=1, built=built))
    # the TLAS refit of the animated instances (animate, then assemble)
    accel = AccelCache(rp5.scene)
    blas = accel.blas()
    inst = rp5.scene.flush()
    cap = inst.capacity
    paged5 = accel.prefer_paged(cap)
    ib, tri = accel.inst_blas(cap), accel.tri_attr()
    mask = torch.ones(cap, dtype=torch.bool, device=rp5.device)
    slots5 = rp5.frame_inputs(cam5)[5]
    state = [inst, 0]

    def step():
        state[1] += 1
        state[0] = AN.animate_instances(state[0], 0.05 * state[1])

    def refit():
        step()
        if paged5:
            return ACC.assemble_scene_paged(*blas, state[0], ib, mask, slots5,
                                            tri)
        return ACC.assemble_scene(*blas, state[0], ib, [mask], tri)

    c5.update(tlas_layout="paged" if paged5 else "flat",
              tlas_refit_ms=host_ms(refit, reps=20),
              animate_instances_ms=host_ms(step, reps=20))
    c5["tris_before_cull"] = int(rp5.frame_inputs(cam5)[0].valid.sum())
    big_ok = (c5["finite"] and c5["animated_finite"]
              and 0 < c5["tris"] <= c5["tris_before_cull"]
              and 0 < c5["animated_tris"] <= c5["tris_before_cull"]
              and c5["static_launches_one_frame"].get("raster_exact", 0) > 0
              and c5["animated_launches_one_frame"].get("raster_exact", 0) > 0)
    c5["copy_400_256x128"] = card_vs_cpu(
        lambda dev: SC.build_dynamic_scene(400, 256, 128, device=dev),
        lambda e, r, c: SC.run_dynamic(frames=3, built=(e, r, c))[1])
    ok &= big_ok and c5["copy_400_256x128"]["ok"]
    out["config5"] = c5

    def in_turns(cases, frames=10):
        """Median frame ms of each (name, render, cam, kw) case, twice, in
        the order a b c c b a (a drift between cases shows as a spread)."""
        ms = {name: [] for name, *_ in cases}
        for name, r, cam, kw in cases + cases[::-1]:
            ms[name].append(frame_ms(r, cam, frames=frames, warmup=2, **kw))
        return ms

    anim_kw = dict(time=t_anim)

    # -- animated RT, flat: config 3's scene, its sphere deformed ------------
    rt_out, cases = {}, []
    _, rt0, cam0 = SC.build_rt_scene(1920, 1080, device="cuda")
    cases.append(("unanimated", rt0, cam0, {}))
    for resplit in (False, True):
        _, rt, cam = SC.build_animated_rt_scene(1920, 1080, resplit=resplit,
                                                device="cuda")
        (ldr, aux), one = one_frame(lambda: rt.render(cam, time=t_anim))
        inst = rt.scene.flush()
        blas, ib = rt.accel.blas(), rt.accel.inst_blas(inst.capacity)
        masks, tri = rt._device_inputs(inst.capacity)[1], rt.accel.tri_attr()
        name = "resplit" if resplit else "refit"
        rt_out[name] = dict(
            paged=rt.accel.prefer_paged(inst.capacity),
            anim_leaves=blas[1].num_anim_leaves,
            refit_assemble_ms=host_ms(lambda: ACC.assemble_scene(
                *blas, inst, ib, masks, tri, time=t_anim,
                animate=AN.animate_vertices, resplit=resplit)),
            launches_one_frame=one,
            finite=bool(torch.isfinite(aux["hdr"]).all()))
        ok &= (rt_out[name]["finite"] and not rt_out[name]["paged"]
               and all(one.get(k, 0) > 0
                       for k in ("trace_resolve", "trace_bundle")))
        cases.append((name, rt, cam, anim_kw))
        keep[f"rt_flat_{name}"] = (rt, cam)
    rt_out["frame_ms_in_turns"] = in_turns(cases)
    rt_out["card_vs_cpu_96x64_resplit"] = card_vs_cpu(
        lambda dev: SC.build_animated_rt_scene(96, 64, resplit=True,
                                               device=dev)[1:],
        lambda r, c: r.render(c, time=t_anim)[0])
    ok &= rt_out["card_vs_cpu_96x64_resplit"]["ok"]
    out["rt_flat"] = rt_out

    # -- animated RT, paged: the 10k crowd, one instance in 64 animated ------
    cr_out, cases = {}, []
    rt0, cam0 = SC.build_crowd_scene(10_000, 1024, 1024, device="cuda")[2:]
    cases.append(("unanimated", rt0, cam0, {}))
    for resplit in (False, True):
        _, _, rt, cam = SC.build_animated_crowd_scene(
            10_000, 1024, 1024, resplit=resplit, device="cuda")
        (ldr, aux), one = one_frame(lambda: rt.render(cam, time=t_anim))
        inst = rt.scene.flush()
        blas, ib = rt.accel.blas(), rt.accel.inst_blas(inst.capacity)
        slots, masks = rt._device_inputs(inst.capacity)[:2]
        tri = rt.accel.tri_attr()
        name = "resplit" if resplit else "refit"
        meta = blas[1]
        cr_out[name] = dict(
            paged=rt.accel.prefer_paged(inst.capacity),
            unique=len(meta.anim), anim_leaves=meta.num_anim_leaves,
            assemble_scene_paged_ms=host_ms(lambda: ACC.assemble_scene_paged(
                *blas, inst, ib, masks[0], slots, tri, time=t_anim,
                animate=AN.animate_vertices, resplit=resplit)),
            launches_one_frame=one,
            finite=bool(torch.isfinite(aux["hdr"]).all()))
        ok &= (cr_out[name]["finite"] and cr_out[name]["paged"]
               and all(one.get(k, 0) > 0 for k in ("trace_scene_paged",
                                                   "trace_resolve_paged")))
        cases.append((name, rt, cam, anim_kw))
        keep[f"crowd_{name}"] = (rt, cam)
    cr_out["frame_ms_in_turns"] = in_turns(cases)
    # the refit's host ops and ms, batched against one BLAS at a time
    rt, _ = keep["crowd_resplit"]
    meta, art = rt.accel.blas()[1], rt.accel.blas()[2]
    for batched in (True, False):
        key = "batched" if batched else "per_instance"
        fn = lambda: ACC.refit_anim_blases(meta, art, t_anim,
                                           AN.animate_vertices,
                                           batched=batched)
        refit_out, n_ops = count_ops(fn)
        fn2 = lambda: ACC.resplit_anim_tables(meta, art, t_anim,
                                              AN.animate_vertices,
                                              batched=batched)
        rs_out, n_ops_rs = count_ops(fn2)
        cr_out[f"refit_{key}"] = dict(host_ops=n_ops, ms=host_ms(fn),
                                      resplit_host_ops=n_ops_rs,
                                      resplit_ms=host_ms(fn2))
        if batched:
            ref = (refit_out, rs_out)
    cr_out["batched_bitwise"] = all(
        same_bits(a, b) for a, b in zip(ref[0] + ref[1], refit_out + rs_out))
    ok &= cr_out["batched_bitwise"]
    cr_out["card_vs_cpu_600_96x64_paged"] = card_vs_cpu(
        lambda dev: SC.build_animated_crowd_scene(600, 96, 64, resplit=True,
                                                  device=dev)[2:],
        lambda r, c: r.render(c, time=t_anim, paged=True)[0])
    ok &= cr_out["card_vs_cpu_600_96x64_paged"]["ok"]
    out["crowd_paged"] = cr_out

    # -- animated hybrid config 4 -------------------------------------------
    _, hy0, cam0 = SC.build_hybrid_scene(1920, 1080, device="cuda")
    _, hy, cam = SC.build_animated_hybrid_scene(1920, 1080, device="cuda")
    keep["hybrid"] = (hy, cam)
    (ldr, aux), one = one_frame(lambda: hy.render(cam, time=t_anim))
    hy_out = dict(paged=bool(aux["paged"]),
                  anim_leaves=hy.accel.blas()[1].num_anim_leaves,
                  frame_ms_in_turns=in_turns([
                      ("unanimated", hy0, cam0, {}),
                      ("animated", hy, cam, anim_kw)]),
                  launches_one_frame=one,
                  finite=bool(torch.isfinite(aux["hdr"]).all()))
    hy_out["card_vs_cpu_96x64"] = card_vs_cpu(
        lambda dev: SC.build_animated_hybrid_scene(96, 64, device=dev)[1:],
        lambda h, c: h.render(c, time=t_anim)[0])
    ok &= (hy_out["finite"] and not hy_out["paged"]
           and hy_out["card_vs_cpu_96x64"]["ok"]
           and all(one.get(k, 0) > 0 for k in ("raster_exact", "trace_bundle",
                                               "trace_resolve")))
    out["hybrid"] = hy_out
    torch.cuda.synchronize()
    out["launches"] = read_counts()

    # -- uncounted: the kernels on the animation path's inputs, bitwise ------
    checks = {}
    w5, h5 = rp5.width, rp5.height
    case = RasterCase(RE.bin_triangles(frame_batch(rp5, cam5), w5, h5), w5, h5)
    checks["k1_config5"] = compare_raster(case, reps=reps)
    rt, cam = keep["rt_flat_resplit"]
    ctx, o, d, far, _ = primary_wavefront(rt, cam, paged=False, time=t_anim)
    walk = dict(root_code=ctx.root_code, stack_size=ctx.stack_size)
    got = TK.trace_resolve_kernel(ctx.scene, ctx.slot_materials, o, d, far,
                                  **walk)
    ref = TK.trace_resolve_plain(ctx.scene, ctx.slot_materials, o, d, far,
                                 **walk)
    good, mism, err = resolve_check(got, ref)
    checks["k8_rt_resplit_primary"] = dict(
        bitwise=good, mismatches=mism, max_abs_err=err, rays=o.shape[0],
        ms=timed(lambda: TK.trace_resolve_kernel(
            ctx.scene, ctx.slot_materials, o, d, far, **walk), reps))
    rt, cam = keep["crowd_resplit"]
    ctx, o, d, far, _ = primary_wavefront(rt, cam, paged=True, time=t_anim)
    walk = dict(root_code=ctx.root_code, stack_size=ctx.stack_size,
                max_steps=ctx._step_bound())
    for name, kernel, plain, check in (
            ("k11_crowd_resplit_primary",
             lambda: TPG.trace_resolve_paged_kernel(
                 ctx.scene, ctx.slot_materials, o, d, far, **walk),
             lambda: TPG.trace_resolve_paged_plain(
                 ctx.scene, ctx.slot_materials, o, d, far,
                 flat=ctx.flat_view(), **walk), resolve_check),
            ("k10_crowd_resplit_primary",
             lambda: TPG.trace_scene_paged_kernel(ctx.scene, o, d, far,
                                                  **walk),
             lambda: TPG.trace_scene_paged_plain(
                 ctx.scene, o, d, far, flat=ctx.flat_view(), **walk),
             rec_check)):
        good, mism, err = check(kernel(), plain())
        checks[name] = dict(bitwise=good, mismatches=mism, max_abs_err=err,
                            rays=o.shape[0], ms=timed(kernel, reps))
    out["checks"] = checks
    ok &= all(v["bitwise"] for v in checks.values())
    out["ok"] = ok
    return out


def native_phase(reps=10, n=100_000, device="cuda"):
    """The native scene core: which library loaded, config 5's scene
    (build_dynamic_scene(100_000, 1920, 1080)) with the native packer and
    a Python-mirror twin holding the same instances: the flushed
    InstanceArrays bitwise on live rows (model ids on every row) after the
    build, 1,000 transform edits, 500 swap-removes and a grow past the
    capacity; morton3d against _morton_u64's numpy branch; host ms (median
    of `reps`, synchronized) of a full flush, a 1,000-dirty-row flush and
    build_static_mapping (expand_static's topology rebuild), each way."""
    import numpy as np
    import torch

    from paperrenderer_tpu_torch import native as NV
    from paperrenderer_tpu_torch.core import ModelInstance, Scene
    from paperrenderer_tpu_torch.ops import static_batch as SB
    from paperrenderer_tpu_torch.scenes import build_dynamic_scene

    out = dict(available=NV.AVAILABLE, loaded_from=NV.LOADED_FROM,
               build_error=NV.BUILD_ERROR, shipped=str(NV.SHIPPED))
    ok = bool(NV.AVAILABLE)
    if not ok:
        return dict(ok=False, **out)
    _, rp, _ = build_dynamic_scene(n, 1920, 1080, device=device)
    sn = rp.scene
    sp = Scene(sn.arena, use_native=False, device=device)
    sync = (torch.cuda.synchronize if device == "cuda" else lambda: None)
    for m in sn.models:
        sp.register_model(m)
    twins = []
    for inst in sn.instances:
        t = ModelInstance(inst.model)
        t.set_transform(pos=inst.position, scale=inst.scale,
                        quat=inst.rotation)
        sp.add_instance(t)
        twins.append(t)
    ok &= sn._native is not None and sp._native is None
    rng = np.random.default_rng(5)
    checks = {}

    def check(step):
        a, b = sn.flush(), sp.flush()
        n = sn.count
        same = (a.capacity == b.capacity and n == sp.count
                and bool(torch.equal(a.model_id, b.model_id))
                and all(bool(torch.equal(getattr(a, f)[:n], getattr(b, f)[:n]))
                        for f in ("pos", "scale", "quat")))
        checks[step] = dict(bitwise=same, count=n, capacity=a.capacity)
        return same

    def edit(k):
        rows = rng.choice(sn.count, k, replace=False)
        vals = rng.uniform(-5, 5, (k, 3)).astype(np.float32)
        quats = rng.normal(size=(k, 4)).astype(np.float32)
        for r, v, q in zip(rows, vals, quats):
            for scene in (sn, sp):
                scene.instances[r].set_transform(pos=v, quat=q)

    ok &= check("build")
    edit(1000)
    ok &= check("edit_1000")
    for r in rng.choice(sn.count - 600, 500, replace=False):
        for scene in (sn, sp):
            scene.remove_instance(scene.instances[int(r)])
    ok &= check("swap_remove_500")
    cap = sn.flush().capacity
    for k in range(cap - sn.count + 1):
        for scene in (sn, sp):
            inst = ModelInstance(sn.models[k % 2])
            inst.set_transform(pos=(0.5 * k, -3.0, 1.0))
            scene.add_instance(inst)
    ok &= check("grow")
    out["checks"] = checks
    pos = np.stack([i.position for i in sn.instances])
    morton_same = bool(np.array_equal(SB._morton_u64(pos),
                                      SB._morton_u64(pos, use_native=False)))
    out["morton_bitwise"] = morton_same
    ok &= morton_same and SB._morton_u64(pos).dtype == np.uint64

    def host(fn, warm=1):
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def host_once(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    def full(scene):
        scene._full_upload = True
        scene.flush()

    def delta(scene):
        edit_rows = rng.choice(scene.count, 1000, replace=False)
        for r in edit_rows:   # the edits themselves are not timed
            scene.instances[r].set_transform(pos=(float(r), 0.0, 0.0))
        sync()
        t0 = time.perf_counter()
        scene.flush()
        sync()
        return (time.perf_counter() - t0) * 1e3

    out["host_ms"] = {
        which: dict(
            full_flush=host(lambda s=scene: full(s)),
            dirty_1000_flush=statistics.median(delta(scene)
                                               for _ in range(reps)),
            static_mapping=statistics.median(   # seconds each: 3 reps
                host_once(lambda s=scene: SB.build_static_mapping(s))
                for _ in range(3)))
        for which, scene in (("native", sn), ("python", sp))}
    out["instances"] = sn.count
    return dict(ok=ok, **out)


def write_glb(path, meshes, materials, translations):
    """A .glb: `meshes` [(name, (pos, idx, nrm, uv), material index)],
    `materials` [dict(name, albedo, alpha, roughness, metallic, emissive,
    blend, textures={glTF slot: u8 image, or an encoded PNG / JPEG})], one
    node per translation (its mesh: the row's index modulo the mesh count)
    under one identity root. Images are embedded (bufferViews), arrays as
    PNGs; identical images are written once. A writer for the smoke test
    only: glTF export is not part of either package."""
    import numpy as np

    from paperrenderer_tpu_torch.io.image import encode_png

    chunks, views, accessors, images, image_ids = [], [], [], [], {}
    offset = [0]

    def view(data):
        pad = -len(data) % 4
        chunks.append(data + b"\x00" * pad)
        views.append({"buffer": 0, "byteOffset": offset[0],
                      "byteLength": len(data)})
        offset[0] += len(data) + pad
        return len(views) - 1

    def accessor(arr, ctype, typ):
        accessors.append({"bufferView": view(arr.tobytes()),
                          "componentType": ctype, "count": int(arr.shape[0]),
                          "type": typ})
        return len(accessors) - 1

    def image(img):
        if id(img) not in image_ids:
            data = img if isinstance(img, bytes) else encode_png(img)
            images.append({"bufferView": view(data), "mimeType":
                           "image/jpeg" if data[:2] == b"\xff\xd8"
                           else "image/png"})
            image_ids[id(img)] = len(images) - 1
        return {"index": image_ids[id(img)]}

    gl_meshes = []
    for name, (pos, idx, nrm, uv), mat in meshes:
        attrs = {"POSITION": accessor(np.asarray(pos, np.float32), 5126, "VEC3"),
                 "NORMAL": accessor(np.asarray(nrm, np.float32), 5126, "VEC3"),
                 "TEXCOORD_0": accessor(np.asarray(uv, np.float32), 5126,
                                        "VEC2")}
        ind = accessor(np.asarray(idx, np.uint32).reshape(-1), 5125, "SCALAR")
        gl_meshes.append({"name": name, "primitives": [
            {"attributes": attrs, "indices": ind, "material": mat}]})
    gl_mats = []
    for m in materials:
        tex = m.get("textures", {})
        pbr = {"baseColorFactor": list(m["albedo"]) + [m["alpha"]],
               "roughnessFactor": m["roughness"],
               "metallicFactor": m["metallic"]}
        mat = {"name": m["name"], "pbrMetallicRoughness": pbr,
               "emissiveFactor": list(m["emissive"])}
        for key, slot, dst in (
                ("base_texture", "baseColorTexture", pbr),
                ("mr_texture", "metallicRoughnessTexture", pbr),
                ("emissive_texture", "emissiveTexture", mat),
                ("occlusion_texture", "occlusionTexture", mat)):
            if tex.get(key) is not None:
                dst[slot] = image(tex[key])
        if m.get("blend"):
            mat["alphaMode"] = "BLEND"
        gl_mats.append(mat)
    n_mesh = len(gl_meshes)
    nodes = [{"name": "root", "children": list(range(1, len(translations) + 1))}]
    nodes += [{"mesh": k % n_mesh, "translation": [float(x) for x in t]}
              for k, t in enumerate(translations)]
    binary = b"".join(chunks)
    gltf = {"asset": {"version": "2.0"}, "scene": 0,
            "scenes": [{"nodes": [0]}], "nodes": nodes, "meshes": gl_meshes,
            "materials": gl_mats,   # texture i samples image i
            "textures": [{"source": i} for i in range(len(images))],
            "images": images, "buffers": [{"byteLength": len(binary)}],
            "bufferViews": views, "accessors": accessors}
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(js) + 8
                            + len(binary)))
        f.write(struct.pack("<I4s", len(js), b"JSON"))
        f.write(js)
        f.write(struct.pack("<I4s", len(binary), b"BIN\x00"))
        f.write(binary)
    return os.path.getsize(path)


# -- image writers for the glTF image forms -----------------------------------------
# numpy only (the card host has no imaging library): the forms of JPEG and
# PNG that io.image.read_image decodes and that an imaging library reads
# but does not write. Test support: glTF export and image encoding are
# not part of either package.

JPEG_HUFFMAN = {   # T.81 Annex K's tables, (class, id) -> (counts, symbols)
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             "000102030405060708090a0b"),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             "000102030405060708090a0b"),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125),
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
             "2433627282090a161718191a25262728292a3435363738393a434445464748"
             "494a535455565758595a636465666768696a737475767778797a8384858687"
             "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2"
             "c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
             "f5f6f7f8f9fa"),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
             "000102031104052131061241510761711322328108144291a1b1c109233352"
             "f0156272d10a162434e125f11718191a262728292a35363738393a43444546"
             "4748494a535455565758595a636465666768696a737475767778797a828384"
             "85868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8"
             "b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3"
             "f4f5f6f7f8f9fa"),
}
JPEG_QUANT = (   # Annex K's luminance and chrominance tables, natural order
    (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99),
    (17, 18, 24, 47) + (99,) * 4 + (18, 21, 26, 66) + (99,) * 4
    + (24, 26, 56) + (99,) * 5 + (47, 66) + (99,) * 38)
def jpeg_segment(marker, body=b""):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def rgb_to_ycc(img):
    """u8 [H, W, 3] RGB -> u8 YCbCr planes (JFIF's transform, rounded)."""
    import numpy as np

    r, g, b = (img[..., k].astype(np.float64) for k in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return [np.clip(np.round(p), 0, 255).astype(np.uint8) for p in (y, cb, cr)]


def jpeg_coefficients(planes, factors):
    """Full-size u8 planes with (h, v) sampling factors -> (per component
    i32[nby, nbx, 64] quantized DCT blocks in zigzag order over the MCU
    grid, the two quantization tables in natural order, Annex K's scaled
    as libjpeg's quality 85 scales them): a box-filtered downsample, edge
    replication to the grid, a float DCT."""
    import numpy as np

    from paperrenderer_tpu_torch.io.jpeg import ZIGZAG

    hgt, wid = planes[0].shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    qtabs = [np.clip((np.array(t) * 30 + 50) // 100, 1, 255)   # 30%
             for t in JPEG_QUANT]
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    basis *= np.where(k == 0, np.sqrt(0.125), 0.5)[:, None]
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    out = []
    for ci, (plane, (h, v)) in enumerate(zip(planes, factors)):
        fx, fy = hmax // h, vmax // v
        p = plane.astype(np.float64)
        if hmax % h or vmax % v:   # a ratio libjpeg refuses: nearest samples
            p = p[(np.arange(-(-hgt * v // vmax)) * vmax // v)[:, None],
                  np.arange(-(-wid * h // hmax)) * hmax // h]
        else:
            p = np.pad(p, ((0, -hgt % fy), (0, -wid % fx)), mode="edge")
            p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx,
                          fx).mean((1, 3))
        ny, nx = mcuy * v * 8, mcux * h * 8
        p = np.pad(p, ((0, ny - p.shape[0]), (0, nx - p.shape[1])),
                   mode="edge") - 128.0
        blk = p.reshape(ny // 8, 8, nx // 8, 8).transpose(0, 2, 1, 3)
        coef = basis @ blk @ basis.T
        q = qtabs[min(ci, 1)].reshape(8, 8)
        coef = np.round(coef / q).astype(np.int32).reshape(ny // 8, nx // 8, 64)
        out.append(coef[..., ZIGZAG])
    return out, qtabs


class _BitWriter:
    """MSB-first bits with JPEG's byte stuffing; ``flush`` pads with 1s."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _huffman_codes(table):
    """A (counts, symbols hex) table -> {symbol: (code, length)}."""
    counts, hexsyms = table
    symbols = bytes.fromhex(hexsyms)
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _category(v):
    """A signed value -> (magnitude category, its extra bits)."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


class _QMEncoder:
    """T.81's QM encoder (libjpeg's jcarith.c ``arith_encode`` and
    ``finish_pass``), carries propagated into the bytes already out;
    ``finish`` returns the interval's stuffed bytes."""

    def __init__(self):
        from paperrenderer_tpu_torch.io import jpeg as J

        self.qe, self.nl, self.nm = J.QE, J.NEXT_LPS, J.NEXT_MPS
        self.out, self.c, self.a, self.ct = bytearray(), 0, 0x10000, 11

    def _byte(self):
        temp = self.c >> 19
        if temp > 0xFF:                      # carry into the bytes out
            i = len(self.out) - 1
            while self.out[i] == 0xFF:
                self.out[i] = 0
                i -= 1
            self.out[i] += 1
        self.out.append(temp & 0xFF)

    def encode(self, st, i, val):
        sv = st[i]
        s = sv & 0x7F
        q = self.qe[s]
        self.a -= q
        if val != sv >> 7:                   # the less probable symbol
            if self.a >= q:
                self.c += self.a
                self.a = q
            st[i] = (sv & 0x80) ^ self.nl[s]
        else:
            if self.a >= 0x8000:
                return
            if self.a < q:
                self.c += self.a
                self.a = q
            st[i] = (sv & 0x80) ^ self.nm[s]
        while True:                          # renormalize (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte()
                self.c &= 0x7FFFF
                self.ct = 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        self._byte()
        self.out.append((self.c >> 11) & 0xFF)
        return bytes(self.out).rstrip(b"\0").replace(b"\xff", b"\xff\x00")


def _arith_dc(enc, st, ctx, v, cond):
    """jcarith's DC difference ``v`` -> the next conditioning context."""
    if v == 0:
        enc.encode(st, ctx, 0)
        return 0
    enc.encode(st, ctx, 1)
    sign = v < 0
    v = abs(v)
    enc.encode(st, ctx + 1, int(sign))
    i, nxt = ctx + 2 + sign, 4 + 4 * sign
    m, v = 0, v - 1
    if v:
        enc.encode(st, i, 1)
        m, v2, i = 1, v >> 1, 20
        while v2:
            enc.encode(st, i, 1)
            m, v2, i = m << 1, v2 >> 1, i + 1
    enc.encode(st, i, 0)
    lo, hi = cond
    if m < (1 << lo) >> 1:
        nxt = 0
    elif m > (1 << hi) >> 1:
        nxt += 8
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, int(bool(m & v)))
        m >>= 1
    return nxt


def _arith_ac(enc, st, i, k, v, kx, fixed):
    """jcarith's nonzero AC value ``v`` at zigzag index k whose S0 bin is
    ``st[i + 2]`` (the sign and magnitude; the zero-run bins are the
    caller's)."""
    enc.encode(fixed, 0, int(v < 0))
    v = abs(v) - 1
    i += 2
    m = 0
    if v:
        enc.encode(st, i, 1)
        m, v2 = 1, v >> 1
        if v2:
            enc.encode(st, i, 1)
            m, i = 2, (189 if k <= kx else 217)
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                m, v2, i = m << 1, v2 >> 1, i + 1
    enc.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, int(bool(m & v)))
        m >>= 1


def _scan_mcus(comps, sel, wid, hgt):
    """A scan's MCU count, MCUs a row and block layout (as a decoder
    walks it)."""
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if len(sel) == 1:
        c = comps[sel[0]]
        bpr = -(-(-(-wid * c["h"] // hmax)) // 8)
        rows = -(-(-(-hgt * c["v"] // vmax)) // 8)
        return bpr * rows, bpr, [(sel[0], 0, 0)]
    bpr = -(-wid // (8 * hmax))
    layout = [(ci, y, x) for ci in sel for y in range(comps[ci]["v"])
              for x in range(comps[ci]["h"])]
    return bpr * -(-hgt // (8 * vmax)), bpr, layout


def _scan_data(comps, coefs, sel, wid, hgt, restart, encode_mcu):
    """A scan's entropy-coded data: ``encode_mcu(mcu blocks)`` per MCU in
    restart intervals, each interval's bytes from ``encode_mcu.finish()``."""
    n_mcus, bpr, layout = _scan_mcus(comps, sel, wid, hgt)
    single = len(sel) == 1
    per = restart or n_mcus
    out = []
    for k0 in range(0, n_mcus, per):
        if k0:
            out.append(bytes([0xFF, 0xD0 + (k0 // per - 1) % 8]))
        coder = encode_mcu()
        for mcu in range(k0, min(n_mcus, k0 + per)):
            my, mx = divmod(mcu, bpr)
            for ci, y, x in layout:
                if single:
                    by, bx = my, mx
                else:
                    by, bx = my * comps[ci]["v"] + y, mx * comps[ci]["h"] + x
                coder.block(ci, coefs[ci][by][bx])
        out.append(coder.finish())
    return b"".join(out)


class _HuffmanMCU:
    """Sequential Huffman coding of blocks (zigzag lists) with Annex K's
    tables (id 0 for component 0, 1 for the others)."""

    def __init__(self):
        self.bits, self.pred = _BitWriter(), {}
        self.codes = {key: _huffman_codes(t) for key, t in JPEG_HUFFMAN.items()}

    def block(self, ci, z):
        put, t = self.bits.put, min(ci, 1)
        dc, ac = self.codes[0, t], self.codes[1, t]
        s, extra = _category(z[0] - self.pred.get(ci, 0))
        self.pred[ci] = z[0]
        put(*dc[s])
        if s:
            put(extra, s)
        last = 63
        while last and not z[last]:
            last -= 1
        run = 0
        for k in range(1, last + 1):
            if not z[k]:
                run += 1
                continue
            while run > 15:
                put(*ac[0xF0])
                run -= 16
            s, extra = _category(z[k])
            put(*ac[run << 4 | s])
            put(extra, s)
            run = 0
        if last < 63:
            put(*ac[0])

    def finish(self):
        return self.bits.flush()


class _ArithMCU:
    """Arithmetic coding of blocks (zigzag lists, full precision) in one
    scan's form (``jcarith.c``: ``encode_mcu`` or a progressive form with
    its point transform), conditioning table id 0 for component 0, 1 for
    the others; every statistics area starts at zero."""

    def __init__(self, spectral, cond):
        self.enc = _QMEncoder()
        self.spectral, self.cond = spectral, cond
        self.dc = {t: [0] * 64 for t in (0, 1)}
        self.ac = {t: [0] * 256 for t in (0, 1)}
        self.fixed = [113]
        self.last, self.ctx = {}, {}

    def block(self, ci, z):
        enc, t, fixed = self.enc, min(ci, 1), self.fixed
        ss, se, ah, al = self.spectral or (0, 63, 0, 0)
        kx = self.cond[1].get(t, 5)
        if ss == 0 and ah == 0:                  # DC (sequential or first)
            m = z[0] >> al
            self.ctx[ci] = _arith_dc(enc, self.dc[t], self.ctx.get(ci, 0),
                                     m - self.last.get(ci, 0),
                                     self.cond[0].get(t, (0, 1)))
            self.last[ci] = m
            if self.spectral is not None:
                return
        elif ss == 0:                            # DC refinement
            enc.encode(fixed, 0, (z[0] >> al) & 1)
            return
        st = self.ac[t]
        ss = max(ss, 1)

        def shifted(k, shift):
            v = z[k]
            return (v >> shift) if v >= 0 else -((-v) >> shift)

        ke = se
        while ke >= ss and not shifted(ke, al):
            ke -= 1
        if ah == 0:                              # AC (sequential or first)
            k = ss
            while k <= ke:
                i = 3 * (k - 1)
                enc.encode(st, i, 0)             # not the end of block
                while not shifted(k, al):
                    enc.encode(st, i + 1, 0)
                    i += 3
                    k += 1
                enc.encode(st, i + 1, 1)
                _arith_ac(enc, st, i, k, shifted(k, al), kx, fixed)
                k += 1
            if k <= se:
                enc.encode(st, 3 * (k - 1), 1)
            return
        kex = ke                                 # AC refinement
        while kex > 0 and not shifted(kex, ah):
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                enc.encode(st, i, 0)
            while True:
                v = abs(shifted(k, al))
                if v:
                    if v >> 1:                   # a correction bit
                        enc.encode(st, i + 2, v & 1)
                    else:                        # newly nonzero
                        enc.encode(st, i + 1, 1)
                        enc.encode(fixed, 0, int(z[k] < 0))
                    break
                enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def finish(self):
        return self.enc.finish()


def progressive_script(ncomps):
    """libjpeg's ``jpeg_simple_progression`` scan script: (components, Ss,
    Se, Ah, Al) per scan."""
    every = tuple(range(ncomps))
    if ncomps == 3:
        return [(every, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                (every, 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    out = [(every, 0, 0, 0, 1)]
    for ss, se, ah, al in ((1, 5, 0, 2), (6, 63, 0, 2), (1, 63, 2, 1)):
        out += [((c,), ss, se, ah, al) for c in every]
    out.append((every, 0, 0, 1, 0))
    return out + [((c,), 1, 63, 1, 0) for c in every]


def write_jpeg(planes, factors=None, coding="huffman",
               script=None, restart=0, adobe=None, jfif=True, ids=None,
               dac=None):
    """A DCT JPEG of u8 ``planes`` (one full-size plane a component,
    written as the component's samples): ``factors`` (h, v) a component
    (default 1x1), ``coding`` "huffman" (baseline, Annex K tables) or
    "arithmetic" (sequential, or progressive by ``script``: (components,
    Ss, Se, Ah, Al) a scan), a restart interval in MCUs, an Adobe APP14
    transform flag, a JFIF APP0, component ``ids`` (default 1, 2, ...),
    ``dac`` = ({table: (L, U)}, {table: Kx}) for arithmetic coding (a DAC
    segment; None: the defaults, no segment)."""
    from paperrenderer_tpu_torch.io.jpeg import ZIGZAG

    nc = len(planes)
    factors = factors or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    hgt, wid = planes[0].shape
    coefs, qtabs = jpeg_coefficients(planes, factors)
    coefs = [c.tolist() for c in coefs]
    comps = [dict(h=h, v=v) for h, v in factors]
    progressive = script is not None
    sof = {("huffman", False): 0xC0, ("arithmetic", False): 0xC9,
           ("arithmetic", True): 0xCA}[coding, progressive]
    head = [b"\xff\xd8"]
    if jfif:
        head.append(jpeg_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                 b"\x00\x00"))
    if adobe is not None:
        head.append(jpeg_segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                                 + bytes([adobe])))
    head.append(jpeg_segment(0xDB, b"".join(
        bytes([t]) + bytes(q[ZIGZAG].astype("u1")) for t, q in
        enumerate(qtabs[:min(nc, 2)]))))
    head.append(jpeg_segment(sof, struct.pack(">BHHB", 8, hgt, wid, nc)
                             + b"".join(bytes([i, h << 4 | v, min(k, 1)])
                                        for k, (i, (h, v)) in
                                        enumerate(zip(ids, factors)))))
    if coding == "huffman":
        head.append(jpeg_segment(0xC4, b"".join(
            bytes([tc << 4 | th]) + bytes(t[0]) + bytes.fromhex(t[1])
            for (tc, th), t in sorted(JPEG_HUFFMAN.items()) if th < nc)))
    elif dac is not None:
        head.append(jpeg_segment(0xCC, b"".join(
            [bytes([t, u << 4 | lo]) for t, (lo, u) in dac[0].items()]
            + [bytes([16 + t, k]) for t, k in dac[1].items()])))
    if restart:
        head.append(jpeg_segment(0xDD, struct.pack(">H", restart)))
    cond = dac or ({}, {})
    scans = script or [(tuple(range(nc)), 0, 63, 0, 0)]
    for sel, ss, se, ah, al in scans:
        spectral = (ss, se, ah, al) if progressive else None
        coder = (_HuffmanMCU if coding == "huffman" else
                 functools.partial(_ArithMCU, spectral, cond))
        head.append(jpeg_segment(0xDA, bytes([len(sel)]) + b"".join(
            bytes([ids[c], min(c, 1) * 0x11]) for c in sel)
            + bytes([ss, se, ah << 4 | al])))
        head.append(_scan_data(comps, coefs, list(sel), wid, hgt, restart,
                               coder))
    return b"".join(head) + b"\xff\xd9"


def write_lossless_jpeg(planes, predictor=1, pt=0, restart_rows=0, ids=None,
                        interleave=True, factors=None):
    """A lossless JPEG (SOF3) of u8 planes: ``predictor`` 1-7, point
    transform ``pt``, a restart every ``restart_rows`` MCU rows, one
    interleaved scan or a scan a component (1x1 sampling), (h, v)
    ``factors`` a component (box-filtered down; the interleaved MCUs' dummy
    samples coded as 0); Annex K's DC luminance table codes the
    differences (|d| < 512 at 8 bits)."""
    import numpy as np

    nc = len(planes)
    ids = ids or list(range(1, nc + 1))
    factors = factors or [(1, 1)] * nc
    hgt, wid = planes[0].shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    codes = _huffman_codes(JPEG_HUFFMAN[0, 0])
    diffs = []
    for plane, (fh, fv) in zip(planes, factors):
        fx, fy = hmax // fh, vmax // fv
        p = np.pad(plane.astype(np.float64), ((0, -hgt % fy), (0, -wid % fx)),
                   mode="edge")
        p = np.round(p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx,
                               fx).mean((1, 3))).astype(np.int64)
        ch, cw = -(-hgt * fv // vmax), -(-wid * fh // hmax)
        x = (p[:ch, :cw] >> pt).tolist()
        d = []     # the differences, rows restarting as the decoder's do
        for y in range(ch):
            first = y == 0 or (restart_rows and y % fv == 0
                               and (y // fv) % restart_rows == 0)
            row = []
            for c in range(cw):
                if first:
                    p = (1 << (7 - pt)) if c == 0 else x[y][c - 1]
                elif c == 0:
                    p = x[y - 1][0]
                else:
                    ra, rb, rc = x[y][c - 1], x[y - 1][c], x[y - 1][c - 1]
                    p = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                         rb + ((ra - rc) >> 1), (ra + rb) >> 1)[predictor - 1]
                row.append(x[y][c] - p)
            d.append(row)
        diffs.append(d)
    head = [b"\xff\xd8",
            jpeg_segment(0xC3, struct.pack(">BHHB", 8, hgt, wid, nc)
                         + b"".join(bytes([i, h << 4 | v, 0])
                                    for i, (h, v) in zip(ids, factors)))]
    t = JPEG_HUFFMAN[0, 0]
    head.append(jpeg_segment(0xC4, b"\x00" + bytes(t[0])
                             + bytes.fromhex(t[1])))
    groups = [list(range(nc))] if interleave else [[c] for c in range(nc)]
    mpr, mrows = -(-wid // hmax), -(-hgt // vmax)
    if restart_rows:
        head.append(jpeg_segment(0xDD, struct.pack(">H", restart_rows * mpr)))
    for sel in groups:
        head.append(jpeg_segment(0xDA, bytes([len(sel)]) + b"".join(
            bytes([ids[c], 0]) for c in sel) + bytes([predictor, 0, pt])))
        shape = [(1, 1)] * nc if len(sel) == 1 else factors
        rows = restart_rows or mrows
        for y0 in range(0, mrows, rows):
            if y0:
                head.append(bytes([0xFF, 0xD0 + (y0 // rows - 1) % 8]))
            bits = _BitWriter()
            for my in range(y0, min(mrows, y0 + rows)):
                for mx in range(mpr):
                    for ci in sel:
                        fh, fv = shape[ci]
                        for y in range(my * fv, my * fv + fv):
                            for x in range(mx * fh, mx * fh + fh):
                                d = diffs[ci]
                                v = d[y][x] if y < len(d) and x < len(d[0]) \
                                    else 0
                                s, extra = _category(v)
                                bits.put(*codes[s])
                                if s:
                                    bits.put(extra, s)
            head.append(bits.flush())
    return b"".join(head) + b"\xff\xd9"


def drop_scans(data, drop):
    """A JPEG with the scans for which ``drop(components, Ss, Se, Ah, Al)``
    is true cut out (header and entropy-coded data)."""
    out, pos = [data[:2]], 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            out.append(data[pos:])
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        end = pos + 2 + length
        if marker == 0xDA:
            body = data[pos + 4:end]
            ns = body[0]
            sel = tuple(body[1 + 2 * i] for i in range(ns))
            ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
            while True:         # the data runs to the next non-RST marker
                end = data.index(b"\xff", end)
                if data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
                    end += 2
                    continue
                break
            if drop(sel, ss, se, ahl >> 4, ahl & 15):
                pos = end
                continue
        out.append(data[pos:end])
        pos = end
    return b"".join(out)


def write_png_gray(img, depth, trns=None, interlace=False):
    """A gray PNG of ``img`` [H, W] holding values below 2^depth at depth
    1, 2 or 4 (sub-byte samples, high bits first), a ``tRNS`` gray key,
    Adam7-interlaced or not; filter type 0 on every row."""
    import numpy as np
    import zlib

    from paperrenderer_tpu_torch.io.image import _ADAM7, _chunk

    h, w = img.shape

    def rows(a):
        per = 8 // depth
        a = np.pad(a, ((0, 0), (0, -a.shape[1] % per))).astype(np.uint8)
        packed = np.zeros((a.shape[0], a.shape[1] // per), np.uint8)
        for k in range(per):
            packed |= a[:, k::per] << (8 - depth * (k + 1))
        return np.concatenate([np.zeros((a.shape[0], 1), np.uint8), packed],
                              axis=1).tobytes()

    if interlace:
        raw = b"".join(rows(img[y0::dy, x0::dx]) for x0, y0, dx, dy in _ADAM7
                       if w > x0 and h > y0)
    else:
        raw = rows(img)
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0,
                                    int(interlace))),
        _chunk(b"tRNS", struct.pack(">H", trns)) if trns is not None else b"",
        _chunk(b"IDAT", zlib.compress(raw, 6)), _chunk(b"IEND", b"")])


# -- image writers for the glTF container forms (BMP, TGA, GIF) --------------
# numpy only, as the JPEG and PNG writers above: the forms io.image decodes
# beyond what an imaging library writes (RLE, bitfields, other headers and
# depths, colour maps at an offset, offset GIF frames).


def bmp_rle(idx, rle4=False, deltas=()):
    """Encode indices [H, W] (rows bottom-up, as a BMP stores them) as
    RLE8 / RLE4: runs of 3 or more equal pixels as encoded runs, the rest
    as absolute runs (or encoded runs of 1-2), an end of line per row and
    the end of bitmap; ``deltas`` (row, column, right, up) write a delta
    escape there, its offsets as 2 bytes (RLE's own layout)."""
    import numpy as np

    out = bytearray()
    h, w = idx.shape
    cap = 254 if rle4 else 255
    for y in range(h):
        row = idx[h - 1 - y].tolist()
        x = 0
        while x < w:
            for dy, dx, right, up in deltas:
                if (dy, dx) == (y, x):
                    out += bytes((0, 2, right, up))
            run = 1
            while x + run < w and run < cap and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                v = row[x]
                out += bytes((run, (v << 4 | v) if rle4 else v))
                x += run
                continue
            n = 3
            while x + n < w and n < cap and not (
                    x + n + 2 < w and row[x + n] == row[x + n + 1]
                    == row[x + n + 2]):
                n += 1
            lit = row[x:x + n]
            if rle4:
                lit = lit + [0] * (n & 1)
                body = bytes(a << 4 | b for a, b in zip(lit[::2], lit[1::2]))
            else:
                body = bytes(lit)
            out += bytes((0, n)) + body + b"\x00" * (len(body) & 1)
            x += n
        out += b"\x00\x00"
    out += b"\x00\x01"
    return bytes(out)


def write_bmp(pixels, bits, palette=None, header=40, compression=0,
              masks=None, top_down=False, body=None, file_header=True):
    """A BMP (a DIB without ``file_header``): ``pixels`` indices [H, W] at
    1-8 bits, packed u16 / u32 values [H, W] at 16 / 32 bits, or RGB
    [H, W, 3] at 24 bits; ``palette`` [n, 3] RGB; ``header`` 12 (OS/2
    core: 3-byte entries), 40 or a V2-V5 size (52, 56, 108, 124) with
    ``masks`` in it (40: after it); compression 0 (BI_RGB), 1 / 2 (RLE8 /
    RLE4: ``body`` the stream, else bmp_rle of the pixels), 3
    (BI_BITFIELDS) or another code with ``body`` as the pixel data."""
    import numpy as np

    h, w = pixels.shape[:2]
    if body is None and compression in (1, 2):
        body = bmp_rle(pixels, compression == 2)
    if body is None:
        rows = pixels[::-1] if not top_down else pixels
        if bits < 8:
            per = 8 // bits
            a = np.pad(rows.astype(np.uint8), ((0, 0), (0, -w % per)))
            packed = np.zeros((h, a.shape[1] // per), np.uint8)
            for k in range(per):
                packed |= a[:, k::per] << (8 - bits * (k + 1))
            raw = packed
        elif bits == 24:
            raw = rows[..., ::-1].reshape(h, -1)
        else:
            raw = rows.astype({8: "u1", 16: "<u2", 32: "<u4"}[bits]).view(
                np.uint8).reshape(h, -1)
        stride = ((w * bits + 31) >> 3) & ~3
        body = np.pad(raw, ((0, 0), (0, stride - raw.shape[1]))).tobytes()
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, len(body), 2835, 2835,
                           len(pal) // 4, 0)
        extra = b"".join(struct.pack("<I", m) for m in (masks or ()))
        if header == 40:
            info += extra
        else:
            info += (extra + bytes(header - 40))[:header - 40]
    off = (14 if file_header else 0) + len(info) + len(pal)
    head = (b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off)
            if file_header else b"")
    return head + info + pal + body


def pack_rgb(rgb, bits=(5, 6, 5)):
    """RGB [..., 3] -> 5-6-5 or 5-5-5 u16 values (high bits kept)."""
    import numpy as np

    v = np.zeros(rgb.shape[:-1], np.uint32)
    for c, b in enumerate(bits):
        v = (v << b) | (rgb[..., c].astype(np.uint32) >> (8 - b))
    return v


def pack_masks(rgba, masks):
    """RGBA [H, W, 4] -> u32 values with each channel in its 8-bit mask
    (masks r, g, b, a; a 0 mask drops the channel)."""
    import numpy as np

    v = np.zeros(rgba.shape[:2], np.uint32)
    for c, m in enumerate(masks):
        if m:
            shift = (m & -m).bit_length() - 1
            v |= rgba[..., c].astype(np.uint32) << shift
    return v


def tga_rle(pixels, width):
    """Pixel rows [N, bytes per pixel] -> TGA run-length packets over one
    stream: runs of 2+ equal pixels repeated (cut at each row's end, as
    readers require), others literal (across rows); 128 at most."""
    out = bytearray()
    px = [bytes(p) for p in pixels]
    i, n = 0, len(px)
    while i < n:
        run = 1
        end = min(n, i - i % width + width, i + 128)
        while i + run < end and px[i + run] == px[i]:
            run += 1
        if run >= 2:
            out += bytes((0x80 | (run - 1),)) + px[i]
            i += run
            continue
        j = i + 1
        while j < n and j - i < 128 and not (
                j + 1 < n and px[j] == px[j + 1] and (j + 1) % width):
            j += 1
        out += bytes((j - i - 1,)) + b"".join(px[i:j])
        i = j
    return bytes(out)


def write_tga(pixels, image_type, depth, colormap=None, map_depth=0,
              map_start=0, origin="bottom-left", alpha_bits=0, image_id=b""):
    """A TGA of ``pixels``: gray or indices [H, W] (depth 8), gray + alpha
    [H, W, 2] (16), RGB / RGBA [H, W, 3|4] (24 / 32), or packed 15/16-bit
    values [H, W]; image types 1-3 or 9-11 (run-length packets over the
    whole pixel stream, literal ones crossing rows); ``colormap`` [n, 3|4]
    RGB(A) at ``map_depth`` 15, 16 (alpha below 128: the top bit), 24 or
    32 bits with its first index ``map_start``;
    ``origin`` one of the four corners."""
    import numpy as np

    h, w = pixels.shape[:2]
    flip_x = origin.endswith("right")
    top = origin.startswith("top")
    rows = pixels[:, ::-1] if flip_x else pixels
    rows = rows if top else rows[::-1]
    if depth in (15, 16) and rows.ndim == 2 and image_type in (2, 10):
        raw = rows.astype("<u2").view(np.uint8).reshape(h * w, 2)
    elif rows.ndim == 3 and rows.shape[2] >= 3:
        raw = rows[..., [2, 1, 0] + ([3] if rows.shape[2] == 4 else [])]
        raw = raw.reshape(h * w, -1)
    else:
        raw = rows.reshape(h * w, -1).astype(np.uint8)
    body = tga_rle(raw, w) if image_type & 8 else raw.tobytes()
    cmap = b""
    if colormap is not None:
        c = np.asarray(colormap)
        if map_depth in (15, 16):   # the top bit: alpha below 128
            v = pack_rgb(c[:, :3], (5, 5, 5))
            if c.shape[1] == 4:
                v |= (c[:, 3] < 128).astype(np.uint32) << 15
            cmap = v.astype("<u2").tobytes()
        else:
            cmap = c[:, [2, 1, 0] + ([3] if map_depth == 32 else [])].astype(
                np.uint8).tobytes()
    flags = alpha_bits | (0x20 if top else 0) | (0x10 if flip_x else 0)
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), int(colormap is not None),
                       image_type, map_start,
                       0 if colormap is None else len(colormap), map_depth,
                       0, 0, w, h, depth, flags)
    return head + image_id + cmap + body


def gif_lzw(idx, min_size, clear_when_full=True, literal=False):
    """GIF LZW (codes packed from the low bit) of the flat indices: a clear
    code first; a full 4,096-entry table is cleared, or, with
    ``clear_when_full=False``, kept (12-bit codes, no new entries);
    ``literal``: one code a pixel (the table still grows: it fills after
    about 3,840 pixels)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table = {(k,): k for k in range(clear)}
    size, nxt = min_size + 1, clear + 2
    emit(clear, size)
    cur = ()
    for v in idx:
        ext = cur + (v,)
        if ext in table and not (literal and cur):
            cur = ext
            continue
        emit(table[cur], size)
        if nxt < 4096:
            table[ext] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        elif clear_when_full:
            emit(clear, size)
            table = {(k,): k for k in range(clear)}
            size, nxt = min_size + 1, clear + 2
        cur = (v,)
    if cur:
        emit(table[cur], size)
    emit(end, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(frames, palette=None, screen=None, transparency=None,
              clear_when_full=True, literal=False):
    """A GIF89a: ``frames`` [(indices [h, w], x0, y0, local palette or
    None, interlace)], a global ``palette`` [n, 3] (n a power of two),
    the logical ``screen`` (w, h; the first frame's extent by default),
    a graphic-control transparency index on the first frame, and
    gif_lzw's options."""
    import numpy as np

    def table(p):
        p = np.asarray(p, np.uint8)
        bits = max(1, int(len(p) - 1).bit_length())
        return bits, np.pad(p, ((0, (1 << bits) - len(p)), (0, 0))).tobytes()

    idx0 = frames[0][0]
    sw, sh = screen or (idx0.shape[1] + frames[0][1], idx0.shape[0] + frames[0][2])
    flags, gct = 0, b""
    if palette is not None:
        bits, gct = table(palette)
        flags = 0x80 | (bits - 1) | ((bits - 1) << 4)
    out = [b"GIF89a", struct.pack("<HHBBB", sw, sh, flags, 0, 0), gct]
    for k, (idx, x0, y0, local, interlace) in enumerate(frames):
        if k == 0 and transparency is not None:
            out.append(b"\x21\xf9\x04" + struct.pack("<BHB", 1, 10, transparency)
                       + b"\x00")
        h, w = idx.shape
        fflags, lct = 0x40 if interlace else 0, b""
        if local is not None:
            bits, lct = table(local)
            fflags |= 0x80 | (bits - 1)
        out.append(b"\x2c" + struct.pack("<HHHHB", x0, y0, w, h, fflags) + lct)
        rows = idx
        if interlace:
            order = np.concatenate([np.arange(s, h, d) for s, d in
                                    ((0, 8), (4, 8), (2, 4), (1, 2))])
            rows = idx[order]
        min_size = max(2, int(idx.max()).bit_length())
        data = gif_lzw(rows.reshape(-1).tolist(), min_size, clear_when_full,
                       literal)
        out.append(bytes((min_size,)) + b"".join(
            bytes((len(data[i:i + 255]),)) + data[i:i + 255]
            for i in range(0, len(data), 255)) + b"\x00")
    out.append(b"\x3b")
    return b"".join(out)


def bcn_blocks(img):
    """An image [H, W] or [H, W, C] -> its 4x4 blocks [n, 16, C] (rows of
    ceil(W / 4) blocks; the edges repeated to whole blocks)."""
    import numpy as np

    a = img[..., None] if img.ndim == 2 else img
    h, w, c = a.shape
    a = np.pad(a, ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge")
    nby, nbx = a.shape[0] // 4, a.shape[1] // 4
    return a.reshape(nby, 4, nbx, 4, c).transpose(0, 2, 1, 3, 4).reshape(
        -1, 16, c).astype(np.int64)


def _nearest(values, palette):
    """Index of the nearest palette entry: values [n, 16, C], palette
    [n, k, C] -> [n, 16]."""
    d = ((values[:, :, None] - palette[:, None]) ** 2).sum(-1)
    return d.argmin(-1)


def _bc1_encode(px):
    """BC1 colour blocks (four colours) of RGB blocks [n, 16, 3] -> [n, 8]
    bytes: the per-channel extremes as 5-6-5 endpoints, the nearest of the
    four colours the decoder makes."""
    import numpy as np

    hi, lo = px.max(1), px.min(1)

    def pack(c):
        return (c[:, 0] >> 3) << 11 | (c[:, 1] >> 2) << 5 | c[:, 2] >> 3

    def unpack(v):
        r, g, b = (v >> 11) << 3, ((v >> 5) & 63) << 2, (v & 31) << 3
        return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)

    c0, c1 = pack(hi), pack(lo)
    p0, p1 = unpack(c0), unpack(c1)
    pal = np.stack([p0, p1, (2 * p0 + p1) // 3, (p0 + 2 * p1) // 3], 1)
    idx = np.where((c0 > c1)[:, None], _nearest(px, pal), 0)
    lut = (idx << (2 * np.arange(16))).sum(1)
    return np.stack([c0 & 255, c0 >> 8, c1 & 255, c1 >> 8] +
                    [(lut >> (8 * k)) & 255 for k in range(4)], 1)


def _alpha_encode(a):
    """BC3 / BC4 alpha blocks of [n, 16] bytes -> [n, 8]: the extremes,
    eight levels, nearest."""
    import numpy as np

    a0, a1 = a.max(1), a.min(1)
    k = np.arange(1, 7)
    levels = np.concatenate([a0[:, None], a1[:, None],
                             ((7 - k) * a0[:, None] + k * a1[:, None]) // 7],
                            1)
    idx = np.where((a0 > a1)[:, None],
                   np.abs(a[:, :, None] - levels[:, None]).argmin(-1), 0)
    lut = (idx << (3 * np.arange(16))).sum(1)
    return np.stack([a0, a1] + [(lut >> (8 * k)) & 255 for k in range(6)], 1)


def _bc7_mode6(px):
    """BC7 mode 6 of RGBA blocks [n, 16, 4] -> [n, 16]: 7-bit endpoints
    with a p-bit each (the channels' extremes), 4-bit indices on the
    decoder's weights, the first index's top bit cleared by swapping the
    endpoints."""
    import numpy as np

    lo, hi = px.min(1), px.max(1)
    e = np.stack([lo, hi], 1)                          # [n, 2, 4]
    p = (e.sum(-1) > 510).astype(np.int64)             # one p-bit a side
    q = np.clip((e - p[..., None]) >> 1, 0, 127)
    ev = q << 1 | p[..., None]
    weights = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                        60, 64])
    pal = ((64 - weights)[None, :, None] * ev[:, :1] + weights[None, :, None]
           * ev[:, 1:] + 32) >> 6
    idx = _nearest(px, pal)
    flip = idx[:, 0] >= 8
    q = np.where(flip[:, None, None], q[:, ::-1], q)
    p = np.where(flip[:, None], p[:, ::-1], p)
    idx = np.where(flip[:, None], 15 - idx, idx)
    vals, widths = [np.full(len(px), 64)], [7]         # mode 6: 1 << 6
    for c in range(4):
        for s in range(2):
            vals.append(q[:, s, c])
            widths.append(7)
    vals += [p[:, 0], p[:, 1], idx[:, 0]] + [idx[:, i] for i in range(1, 16)]
    widths += [1, 1, 3] + [4] * 15
    bits = np.concatenate([(v[:, None] >> np.arange(w)) & 1
                           for v, w in zip(vals, widths)], 1)
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")


def encode_bcn(img, kind):
    """``img`` u8 ([H, W] for BC4, [H, W, 3|4] else) -> the BC``kind``
    payload (1: BC1, 3: BC3, 4: BC4, 7: BC7 mode 6) as bytes."""
    import numpy as np

    px = bcn_blocks(img)
    if len(px) > 16384:     # in slices: the nearest-colour search is wide
        return b"".join(encode_bcn_blocks(px[k:k + 16384], kind)
                        for k in range(0, len(px), 16384))
    return encode_bcn_blocks(px, kind)


def encode_bcn_blocks(px, kind):
    """encode_bcn of blocks [n, 16, C] (bcn_blocks)."""
    import numpy as np

    if kind == 4:
        out = _alpha_encode(px[..., 0])
    elif kind == 7:
        if px.shape[-1] == 3:
            px = np.concatenate([px, np.full_like(px[..., :1], 255)], -1)
        out = _bc7_mode6(px)
    else:
        out = _bc1_encode(px[..., :3])
        if kind == 3:
            alpha = px[..., 3] if px.shape[-1] == 4 else np.full(
                px.shape[:2], 255)
            out = np.concatenate([_alpha_encode(alpha), out], 1)
    return np.asarray(out, np.uint8).tobytes()


def write_dds(w, h, body, fourcc=None, dxgi=None, flags=0, bits=0,
              masks=(0, 0, 0, 0), palette=b""):
    """A DDS file: the 124-byte header with pixel-format ``flags`` (0x4
    FourCC added when ``fourcc`` is given; 0x40 RGB, 0x20000 luminance,
    0x20 palette, 0x1 alpha), ``bits`` a pixel and the four ``masks``; a
    DX10 extension with ``dxgi`` when the FourCC is DX10; ``palette``
    (1,024 bytes of RGBA) and ``body``, the first surface's data."""
    fcc = 0
    if fourcc is not None:
        flags |= 0x4
        (fcc,) = struct.unpack("<I", fourcc)
    head = struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0) + bytes(44)
    head += struct.pack("<4I", 32, flags, fcc, bits) + struct.pack("<4I",
                                                                 *masks)
    head += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    ext = struct.pack("<5I", dxgi, 3, 0, 1, 0) if fourcc == b"DX10" else b""
    return b"DDS " + head + ext + palette + body


def tiff_lzw(data, old=False):
    """TIFF LZW (codes from the high bit, one bit wider as the next free
    code reaches 512, 1024, 2048; a clear at 4094 entries). ``old``: the
    old-style codes libtiff's compat decoder reads (from the low bit, one
    bit wider one code later)."""
    out, acc, nbits = bytearray(), 0, 0
    late = 1 if old else 0

    def emit(code, size):
        nonlocal acc, nbits
        if old:
            acc |= code << nbits
            nbits += size
            while nbits >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nbits -= 8
            return
        acc = acc << size | code
        nbits += size
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1

    table = {bytes((k,)): k for k in range(256)}
    size, nxt = 9, 258
    emit(256, size)
    cur = b""
    for k in range(len(data)):
        ext = data[k:k + 1] if not cur else cur + data[k:k + 1]
        if ext in table:
            cur = ext
            continue
        emit(table[cur], size)
        table[ext] = nxt
        nxt += 1
        if nxt > (1 << size) - 1 + late and size < 12:
            size += 1
        if nxt == 4094:
            emit(256, size)
            table = {bytes((j,)): j for j in range(256)}
            size, nxt = 9, 258
        cur = data[k:k + 1]
    if cur:
        emit(table[cur], size)
        nxt += 1
        if nxt > (1 << size) - 1 + late and size < 12:
            size += 1
    emit(257, size)
    if nbits:
        out.append(acc & 0xFF if old else (acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def packbits(data):
    """PackBits: repeat packets for runs of 3 or more, literals else."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes((257 - (j - i + 1), data[i]))
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes((j - i - 1,)) + data[i:j]
        i = j
    return bytes(out)


_BITREV = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def write_tiff(samples, bits=8, photometric=None, sample_format=1,
               compression=1, predictor=1, planar=1, tile=None,
               rows_per_strip=None, big=False, order="<", fill_order=1,
               extra=(), colormap=None, orientation=None, subsampling=None,
               coefficients=None, reference=None, old_lzw=False):
    """A TIFF (``big``: BigTIFF) of ``samples`` [H, W] or [H, W, S]: ints
    below 2^bits (1, 2, 4, 8, 12, 16 or 32 bits; ``sample_format`` 2
    signed, 3 float32), ``photometric`` (by default 1 for one sample, 2
    else; 6 takes Y, Cb, Cr samples), ``extra`` the ExtraSamples,
    ``colormap`` [3 * 2^bits] u16 for a palette; strips of
    ``rows_per_strip`` rows or tiles (``tile`` (w, h), multiples of 16),
    chunky or ``planar`` 2; ``compression`` 1 (none), 32773 (PackBits), 5
    (LZW; ``old_lzw`` the old-style codes), 8 or 32946 (deflate), 34925
    (LZMA, an .xz stream) or 7 (JPEG: a baseline stream a strip or tile,
    its tables in JPEGTables); ``predictor`` 2 (horizontal, 8/16/32 bits)
    or 3 (floating point); ``order`` "<" (II) or ">" (MM); ``fill_order``
    2 reverses each stored byte's bits. YCbCr: ``subsampling`` (h, v)
    packs blocks of h x v Y then Cb, Cr (the block's top-left chroma; a
    JPEG's chroma sampled by the JPEG writer), ``coefficients`` and
    ``reference`` the YCbCrCoefficients and ReferenceBlackWhite as
    (numerator, denominator) pairs."""
    import zlib

    import numpy as np

    s = samples[..., None] if samples.ndim == 2 else samples
    h, w, spp = s.shape
    if photometric is None:
        photometric = 3 if colormap is not None else (1 if spp == 1 else 2)
    tw, tl = tile or (w, rows_per_strip or h)
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp
    kind = {1: "u", 2: "i", 3: "f"}[sample_format]

    def chunk_bytes(block):
        """Rows [r, c, per] of samples -> their stored bytes."""
        r, c, _ = block.shape
        if subsampling and planar == 1:   # h x v blocks of Y, then Cb, Cr
            sh, sv = subsampling
            p = np.pad(block, ((0, -r % sv), (0, -c % sh), (0, 0)),
                       mode="edge").astype(np.uint8)
            rr, cc = p.shape[0] // sv, p.shape[1] // sh
            ys = p[..., 0].reshape(rr, sv, cc, sh).transpose(0, 2, 1, 3)
            return np.concatenate([ys.reshape(rr, cc, sv * sh),
                                   p[::sv, ::sh, 1:]], -1).tobytes()
        if bits == 12:                    # two samples in three bytes
            v = block.reshape(r, -1).astype(np.uint16)
            n = v.shape[1]
            v = np.pad(v, ((0, 0), (0, n % 2)))
            a, b = v[:, 0::2], v[:, 1::2]
            packed = np.stack([a >> 4, (a & 15) << 4 | b >> 8, b & 255],
                              -1).astype(np.uint8).reshape(r, -1)
            return packed[:, :-(-n * 12 // 8)].tobytes()
        if bits < 8:
            v = block.reshape(r, -1).astype(np.uint8)
            k = 8 // bits
            v = np.pad(v, ((0, 0), (0, -v.shape[1] % k)))
            packed = np.zeros((r, v.shape[1] // k), np.uint8)
            for j in range(k):
                packed |= v[:, j::k] << (8 - bits * (j + 1))
            return packed.tobytes()
        dt = np.dtype(f"{kind}{bits // 8}")
        v = block.astype(dt).reshape(r, -1)
        if predictor == 2:
            u = v.view(f"u{bits // 8}")
            d = u.copy()
            d[:, per:] = u[:, per:] - u[:, :-per]
            v = d
        if predictor == 3:
            be = v.astype(dt.newbyteorder(">")).view(np.uint8).reshape(
                r, -1, bits // 8)
            planes_ = be.transpose(0, 2, 1).reshape(r, -1).astype(np.int64)
            diff = planes_.copy()
            diff[:, per:] = planes_[:, per:] - planes_[:, :-per]
            return (diff & 255).astype(np.uint8).tobytes()
        return v.astype(v.dtype.newbyteorder(order)).tobytes()

    chunks, tables = [], None
    for plane in range(planes):
        for y in range(0, h, tl):
            for x in range(0, w, tw) if tile else (0,):
                sl = slice(plane, plane + 1) if planar == 2 else slice(None)
                block = s[y:y + tl, x:x + tw, sl]
                if tile:
                    block = np.pad(block, ((0, tl - block.shape[0]),
                                           (0, tw - block.shape[1]), (0, 0)))
                if compression == 7:
                    bands = [block[..., k].astype(np.uint8)
                             for k in range(block.shape[2])]
                    factors = [subsampling] + [(1, 1)] * 2 if subsampling \
                        else None
                    tables, raw = jpeg_abbreviate(write_jpeg(
                        bands, factors, jfif=False))
                    chunks.append(raw)
                    continue
                raw = chunk_bytes(block)
                if compression == 32773:
                    raw = packbits(raw)
                elif compression == 5:
                    raw = tiff_lzw(raw, old_lzw)
                elif compression == 34925:
                    import lzma

                    raw = lzma.compress(raw, lzma.FORMAT_XZ)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw, 6)
                if fill_order == 2:
                    raw = raw.translate(_BITREV)
                chunks.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if sample_format != 1:
        tags[339] = (3, [sample_format] * spp)
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(colormap))
    if orientation is not None:
        tags[274] = (3, [orientation])
    if subsampling:
        tags[530] = (3, list(subsampling))
    if coefficients:
        tags[529] = (5, [int(x) for pair in coefficients for x in pair])
    if reference:
        tags[532] = (5, [int(x) for pair in reference for x in pair])
    if tables is not None:
        tags[347] = (7, list(tables))
    if tile:
        tags[322], tags[323] = (4, [tw]), (4, [tl])
    else:
        tags[278] = (4, [tl])
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    head = 16 if big else 8
    body = b"".join(chunks)
    offsets = np.cumsum([0] + [len(c) for c in chunks[:-1]]) + head
    off_type = 16 if big else 4
    tags[off_tag] = (off_type, [int(o) for o in offsets])
    tags[cnt_tag] = (off_type, [len(c) for c in chunks])
    codes = {3: "H", 4: "L", 5: "L", 7: "B", 16: "Q"}
    ifd_pos = head + len(body) + (len(body) & 1)
    inline = 8 if big else 4
    entry = 20 if big else 12
    n = len(tags)
    extra_pos = ifd_pos + (8 if big else 2) + n * entry + (8 if big else 4)
    entries, spill = b"", b""
    for tag in sorted(tags):
        typ, values = tags[tag]
        payload = struct.pack(f"{order}{len(values)}{codes[typ]}", *values)
        if len(payload) <= inline:
            value = payload.ljust(inline, b"\x00")
        else:
            value = struct.pack(order + ("Q" if big else "L"),
                                extra_pos + len(spill))
            spill += payload + b"\x00" * (len(payload) & 1)
        count = len(values) // 2 if typ == 5 else len(values)
        entries += struct.pack(order + ("HHQ" if big else "HHL"), tag, typ,
                               count) + value
    bo = b"II" if order == "<" else b"MM"
    if big:
        header = bo + struct.pack(order + "HHHQ", 43, 8, 0, ifd_pos)
        ifd = struct.pack(order + "Q", n) + entries + struct.pack(
            order + "Q", 0)
    else:
        header = bo + struct.pack(order + "HL", 42, ifd_pos)
        ifd = struct.pack(order + "H", n) + entries + struct.pack(
            order + "L", 0)
    return header + body + b"\x00" * (len(body) & 1) + ifd + spill


def jpeg_split(data):
    """A JPEG -> (SOI and each marker segment before the first SOS, the
    bytes from that SOS on); joined, the first is a BLP1's shared JPEG
    header and the second its first mip."""
    segs, pos = [data[:2]], 2
    while data[pos + 1] != 0xDA:
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        segs.append(data[pos:pos + 2 + length])
        pos += 2 + length
    return segs, data[pos:]


def jpeg_abbreviate(data):
    """A JPEG -> (its tables as an abbreviated stream: SOI, DQT, DHT, EOI;
    the stream without them), as JPEG-in-TIFF stores a strip or tile."""
    segs, scan = jpeg_split(data)
    tables = b"".join(s for s in segs if s[1] in (0xDB, 0xC4))
    image = b"".join(s for s in segs if s[1] not in (0xDB, 0xC4))
    return b"\xff\xd8" + tables + b"\xff\xd9", image + scan


def write_ppm(samples, magic="P6", maxval=255, plain_width=70):
    """A Netpbm file: ``magic`` P1-P6 (P1 / P4 take 0 / 1 with 1 black),
    P0CMYK / PyP / PyRGBA / PyCMYK (Pillow's own), with a comment in the
    header; ``maxval`` above 255 stores two bytes big-endian; the plain
    forms (P1-P3) wrap their lines at ``plain_width`` characters. "Pf":
    ``samples`` f32 [H, W], written bottom-up, little-endian (scale -1)."""
    import numpy as np

    h, w = samples.shape[:2]
    head = f"{magic}\n# written by chip_smoke.py\n{w} {h}\n".encode()
    if magic == "Pf":
        return head + b"-1.0\n" + samples[::-1].astype("<f4").tobytes()
    if magic in ("P1", "P4"):
        if magic == "P4":
            return head + np.packbits(samples.astype(np.uint8), axis=1
                                      ).tobytes()
        text = " ".join(str(int(v)) for v in samples.reshape(-1))
    else:
        head += f"{maxval}\n".encode()
        if magic in ("P2", "P3"):
            text = " ".join(str(int(v)) for v in samples.reshape(-1))
        else:
            dt = ">u2" if maxval > 255 else "u1"
            return head + samples.astype(dt).tobytes()
    lines, line = [], ""
    for tok in text.split(" "):
        if len(line) + len(tok) + 1 > plain_width:
            lines.append(line)
            line = tok
        else:
            line = f"{line} {tok}" if line else tok
    lines.append(line)
    return head + ("\n".join(lines) + "\n").encode()


def write_qoi(pixels):
    """A QOI file of RGB [H, W, 3] or RGBA [H, W, 4] u8: the reference
    encoder's ops (runs, the 64-entry index, small differences, luma,
    full RGB / RGBA)."""
    h, w, c = pixels.shape
    px = pixels.reshape(-1, c).tolist()
    out = bytearray(b"qoif" + struct.pack(">IIBB", w, h, c, 0))
    index = [(0, 0, 0, 0)] * 64
    prev, run = (0, 0, 0, 255), 0
    for k, p in enumerate(px):
        cur = tuple(p) + ((255,) if c == 3 else ())
        if cur == prev:
            run += 1
            if run == 62 or k == len(px) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        r, g, b, a = cur
        slot = (r * 3 + g * 5 + b * 7 + a * 11) % 64
        if index[slot] == cur:
            out.append(slot)
        else:
            index[slot] = cur
            if a != prev[3]:
                out += bytes((0xFF, r, g, b, a))
            else:
                dr, dg, db = ((r - prev[0] + 128) % 256 - 128,
                              (g - prev[1] + 128) % 256 - 128,
                              (b - prev[2] + 128) % 256 - 128)
                if -2 <= dr < 2 and -2 <= dg < 2 and -2 <= db < 2:
                    out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2
                               | (db + 2))
                elif -32 <= dg < 32 and -8 <= dr - dg < 8 \
                        and -8 <= db - dg < 8:
                    out += bytes((0x80 | (dg + 32),
                                  (dr - dg + 8) << 4 | (db - dg + 8)))
                else:
                    out += bytes((0xFE, r, g, b))
        prev = cur
    return bytes(out + b"\x00" * 7 + b"\x01")


def write_ico(entries, cursor=False):
    """An ICO (``cursor``: CUR) of ``entries`` [(kind, data, (w, h),
    bits)]: kind "png" with PNG bytes, or "bmp" with a DIB (write_bmp's
    file_header=False) whose header height is doubled and an AND mask
    (bool [h, w], True transparent) appended, 1 bit a pixel, rows of 32
    bits, bottom-up; the directory's width, height and bit count as
    given (256 written as 0)."""
    import numpy as np

    blobs = []
    for kind, data, (w, h), bits, *mask in entries:
        if kind == "bmp":
            data = data[:8] + struct.pack("<i", 2 * h) + data[12:]
            m = mask[0] if mask else np.zeros((h, w), bool)
            m = np.pad(m[::-1].astype(np.uint8), ((0, 0), (0, -w % 32)))
            data += np.packbits(m, axis=1).tobytes()
        blobs.append(data)
    out = struct.pack("<HHH", 0, 2 if cursor else 1, len(entries))
    off = 6 + 16 * len(entries)
    for (kind, data, (w, h), bits, *_), blob in zip(entries, blobs):
        out += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0,
                           0 if not cursor else 1, bits if not cursor else 1,
                           len(blob), off)
        off += len(blob)
    return out + b"".join(blobs)


def write_psd(bands, psd_mode, bits=8, compression=0, color_data=b"",
              resources=(), layers=b"", version=1):
    """A PSD of ``bands`` (u8 [H, W] planes; 0 / 1 at ``bits`` 1; 16 bits
    big-endian), ``psd_mode`` Photoshop's colour mode (0 bitmap, 1 gray,
    2 indexed, 3 RGB, 4 CMYK, 7 multichannel, 8 duotone, 9 LAB),
    ``color_data`` the colour-mode section (an indexed file's 768-byte
    palette, a plane a colour), ``resources`` [(id, name, body)],
    ``layers`` the layer and mask section's bytes (not parsed by
    readers of the composite); ``compression`` 0 (raw planes) or 1
    (PackBits rows behind their byte counts)."""
    import numpy as np

    h, w = bands[0].shape

    def rows(b):
        if bits == 1:
            return np.packbits(b.astype(np.uint8) & 1, axis=1)
        return b.astype(f">u{bits // 8}").view(np.uint8).reshape(h, -1)

    out = b"8BPS" + struct.pack(">H6xHIIHH", version, len(bands), h, w,
                                bits, psd_mode)
    out += struct.pack(">I", len(color_data)) + color_data
    res = b""
    for rid, name, body in resources:
        pascal = bytes([len(name)]) + name
        pascal += b"\x00" * (len(pascal) % 2)
        res += (b"8BIM" + struct.pack(">H", rid) + pascal
                + struct.pack(">I", len(body)) + body
                + b"\x00" * (len(body) % 2))
    out += struct.pack(">I", len(res)) + res
    out += struct.pack(">I", len(layers)) + layers
    out += struct.pack(">H", compression)
    planes = [rows(b) for b in bands]
    if compression == 1:
        packed = [packbits(r.tobytes()) for plane in planes for r in plane]
        return (out + b"".join(struct.pack(">H", len(p)) for p in packed)
                + b"".join(packed))
    return out + b"".join(p.tobytes() for p in planes)


def _sgi_rle(row, bpc):
    """An SGI RLE row of atoms (``bpc`` bytes, big-endian): runs of 3 or
    more repeated (count, atom), literals (0x80 | count, atoms), counts up
    to 127, then a zero atom."""
    c = "B" if bpc == 1 else "H"
    out, i, n = b"", 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 126:
            j += 1
        if j - i >= 2:
            out += struct.pack(">" + c * 2, j - i + 1, int(row[i]))
            i = j + 1
            continue
        j = i
        while j < n and j - i < 127 and not (
                j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        out += struct.pack(f">{1 + j - i}{c}", 0x80 | (j - i),
                           *(int(v) for v in row[i:j]))
        i = j
    return out + struct.pack(">" + c, 0)


def write_sgi(samples, bpc=1, rle=False, dimension=None):
    """An SGI image of ``samples`` [H, W] or [H, W, Z] (values below
    2^(8 bpc)), stored bottom up, a plane a channel: verbatim or RLE
    (the offset and length tables, then each row's runs)."""
    import numpy as np

    s = samples[..., None] if samples.ndim == 2 else samples
    h, w, z = s.shape
    dim = dimension or (3 if z > 1 else 2)
    head = struct.pack(">hBBHHHHll4s80sl404s", 474, int(rle), bpc, dim, w,
                       h, z, 0, (1 << 8 * bpc) - 1, b"", b"", 0, b"")
    rows = s[::-1].transpose(2, 0, 1)            # [z, h, w], bottom row 1st
    if not rle:
        return head + rows.astype(f">u{bpc}").tobytes()
    runs = [_sgi_rle(row, bpc) for plane in rows for row in plane]
    off = 512 + 8 * len(runs)
    starts = np.cumsum([0] + [len(r) for r in runs[:-1]]) + off
    return (head + struct.pack(f">{len(runs)}I", *(int(v) for v in starts))
            + struct.pack(f">{len(runs)}I", *(len(r) for r in runs))
            + b"".join(runs))


def write_blp(version, w, h, body, compression=1, encoding=1, alpha=0,
              alpha_encoding=0, palette=None, jpeg_header=b""):
    """A BLP1 or BLP2 (``version`` 1 / 2) of ``w`` x ``h`` with one mip,
    ``body``: compression 0 (BLP1: a JPEG, ``jpeg_header`` its shared
    header, ``body`` the mip's bytes after it) or 1 (``encoding`` 1 (BLP2)
    or 4 / 5 (BLP1) palette indices with ``palette`` [256, 4] BGRA, or 2
    (BLP2) DXT blocks by ``alpha_encoding`` 0 / 1 / 7); ``alpha`` the
    alpha depth."""
    import numpy as np

    pal = b"" if palette is None else np.asarray(
        palette, np.uint8).reshape(-1, 4)[:256].tobytes().ljust(1024,
                                                                b"\x00")
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h,
                                     encoding, 0)
        extra = (struct.pack("<I", len(jpeg_header)) + jpeg_header
                 if compression == 0 else pal)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding,
                                     alpha, alpha_encoding, 1, w, h)
        extra = pal or bytes(1024)
    off = len(head) + 128 + len(extra)
    return (head + struct.pack("<16I", off, *[0] * 15)
            + struct.pack("<16I", len(body), *[0] * 15) + extra + body)


def write_ftex(w, h, body, fmt=1):
    """An FTEX texture of one mip and one format: ``fmt`` 0 (DXT1 blocks)
    or 1 (raw RGB)."""
    return (b"FTEX" + struct.pack("<iiiiiii", 1, w, h, 1, 1, fmt, 32)
            + struct.pack("<i", len(body)) + body)


def pcx_rle(data):
    """PCX run-length coding of one row: runs of 2-63 (and any byte of
    0xC0 or more) as (0xC0 | count, byte), single bytes as they are."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 62:
            j += 1
        if j > i or data[i] >= 0xC0:
            out += bytes((0xC0 | (j - i + 1), data[i]))
        else:
            out.append(data[i])
        i = j + 1
    return bytes(out)


def write_pcx(samples, bits=8, planes=1, version=5, palette=None,
              ega=None, stride=None):
    """A PCX of ``samples``: [H, W] 0 / 1 (``bits`` 1, 1 plane), [H, W]
    indices below 2^planes (``bits`` 1, ``planes`` 2 or 4: bit planes,
    ``ega`` the header's 16-colour palette [16, 3]), [H, W] bytes (8 bits,
    ``palette`` [256, 3] appended after 0x0C), [H, W, 3] (8 bits, 3
    planes: a colour line each); each row's planes run-length coded
    together, ``stride`` bytes a plane line (default even)."""
    import numpy as np

    h, w = samples.shape[:2]
    need = (w * bits + 7) // 8
    stride = stride or need + need % 2
    if bits == 1:
        lines = [np.packbits((samples >> k) & 1, axis=1)
                 for k in range(planes)]
    elif samples.ndim == 3:
        lines = [samples[..., k] for k in range(planes)]
    else:
        lines = [samples]
    lines = [np.pad(ln.astype(np.uint8), ((0, 0), (0, stride - ln.shape[1])))
             for ln in lines]
    rows = np.concatenate(lines, 1)
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1,
                       h - 1, 72, 72)
    head += (np.zeros((16, 3), np.uint8) if ega is None else np.asarray(
        ega, np.uint8)).tobytes()
    head += struct.pack("<BBHHHH", 0, planes, stride, 1, 0, 0).ljust(64,
                                                                      b"\x00")
    body = b"".join(pcx_rle(r.tobytes()) for r in rows)
    tail = b"" if palette is None else b"\x0c" + np.asarray(
        palette, np.uint8).tobytes()
    return head + body + tail


def write_dcx(pages):
    """A DCX of PCX ``pages``: the offset table (ended by 0), then the
    pages."""
    off = 4 + 4 * (len(pages) + 1)
    table = []
    for page in pages:
        table.append(off)
        off += len(page)
    return (b"\xb1\x68\xde\x3a" + struct.pack(f"<{len(pages) + 1}I",
                                              *table, 0) + b"".join(pages))


def grid_gltf_source(n, width, height, device):
    """Config 2's textured grid (scenes.build_textured_grid's geometry,
    instances, camera and textures) as glTF carries it: the occlusion map
    quantized to u8 (a PNG holds no floats) and material "b" a 50% BLEND
    glass; built directly on `device` with two translucent layers. Returns
    (engine, pass, camera, write_glb arguments)."""
    import numpy as np

    from paperrenderer_tpu_torch.scenes import _grid_textures

    tex = _grid_textures(0)
    occ = tex[1]["occlusion_texture"]
    tex[1]["occlusion_texture"] = (np.clip(occ, 0, 1) * 255 + 0.5).astype(
        np.uint8)
    return grid_glb_spec(n, width, height, device, tex)


def grid_glb_spec(n, width, height, device, tex, images=None):
    """Config 2's grid built directly on `device` with the four materials'
    textures `tex` (material "b" made a 50% BLEND glass, two translucent
    layers), and its write_glb arguments: the materials' images are
    `images` [{texture key: encoded bytes}] where given, else the arrays.
    Returns (engine, pass, camera, write_glb arguments)."""
    from paperrenderer_tpu_torch.core import SHADE_TRANSLUCENT
    from paperrenderer_tpu_torch.core.geometry import make_cube, make_icosphere
    from paperrenderer_tpu_torch.scenes import build_dynamic_scene

    tex[1].update(shading_model=SHADE_TRANSLUCENT, alpha=0.5)
    eng, rp, cam = build_dynamic_scene(n, width, height, device=device,
                                       textures=tex)
    rp.translucent_layers = 2
    rows = [v for v in rp.materials.rows()[1:5]]
    names = "abcd"
    keys = ("base_texture", "mr_texture", "emissive_texture",
            "occlusion_texture")
    mats = [dict(name=names[k], albedo=rows[k]["albedo"],
                 alpha=rows[k]["alpha"], roughness=rows[k]["roughness"],
                 metallic=rows[k]["metallic"], emissive=rows[k]["emissive"],
                 blend=rows[k]["shading_model"] == SHADE_TRANSLUCENT,
                 textures=(images[k] if images else
                           {key: rows[k][key] for key in keys
                            if rows[k][key] is not None}))
            for k in range(4)]
    cube, ball = make_cube(size=0.5), make_icosphere(radius=0.3,
                                                     subdivisions=1)
    # glTF binds materials to meshes: instance k (mesh k % 2, material
    # k % 4) becomes node k of mesh k % 4
    meshes = [(f"{'cube' if k % 2 == 0 else 'ball'}_{names[k]}",
               cube if k % 2 == 0 else ball, k) for k in range(4)]
    translations = [i.position for i in rp.scene.instances]
    return eng, rp, cam, (meshes, mats, translations)


# the grid's images in the JPEG and PNG forms an imaging library decodes
# beyond baseline / progressive JPEG and 8/16-bit PNG: (material, texture
# key, form); material "d" gains a second occlusion map
GLTF_FORMS = ((0, "base_texture", "arithmetic progressive"),
              (0, "mr_texture", "lossless"),
              (1, "base_texture", "CMYK (Adobe)"),
              (1, "occlusion_texture", "4-bit gray PNG"),
              (2, "base_texture", "YCCK"),
              (2, "mr_texture", "4:4:0"),
              (3, "base_texture", "block-smoothed progressive"),
              (3, "emissive_texture", "4:1:1"),
              (3, "occlusion_texture", "1-bit gray PNG"))


def encode_form(form, img):
    """`img` (u8 [H, W, 3]; [H, W] for the gray PNGs) in a GLTF_FORMS
    form, written so that it decodes to about the same picture."""
    import numpy as np

    ycc = rgb_to_ycc(img) if img.ndim == 3 else None
    if form == "arithmetic progressive":    # DAC conditioning, restarts
        return write_jpeg(ycc, [(2, 2), (1, 1), (1, 1)], coding="arithmetic",
                          script=progressive_script(3), restart=64,
                          dac=({0: (1, 4)}, {0: 8}))
    if form == "lossless":                  # predictor 7, RGB ids
        return write_lossless_jpeg([img[..., k] for k in range(3)], 7,
                                   restart_rows=64, ids=[82, 71, 66])
    no_black = np.full(img.shape[:2], 255, np.uint8)   # Adobe's inverted K
    if form == "CMYK (Adobe)":              # C, M, Y read inverted: R, G, B
        return write_jpeg([img[..., k] for k in range(3)] + [no_black],
                          adobe=0, jfif=False)
    if form == "YCCK":                      # YCbCr of the inverted RGB
        return write_jpeg(rgb_to_ycc(255 - img) + [no_black],
                          [(2, 2), (1, 1), (1, 1), (2, 2)], adobe=2,
                          jfif=False)
    if form in ("4:4:0", "4:1:1"):
        return write_jpeg(ycc, [(1, 2) if form == "4:4:0" else (4, 1),
                                (1, 1), (1, 1)], restart=16)
    if form == "block-smoothed progressive":   # the refinement scans cut
        return drop_scans(write_jpeg(ycc, [(2, 2), (1, 1), (1, 1)],
                                     coding="arithmetic",
                                     script=progressive_script(3)),
                          lambda sel, ss, se, ah, al: ah > 0)
    depth = 4 if form == "4-bit gray PNG" else 1
    return write_png_gray(img >> (8 - depth), depth)


# the grid's images in the container formats: (material, texture key, form)
GLTF_CONTAINERS = ((0, "base_texture", "WebP lossy"),
                   (1, "base_texture", "WebP lossy with alpha"),
                   (3, "emissive_texture", "WebP lossless"),
                   (2, "mr_texture", "BMP RLE8"),
                   (0, "mr_texture", "BMP 5-6-5"),
                   (2, "base_texture", "TGA 32-bit run-length, top-left"),
                   (1, "occlusion_texture", "TGA 8-bit gray"),
                   (3, "occlusion_texture",
                    "GIF interlaced, transparency index"),
                   (3, "base_texture", "BMP V5 with an alpha mask"))
# the grid's images in the second part's container formats
GLTF_CONTAINERS2 = ((0, "base_texture", "DDS BC1"),
                    (1, "base_texture", "DDS BC3 with alpha"),
                    (2, "base_texture", "DDS BC7 mode 6"),
                    (1, "occlusion_texture", "DDS BC4"),
                    (0, "mr_texture", "TIFF LZW, predictor 2"),
                    (3, "base_texture", "TIFF tiled deflate RGBA"),
                    (3, "occlusion_texture", "BigTIFF PackBits 16-bit gray"),
                    (2, "mr_texture", "PPM binary (P6)"),
                    (3, "emissive_texture", "QOI RGBA"))
# the grid's images in the third part's container formats
GLTF_CONTAINERS3 = ((0, "base_texture", "PSD RLE RGBA"),
                    (1, "base_texture", "PSD raw CMYK"),
                    (2, "base_texture", "TIFF JPEG YCbCr 4:2:0, tiled"),
                    (3, "base_texture", "BLP2 DXT5"),
                    (0, "mr_texture", "TIFF LZMA, predictor 2"),
                    (2, "mr_texture", "BLP1 JPEG"),
                    (3, "emissive_texture", "FTEX DXT1"),
                    (1, "occlusion_texture", "SGI RLE RGBA"),
                    (3, "occlusion_texture", "PCX 24-bit"))
# the WebP files, written by tests/data/webp/make_webp.py (libwebp 1.6.0)
WEBP_FILES = {"WebP lossy": "base0_lossy.webp",
              "WebP lossy with alpha": "base1_alpha.webp",
              "WebP lossless": "emissive3_lossless.webp"}


def alpha_pattern(h, w):
    """A seeded alpha for the container forms: opaque, with translucent
    discs and a transparent band."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    a = np.full((h, w), 255, np.uint8)
    for cy, cx, r in np.random.default_rng(7).uniform(0.1, 0.9, (6, 3)):
        a[(yy - cy) ** 2 + (xx - cx) ** 2 < (0.15 * r) ** 2] = 160
    a[(yy > 0.45) & (yy < 0.5)] = 0
    return a


def encode_container(form, img):
    """`img` (u8 [H, W, 3]; [H, W] for the gray maps) in a GLTF_CONTAINERS
    form: the WebP forms are the committed files (written from the same
    textures), the others numpy-only writers' files."""
    import numpy as np

    if form in WEBP_FILES:
        with open(os.path.join(HERE, "tests", "data", "webp",
                               WEBP_FILES[form]), "rb") as f:
            return f.read()
    if form == "BMP RLE8":   # green and blue to 16 levels each: 256 colours
        idx = ((img[..., 1] >> 4) << 4 | img[..., 2] >> 4).astype(np.uint8)
        k = np.arange(256)
        pal = np.stack([np.zeros(256), (k >> 4) * 17, (k & 15) * 17],
                       -1).astype(np.uint8)
        return write_bmp(idx, 8, pal, compression=1)
    if form == "BMP 5-6-5":
        return write_bmp(pack_rgb(img), 16, compression=3,
                         masks=(0xF800, 0x7E0, 0x1F))
    alpha = alpha_pattern(*img.shape[:2])
    rgba = np.concatenate([img, alpha[..., None]], -1) if img.ndim == 3 \
        else None
    if form == "TGA 32-bit run-length, top-left":
        return write_tga(rgba, 10, 32, origin="top-left", alpha_bits=8)
    if form == "TGA 8-bit gray":
        return write_tga(img, 3, 8)
    if form == "GIF interlaced, transparency index":   # reversed gray table
        k = np.arange(256, dtype=np.uint8)
        pal = np.stack([255 - k] * 3, -1)
        return write_gif([(255 - img, 0, 0, None, True)], pal,
                         transparency=0)
    masks = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)    # BMP V5, alpha mask
    return write_bmp(pack_masks(rgba, masks), 32, compression=3, masks=masks,
                     header=124)


def encode_container2(form, img):
    """`img` (u8 [H, W, 3]; [H, W] for the gray maps) in a GLTF_CONTAINERS2
    form, by the numpy-only writers (write_dds, write_tiff, write_ppm,
    write_qoi); alpha_pattern's alpha where the form has alpha."""
    import numpy as np

    h, w = img.shape[:2]
    rgba = np.concatenate([img, alpha_pattern(h, w)[..., None]], -1) \
        if img.ndim == 3 else None
    if form.startswith("DDS"):
        kind, fourcc, dxgi = {"DDS BC1": (1, b"DXT1", None),
                              "DDS BC3 with alpha": (3, b"DXT5", None),
                              "DDS BC7 mode 6": (7, b"DX10", 98),
                              "DDS BC4": (4, b"ATI1", None)}[form]
        return write_dds(w, h, encode_bcn(rgba if kind == 3 else img, kind),
                         fourcc, dxgi)
    if form == "TIFF LZW, predictor 2":
        return write_tiff(img, compression=5, predictor=2, rows_per_strip=32)
    if form == "TIFF tiled deflate RGBA":
        return write_tiff(rgba, compression=8, tile=(256, 256), extra=(2,))
    if form == "BigTIFF PackBits 16-bit gray":   # values 0-255: the same gray
        return write_tiff(img.astype(np.uint16), bits=16, compression=32773,
                          big=True, rows_per_strip=64)
    if form == "PPM binary (P6)":
        return write_ppm(img, "P6")
    return write_qoi(rgba)


def encode_container3(form, img):
    """`img` (u8 [H, W, 3]; [H, W] for the gray maps, repeated to RGB) in a
    GLTF_CONTAINERS3 form, by the numpy-only writers (write_psd,
    write_tiff, write_blp, write_ftex, write_sgi, write_pcx);
    alpha_pattern's alpha where the form has alpha."""
    import numpy as np

    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    h, w = img.shape[:2]
    rgba = np.concatenate([img, alpha_pattern(h, w)[..., None]], -1)
    if form == "PSD RLE RGBA":
        return write_psd([rgba[..., k] for k in range(4)], 3, compression=1)
    if form == "PSD raw CMYK":     # read inverted, no black: the RGB back
        return write_psd([img[..., k] for k in range(3)]
                         + [np.full((h, w), 255, np.uint8)], 4)
    if form == "TIFF JPEG YCbCr 4:2:0, tiled":
        return write_tiff(np.stack(rgb_to_ycc(img), -1), photometric=6,
                          compression=7, subsampling=(2, 2),
                          tile=(256, 256))
    if form == "TIFF LZMA, predictor 2":
        return write_tiff(img, compression=34925, predictor=2,
                          rows_per_strip=64)
    if form == "BLP2 DXT5":
        return write_blp(2, w, h, encode_bcn(rgba, 3), encoding=2,
                         alpha=8, alpha_encoding=7)
    if form == "BLP1 JPEG":        # read back as BGR: written as B, G, R
        head, body = jpeg_split(write_jpeg(rgb_to_ycc(img[..., ::-1]),
                                           [(2, 2), (1, 1), (1, 1)]))
        return write_blp(1, w, h, body, compression=0, encoding=0,
                         jpeg_header=b"".join(head))
    if form == "FTEX DXT1":
        return write_ftex(w, h, encode_bcn(img, 1), 0)
    if form == "SGI RLE RGBA":
        return write_sgi(rgba, rle=True)
    return write_pcx(img, 8, 3)


def grid_forms_source(n, width, height, device, forms=GLTF_FORMS,
                      encode=encode_form):
    """Config 2's textured grid with its images in the `forms` (GLTF_FORMS,
    GLTF_CONTAINERS or GLTF_CONTAINERS2) as `encode` writes them, each
    decoded by read_image (timed) for the directly built scene. Returns
    (engine, pass, camera, write_glb arguments, {form: size, bytes, decode
    seconds})."""
    import numpy as np

    from paperrenderer_tpu_torch.io.image import read_image
    from paperrenderer_tpu_torch.scenes import _grid_textures

    tex = _grid_textures(0)
    occ = (np.clip(tex[1]["occlusion_texture"], 0, 1) * 255 + 0.5).astype(
        np.uint8)
    tex[1]["occlusion_texture"], tex[3]["occlusion_texture"] = occ, occ.T
    images, decode = [{} for _ in tex], {}
    for k, key, form in forms:
        t0 = time.perf_counter()
        data = encode(form, tex[k][key])
        t1 = time.perf_counter()
        tex[k][key] = read_image(data)
        decode[form] = dict(size="%dx%d" % tex[k][key].shape[1::-1],
                            bytes=len(data), encode_seconds=t1 - t0,
                            decode_seconds=time.perf_counter() - t1)
        images[k][key] = data
    return (*grid_glb_spec(n, width, height, device, tex, images), decode)


def gltf_scene(path, lights, width, height, device):
    """load_gltf + instantiate into a new engine's RenderPass (two
    translucent layers) and RayTraceRender / HybridRender mirroring it ->
    (dict of renders, load seconds, instantiate seconds)."""
    from paperrenderer_tpu_torch.core import RenderEngine
    from paperrenderer_tpu_torch.io import instantiate, load_gltf

    eng = RenderEngine(device=device, device_check=False)
    t0 = time.perf_counter()
    gs = load_gltf(path, eng.scene.arena)
    load_s = time.perf_counter() - t0
    rp = eng.create_render_pass(width=width, height=height, lights=lights,
                                translucent_layers=2)
    t0 = time.perf_counter()
    instantiate(gs, rp)
    inst_s = time.perf_counter() - t0
    return mirrors(eng, rp, lights, width, height), load_s, inst_s


def mirrors(eng, rp, lights, width, height):
    """{static, draw_list, rt, hybrid} renders over one RenderPass's
    instances (the RT and hybrid renders adopt its bindings)."""
    kw = dict(width=width, height=height, lights=lights)
    rt = eng.create_ray_trace_render(**kw)
    rt.add_instances_from(rp)
    hy = eng.create_hybrid_render(**kw)
    hy.add_instances_from(rp)
    return dict(static=rp, draw_list=rp, rt=rt, hybrid=hy)


def render_four(renders, cam):
    return {name: r.render(cam, **({"static_path": False}
                                   if name == "draw_list" else {}))[0]
            for name, r in renders.items()}


def first_difference(a, b):
    """The first differing input of two renders' frames (instance SoA,
    material table, atlas), or None."""
    import torch

    ia, ib = a.scene.flush(), b.scene.flush()
    n = a.scene.count
    if n != b.scene.count:
        return f"instance count {n} != {b.scene.count}"
    for f in ("pos", "scale", "quat"):
        if not torch.equal(getattr(ia, f)[:n], getattr(ib, f)[:n]):
            return f"instances.{f}"
    ta, tb = a.materials.table(), b.materials.table()
    for f in dataclasses.fields(ta):
        if not torch.equal(getattr(ta, f.name), getattr(tb, f.name)):
            return f"material table {f.name}"
    xa, xb = a.materials.texture_arrays(), b.materials.texture_arrays()
    if not torch.equal(xa.pairs, xb.pairs):
        return "texture atlas"
    return "none of instances, materials, atlas"


def gltf_phase(work_dir, n=10_000, width=1920, height=1080,
               small=(400, 128, 64)):
    """glTF import: config 2's textured grid written as a .glb (write_glb),
    loaded with load_gltf + instantiate on the card and rendered at
    `width` x `height` through the static frame (two translucent layers),
    the draw-list frame, RayTraceRender and HybridRender, each held with
    the golden bands (and bitwise) to the same frame of the scene built
    directly; load/instantiate seconds and frame ms; a `small` copy on the
    card against the port's CPU frames (mean |diff| <= 1e-5)."""
    import numpy as np

    os.makedirs(work_dir, exist_ok=True)
    eng, rp, cam, spec = grid_gltf_source(n, width, height, "cuda")
    path = os.path.join(work_dir, f"grid{n}.glb")
    t0 = time.perf_counter()
    nbytes = write_glb(path, *spec)
    out = dict(glb_bytes=nbytes, write_seconds=time.perf_counter() - t0,
               substitutions="occlusion u8 (PNG); material b BLEND 50%")
    direct = mirrors(eng, rp, rp.lights, width, height)
    loaded, load_s, inst_s = gltf_scene(path, rp.lights, width, height,
                                        "cuda")
    out.update(load_seconds=load_s, instantiate_seconds=inst_s,
               instances=loaded["static"].scene.count)
    ok = loaded["static"].scene.count == n
    want = {k: v.cpu().numpy() for k, v in render_four(direct, cam).items()}
    got = {k: v.cpu().numpy() for k, v in render_four(loaded, cam).items()}
    for name in want:
        good, mean, frac = bands(got[name], want[name])
        same = bool(np.array_equal(got[name], want[name]))
        r = loaded[name]
        kw = {"static_path": False} if name == "draw_list" else {}
        case = dict(ok=good, mean=mean, frac=frac, bitwise=same,
                    finite=bool(np.isfinite(got[name]).all()),
                    ms=frame_ms(r, cam, frames=10, warmup=2, **kw),
                    direct_ms=frame_ms(direct[name], cam, frames=10,
                                       warmup=2, **kw))
        if name in ("rt", "hybrid"):
            case["paged"] = r.accel.prefer_paged(r.scene.flush().capacity) \
                if name == "rt" else None
        if not same:
            case["first_difference"] = first_difference(
                r if name != "hybrid" else r._rp,
                direct[name] if name != "hybrid" else direct[name]._rp)
        out[name] = case
        ok &= good and case["finite"]
    # a small copy, card against CPU
    ns, ws, hs = small
    eng_s, rp_s, cam_s, spec_s = grid_gltf_source(ns, ws, hs, "cpu")
    path_s = os.path.join(work_dir, f"grid{ns}.glb")
    write_glb(path_s, *spec_s)
    frames = {}
    for dev in ("cuda", "cpu"):
        lights = rp_s.lights.to(dev)
        renders, _, _ = gltf_scene(path_s, lights, ws, hs, dev)
        frames[dev] = {k: v.cpu().numpy()
                       for k, v in render_four(renders, cam_s).items()}
    small_out = {}
    for name in frames["cpu"]:
        d = np.abs(frames["cuda"][name] - frames["cpu"][name]).max(axis=-1)
        small_out[name] = dict(mean=float(d.mean()), max=float(d.max()),
                               ok=float(d.mean()) <= 1e-5)
        ok &= small_out[name]["ok"]
    out["card_vs_cpu_%d_%dx%d" % small] = small_out
    del eng, rp, direct, loaded, eng_s, rp_s
    forms = gltf_forms_case(work_dir, n, width, height)
    out["forms"] = forms
    containers = gltf_forms_case(work_dir, n, width, height, GLTF_CONTAINERS,
                                 encode_container, "containers")
    out["containers"] = containers
    containers2 = gltf_forms_case(work_dir, n, width, height,
                                  GLTF_CONTAINERS2, encode_container2,
                                  "containers2")
    out["containers2"] = containers2
    containers3 = gltf_forms_case(work_dir, n, width, height,
                                  GLTF_CONTAINERS3, encode_container3,
                                  "containers3")
    out["containers3"] = containers3
    return dict(ok=ok and forms.pop("ok") and containers.pop("ok")
                and containers2.pop("ok") and containers3.pop("ok"), **out)


def gltf_forms_case(work_dir, n, width, height, forms=GLTF_FORMS,
                    encode=encode_form, tag="forms"):
    """The grid again with its images in the `forms` (grid_forms_source)
    written as a .glb, loaded with load_gltf + instantiate on the card and
    rendered through the four frames, each held bitwise to the frame of the
    scene built directly from read_image of the same bytes; the seconds to
    encode and decode each form at its size, beside the card's name and
    power limit."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    torch.cuda.empty_cache()
    eng, rp, cam, spec, decode = grid_forms_source(n, width, height, "cuda",
                                                   forms, encode)
    path = os.path.join(work_dir, f"grid{n}_{tag}.glb")
    out = dict(card=smi, decode=decode, glb_bytes=write_glb(path, *spec))
    print(f"gltf {tag}, {smi}: " + "; ".join(
        f"{form} {d['size']} {d['decode_seconds']:.3f} s"
        for form, d in decode.items()), flush=True)
    direct = mirrors(eng, rp, rp.lights, width, height)
    loaded, out["load_seconds"], out["instantiate_seconds"] = gltf_scene(
        path, rp.lights, width, height, "cuda")
    ok = loaded["static"].scene.count == n
    want, got = render_four(direct, cam), render_four(loaded, cam)
    for name in want:
        same = bool(torch.equal(got[name], want[name]))
        finite = bool(torch.isfinite(got[name]).all())
        out[name] = dict(bitwise=same, finite=finite)
        if not same:
            r = loaded[name]
            out[name]["first_difference"] = first_difference(
                r if name != "hybrid" else r._rp,
                direct[name] if name != "hybrid" else direct[name]._rp)
        ok &= same and finite
    return dict(ok=ok, **out)


def viewer_phase(size=512, window_s=3.0, device="cuda"):
    """The live viewer over the example scene at `size`: modes raster, rt
    and hybrid, each warmed up by one direct render (kernel builds off the
    render thread). Over 127.0.0.1: the page; /frame.png against a direct
    render of the same camera, mode and frame number (the render loop
    paused before its next frame), bitwise in u8; a material edit and a
    mode switch change the next frames; /stats carries no error; frames
    presented per second in each mode. Returns (results, viewer)."""
    import threading
    import urllib.request

    import numpy as np

    from paperrenderer_tpu_torch import (
        HybridRender, RayTraceRender, StatisticsTracker, Viewer)
    from paperrenderer_tpu_torch.io import read_image
    from paperrenderer_tpu_torch.scenes import build_example_scene

    rp, cam = build_example_scene(size, size, device=device)
    rt = RayTraceRender(rp.scene, rp.materials, width=size, height=size,
                        lights=rp.lights, shadow_samples=2)
    rt.add_instances_from(rp)
    hy = HybridRender(rp.scene, rp.materials, width=size, height=size,
                      lights=rp.lights)
    hy.add_instances_from(rp)
    renders = dict(raster=rp, rt=rt, hybrid=hy)
    for r in renders.values():
        r.render(cam)

    class Gate:
        """on_frame hook: pauses the render loop before its next frame."""

        def __init__(self):
            self.hold, self.paused, self.go = (threading.Event(),
                                               threading.Event(),
                                               threading.Event())

        def __call__(self, viewer, index, dt):
            if self.hold.is_set():
                self.paused.set()
                self.go.wait(60)
                self.go.clear()
                self.paused.clear()

    gate = Gate()
    v = Viewer(renders, cam, statistics=StatisticsTracker(),
               on_frame=gate).start()

    def get(path):
        with urllib.request.urlopen(v.url + path, timeout=60) as r:
            return r.read()

    def post(path, obj):
        req = urllib.request.Request(v.url + path,
                                     data=json.dumps(obj).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    def paused_check(mode):
        """Pause the loop, fetch the presented frame, render it directly."""
        gate.hold.set()
        assert gate.paused.wait(60), "render loop did not pause"
        png = read_image(get("/frame.png"))
        r = renders[mode]
        saved = getattr(r, "_frame", None)
        if saved is not None:
            r._frame = saved - 1   # the presented frame's sample key
        ldr = r.render(cam)[0]
        if saved is not None:
            r._frame = saved
        direct = (np.clip(ldr.cpu().numpy(), 0, 1) * 255 + 0.5).astype(
            np.uint8)
        gate.hold.clear()
        gate.go.set()
        return png, bool(np.array_equal(png, direct))

    out, ok = {}, True
    try:
        ok &= v.wait_frame(2, timeout=120)
        ok &= "paperrenderer_tpu_torch" in get("/").decode()
        modes = json.loads(get("/modes"))
        ok &= modes == {"modes": ["raster", "rt", "hybrid"], "active": "raster"}
        fps = {}
        frames = {}
        for mode in ("raster", "rt", "hybrid"):
            ok &= post("/mode", {"mode": mode}) == {"ok": True}
            i0 = v._frame_index
            ok &= v.wait_frame(i0 + 2, timeout=120)
            png, same = paused_check(mode)
            frames[mode] = png
            out[f"{mode}_matches_direct"] = same
            ok &= same and png.shape == (size, size, 3)
            i0, t0 = v._frame_index, time.perf_counter()
            time.sleep(window_s)
            fps[mode] = (v._frame_index - i0) / (time.perf_counter() - t0)
        out["fps"] = fps
        out["mode_switch_changes_frame"] = bool(
            np.abs(frames["rt"].astype(int) - frames["raster"]).max() > 8)
        ok &= out["mode_switch_changes_frame"]
        # a live material edit in raster mode
        post("/mode", {"mode": "raster"})
        i0 = v._frame_index
        v.wait_frame(i0 + 2, timeout=120)
        before, _ = paused_check("raster")
        mats = json.loads(get("/materials"))["materials"]
        red = [m for m in mats if m["name"] == "red"][0]
        ok &= post("/material", {"id": red["id"],
                                 "updates": {"albedo": [0.1, 0.9, 0.1]}}) \
            == {"ok": True}
        i0 = v._frame_index
        v.wait_frame(i0 + 2, timeout=120)
        after, same = paused_check("raster")
        out["edit_changes_frame"] = bool(
            np.abs(after.astype(int) - before).max() > 8)
        out["edit_matches_direct"] = same
        ok &= out["edit_changes_frame"] and same
        stats = json.loads(get("/stats"))
        out["stats_error"] = stats.get("error")
        ok &= "error" not in stats
        out["frames_served"] = stats["frame"]
    finally:
        gate.hold.clear()
        gate.go.set()
        v.stop()
    return dict(ok=ok, **out)


XLA_CASES = (("raster_512", "raster_512", 512, {}),
             ("raster_example", "raster_example", 128, {}),
             ("supersample2", "raster_supersample2", 128, {"supersample": 2}),
             ("rt", "rt_example", 128, {}),
             ("hybrid", "hybrid_example", 128, {}),
             ("textured", "textured_example", 128, {}))


def xla_route_phase(read_counts):
    """use_pallas=False on the card: each XLA_CASES frame against its
    golden with the bands (the RT and hybrid frames with the first frame's
    samples, as the goldens), its ms beside the kernel route's (median of
    5 synchronized frames; the route is slow by nature and is not tuned),
    and no kernel launched by the XLA frames but the hybrid frame's
    traversal kernels (its RT passes follow the device)."""
    from paperrenderer_tpu_torch.scenes import (
        build_example_scene, build_hybrid_scene, build_rt_scene,
        build_textured_scene)

    out, ok = {}, True
    for name, gold, size, kw in XLA_CASES:
        if name.startswith(("raster", "supersample")):
            r, cam = build_example_scene(size, size, device="cuda")
        elif name == "textured":
            r, cam = build_textured_scene(size, size, device="cuda")[2:]
        else:
            build = build_hybrid_scene if name == "hybrid" else build_rt_scene
            _, r, cam = build(size, size, device="cuda")
        for k, val in kw.items():
            setattr(r, k, val)
        kernel_ms = frame_ms(r, cam, frames=5, warmup=1)
        r.use_pallas = False
        if hasattr(r, "_frame"):
            r._frame = 0   # the golden's samples: the first frame's key
        read_counts(reset=True)
        ldr = r.render(cam)[0]
        counts = read_counts()
        good, mean, frac = bands(ldr.cpu().numpy(), golden(gold))
        launched = sum(v for k, v in counts.items() if not (
            name == "hybrid" and k.startswith("trace_")))
        out[name] = dict(ok=good and launched == 0, golden=gold, mean=mean,
                         frac=frac, kernel_launches=launched, launches=counts,
                         xla_ms=frame_ms(r, cam, frames=5, warmup=1),
                         kernel_ms=kernel_ms)
        ok &= out[name]["ok"]
    return dict(ok=ok, **out)


EXAMPLE_RUNS = (
    ("render_scene", ["--size", "128"], "raster_example"),
    ("render_scene", ["--size", "512"], "raster_512"),
    ("render_rt", ["--size", "128"], "rt_example"),
    ("render_hybrid", ["--size", "128"], "hybrid_example"),
    ("render_textured", ["--size", "128"], "textured_example"),
    ("render_crowd", ["--n", "600", "--size", "128"], "crowd_paged"),
    ("render_dynamic", ["--n", "10000", "--frames", "5"], None),
    ("view_scene", ["--size", "128", "--frames", "5", "--rt", "--port", "0"],
     None),
)


def examples_phase(work_dir, timeout=300):
    """Each example module in a subprocess (`python -m
    paperrenderer_tpu_torch.examples.<name>`), four at a time; its PNG held
    to its golden with the bands (render_dynamic: 1920x1080 and finite;
    view_scene: 5 frames served, the last one written)."""
    import numpy as np

    from paperrenderer_tpu_torch.io import read_image

    os.makedirs(work_dir, exist_ok=True)

    def run(spec):
        name, args, gold = spec
        out_png = os.path.join(work_dir, f"{name}_{'_'.join(args[:2])}.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"paperrenderer_tpu_torch.examples.{name}",
             "--out", out_png] + args, cwd=HERE, capture_output=True,
            text=True, timeout=timeout)
        res = dict(rc=proc.returncode, seconds=time.perf_counter() - t0,
                   stdout=proc.stdout.strip().splitlines()[-3:])
        if proc.returncode != 0:
            res["stderr"] = proc.stderr[-2000:]
            return name, res, False
        img = read_image(out_png)
        finite = img.ndim == 3 and img.shape[-1] == 3
        if gold is not None:
            good, mean, frac = bands(img.astype(np.float32) / 255.0,
                                     golden(gold))
            res.update(golden=gold, mean=mean, frac=frac)
        else:
            good = finite and img.max() > 0
        res["shape"] = list(img.shape)
        return name, res, bool(good and finite)

    out, ok = {}, True
    with ThreadPoolExecutor(4) as pool:
        for spec, (name, res, good) in zip(EXAMPLE_RUNS,
                                           pool.map(run, EXAMPLE_RUNS)):
            key = name if name != "render_scene" else f"render_scene_{spec[1][1]}"
            out[key] = dict(ok=good, **res)
            ok &= good
    return dict(ok=ok, **out)


PARALLEL_RANKS = 4           # gloo ranks sharing the one card, a 2x2 mesh
PARALLEL_FRAMES = 5          # timed frames a case (after one warm-up)


def primary_vs_k8(rt, cam, width, height):
    """The primary surfaces of the world BVH (``BatchTracer``) against the
    two-level tracer's (K8) on ``rt``'s scene: counts of rays whose hit
    flags, materials or world positions (1e-4 relative) differ, those of
    them that graze a triangle edge (barycentric margin < 1e-3 on a side
    that hits) and those that do not."""
    import torch

    from paperrenderer_tpu_torch.ops import accel as ACC
    from paperrenderer_tpu_torch.ops import trace as T
    from paperrenderer_tpu_torch.ops.trace_kernel import trace_resolve_kernel
    from paperrenderer_tpu_torch.render import build_world_scene
    from paperrenderer_tpu_torch.utils import random as rnd

    args, kw = rt.world_inputs(cam, rnd.prng_key(0))
    instances, tables, geo, table, _lights, cm, slots, _tm = args[:8]
    batch, bvh = build_world_scene(
        instances, tables, geo, cm, slots,
        max_meshes_per_lod=kw["max_meshes_per_lod"],
        tri_capacity=kw["tri_capacity"])
    o, d = T.raygen(cm, width, height)
    r = o.shape[0]
    far = torch.full((r,), 1000.0, device=o.device)
    rec = T.BatchTracer(batch, bvh, table).trace(o, d, far)
    ws = T.resolve_hits(batch, rec, o, d)
    inst = rt.scene.flush()
    blasset, meta, anim_rest, anim_nodes = rt.accel.blas()
    two = ACC.make_scene_tracer(
        blasset, meta, anim_rest, anim_nodes, inst,
        rt.accel.inst_blas(inst.capacity),
        rt._device_inputs(inst.capacity)[1], rt.accel.tri_attr(), slots,
        table, tlas_index=0, stack_size=rt.accel.stack_size(inst.capacity))
    rec2, attrs = trace_resolve_kernel(
        two.scene, slots, o, d, far, root_code=two.root_code,
        stack_size=two.stack_size)
    ts = ACC.surface_hits(rec2, attrs, o, d)

    def margin(bary):
        u, v = bary[:, 0], bary[:, 1]
        return torch.minimum(torch.minimum(u, v), 1.0 - u - v)

    both = ws.valid & ts.valid
    scale = torch.clamp(ts.world_pos.abs().amax(dim=-1), min=1.0)
    rel = (ws.world_pos - ts.world_pos).abs().amax(dim=-1) / scale
    flag_off = ws.valid != ts.valid
    mat_off = both & (ws.material != ts.material)
    pos_off = both & (rel > 1e-4)
    edge = ((rec.hit & (margin(rec.bary) < 1e-3))
            | (rec2.hit & (margin(rec2.bary) < 1e-3)))
    off = flag_off | mat_off | pos_off
    kept = both & ~edge
    return dict(
        rays=r, hits=int(ws.valid.sum()),
        hit_flags_differ=int(flag_off.sum()),
        materials_differ=int(mat_off.sum()),
        world_pos_beyond_1e4=int(pos_off.sum()),
        edge_ties=int((off & edge).sum()),
        differ_off_edge=int((off & ~edge).sum()),
        max_rel_pos_err=float(rel[kept].max()) if bool(kept.any()) else 0.0)


def world_rt_phase(width=1920, height=1080, device="cuda"):
    """The world_rt phase (see the module docstring)."""
    import torch

    import numpy as np

    from paperrenderer_tpu_torch.ops import bvh as TB
    from paperrenderer_tpu_torch.render import build_world_scene, rt_frame
    from paperrenderer_tpu_torch.scenes import build_rt_scene
    from paperrenderer_tpu_torch.utils import random as rnd

    out, ok = {}, True
    _, rt, cam = build_rt_scene(width, height, device=device)
    key = rnd.fold_in(rt._key, 1)          # the key of rt's first frame
    args, kw = rt.world_inputs(cam, key)
    instances, tables, geo, _table, _lights, cm, slots, _tm = args[:8]
    t0 = time.perf_counter()
    batch, bvh = build_world_scene(
        instances, tables, geo, cm, slots,
        max_meshes_per_lod=kw["max_meshes_per_lod"],
        tri_capacity=kw["tri_capacity"])
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    lo, hi = batch.world.amin(dim=1), batch.world.amax(dim=1)
    cpu = TB.build_bvh(lo.cpu(), hi.cpu(), batch.valid.cpu())
    out["build"] = dict(
        ms=build_ms, triangles=int(batch.valid.sum()),
        capacity=batch.capacity, leaves=bvh.num_leaves, depth=bvh.depth,
        card_equals_cpu=all(same_bits(getattr(bvh, f).cpu(), getattr(cpu, f))
                            for f in ("node_min", "node_max", "perm",
                                      "child_boxes")))
    ok &= out["build"]["card_equals_cpu"]

    def frame_vs_two_level():
        """rt_frame (world BVH) against render_frame_rt (two-level) with
        the key of rt's first frame, in the golden bands."""
        ldr_w, aux_w = rt_frame(*args, **kw)
        rt._frame = 0
        ldr_t, _ = rt.render(cam)
        good, mean, frac = bands(ldr_w.cpu().numpy(), ldr_t.cpu().numpy())
        return dict(mean=mean, frac=frac,
                    ok=good and bool(torch.isfinite(aux_w["hdr"]).all()))

    # the scene as built: primary surfaces against the two-level tracer
    # (K8) reported (config 3's cube quaternion is not unit, and the TLAS
    # inverts R as R^T), the frames held in the golden bands
    out["primary_vs_k8_as_built"] = primary_vs_k8(rt, cam, width, height)
    out["frame_vs_two_level_as_built"] = frame_vs_two_level()
    ok &= out["frame_vs_two_level_as_built"]["ok"]
    # the same scene with its quaternions normalized: every primary surface
    # off a triangle edge held to K8's, the frames held in the bands
    for inst in rt.scene.instances:
        q = np.asarray(inst.rotation, np.float64)
        inst.set_transform(quat=(q / np.linalg.norm(q)).astype(np.float32))
    rt.invalidate()
    args, kw = rt.world_inputs(cam, key)
    out["primary_vs_k8"] = primary_vs_k8(rt, cam, width, height)
    ok &= out["primary_vs_k8"]["differ_off_edge"] == 0
    out["frame_vs_two_level"] = frame_vs_two_level()
    ok &= out["frame_vs_two_level"]["ok"]
    TB.STATS.update(steps=0, host_reads=0)
    torch.cuda.synchronize()
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        rt_frame(*args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["steps_one_frame"] = TB.STATS["steps"]
            out["host_reads_one_frame"] = TB.STATS["host_reads"]
    out["frame_ms"] = statistics.median(times)
    rt._frame = 0
    out["two_level_frame_ms"] = frame_ms(rt, cam, frames=3, warmup=1)
    return dict(ok=ok, **out)


def deterministic(render):
    """``render`` (an RT or hybrid render) with radius-0 lights and no AO or
    reflection samples: every sample is the same ray, so a tile's folded
    key cannot change its pixels."""
    import torch

    if hasattr(render, "params"):                  # RayTraceRender
        render.params = dataclasses.replace(render.params, ao_samples=0,
                                            reflection_samples=0)
        render.lights = dataclasses.replace(
            render.lights, radius=torch.zeros_like(render.lights.radius))
    else:                                          # HybridRender
        render.ao_samples = render.reflection_samples = 0
        rp = render._rp
        rp.lights = dataclasses.replace(
            rp.lights, radius=torch.zeros_like(rp.lights.radius))
    render.invalidate()
    return render


def parallel_scenes():
    """The parallel phase's scenes at 1920x1080 on the card: config 2's
    grid, the translucent grid (4 layers), config 3's RT scene and config
    4's hybrid scene, with deterministic copies of the last two."""
    from paperrenderer_tpu_torch.scenes import (
        build_dynamic_scene, build_example_scene, build_hybrid_scene,
        build_rt_scene, build_translucent_grid)

    w, h = 1920, 1080
    rp1, cam1 = build_example_scene(128, 128, device="cuda")
    _, rp2, cam2 = build_dynamic_scene(10_000, w, h, device="cuda")
    _, rpt, camt = build_translucent_grid(10_000, w, h, device="cuda")
    _, rt, cam3 = build_rt_scene(w, h, device="cuda")
    _, rt_det, _ = build_rt_scene(w, h, device="cuda")
    _, hy, cam4 = build_hybrid_scene(w, h, device="cuda")
    _, hy_det, _ = build_hybrid_scene(w, h, device="cuda")
    return dict(
        static=dict(config2=(rp2, cam2, {}),
                    translucent=(rpt, camt, dict(translucent_layers=4)),
                    ss2_config2=(rp2, cam2, dict(supersample=2)),
                    golden128=(rp1, cam1, {})),
        rt=dict(config3=(rt, cam3), config3_det=(deterministic(rt_det), cam3)),
        hybrid=dict(config4=(hy, cam4),
                    config4_det=(deterministic(hy_det), cam4)))


def parallel_frames(mesh, scenes, key):
    """One sharded frame of each case as closures -> {name: fn() -> tile};
    the static ones return (ldr, required, aux), the RT and hybrid ones
    the ldr tile (and the hybrid's aux)."""
    from paperrenderer_tpu_torch.parallel import (
        make_sharded_hybrid_frame, make_sharded_rt_frame,
        sharded_render_frame_static, sharded_rt_frame)
    from paperrenderer_tpu_torch.parallel import tiles as PT

    fns = {}
    for name, (rp, cam, kw) in scenes["static"].items():
        args, fkw = PT.static_inputs(rp, cam)
        fns[name] = functools.partial(
            sharded_render_frame_static, mesh, *args, **fkw, **kw,
            use_pallas=True, return_required=True, return_aux=True)
    for name, (rt, cam) in scenes["rt"].items():
        for paged in (False, True):
            meta, args, kw = PT.rt_inputs(rt, cam, key)
            fn = make_sharded_rt_frame(mesh, meta, use_pallas=True,
                                       paged=paged)
            fns[f"{name}_{'paged' if paged else 'flat'}"] = \
                functools.partial(fn, *args, **kw)
    for name, (hy, cam) in scenes["hybrid"].items():
        meta, args, kw = PT.hybrid_inputs(hy, cam, key)
        fn = make_sharded_hybrid_frame(mesh, meta, use_pallas_trace=True)
        fns[name] = functools.partial(fn, *args, **kw, use_pallas=True)
    rt, cam = scenes["rt"]["config3"]
    args, kw = rt.world_inputs(cam, key)
    fns["world_rt"] = functools.partial(
        sharded_rt_frame, mesh, *args[:9], width=kw["width"],
        height=kw["height"], max_meshes_per_lod=kw["max_meshes_per_lod"],
        tri_capacity=kw["tri_capacity"], params=world_params(kw))
    return fns


def world_params(kw):
    """The RTParams of ``RayTraceRender.world_inputs``' keywords."""
    from paperrenderer_tpu_torch.ops.trace import RTParams

    return RTParams(shadow_samples=kw["shadow_samples"],
                    reflection_samples=kw["reflection_samples"],
                    ao_samples=kw["ao_samples"], ao_radius=kw["ao_radius"],
                    leaf_cutout=kw["leaf_cutout"])


def parallel_rank(rank, world, out_dir):
    """One of the parallel phase's gloo ranks, all on the one card: every
    case's main path once with the launch counters at 0 (read after),
    each tile against a one-process call on its window with its folded
    key (RT: trace_frame; hybrid: parallel.tiles.hybrid_tile on the
    un-gathered batch), the tiles gathered to rank 0 (written to
    ``out_dir``), the probe against ``required``, per-rank frame ms."""
    import torch

    sys.path.insert(0, HERE)
    from paperrenderer_tpu_torch.ops import accel as ACC
    from paperrenderer_tpu_torch.ops import raster_exact as RE
    from paperrenderer_tpu_torch.ops import trace as T
    from paperrenderer_tpu_torch.ops import trace_kernel as TK
    from paperrenderer_tpu_torch.ops import trace_paged as TPG
    from paperrenderer_tpu_torch.ops.static_batch import expand_static
    from paperrenderer_tpu_torch.ops.tonemap import tonemap
    from paperrenderer_tpu_torch.parallel import (gather_tiles,
                                                  make_tile_mesh,
                                                  measure_sharded_demand)
    from paperrenderer_tpu_torch.parallel import tiles as PT
    from paperrenderer_tpu_torch.utils import random as rnd

    torch.cuda.set_device(0)
    mesh = make_tile_mesh()
    key = rnd.prng_key(11)
    scenes = parallel_scenes()
    fns = parallel_frames(mesh, scenes, key)
    counters = (RE.LAUNCHES, TK.LAUNCHES, TPG.LAUNCHES)
    for fn in fns.values():                      # warm-up: loads, caches
        fn()
    torch.cuda.synchronize()
    for c in counters:
        for k in c:
            c[k] = 0
    outs = {name: fn() for name, fn in fns.items()}   # the main path
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if v}
    res = dict(rank=rank, coords=mesh.coords, shape=mesh.shape,
               backend=mesh.backend, launches=launches, checks={}, ms={})
    gathered = {}
    for name, out in outs.items():
        if name in scenes["static"]:
            ldr, required, aux = out
            gathered[name] = dict(
                ldr=gather_tiles(ldr, mesh).cpu(), required=required,
                depth=gather_tiles(aux["depth"], mesh).cpu(),
                tri_id=gather_tiles(aux["tri_id"], mesh).cpu())
        else:
            ldr = out[0] if isinstance(out, tuple) else out
            gathered[name] = gather_tiles(ldr, mesh).cpu()
    # each RT / hybrid tile against one process on its window
    for name, (rt, cam) in scenes["rt"].items():
        for paged in (False, True):
            meta, args, kw = PT.rt_inputs(rt, cam, key)
            (blasset, anim_rest, anim_nodes, instances, inst_blas, masks,
             tri_attr, table, lights, cm, slots, tm, _, time_, tex) = args
            tile_w, tile_h, win = PT.tile_window(mesh, kw["width"],
                                                 kw["height"])
            ctx = ACC.make_scene_tracer(
                blasset, meta, anim_rest, anim_nodes, instances, inst_blas,
                masks, tri_attr, slots, table, tlas_index=0,
                stack_size=kw["stack_size"], paged=paged, leaf_cutout=False,
                textures=tex, time=time_)
            params = T.RTParams(
                shadow_samples=kw["shadow_samples"],
                reflection_samples=kw["reflection_samples"],
                ao_samples=kw["ao_samples"], ao_radius=kw["ao_radius"])
            one = tonemap(T.trace_frame(
                ctx, table, lights, cm, rnd.fold_in(key, mesh.index),
                width=tile_w, height=tile_h, params=params, **win), tm)
            case = f"{name}_{'paged' if paged else 'flat'}"
            res["checks"][case] = same_bits(outs[case], one)
    for name, (hy, cam) in scenes["hybrid"].items():
        meta, args, kw = PT.hybrid_inputs(hy, cam, key)
        (mapping, blasset, anim_rest, anim_nodes, instances, inst_blas,
         tri_attr, tables, table, lights, cm, slots, visible, tm, _, time_,
         tex) = args
        tile_w, tile_h, win = PT.tile_window(mesh, kw["width"], kw["height"])
        batch, _ = expand_static(mapping, instances, tables, cm, slots,
                                 visible)
        mask = (torch.ones(instances.capacity, dtype=torch.bool,
                           device="cuda"),)
        ctx = ACC.make_scene_tracer(
            blasset, meta, anim_rest, anim_nodes, instances, inst_blas, mask,
            tri_attr, slots, table, tlas_index=0,
            stack_size=kw["stack_size"], textures=tex, time=time_)
        one, _ = PT.hybrid_tile(
            batch, ctx, table, lights, cm, tm, rnd.fold_in(key, mesh.index),
            tex, tile_w=tile_w, tile_h=tile_h, window=win, use_pallas=True,
            shadow_samples=kw["shadow_samples"],
            reflection_samples=kw["reflection_samples"],
            ao_samples=kw["ao_samples"], ao_radius=kw["ao_radius"])
        res["checks"][name] = same_bits(outs[name][0], one)
    # the legacy world-BVH frame: one process's trace of the window
    from paperrenderer_tpu_torch.render import build_world_scene

    rt, cam = scenes["rt"]["config3"]
    args, kw = rt.world_inputs(cam, key)
    tile_w, tile_h, win = PT.tile_window(mesh, kw["width"], kw["height"])
    batch, bvh = build_world_scene(
        *args[:3], args[5], args[6],
        max_meshes_per_lod=kw["max_meshes_per_lod"],
        tri_capacity=kw["tri_capacity"])
    one = tonemap(T.trace_frame(
        T.BatchTracer(batch, bvh, args[3]), args[3], args[4], args[5],
        rnd.fold_in(key, mesh.index), width=tile_w, height=tile_h,
        params=world_params(kw), **win), args[7])
    res["checks"]["world_rt"] = same_bits(outs["world_rt"], one)
    if rank == 0:
        for name, (rp, cam, kw) in scenes["static"].items():
            m, inst, tables, mats, cm, slots, vis = rp.frame_inputs(cam)
            gathered[name]["probe"] = measure_sharded_demand(
                m, inst, tables, cm, slots, vis, mats, width=rp.width,
                height=rp.height, rows=mesh.shape[0], cols=mesh.shape[1],
                translucent_layers=kw.get("translucent_layers", 0),
                supersample=kw.get("supersample", 1))
        torch.save(gathered, os.path.join(out_dir, "gathered.pt"))
    # per-rank frame ms (the ranks share the card: not a scaling number)
    for name, fn in fns.items():
        torch.distributed.barrier()
        times = []
        for _ in range(PARALLEL_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res["ms"][name] = statistics.median(times)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def window_err(a, b):
    """Max |a - b| of two depth planes, +inf where empty in both."""
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return float("inf")
    return float((a[both] - b[both]).abs().max()) if both.any() else 0.0


def parallel_phase(work_dir):
    """The parallel phase: (a) NCCL at world size 1 in this process, the
    sharded static (K1) and hybrid frames bitwise the single-device ones;
    (b) four gloo ranks sharing the card in a 2x2 mesh (960x540 windows),
    their gathered frames against this process's single-device frames."""
    import shutil

    import torch
    import torch.distributed as dist

    from paperrenderer_tpu_torch.ops import raster_exact as RE
    from paperrenderer_tpu_torch.ops.raster import attach_cull
    from paperrenderer_tpu_torch.ops.static_batch import expand_static
    from paperrenderer_tpu_torch.ops.translucency import non_opaque_mask
    from paperrenderer_tpu_torch.parallel import (
        make_sharded_hybrid_frame, make_tile_mesh, spawn_ranks)
    from paperrenderer_tpu_torch.parallel import tiles as PT
    from paperrenderer_tpu_torch.render.hybrid import render_frame_hybrid
    from paperrenderer_tpu_torch.utils import random as rnd

    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    out, ok = {}, True
    scenes = parallel_scenes()
    key = rnd.prng_key(11)

    # the windowed K1 and K2 on the card against their plain versions, on
    # the bottom-right 960x540 window (origin (960, 540): its cells straddle
    # the full grid's rows) of config 2 and of the translucent grid's first
    # peel layer
    win = dict(full_width=1920, full_height=1080, origin=(960, 540))
    kernels = {}
    for name in ("config2", "translucent"):
        rp, cam, _ = scenes["static"][name]
        m, inst, tables, mats, cm, slots, vis = rp.frame_inputs(cam)
        batch, _ = expand_static(m, inst, tables, cm, slots, vis)
        batch = attach_cull(batch, mats)
        glass = non_opaque_mask(mats, batch.material)
        opaque = dataclasses.replace(batch, valid=batch.valid & ~glass)
        bins = RE.bin_triangles(opaque, 960, 540, **win)
        args = (bins.cell_start, bins.cell_groups, bins.coef, 960, 540)
        (d_k, t_k), ms = timed_once(lambda: RE.rasterize_bins(*args, **win))
        (d_p, t_p), plain_ms = timed_once(lambda: RE.rasterize_bins_plain(
            *args, origin=win["origin"]))
        kernels[f"k1_{name}_window"] = dict(
            bitwise=same_bits(d_k, d_p) and same_bits(t_k, t_p),
            max_abs_err=window_err(d_k, d_p), ms=ms, plain_ms=plain_ms,
            pairs=bins.n_pairs)
        if name == "translucent":
            tb = RE.bin_triangles(dataclasses.replace(
                batch, valid=batch.valid & glass), 960, 540, **win)
            floor = torch.full((540, 960), torch.iinfo(torch.int32).min + 1,
                               dtype=torch.int32, device="cuda")
            window = (floor, RE.depth_to_key(d_k))
            args = (tb.cell_start, tb.cell_groups, tb.coef, 960, 540)
            (d_k, t_k), ms = timed_once(lambda: RE.rasterize_bins(
                *args, keyed=True, window=window, **win))
            (d_p, t_p), plain_ms = timed_once(
                lambda: RE.rasterize_bins_plain(
                    *args, keyed=True, window=window, origin=win["origin"]))
            kernels["k2_translucent_window_layer1"] = dict(
                bitwise=same_bits(d_k, d_p) and same_bits(t_k, t_p),
                max_abs_err=window_err(d_k, d_p), ms=ms, plain_ms=plain_ms,
                pairs=tb.n_pairs, covered=int((t_k >= 0).sum()))
    out["windowed_kernels"] = kernels
    ok &= all(v["bitwise"] for v in kernels.values())

    # (a) NCCL, world size 1
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(work_dir, "nccl1"), 1),
        rank=0, world_size=1)
    try:
        mesh = make_tile_mesh()
        fns = parallel_frames(mesh, scenes, key)
        a = {}
        rp, cam, _ = scenes["static"]["config2"]
        ldr_1, req_1, _ = fns["config2"]()
        ldr, aux = rp.render(cam)
        a["config2_static"] = dict(bitwise=same_bits(ldr_1, ldr),
                                   required=req_1,
                                   single_required=aux["required_work"])
        for name, paged in (("config4", True), ("config4_det", False)):
            hy, cam = scenes["hybrid"][name]
            meta, args, kw = PT.hybrid_inputs(hy, cam, key)
            ldr_1, _ = make_sharded_hybrid_frame(
                mesh, meta, use_pallas_trace=True, paged=paged)(
                    *args, **kw, use_pallas=True)
            rp = hy._rp
            m, inst, tables, table, cm, slots, vis = rp.frame_inputs(cam)
            blasset, meta, anim_rest, anim_nodes = hy.accel.blas()
            cap = inst.capacity
            ldr, _ = render_frame_hybrid(
                m, blasset, meta, anim_rest, anim_nodes, inst,
                hy.accel.inst_blas(cap), hy.accel.tri_attr(), tables, table,
                rp.lights, cm, slots, vis, rp.tonemap_params,
                rnd.fold_in(key, 0), args[15], width=hy.width,
                height=hy.height, stack_size=hy.accel.stack_size(cap),
                paged=paged, shadow_samples=hy.shadow_samples,
                reflection_samples=hy.reflection_samples,
                ao_samples=hy.ao_samples, ao_radius=hy.ao_radius,
                textures=rp._cached_textures)
            a[f"{name}_{'paged' if paged else 'flat'}"] = dict(
                bitwise=same_bits(ldr_1, ldr))
        a["backend"] = mesh.backend
        ok &= all(v["bitwise"] for v in a.values() if isinstance(v, dict))
        out["nccl_world1"] = a
    finally:
        dist.destroy_process_group()

    # (b) four gloo ranks on the one card
    t0 = time.perf_counter()
    spawn_ranks(parallel_rank, PARALLEL_RANKS, backend="gloo",
                init_file=os.path.join(work_dir, "gloo4"),
                args=(work_dir,), timeout=400)
    b = dict(spawn_seconds=round(time.perf_counter() - t0, 3))
    ranks = [json.load(open(os.path.join(work_dir, f"rank{r}.json")))
             for r in range(PARALLEL_RANKS)]
    gathered = torch.load(os.path.join(work_dir, "gathered.pt"))
    b["mesh"] = [dict(rank=r["rank"], coords=r["coords"], shape=r["shape"],
                      backend=r["backend"]) for r in ranks]
    b["tile_vs_one_process"] = {c: [r["checks"][c] for r in ranks]
                                for c in ranks[0]["checks"]}
    ok &= all(all(v) for v in b["tile_vs_one_process"].values())
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    b["launches"] = launches
    ok &= all(launches.get(k, 0) > 0 for k in (
        "raster_exact", "raster_peel", "trace_scene", "trace_resolve",
        "trace_bundle", "trace_scene_paged", "trace_resolve_paged"))
    for name, (rp, cam, kw) in scenes["static"].items():
        g = gathered[name]
        rp.translucent_layers = kw.get("translucent_layers", 0)
        rp.supersample = kw.get("supersample", 1)
        ldr, aux = rp.render(cam)
        single_ms = frame_ms(rp, cam, frames=PARALLEL_FRAMES, warmup=1)
        m, inst, tables, mats, cm, slots, vis = rp.frame_inputs(cam)
        batch, _ = expand_static(m, inst, tables, cm, slots, vis)
        batch = attach_cull(batch, mats)
        if rp.translucent_layers:
            batch = dataclasses.replace(batch, valid=batch.valid & ~non_opaque_mask(
                mats, batch.material))
        ss = rp.supersample
        depth, tid, _, _ = RE.rasterize_exact(batch, rp.width * ss,
                                              rp.height * ss)
        rp.translucent_layers, rp.supersample = 0, 1
        same_tid = g["tri_id"] == tid.cpu()
        h_, w_ = rp.height, rp.width
        same_px = same_tid.view(h_, ss, w_, ss).all(dim=3).all(dim=1)
        ldr_c = ldr.cpu()
        ldr_ok = bool(((g["ldr"] == ldr_c).all(dim=-1) | ~same_px).all())
        b[name] = dict(
            depth_bitwise=same_bits(g["depth"], depth.cpu()),
            tid_mismatches=int((~same_tid).sum()),
            ldr_bitwise_where_tid_equal=ldr_ok,
            ldr_bitwise=same_bits(g["ldr"], ldr_c),
            required=g["required"], probe=g["probe"],
            probe_equals_required=g["probe"] == g["required"],
            single_required=aux["required_work"],
            rank_frame_ms=[r["ms"][name] for r in ranks],
            single_device_frame_ms=single_ms)
        ok &= (b[name]["depth_bitwise"] and ldr_ok
               and b[name]["probe_equals_required"])
        if name == "golden128":   # the JAX package's sharded gate
            gate, mean, frac = bands(g["ldr"].numpy(),
                                     golden("sharded_raster"))
            b[name]["sharded_raster_png"] = dict(ok=gate, mean=mean,
                                                 frac=frac)
            ok &= gate
    for kind in ("rt", "hybrid"):
        for name, (r_, cam) in scenes[kind].items():
            layouts = (False, True) if kind == "rt" else (False,)
            for paged in layouts:
                case = (f"{name}_{'paged' if paged else 'flat'}"
                        if kind == "rt" else name)
                render = functools.partial(r_.render, cam, paged=paged)
                b[case] = dict(rank_frame_ms=[r["ms"][case] for r in ranks])
                if name.endswith("_det"):   # the same rays: the same bits
                    b[case]["bitwise_vs_single_device"] = same_bits(
                        gathered[case], render()[0].cpu())
                    ok &= b[case]["bitwise_vs_single_device"]
                else:
                    b[case]["single_device_frame_ms"] = frame_ms(
                        r_, cam, frames=PARALLEL_FRAMES, warmup=1,
                        paged=paged)
    # the world-BVH tiles against the two-level ones (K7-K11: code they
    # share none of) with the same tile keys and samples, in the bands
    gate, mean, frac = bands(gathered["world_rt"].numpy(),
                             gathered["config3_flat"].numpy())
    b["world_rt"] = dict(rank_frame_ms=[r["ms"]["world_rt"] for r in ranks],
                         vs_two_level_tiles=dict(ok=gate, mean=mean,
                                                 frac=frac))
    ok &= gate
    b["note"] = ("four gloo ranks share one card: per-rank frame ms are "
                 "not a scaling number")
    out["gloo_2x2_one_card"] = b
    return dict(ok=ok, **out)


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


def raster_stages():
    """The raster frame's stages; `composite_translucency` holds the peel
    layers' binning, K2 launches, resolves, shading and blend."""
    from paperrenderer_tpu_torch.ops import raster_exact as RE
    from paperrenderer_tpu_torch.render import renderpass as RP

    return [(RP, "expand_static"), (RP, "attach_cull"),
            (RE, "triangle_coefficients"), (RE, "bin_groups"),
            (RE, "rasterize_bins"), (RP, "resolve_gbuffer_pairs"),
            (RP, "shade_gbuffer"), (RP, "composite_translucency"),
            (RP, "tonemap")]


def draw_list_stages():
    """The draw-list frame's stages; `triangle_coefficients` and
    `tile_setup` (the morton sort, packing and chunk boxes) are the setup of
    K5, `rasterize_chunks` its launch."""
    from paperrenderer_tpu_torch.ops import raster_pallas as TPL
    from paperrenderer_tpu_torch.render import renderpass as RP

    return [(RP, "preprocess_instances"), (RP, "build_triangle_batch"),
            (RP, "attach_cull"), (TPL, "triangle_coefficients"),
            (TPL, "tile_setup"), (TPL, "rasterize_chunks"),
            (RP, "resolve_gbuffer"), (RP, "shade_gbuffer"), (RP, "tonemap")]


def rt_stages():
    """The RT frame's stages; `reflections` includes the shadow_and_ao and
    shade_surfaces calls made for its bounce hits (listed again under their
    own names, so those rows count both the primary and the bounce side)."""
    from paperrenderer_tpu_torch.ops import accel as ACC
    from paperrenderer_tpu_torch.ops import trace as TR
    from paperrenderer_tpu_torch.render import raytrace as RT

    return [(ACC, "assemble_scene"), (TR, "raygen"),
            (ACC.SceneTracer, "trace_resolve"), (TR, "shadow_and_ao"),
            (TR, "reflections"), (TR, "shade_surfaces"), (RT, "tonemap")]


def paged_rt_stages():
    """The paged RT frame's stages (the crowd: primary K11, one K10 any-hit
    shadow wavefront, no AO or reflection)."""
    from paperrenderer_tpu_torch.ops import accel as ACC
    from paperrenderer_tpu_torch.ops import trace as TR
    from paperrenderer_tpu_torch.render import raytrace as RT

    return [(ACC, "assemble_scene_paged"), (TR, "raygen"),
            (ACC.PagedSceneTracer, "trace_resolve"),
            (ACC.PagedSceneTracer, "trace_occlusion_bundle"),
            (TR, "shade_surfaces"), (RT, "tonemap")]


def leaf_rt_stages():
    """The leaf grid's RT frame (routed paged): the paged assembly, primary
    rays through K11's alpha form, the shadow wavefronts (K10 any hit, opaque
    under the cutout), the AO wavefronts (K11's alpha form, unfused), the
    reflections (their bounce side's shadow and AO passes also in those
    rows), shading and tonemap."""
    from paperrenderer_tpu_torch.ops import accel as ACC
    from paperrenderer_tpu_torch.ops import trace as TR
    from paperrenderer_tpu_torch.render import raytrace as RT

    return [(ACC, "assemble_scene_paged"), (TR, "raygen"),
            (ACC.PagedSceneTracer, "trace_resolve"),
            (TR, "shadow_visibility"), (TR, "ambient_occlusion"),
            (TR, "reflections"), (TR, "shade_surfaces"), (RT, "tonemap")]


def hybrid_stages():
    """The hybrid frame's stages: the raster G-buffer (the rasterize_exact
    stages), the scene assembly of either layout, the primary-side
    shadow+AO(+bounce) wavefront, deferred shading, the reflections (with
    their bounce side's shadow_and_ao, also in its own row) and tonemap."""
    from paperrenderer_tpu_torch.ops import accel as ACC
    from paperrenderer_tpu_torch.ops import raster_exact as RE
    from paperrenderer_tpu_torch.ops import trace as TR
    from paperrenderer_tpu_torch.render import hybrid as HY

    return [(HY, "expand_static"), (HY, "attach_cull"),
            (RE, "triangle_coefficients"), (RE, "bin_groups"),
            (RE, "rasterize_bins"), (HY, "resolve_gbuffer_pairs"),
            (ACC, "assemble_scene"), (ACC, "assemble_scene_paged"),
            (TR, "shadow_ao_bounce"), (TR, "shadow_and_ao"),
            (HY, "shade_gbuffer"), (TR, "reflections"), (HY, "tonemap")]


def anim_stages_extra():
    """The unique-geometry refit's stages (inside the RT frames' assembly)."""
    from paperrenderer_tpu_torch.ops import accel as ACC

    return [(ACC, "refit_anim_blases"), (ACC, "resplit_anim_tables")]


def profile_frames(render, stages, out_path, frames=5):
    """torch.profiler over `frames` calls of `render()`: the device's busy
    share of the window (kernel time only), and host and device ms per frame
    of each stage (labelled by wrapping the stage functions)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

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
        render()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(frames):
                render()
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
    from paperrenderer_tpu_torch.ops import raster_pallas as TPL
    from paperrenderer_tpu_torch.ops import trace_kernel as TK
    from paperrenderer_tpu_torch.ops import trace_paged as TPG
    from paperrenderer_tpu_torch.scenes import (
        build_big_model_scene, build_crowd_scene, build_dynamic_scene,
        build_example_scene, build_hybrid_scene, build_leaf_rt_grid,
        build_rt_scene, build_translucent_grid)
    from paperrenderer_tpu_torch.utils import cuda_build
    from paperrenderer_tpu_torch.utils import probes as PR
    from paperrenderer_tpu_torch.utils.walk_bench import (frame_batch,
                                                          raster_inputs)

    def build():
        libs = ("raster_exact", "trace", "raster_tiles", "probes")
        with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
            list(pool.map(cuda_build.load_library, libs))
        out = {}
        for name in libs:
            info = cuda_build.BUILD_INFO[name]
            out[name] = dict(
                build_seconds=info["seconds"], cached=info["seconds"] == 0.0,
                ptxas=[l.strip() for l in info["log"].splitlines()
                       if "ptxas" in l or "spill" in l])
        return out

    phase("build", build)

    scenes = {}

    def get(cfg):
        if cfg not in scenes:
            if cfg in (1, "ss_config1"):
                scenes[cfg] = build_example_scene(512, 512, device="cuda")
            elif cfg == "translucent":
                scenes[cfg] = build_translucent_grid(
                    10_000, 1920, 1080, device="cuda")[1:]
            else:
                _, rp, cam = build_dynamic_scene(10_000, 1920, 1080, device="cuda")
                scenes[cfg] = (rp, cam)
            if str(cfg).startswith("ss_"):
                scenes[cfg][0].supersample = 2
        return scenes[cfg]

    raster_ins = {}

    def raster_in():
        """The binned raster kernels' inputs (walk_bench.raster_inputs),
        built once for compare and compare_keyed."""
        if not raster_ins:
            raster_ins.update(raster_inputs(dict(
                config1=get(1), config2=get(2),
                # ragged right and bottom bin cells (200 = 6.25 x 32,
                # 150 = 18.75 x 8)
                ragged=build_example_scene(200, 150, device="cuda"),
                translucent=get("translucent"))))
        return raster_ins

    def compare():
        out = {name[3:]: compare_raster(case)
               for name, case in raster_in().items() if name.startswith("k1_")}
        out["ok"] = all(v["bitwise"] for v in out.values())
        return out

    # count only each path's own launches: each phase's counts start at 0
    # (the traversal counters too: the textured phase launches both kinds)
    raster_counters = (RE.LAUNCHES, TPL.LAUNCHES, TK.LAUNCHES, TPG.LAUNCHES)
    raster_launches = {}

    def counted(name, fn):
        for counter in raster_counters:
            for k in counter:
                counter[k] = 0
        phase(name, fn)
        raster_launches[name] = {k: v for counter in raster_counters
                                 for k, v in counter.items()}

    phase("compare", compare)
    phase("compare_keyed", lambda: compare_keyed(raster_in()))
    counted("compare_tiles", lambda: compare_tiles(dict(
        config1=get(1), config2=get(2),
        # ragged right and bottom tiles (200 = 1.56 x 128, 150 = 18.75 x 8)
        ragged=build_example_scene(200, 150, device="cuda"))))

    rt_scenes = {}

    def rt_1080():
        """The RT scene at 1080p with a second TLAS holding the sphere (mask
        0x01) and the cube (mask 0x02, force opaque) with their materials.
        Frames trace TLAS 0, which the extra rows leave unchanged."""
        if "rt" not in rt_scenes:
            _, rt, cam = build_rt_scene(1920, 1080, device="cuda")
            k = rt.add_tlas()
            sphere, cube = rt.scene.instances[1:3]
            rt.add_instance(sphere, tlas=k, mask=0x01)
            rt.add_instance(cube, tlas=k, mask=0x02, force_opaque=True)
            rt_scenes["rt"] = (rt, cam)
        return rt_scenes["rt"]

    def leaf_grid():
        """The leaf grid (the translucent grid, one instance in sixteen a
        leaf cutout) at 1920x1080 in a RayTraceRender and a HybridRender."""
        if "leaf" not in rt_scenes:
            rt_scenes["leaf"] = build_leaf_rt_grid(10_000, 1920, 1080,
                                                   device="cuda")[1:]
        return rt_scenes["leaf"]

    phase("compare_trace", lambda: compare_trace(
        *rt_1080(), (leaf_grid()[0], leaf_grid()[2])))

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

    def translucent():
        rp, cam = get("translucent")
        ldr, aux = rp.render(cam)
        finite = bool(torch.isfinite(ldr).all()) and tuple(ldr.shape) == (1080, 1920, 3)
        opaque = get(2)[0].render(get(2)[1])[0]
        changed = float(((ldr - opaque).abs().amax(dim=-1) > 1e-3).float().mean())
        # a reduced copy of the scene, card vs the plain CPU path
        small = [build_translucent_grid(400, 256, 128, device=dev)
                 for dev in ("cuda", "cpu")]
        ok_s, mean_s, frac_s = bands(
            small[0][1].render(small[0][2])[0].cpu().numpy(),
            small[1][1].render(small[1][2])[0].numpy())
        return dict(ok=finite and changed > 0 and ok_s,
                    frame_ms=frame_ms(rp, cam, warmup=3),
                    layers=rp.translucent_layers, changed_vs_opaque=changed,
                    total_tris=int(aux["total_tris"]),
                    coverage=float(aux["coverage"]),
                    required_work=aux["required_work"],
                    reduced_vs_cpu=dict(mean=mean_s, frac=frac_s, ok=ok_s))

    def supersample():
        """supersample=2: the 128x128 example scene against its golden, and
        the frame time of config 1 (512x512 out, 1024x1024 raster) and of
        config 2 (1920x1080 out, 3840x2160 raster)."""
        rp, cam = build_example_scene(128, 128, device="cuda")
        rp.supersample = 2
        ldr, _ = rp.render(cam)
        ok, mean, frac = bands(ldr.cpu().numpy(), golden("raster_supersample2"))
        finite = bool(torch.isfinite(ldr).all()) and tuple(ldr.shape) == (128, 128, 3)
        out = dict(golden=dict(mean=mean, frac=frac, ok=ok))
        for cfg, shape in (("ss_config1", (512, 512, 3)),
                           ("ss_config2", (1080, 1920, 3))):
            rp, cam = get(cfg)
            ldr, aux = rp.render(cam)
            finite &= (bool(torch.isfinite(ldr).all())
                       and tuple(ldr.shape) == shape)
            out[cfg] = dict(frame_ms=frame_ms(rp, cam, warmup=3),
                            raster=[rp.width * 2, rp.height * 2],
                            coverage=float(aux["coverage"]),
                            required_work=aux["required_work"])
        return dict(ok=ok and finite, **out)

    def keyed_entry():
        """Config 2's triangles through the keyed forms of rasterize_exact.
        K1 and K3 share the 8x32 bins, so they cover the same pixels, and
        K1's exact depth lies in K3's key bucket except where the
        cross-multiplied compare and the divided keys round a near-tie
        apart (<= 1e-4 of the covered pixels). K3 and K4 find the same
        smallest key except on <= 1e-5 of the pixels: a near-degenerate
        sliver's f32 edge rows can accept pixels outside its screen box, and
        the two cell widths cull those at different distances. The same
        holds between K2 and K4's peel form in the window behind K3's
        depth."""
        rp, cam = get(2)
        batch, w, h = frame_batch(rp, cam), rp.width, rp.height
        d1, t1, _, _ = RE.rasterize_exact(batch, w, h)
        d3, t3, _, req3 = RE.rasterize_exact(batch, w, h, crossz=False)
        d4, t4, _, req4 = RE.rasterize_exact(batch, w, h, quarter=False)
        window = (RE.depth_to_key(d3), torch.full_like(t3, RE.SENTINEL))
        d2, t2, _, _ = RE.rasterize_exact(batch, w, h, depth_window=window)
        d4p, t4p, _, _ = RE.rasterize_exact(batch, w, h, quarter=False,
                                            depth_window=window)
        cov = t1 >= 0
        k1_k3_cov = bool(torch.equal(cov, t3 >= 0))
        off = int((RE.depth_to_key(d1)[cov] != d3.view(torch.int32)[cov]).sum())
        n_cov = int(cov.sum())
        k3_k4_off = int((d3.view(torch.int32) != d4.view(torch.int32)).sum())
        peel_off = int((d2.view(torch.int32) != d4p.view(torch.int32)).sum())
        return dict(ok=k1_k3_cov and off <= 1e-4 * n_cov
                    and k3_k4_off <= 1e-5 * w * h and peel_off <= 1e-5 * w * h
                    and bool((t2 >= 0).any()),
                    k1_k3_same_coverage=k1_k3_cov, k1_outside_k3_bucket=off,
                    covered=n_cov, k3_k4_depth_mismatch=k3_k4_off,
                    k3_k4_coverage_mismatch=int(((t3 >= 0) != (t4 >= 0)).sum()),
                    k3_k4_tid_mismatch=int((t3 != t4).sum()),
                    peel_covered=int((t2 >= 0).sum()),
                    k2_k4peel_depth_mismatch=peel_off,
                    k2_k4peel_tid_mismatch=int((t2 != t4p).sum()),
                    pairs_k3=req3, pairs_k4=req4)

    def draw_list():
        """The draw-list frame: config 1 against the goldens, config 2's
        frame time and counts against the static frame, and a reduced copy
        of config 2 on the card against the CPU."""
        out, ok = {}, True
        for cfg, size, name in ((1, 512, "raster_512"),
                                (None, 128, "raster_example")):
            rp, cam = get(cfg) if cfg else build_example_scene(
                size, size, device="cuda")
            ldr, aux = rp.render(cam, static_path=False)
            good, mean, frac = bands(ldr.cpu().numpy(), golden(name))
            ok &= good and bool(torch.isfinite(ldr).all())
            out[f"golden{size}"] = dict(mean=mean, frac=frac, ok=good)
        out["config1_frame_ms"] = frame_ms(*get(1), static_path=False)
        rp, cam = get(2)
        ldr, aux = rp.render(cam, static_path=False)
        ldr_s, aux_s = rp.render(cam)
        good, mean, frac = bands(ldr.cpu().numpy(), ldr_s.cpu().numpy())
        same_tris = int(aux["total_tris"]) == int(aux_s["total_tris"])
        ok &= (good and same_tris and bool(torch.isfinite(ldr).all())
               and tuple(ldr.shape) == (1080, 1920, 3))
        small = [build_dynamic_scene(400, 256, 128, device=dev)
                 for dev in ("cuda", "cpu")]
        ok_s, mean_s, frac_s = bands(
            small[0][1].render(small[0][2], static_path=False)[0].cpu().numpy(),
            small[1][1].render(small[1][2], static_path=False)[0].numpy())
        return dict(ok=ok and ok_s, **out,
                    config2=dict(
                        frame_ms=frame_ms(rp, cam, warmup=3, static_path=False),
                        visible_count=int(aux["visible_count"]),
                        draw_count=int(aux["draw_count"]),
                        total_tris=int(aux["total_tris"]),
                        static_total_tris=int(aux_s["total_tris"]),
                        tri_capacity=rp._required_tri_capacity(),
                        coverage=float(aux["coverage"]),
                        static_coverage=float(aux_s["coverage"]),
                        vs_static=dict(mean=mean, frac=frac, ok=good)),
                    reduced_vs_cpu=dict(mean=mean_s, frac=frac_s, ok=ok_s))

    for name, fn in (("config1", config1), ("config2", config2),
                     ("translucent", translucent), ("supersample", supersample),
                     ("keyed_entry", keyed_entry), ("draw_list", draw_list)):
        counted(name, fn)
    # the kernels line's launches: K1 and K2 from the raster frames, K3 and
    # K4 from rasterize_exact's keyed forms (no frame runs them), K5 from
    # the draw-list frames, K6 from compare_tiles (no frame runs it)
    frame_phases = ("config1", "config2", "translucent", "supersample")
    launch_path = dict(raster_exact=frame_phases, raster_peel=frame_phases,
                       raster_keyed=("keyed_entry",),
                       raster_classic=("keyed_entry",),
                       raster_tiles=("draw_list",),
                       raster_tiles_binned=("compare_tiles",))
    launches = {k: sum(raster_launches.get(p, {}).get(k, 0) for p in ps)
                for k, ps in launch_path.items()}

    def rt_frame():
        rt, cam = rt_1080()
        _, rt128, cam128 = build_rt_scene(128, 128, device="cuda")
        ok128, mean128, frac128 = bands(rt128.render(cam128)[0].cpu().numpy(),
                                        golden("rt_example"))
        small = [build_rt_scene(96, 64, device=dev) for dev in ("cuda", "cpu")]
        ok_s, mean_s, frac_s = bands(
            small[0][1].render(small[0][2])[0].cpu().numpy(),
            small[1][1].render(small[1][2])[0].numpy())
        ldr, aux = rt.render(cam)
        finite = (bool(torch.isfinite(aux["hdr"]).all())
                  and tuple(ldr.shape) == (1080, 1920, 3))
        ms = frame_ms(rt, cam, frames=10, warmup=2)
        _, rt_f, cam_f = build_rt_scene(1920, 1080, device="cuda")
        rt_f.params = dataclasses.replace(rt_f.params, fuse_bounce=True)
        ms_fused = frame_ms(rt_f, cam_f, frames=10, warmup=2)
        prim = primary_rays_mrays(rt, cam)
        return dict(ok=ok128 and ok_s and finite,
                    golden128=dict(mean=mean128, frac=frac128, ok=ok128),
                    card_vs_cpu_96x64=dict(mean=mean_s, frac=frac_s, ok=ok_s),
                    frame_ms_1080p=ms, frame_ms_1080p_fuse_bounce=ms_fused,
                    config3=prim)

    def grid_rt():
        """Config 2's 10k grid mirrored into a RayTraceRender (1080p)."""
        if "grid" not in rt_scenes:
            eng, rp, cam = build_dynamic_scene(10_000, 1920, 1080,
                                               device="cuda")
            rt = eng.create_ray_trace_render(width=1920, height=1080,
                                             lights=rp.lights)
            rt.add_instances_from(rp)
            rt_scenes["grid"] = (rt, cam)
        return rt_scenes["grid"]

    def rt_grid10k():
        prim = primary_rays_mrays(*grid_rt(), check_every=64)
        return dict(ok=prim["subset_bitwise"], **prim)

    def crowd_rt():
        if "crowd" not in rt_scenes:
            rt_scenes["crowd"] = build_crowd_scene(10_000, 1024, 1024,
                                                   device="cuda")[2:]
        return rt_scenes["crowd"]

    def big_rt():
        """The big model: a 224 x 224 uv sphere (100,352 triangles) among
        cubes at 1920x1080; its BLAS build is timed here, once."""
        if "big" not in rt_scenes:
            _, rt, cam = build_big_model_scene(224, 224, 16, 1920, 1080,
                                               device="cuda")
            t0 = time.perf_counter()
            rt.accel.blas()
            torch.cuda.synchronize()
            rt_scenes["big"] = (rt, cam, time.perf_counter() - t0)
        return rt_scenes["big"][:2]

    counters = (TK.LAUNCHES, TPG.LAUNCHES, RE.LAUNCHES, PR.LAUNCHES)

    def reset_counts():
        for counter in counters:
            for k in counter:
                counter[k] = 0

    def read_counts():
        return {k: v for counter in counters for k, v in counter.items()
                if v}

    def counted_since(before):
        """The launches since `before` (a read_counts()), in the counts of
        the phase that runs."""
        return {k: v - before.get(k, 0) for k, v in read_counts().items()
                if v > before.get(k, 0)}

    def crowd():
        """The 10k crowd through RayTraceRender.render at 1024x1024 (paged
        by prefer_paged), and the 600-instance crowd against
        crowd_paged.png through the paged and the routed (flat) frame. Only
        render calls launch kernels here: the live rays and the hit
        fraction are those of compare_paged's wavefronts of this frame."""
        rt, cam = crowd_rt()
        before = read_counts()
        ldr, aux = rt.render(cam)
        one = counted_since(before)
        finite = (bool(torch.isfinite(aux["hdr"]).all())
                  and tuple(ldr.shape) == (1024, 1024, 3))
        ms = frame_ms(rt, cam, frames=10, warmup=2)
        waves = results["compare_paged"]
        prim = waves["k11_crowd_primary"]
        live = prim["rays"] + waves["k10_any_crowd_shadow"]["active_rays"]
        nominal = 2 * prim["rays"]
        out = dict(frame_ms=ms, paged=rt.accel.prefer_paged(
                       rt.scene.flush().capacity),
                   launches_one_frame=one,
                   nominal_rays=nominal, live_rays=live,
                   mrays_per_s_nominal=mrays(nominal, ms),
                   mrays_per_s_live=mrays(live, ms),
                   hit_fraction=prim["hit_fraction"])
        ok = finite and out["paged"]
        _, _, rt128, cam128 = build_crowd_scene(600, 128, 128, device="cuda")
        for name, paged in (("golden128_paged", True),
                            ("golden128_routed", None)):
            good, mean, frac = bands(
                rt128.render(cam128, paged=paged)[0].cpu().numpy(),
                golden("crowd_paged"))
            out[name] = dict(mean=mean, frac=frac, ok=good)
            ok &= good
        small = [build_crowd_scene(600, 96, 64, device=dev)[2:]
                 for dev in ("cuda", "cpu")]
        good, mean, frac = bands(
            small[0][0].render(small[0][1], paged=True)[0].cpu().numpy(),
            small[1][0].render(small[1][1], paged=True)[0].numpy())
        out["card_vs_cpu_96x64_paged"] = dict(mean=mean, frac=frac, ok=good)
        return dict(ok=ok and good, **out)

    def hybrid():
        """HybridRender: the 128x128 example against hybrid_example.png,
        config 4 at 1920x1080 (flat: K1, K9, K8) and config 2's 10k grid at
        1920x1080 (paged: K1, K10, K11) with each route's launches, and a
        reduced copy of each on the card against the CPU."""
        out, ok = {}, True
        _, hy, cam = build_hybrid_scene(128, 128, device="cuda")
        good, mean, frac = bands(hy.render(cam)[0].cpu().numpy(),
                                 golden("hybrid_example"))
        out["golden128"] = dict(mean=mean, frac=frac, ok=good)
        ok &= good
        for name, build in (("config4", lambda: build_hybrid_scene(
                                1920, 1080, device="cuda")[1:]),
                            ("grid10k", lambda: hybrid_grid(10_000, 1920,
                                                            1080, "cuda"))):
            hy, cam = build()
            before = read_counts()
            ldr, aux = hy.render(cam)
            launches = counted_since(before)
            ok &= (bool(torch.isfinite(aux["hdr"]).all())
                   and tuple(ldr.shape) == (1080, 1920, 3))
            out[name] = dict(frame_ms=frame_ms(hy, cam, frames=10, warmup=2),
                             paged=aux["paged"],
                             coverage=float(aux["coverage"]),
                             launches_one_frame=launches)
            if name == "grid10k":
                hybrid_scenes["grid10k"] = (hy, cam)
            else:
                hybrid_scenes["config4"] = (hy, cam)
        ok &= (not out["config4"]["paged"]) and out["grid10k"]["paged"]
        for name, make, paged in (
                ("example_96x64", lambda dev: build_hybrid_scene(
                    96, 64, device=dev)[1:], None),
                ("grid400_256x128_paged", lambda dev: hybrid_grid(
                    400, 256, 128, dev), True)):
            (hy_c, cam_c), (hy_h, cam_h) = make("cuda"), make("cpu")
            good, mean, frac = bands(
                hy_c.render(cam_c, paged=paged)[0].cpu().numpy(),
                hy_h.render(cam_h, paged=paged)[0].numpy())
            out[f"card_vs_cpu_{name}"] = dict(mean=mean, frac=frac, ok=good)
            ok &= good
        return dict(ok=ok, **out)

    def big_model():
        """The big model in a RayTraceRender at 1920x1080: BLAS build
        seconds, chunk count, frame ms; the primary Mrays/s through K11 is
        compare_paged's timing of this frame's primary rays."""
        rt, cam = big_rt()
        build_s = rt_scenes["big"][2]
        meta = rt.accel.blas()[1]
        before = read_counts()
        ldr, aux = rt.render(cam)
        one = counted_since(before)
        finite = (bool(torch.isfinite(aux["hdr"]).all())
                  and tuple(ldr.shape) == (1080, 1920, 3))
        k11 = results["compare_paged"]["k11_big_primary"]
        capacity = rt.scene.flush().capacity
        paged = rt.accel.prefer_paged(capacity)
        return dict(ok=finite and meta.num_bchunks > 0 and paged,
                    blas_build_s=build_s, blas_chunks=meta.num_bchunks,
                    triangles=2 * 224 * 224, max_depth=meta.max_depth,
                    stack_size=rt.accel.stack_size(capacity),
                    paged=paged, launches_one_frame=one,
                    primary_k11_ms=k11["ms"],
                    primary_mrays_per_s=mrays(k11["rays"], k11["ms"]),
                    hit_fraction=k11["hit_fraction"],
                    frame_ms=frame_ms(rt, cam, frames=5, warmup=1))

    def leaf_rt():
        """The leaf grid at 1920x1080: RayTraceRender.render routed (paged
        by prefer_paged: K10 shadows, K11's alpha form for primary, AO and
        reflection rays) and forced flat (K9 shadows, K8's alpha form),
        HybridRender.render (K1, K10, K11's alpha form), and config 3 with
        half-rate reflections off and on (in the order off, on, on, off):
        median frame ms, with one frame's launches; a reduced copy of each
        (the 400-instance leaf grid or the RT scene, 96x64) on the card
        against the CPU with the golden bands."""
        rt, hy, cam = leaf_grid()
        out, ok = {}, True
        for name, render, kw in (("rt_routed", rt, {}),
                                 ("rt_flat", rt, dict(paged=False)),
                                 ("hybrid", hy, {})):
            before = read_counts()
            ldr, aux = render.render(cam, **kw)
            one = counted_since(before)
            ok &= (bool(torch.isfinite(aux["hdr"]).all())
                   and tuple(ldr.shape) == (1080, 1920, 3))
            out[name] = dict(frame_ms=frame_ms(render, cam, frames=10,
                                               warmup=2, **kw),
                             launches_one_frame=one)
        out["rt_routed"]["paged"] = rt.accel.prefer_paged(
            rt.scene.flush().capacity)
        out["hybrid"]["paged"] = bool(aux["paged"])
        ok &= out["rt_routed"]["paged"] and out["hybrid"]["paged"]
        ok &= all(out[n]["launches_one_frame"].get(k, 0) > 0 for n, k in (
            ("rt_routed", "trace_resolve_paged_alpha"),
            ("rt_flat", "trace_resolve_alpha"),
            ("hybrid", "trace_resolve_paged_alpha")))
        half = {False: [], True: []}
        renders = {}
        for on in (False, True):
            _, r3, c3 = build_rt_scene(1920, 1080, device="cuda")
            r3.params = dataclasses.replace(r3.params,
                                            reflection_half_rate=on)
            renders[on] = (r3, c3)
        for on in (False, True, True, False):
            half[on].append(frame_ms(*renders[on], frames=10, warmup=2))
        out["config3_half_rate"] = dict(
            full_rate_ms=half[False], half_rate_ms=half[True],
            half_over_full=sum(half[True]) / sum(half[False]))

        def reduced(dev, name):
            if name == "config3_half_rate":
                _, r3, c3 = build_rt_scene(96, 64, device=dev)
                r3.params = dataclasses.replace(r3.params,
                                                reflection_half_rate=True)
                return r3, c3, {}
            _, r, h, c = build_leaf_rt_grid(400, 96, 64, device=dev)
            return ((h, c, {}) if name == "hybrid_400"
                    else (r, c, dict(paged=name == "rt_400_paged")))

        for name in ("rt_400_paged", "rt_400_flat", "hybrid_400",
                     "config3_half_rate"):
            (rc, cc, kw), (rh, ch, _) = (reduced("cuda", name),
                                         reduced("cpu", name))
            good, mean, frac = bands(rc.render(cc, **kw)[0].cpu().numpy(),
                                     rh.render(ch, **kw)[0].numpy())
            out[f"card_vs_cpu_{name}_96x64"] = dict(mean=mean, frac=frac,
                                                    ok=good)
            ok &= good
        return dict(ok=ok, **out)

    def route_cost():
        """The scenes prefer_paged sends to the paged layout, each framed
        on both layouts in one call, in the order paged, flat, flat, paged
        (a median of 10 frames each): the 10k crowd at 1024x1024, and
        config 2's 10k grid in a RayTraceRender and in a HybridRender at
        1920x1080."""
        out = {}
        for name, (r, cam) in (("crowd", crowd_rt()), ("rt_grid10k", grid_rt()),
                               ("hybrid_grid10k", hybrid_scenes["grid10k"])):
            ms = {True: [], False: []}
            for paged in (True, False, False, True):
                ms[paged].append(frame_ms(r, cam, frames=10, warmup=2,
                                          paged=paged))
            out[name] = dict(paged_ms=ms[True], flat_ms=ms[False],
                             flat_over_paged=sum(ms[False]) / sum(ms[True]))
        return out

    hybrid_scenes = {}
    rt_launches = {}
    for name, fn in (("rt_frame", rt_frame), ("rt_grid10k", rt_grid10k),
                     ("compare_paged", lambda: compare_paged(
                         crowd_rt(), grid_rt(), big_rt(),
                         (leaf_grid()[0], leaf_grid()[2]))),
                     ("crowd", crowd), ("hybrid", hybrid),
                     ("big_model", big_model), ("leaf_rt", leaf_rt),
                     ("route_cost", route_cost)):
        reset_counts()                  # count only this path's launches
        phase(name, fn)
        rt_launches[name] = (read_counts() if name not in (
            "compare_paged", "route_cost") else {})
    # the plain forms of K7-K9 from rt_frame and of K10/K11 from the paged
    # frames; the alpha forms of K8 and K11 from leaf_rt (K7's and K10's
    # alpha forms back SceneTracer.trace(use_alpha=True), which no frame
    # calls: compare_trace and compare_paged hold them)
    flat_keys = ("trace_scene", "trace_resolve", "trace_bundle")
    paged_keys = ("trace_scene_paged", "trace_resolve_paged")
    launches.update({k: rt_launches["rt_frame"].get(k, 0) for k in flat_keys})
    launch_path.update({k: ("rt_frame",) for k in flat_keys})
    paged_path = ("crowd", "hybrid", "big_model")
    launches.update({k: sum(rt_launches[p].get(k, 0) for p in paged_path)
                     for k in paged_keys})
    launch_path.update({k: paged_path for k in paged_keys})
    alpha_launches = {k: rt_launches.get("leaf_rt", {}).get(k + "_alpha", 0)
                      for k in ("trace_resolve", "trace_resolve_paged")}

    def textured():
        return textured_phase(dict(static=get(2), rt=grid_rt(),
                                   hybrid=hybrid_scenes["grid10k"]),
                              textured_scenes)

    textured_scenes = {}
    counted("textured", textured)
    # K1, K2, K5, K8/K9 (the flat example frames) and K10/K11 (the paged
    # grid frames); K7 runs in no default frame (config 3's cull masks
    # launch it)
    tex_launches = raster_launches["textured"]
    tex_needs = ("raster_exact", "raster_peel", "raster_tiles",
                 "trace_resolve", "trace_bundle") + paged_keys
    for k in tex_needs:
        launches[k] += tex_launches.get(k, 0)
        launch_path[k] = tuple(launch_path[k]) + ("textured",)

    # animation: K1 (config 5's frames, the hybrid G-buffer), K8/K9 (the
    # flat RT and hybrid frames), K10/K11 (the paged crowd); K7 only where a
    # pass's cull masks differ, which none of its frames sets
    reset_counts()
    anim_scenes = {}
    phase("animation", lambda: animation_phase(read_counts, anim_scenes))
    anim = results["animation"]
    anim_launches = anim.get("launches", {})
    anim_needs = ("raster_exact", "trace_resolve", "trace_bundle") + paged_keys
    for k in anim_needs + ("trace_scene",):
        if k in anim_needs or anim_launches.get(k, 0):
            launches[k] += anim_launches.get(k, 0)
            launch_path[k] = tuple(launch_path[k]) + ("animation",)
    # the animation phase's kernel checks, by the row they belong to
    anim_checks = dict(raster_exact="k1_", trace_resolve="k8_",
                       trace_scene_paged="k10_", trace_resolve_paged="k11_")

    probe_keys = tuple(PR.LAUNCHES) + ("trace_scene_steps",
                                       "trace_scene_paged_steps")

    def probes():
        """The profiling path, its launches counted, then the bitwise
        comparisons (uncounted)."""
        reset_counts()
        measured = PR.measure()
        launched = read_counts()
        out = compare_probes(rt_1080(), grid_rt(),
                             (leaf_grid()[0], leaf_grid()[2]))
        ok = out.pop("ok") and all(launched.get(k, 0) > 0
                                   for k in probe_keys)
        return dict(ok=ok, measured=measured, launches=launched, **out)

    phase("probes", probes)
    probe_launches = results["probes"].get("launches", {})
    launches.update({k: probe_launches.get(k, 0) for k in PR.LAUNCHES})
    launch_path.update({k: ("probes",) for k in PR.LAUNCHES})
    # this slice's phases: the native scene core, glTF import, the viewer,
    # the XLA route and the example CLIs (subprocesses, not counted here)
    all_counters = (RE.LAUNCHES, TPL.LAUNCHES, TK.LAUNCHES, TPG.LAUNCHES,
                    PR.LAUNCHES)

    def slice_counts(reset=False):
        if reset:
            for counter in all_counters:
                for k in counter:
                    counter[k] = 0
            return {}
        return {k: v for counter in all_counters for k, v in counter.items()
                if v}

    work = os.path.join(HERE, "build", "smoke")
    phase("native", native_phase)
    slice_launches = {}
    for name, fn in (("gltf", lambda: gltf_phase(work)),
                     ("viewer", viewer_phase)):
        slice_counts(reset=True)
        phase(name, fn)   # the viewer reads its counts after stop()
        slice_launches[name] = slice_counts()
        results[name]["launches"] = slice_launches[name]
    emit(phase="slice_launches", ok=True, **slice_launches)
    phase("xla_route", lambda: xla_route_phase(slice_counts))
    phase("examples", lambda: examples_phase(os.path.join(work, "examples")))
    # K1/K2 (static), K5 (draw list), K10/K11 (the 10k grid's paged RT and
    # hybrid) from gltf; K1 and K8/K9 (the flat RT and hybrid modes) from
    # the viewer
    slice_needs = dict(
        gltf=("raster_exact", "raster_peel", "raster_tiles",
              "trace_scene_paged", "trace_resolve_paged"),
        viewer=("raster_exact", "trace_resolve", "trace_bundle"))
    for p_name, ks in slice_needs.items():
        for k in ks:
            launches[k] += slice_launches[p_name].get(k, 0)
            launch_path[k] = tuple(launch_path[k]) + (p_name,)
    # the sharded frames: (a) NCCL at world size 1 here, (b) four gloo ranks
    # on the card; (b)'s ranks count their main path's launches
    phase("parallel", lambda: parallel_phase(os.path.join(work, "parallel")))
    phase("world_rt", world_rt_phase)
    par_launches = results["parallel"].get("gloo_2x2_one_card", {}).get(
        "launches", {})
    par_needs = ("raster_exact", "raster_peel", "trace_scene",
                 "trace_resolve", "trace_bundle", "trace_scene_paged",
                 "trace_resolve_paged")
    for k in par_needs:
        launches[k] += par_launches.get(k, 0)
        launch_path[k] = tuple(launch_path[k]) + ("parallel",)

    raster_needs = dict(config1=["raster_exact"], config2=["raster_exact"],
                        translucent=["raster_exact", "raster_peel"],
                        supersample=["raster_exact"],
                        keyed_entry=["raster_peel", "raster_keyed",
                                     "raster_classic"],
                        draw_list=["raster_tiles"],
                        compare_tiles=["raster_tiles_binned"])
    hyb = results.get("hybrid", {})
    phase("launches", lambda: dict(
        ok=(all(raster_launches.get(p, {}).get(k, 0) > 0
                for p, ks in raster_needs.items() for k in ks)
            and all(rt_launches["rt_frame"].get(k, 0) > 0
                    for k in flat_keys)
            and rt_launches["rt_grid10k"].get("trace_scene", 0) > 0
            and all(rt_launches[p].get(k, 0) > 0 for p in paged_path
                    for k in paged_keys)
            and all(v > 0 for v in alpha_launches.values())
            and all(hyb.get("config4", {}).get("launches_one_frame", {})
                    .get(k, 0) > 0 for k in ("raster_exact", "trace_bundle",
                                             "trace_resolve"))
            and all(hyb.get("grid10k", {}).get("launches_one_frame", {})
                    .get(k, 0) > 0 for k in ("raster_exact",
                                             "trace_scene_paged",
                                             "trace_resolve_paged"))
            and all(probe_launches.get(k, 0) > 0 for k in probe_keys)
            and all(tex_launches.get(k, 0) > 0 for k in tex_needs)
            and all(anim_launches.get(k, 0) > 0 for k in anim_needs)
            and all(slice_launches[p].get(k, 0) > 0
                    for p, ks in slice_needs.items() for k in ks)
            and all(par_launches.get(k, 0) > 0 for k in par_needs)),
        **raster_launches, **rt_launches, probes=probe_launches,
        animation=anim_launches, parallel=par_launches, **slice_launches))
    phase("sync", lambda: {f"config{c}": sync_cost(*get(c)) for c in (1, 2)})
    if args.profile:
        out_dir = os.path.join(HERE, "chiprun_out")
        for c in (1, 2, "translucent", "ss_config2"):
            phase(f"profile{c}", lambda c=c: profile_frames(
                functools.partial(get(c)[0].render, get(c)[1]),
                raster_stages(),
                os.path.join(out_dir, f"profile_config{c}.txt")))
        phase("profile_draw_list", lambda: profile_frames(
            functools.partial(get(2)[0].render, get(2)[1], static_path=False),
            draw_list_stages(),
            os.path.join(out_dir, "profile_config2_draw_list.txt")))
        phase("profile_rt", lambda: profile_frames(
            functools.partial(rt_1080()[0].render, rt_1080()[1]), rt_stages(),
            os.path.join(out_dir, "profile_rt_1080p.txt")))
        phase("profile_crowd", lambda: profile_frames(
            functools.partial(crowd_rt()[0].render, crowd_rt()[1]),
            paged_rt_stages(), os.path.join(out_dir, "profile_crowd.txt")))
        phase("profile_leaf_rt", lambda: profile_frames(
            functools.partial(leaf_grid()[0].render, leaf_grid()[2]),
            leaf_rt_stages(), os.path.join(out_dir, "profile_leaf_rt.txt")))
        for name, stages in (("static", raster_stages),
                             ("hybrid", hybrid_stages)):
            if name in textured_scenes:
                r, cam = textured_scenes[name]
                phase(f"profile_textured_{name}", lambda r=r, cam=cam,
                      st=stages, n=name: profile_frames(
                          functools.partial(r.render, cam), st(),
                          os.path.join(out_dir,
                                       f"profile_textured_grid_{n}.txt")))
        anim_stages = dict(config5=raster_stages, rt_flat_refit=rt_stages,
                           rt_flat_resplit=rt_stages,
                           crowd_refit=paged_rt_stages,
                           crowd_resplit=paged_rt_stages,
                           hybrid=hybrid_stages)
        for name, stages in anim_stages.items():
            if name in anim_scenes:
                r, cam = anim_scenes[name]
                kw = {} if name == "config5" else dict(time=0.7)
                phase(f"profile_animation_{name}", lambda r=r, cam=cam,
                      st=stages, n=name, kw=kw: profile_frames(
                          functools.partial(r.render, cam, **kw),
                          st() + anim_stages_extra(),
                          os.path.join(out_dir, f"profile_animation_{n}.txt")))
        for name in ("config4", "grid10k"):
            if name in hybrid_scenes:
                hy, cam = hybrid_scenes[name]
                phase(f"profile_hybrid_{name}", lambda hy=hy, cam=cam, n=name:
                      profile_frames(functools.partial(hy.render, cam),
                                     hybrid_stages(),
                                     os.path.join(out_dir,
                                                  f"profile_hybrid_{n}.txt")))

    cmp = results.get("compare", {})
    cmp1, cmp2 = cmp.get("config1", {}), cmp.get("config2", {})
    ck = results.get("compare_keyed", {})
    # the compare_keyed cases of each keyed kernel; the first is timed
    keyed_cases = dict(raster_peel=[f"k2_translucent_layer{i}"
                                    for i in range(1, 5)]
                       + ["k2_config2_layer1", "k2_config2_layer2"],
                       raster_keyed=["k3_config2"],
                       raster_classic=[
                           "k4_config2", "k4_peel_config2", "k4_config2_tail",
                           "k4_ragged", "k4_peel_ragged", "k4_window",
                           "k4_peel_window", "k4_peel_closed", "k4_long",
                           "k4_peel_long"])
    ctl = results.get("compare_tiles", {})
    # the compare_tiles cases of each tile kernel; the first is timed
    tile_cases = dict(raster_tiles=["k5_config2", "k5_config1", "k5_ragged",
                                    "k5_adversarial"],
                      raster_tiles_binned=["k6_config2",
                                           "k6_config2_presorted",
                                           "k6_adversarial"])
    ct = results.get("compare_trace", {})
    # the wavefront each traversal kernel is timed on (all cases in the
    # compare_trace line)
    timed_on = dict(trace_scene="k7_closest_primary",
                    trace_resolve="k8_primary", trace_bundle="k9_shadow_ao",
                    trace_scene_paged="k10_grid_primary",
                    trace_resolve_paged="k11_crowd_primary")
    prefix = dict(trace_scene="k7", trace_resolve="k8", trace_bundle="k9",
                  trace_scene_paged="k10", trace_resolve_paged="k11")
    pb = results.get("probes", {})
    # the probes' cases of each K12 kernel, as (compare_probes case,
    # measure() entry); the first is the row's
    probe_cases = dict(
        chunk_stream=[(f"k12a_{f}", f) for f in ("bulk", "plain", "cp_async")],
        chunk_stream_sweep=[
            (f"k12b_{n}", n) for n in ["chained_6144"] + [
                f"{'dbuf' if dbuf else 'chained'}_{blk}"
                for blk, dbuf in PR.SWEEP_CASES
                if (blk, dbuf) != (6144, False)]],
        pass_through=[(f"k12c_r{r}", f"r{r}") for r in PR.PASS_RAYS])
    # the step-count forms of K7/K10: the compare_probes case timed
    steps_on = dict(trace_scene="k7_steps_primary",
                    trace_scene_paged="k10_steps_grid_primary")

    def probe_row(name):
        cases = probe_cases[name]
        meas = pb.get("measured", {}).get(name, {})
        first, m0 = pb.get(cases[0][0], {}), meas.get(cases[0][1], {})
        row = dict(
            max_abs_err=max(pb.get(c, {}).get("max_abs_err", float("nan"))
                            for c, _ in cases),
            ms=m0.get("ms"), plain_ms=first.get("plain_ms"),
            bound_ms=first.get("bound_ms"), bound_by=first.get("bound_by"),
            library_ms=m0.get("copy_ms"), timed_on=cases[0][0])
        for c, m in cases:
            row["ms_" + c] = meas.get(m, {}).get("ms")
            if "us_per_step_events" in meas.get(m, {}):
                row["us_per_step_" + c] = meas[m]["us_per_step_events"]
                row["us_per_step_globaltimer_" + c] = \
                    meas[m]["us_per_step_globaltimer"]
            if "copy_ms" in meas.get(m, {}):
                row["library_ms_" + c] = meas[m]["copy_ms"]
        return row

    rows = []
    for k in KERNELS:
        if k["name"] == "raster_exact":
            k1_cases = [c for c, v in cmp.items() if isinstance(v, dict)]
            row = dict(
                max_abs_err=max([cmp[c].get("max_abs_err", float("nan"))
                                 for c in k1_cases] or [float("nan")]),
                ms=cmp2.get("ms"), plain_ms=cmp2.get("plain_ms"),
                bound_ms=cmp2.get("bound_ms"), bound_by=cmp2.get("bound_by"),
                timed_on="config2", plain_ms_config1=cmp1.get("plain_ms"))
            row.update({"ms_" + c: cmp[c].get("ms") for c in k1_cases
                        if c != "config2"})
            row.update({f: cmp2.get(f) for f in (
                "candidates", "tested", "kept_share", "candidates_evaluated",
                "lists")})
            row.update({f"{f}_{c}": cmp[c].get(f) for c in k1_cases
                        if c != "config2" for f in ("bound_ms", "kept_share")})
        elif k["name"] in probe_cases:
            row = probe_row(k["name"])
        elif k["name"] in keyed_cases or k["name"] in tile_cases:
            names, ck_ = ((keyed_cases[k["name"]], ck) if k["name"] in keyed_cases
                          else (tile_cases[k["name"]], ctl))
            case = ck_.get(names[0], {})
            row = dict(
                max_abs_err=max(ck_.get(c, {}).get("max_abs_err", float("nan"))
                                for c in names),
                ms=case.get("ms"), plain_ms=case.get("plain_ms"),
                bound_ms=case.get("bound_ms"), bound_by=case.get("bound_by"),
                timed_on=names[0])
            row.update({"ms_" + c: ck_.get(c, {}).get("ms") for c in names[1:]})
            if k["name"] in tile_cases:   # the work the rejection leaves
                row.update({f: case.get(f) for f in (
                    "candidates", "tested", "candidates_evaluated", "lists",
                    "ranges")})
            else:                         # the same, and each case's bound,
                row.update({f: case.get(f) for f in (   # kept and skipped
                    "candidates", "tested", "kept_share",
                    "candidates_evaluated", "skipped_share", "lists")})
                row.update({f"{f}_{c}": ck_.get(c, {}).get(f)
                            for c in names[1:] for f in (
                                "bound_ms", "kept_share", "skipped_share")})
        else:
            src = ct if prefix[k["name"]] in ("k7", "k8", "k9") else \
                results.get("compare_paged", {})
            names = [c for c in src if c.startswith(prefix[k["name"]])
                     and "bitwise" in src[c]]
            case = src.get(timed_on[k["name"]], {})
            row = dict(
                max_abs_err=max([src[c].get("max_abs_err", float("nan"))
                                 for c in names] or [float("nan")]),
                ms=case.get("ms"), plain_ms=case.get("plain_ms"),
                bound_ms=case.get("bound_ms"), bound_by=case.get("bound_by"),
                timed_on=timed_on[k["name"]])
            row.update({"ms_" + c: src[c].get("ms") for c in names
                        if c != timed_on[k["name"]]})
            if k["name"] == "trace_bundle":   # every wave's bound and live
                for c in names:                 # share, the walks' pops
                    row.update({f"{f}_{c}": src[c].get(f) for f in (
                        "bound_ms", "plain_walk_bound_ms", "live")})
                row.update({f: case.get(f) for f in (
                    "plain_walk_bound_ms", "live", "active_samples", "bytes",
                    "visits", "union_visits")})
            if k["name"] == "trace_scene_paged":   # K7 on the same rays
                row["ms_k7_grid_primary_flat"] = src.get(
                    "k7_grid_primary_flat", {}).get("ms")
            if k["name"] in alpha_launches:   # the alpha form: leaf_rt
                case = src.get(prefix[k["name"]] + "_alpha_leaf_primary", {})
                row["alpha"] = dict(
                    ms_plain_form_same_rays=src.get(
                        prefix[k["name"]] + "_leaf_primary", {}).get("ms"),
                    ms=case.get("ms"), plain_ms=case.get("plain_ms"),
                    bound_ms=case.get("bound_ms"),
                    bound_by=case.get("bound_by"),
                    timed_on=prefix[k["name"]] + "_alpha_leaf_primary",
                    launches=alpha_launches[k["name"]],
                    launches_from=["leaf_rt"])
            if k["name"] in steps_on:   # the step-count form: probes
                case = pb.get(steps_on[k["name"]], {})
                row["steps"] = dict(
                    ms=case.get("ms"), plain_ms=case.get("plain_ms"),
                    bound_ms=case.get("bound_ms"),
                    bound_by=case.get("bound_by"),
                    steps_mean=case.get("steps_mean"),
                    steps_max=case.get("steps_max"),
                    timed_on=steps_on[k["name"]],
                    launches=probe_launches.get(k["name"] + "_steps", 0),
                    launches_from=["probes"])
        if k["name"] in RE.LAUNCHES:
            row["launches_keyed_entry"] = raster_launches.get(
                "keyed_entry", {}).get(k["name"], 0)
        for c, v in anim.get("checks", {}).items():   # the animation path's
            if c.startswith(anim_checks.get(k["name"], "-")):   # inputs
                row["ms_" + c] = v.get("ms")
                errs = [e for e in (row.get("max_abs_err"),
                                    v.get("max_abs_err")) if e == e]
                row["max_abs_err"] = max(errs) if errs else float("nan")
        if k["name"] in launch_path and "animation" in launch_path[k["name"]]:
            row["launches_animation"] = anim_launches.get(k["name"], 0)
        for p_name in slice_needs:   # this slice's phases, counted or not
            row["launches_" + p_name] = slice_launches[p_name].get(
                k["name"], 0)
        row["launches_parallel"] = par_launches.get(k["name"], 0)
        win_case = dict(raster_exact="k1_config2_window",
                        raster_peel="k2_translucent_window_layer1").get(
                            k["name"])
        if win_case:   # the windowed form (parallel phase, 960x540 window)
            row["window"] = results["parallel"].get(
                "windowed_kernels", {}).get(win_case)
            err = (row["window"] or {}).get("max_abs_err", float("nan"))
            if err == err:
                row["max_abs_err"] = max(row["max_abs_err"], err)
        row["launches_xla_route"] = sum(   # 0: the route runs no kernel
            v.get("launches", {}).get(k["name"], 0) for v in results.get(
                "xla_route", {}).values() if isinstance(v, dict))
        n_alpha = alpha_launches.get(k["name"], 0)
        n_steps = (probe_launches.get(k["name"] + "_steps", 0)
                   if k["name"] in steps_on else 0)
        rows.append(dict(k, launches=launches.get(k["name"], 0) + n_alpha
                         + n_steps,
                         launches_from=list(launch_path[k["name"]])
                         + (["leaf_rt"] if k["name"] in alpha_launches
                            else [])
                         + (["probes"] if n_steps else []),
                         library_ms=row.pop("library_ms", None), **row))
    emit(kernels=rows)
    print(smi, flush=True)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    emit(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
