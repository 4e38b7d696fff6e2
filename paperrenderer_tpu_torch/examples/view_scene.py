"""Serve the example scene through the live HTTP viewer.

The headless analogue of the reference example's windowed loop
(example/src/main.cpp frame loop + GuiRender.cpp ImGui panel): streams
frames at whatever rate the device sustains and exposes material sliders,
a raster<->RT mode switch, camera moves and per-frame statistics at
http://HOST:PORT (default 127.0.0.1:8080).

    python -m paperrenderer_tpu_torch.examples.view_scene [--size 256]
        [--rt] [--frames 200] [--out last.png] [--cpu]
"""

from __future__ import annotations

import sys
import time

from . import _cli


def main(argv=None) -> int:
    p = _cli.parser(__doc__)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--rt", action="store_true",
                   help="also register the pure-RT and hybrid modes")
    p.add_argument("--frames", type=int, default=0,
                   help="exit after N frames (0 = run until Ctrl-C)")
    p.add_argument("--out", default=None,
                   help="write the last presented frame here on exit")
    args = p.parse_args(argv)
    dev = _cli.device(args)

    from ..render import HybridRender, RayTraceRender
    from ..scenes import build_example_scene
    from ..utils.stats import StatisticsTracker
    from ..viewer import Viewer

    stats = StatisticsTracker()
    rp, cam = build_example_scene(args.size, args.size, device=dev)
    renders = {"raster": rp}
    if args.rt:
        # raster <-> RT toggle over the SAME scene (GuiRender.cpp:79-87)
        rt = RayTraceRender(rp.scene, rp.materials, width=args.size,
                            height=args.size, lights=rp.lights,
                            shadow_samples=2)
        rt.add_instances_from(rp)
        hy = HybridRender(rp.scene, rp.materials, width=args.size,
                          height=args.size, lights=rp.lights)
        hy.add_instances_from(rp)
        renders.update(rt=rt, hybrid=hy)
    for r in renders.values():   # build the kernels on this thread
        r.render(cam)
    v = Viewer(renders, cam, host=args.host, port=args.port,
               statistics=stats).start()
    print(f"viewer at {v.url} (modes: {', '.join(renders)})", flush=True)
    try:
        if args.frames:
            if not v.wait_frame(args.frames, timeout=3600):
                print("timed out waiting for frames", file=sys.stderr)
                return 1
        else:
            while True:
                time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        v.stop()
    s = v.snapshot_stats()
    print(f"served {s['frame']} frames at ~{s['fps']:.1f} fps")
    if args.out and v._frame_png is not None:
        with open(args.out, "wb") as f:
            f.write(v._frame_png)
        print("wrote", args.out)
    if "error" in s:
        print("frame error:", s["error"], file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
