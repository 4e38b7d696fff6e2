"""Example: a pure ray-traced frame (RayTraceRender, the reference's RT path).

    python -m paperrenderer_tpu_torch.examples.render_rt [--size 192]
        [--out rt.png] [--cpu]
"""

from __future__ import annotations

import sys

from . import _cli


def main(argv=None) -> int:
    p = _cli.parser(__doc__)
    p.add_argument("--size", type=int, default=192)
    p.add_argument("--out", default="rt.png")
    p.add_argument("--frames", type=int, default=3)
    args = p.parse_args(argv)
    dev = _cli.device(args)

    from ..io.image import write_png
    from ..scenes import build_rt_scene

    _, rt, cam = build_rt_scene(args.size, args.size, device=dev)
    first, ms, (ldr, _) = _cli.time_frames(lambda: rt.render(cam), dev,
                                           args.frames)
    print(f"first frame: {first:.2f}s; steady: {ms:.1f} ms/frame")
    write_png(args.out, ldr)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
