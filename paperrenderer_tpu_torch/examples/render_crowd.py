"""Example: a many-instance ray-traced crowd (the paged layout's showcase).

10k+ instances traced through the paged traversal kernels
(ops/trace_paged.py): the TLAS is walked chunk by chunk, so the traced
scene's size is bounded by device memory, like the reference's driver TLAS
(AccelerationStructure.cpp:479-616).

    python -m paperrenderer_tpu_torch.examples.render_crowd [--n 10000]
        [--size 512] [--out crowd.png] [--cpu]
"""

from __future__ import annotations

import sys

from . import _cli


def main(argv=None) -> int:
    p = _cli.parser(__doc__)
    p.add_argument("--n", type=int, default=10_000)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", default="crowd.png")
    p.add_argument("--frames", type=int, default=3)
    args = p.parse_args(argv)
    dev = _cli.device(args)

    from ..io.image import write_png
    from ..scenes import build_crowd_scene

    _, _, rt, cam = build_crowd_scene(args.n, args.size, args.size, device=dev)
    first, ms, (ldr, _) = _cli.time_frames(lambda: rt.render(cam), dev,
                                           args.frames)
    paged = rt.accel.prefer_paged(rt.scene.flush().capacity)
    print(f"first frame (kernel builds included): {first:.2f}s; "
          f"steady: {ms:.1f} ms/frame; layout {'paged' if paged else 'flat'}")
    write_png(args.out, ldr)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
