"""Example: a hybrid frame, raster G-buffer + RT shadows, AO and reflections.

    python -m paperrenderer_tpu_torch.examples.render_hybrid [--size 256]
        [--out hybrid.png] [--cpu]
"""

from __future__ import annotations

import sys

from . import _cli


def main(argv=None) -> int:
    p = _cli.parser(__doc__)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--out", default="hybrid.png")
    p.add_argument("--frames", type=int, default=3)
    args = p.parse_args(argv)
    dev = _cli.device(args)

    from ..io.image import write_png
    from ..scenes import build_hybrid_scene

    _, hy, cam = build_hybrid_scene(args.size, args.size, device=dev)
    first, ms, (ldr, aux) = _cli.time_frames(lambda: hy.render(cam), dev,
                                             args.frames)
    print(f"first frame: {first:.2f}s  coverage={float(aux['coverage']):.3f}; "
          f"steady: {ms:.1f} ms/frame")
    write_png(args.out, ldr)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
