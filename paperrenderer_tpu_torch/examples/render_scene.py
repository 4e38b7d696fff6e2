"""Example: build the example scene through the public API and render it.

The analogue of the reference example app's raster path
(example/src/main.cpp): several models, per-slot materials, point lights,
camera, tonemap, rendered headless and written to PNG.

    python -m paperrenderer_tpu_torch.examples.render_scene [--size 512]
        [--out scene.png] [--cpu]
"""

from __future__ import annotations

import sys

from . import _cli


def main(argv=None) -> int:
    p = _cli.parser(__doc__)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", default="scene.png")
    p.add_argument("--frames", type=int, default=5)
    args = p.parse_args(argv)
    dev = _cli.device(args)

    from ..io.image import write_png
    from ..scenes import build_example_scene

    rp, cam = build_example_scene(args.size, args.size, device=dev)
    first, ms, (ldr, aux) = _cli.time_frames(lambda: rp.render(cam), dev,
                                             args.frames)
    print(f"first frame (kernel builds included): {first:.2f}s; "
          f"steady: {ms:.1f} ms/frame")
    print(f"coverage={float(aux['coverage']):.3f} "
          f"visible={int(aux['visible_count'])} tris={int(aux['total_tris'])}")
    write_png(args.out, ldr)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
