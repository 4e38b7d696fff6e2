"""Example: a dynamic instanced scene (bench configs 2 and 5).

N instances animated on the device every frame (no per-instance host
work), rendered through the static frame: expand, K1 raster, shade,
tonemap (``scenes.run_dynamic``).

    python -m paperrenderer_tpu_torch.examples.render_dynamic [--n 10000]
        [--width 1920] [--height 1080 | --size N] [--frames 20]
        [--out dynamic.png] [--cpu]
"""

from __future__ import annotations

import statistics
import sys

from . import _cli


def main(argv=None) -> int:
    p = _cli.parser(__doc__)
    p.add_argument("--n", type=int, default=10_000)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--size", type=int, default=None,
                   help="a square image of this size (overrides both)")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = _cli.device(args)
    w, h = ((args.size, args.size) if args.size
            else (args.width, args.height))

    from ..io.image import write_png
    from ..scenes import run_dynamic

    ms, ldr, aux = run_dynamic(args.n, w, h, frames=args.frames, device=dev)
    med = statistics.median(ms) if ms else float("nan")
    print(f"n={args.n} {w}x{h}: {med:.2f} ms/frame (median of {len(ms)}), "
          f"visible={int(aux['visible_count'])} tris={int(aux['total_tris'])} "
          f"coverage={float(aux['coverage']):.3f}")
    if args.out:
        write_png(args.out, ldr)
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
