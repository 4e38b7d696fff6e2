"""Example: textured materials through the full pipeline.

Procedural checker/gradient images become baseColor, emissive and
metallicRoughness textures (the reference Image + combined sampler path,
VulkanResources.cpp:640-1003), packed into the shared atlas and sampled
with mip selection in the deferred shade.

    python -m paperrenderer_tpu_torch.examples.render_textured [--size 512]
        [--out textured.png] [--rt] [--cpu]
"""

from __future__ import annotations

import sys

from . import _cli


def main(argv=None) -> int:
    p = _cli.parser(__doc__)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", default="textured.png")
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--rt", action="store_true",
                   help="the ray-traced frame instead of the raster one")
    args = p.parse_args(argv)
    dev = _cli.device(args)

    from ..io.image import write_png
    from ..render import RayTraceRender
    from ..scenes import build_textured_scene

    scene, registry, rp, cam = build_textured_scene(args.size, args.size,
                                                    device=dev)
    render = rp
    if args.rt:
        # the same instances and materials in the RT pass
        render = RayTraceRender(scene, registry, width=args.size,
                                height=args.size, lights=rp.lights,
                                shadow_samples=1, reflection_samples=1,
                                ao_samples=1)
        render.add_instances_from(rp)
    first, ms, (ldr, _) = _cli.time_frames(lambda: render.render(cam), dev,
                                           args.frames)
    print(f"first frame (kernel builds included): {first:.2f}s; "
          f"steady: {ms:.1f} ms/frame")
    write_png(args.out, ldr)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
