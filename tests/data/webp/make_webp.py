"""Write the WebP textures that chip_smoke.py's gltf phase loads
(GLTF_CONTAINERS): config 2's grid textures
(``paperrenderer_tpu_torch.scenes._grid_textures(0)``) through PIL's WebP
encoder (libwebp), since the card host has no imaging library:

  * base0_lossy.webp: material 0's 1024^2 base colour, lossy, quality 75;
  * base1_alpha.webp: material 1's 1024^2 base colour with
    chip_smoke.alpha_pattern as alpha, lossy, quality 75 (the alpha
    lossless-compressed and filtered, libwebp's defaults);
  * emissive3_lossless.webp: material 3's 256^2 emissive map, lossless.

Run from the repository root: ``python tests/data/webp/make_webp.py``.
It writes libwebp_version.txt beside the files (the files in the
repository were written with libwebp 1.6.0).
"""

import importlib.util
import io
import os
import sys

import numpy as np
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)

from paperrenderer_tpu_torch.scenes import _grid_textures  # noqa: E402


def _alpha_pattern():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.alpha_pattern


def main():
    tex = _grid_textures(0)
    base1 = tex[1]["base_texture"]
    rgba = np.concatenate(
        [base1, _alpha_pattern()(*base1.shape[:2])[..., None]], -1)
    files = {"base0_lossy.webp": (tex[0]["base_texture"], dict(quality=75)),
             "base1_alpha.webp": (rgba, dict(quality=75)),
             "emissive3_lossless.webp": (tex[3]["emissive_texture"],
                                         dict(lossless=True))}
    for name, (img, kw) in files.items():
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "WEBP", **kw)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(buf.getvalue())
        print(name, len(buf.getvalue()), "bytes")
    version = features.version("webp")
    with open(os.path.join(HERE, "libwebp_version.txt"), "w") as f:
        f.write(f"libwebp {version}\n")
    print("libwebp", version)


if __name__ == "__main__":
    main()
