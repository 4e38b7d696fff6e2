"""The PyTorch port's ``read_image`` on what its imaging-library reference
(the JAX package's ``read_image``, PIL) makes of PNG transparency keys,
and on the JPEG forms both packages refuse, on the CPU.

Two tests (the image formats both decode are
tests/test_torch_io.py::test_image_formats_match_jax):

1. a gray PNG's ``tRNS`` key: 16-bit gray (PIL's "I;16" -> RGBA compares
   the clipped gray with the key's low byte: key 200 makes the pixels of
   200 transparent, key 1000 those of 232, none of 1000), with the 8-bit
   gray, 8-bit RGB and 16-bit RGB keys PIL ignores, bitwise;
2. 12- and 16-bit, hierarchical (SOF5-SOF7, SOF13), arithmetic lossless
   (SOF11), 2-component and non-integral-sampling JPEGs: both packages
   refuse them, the port with NotImplementedError naming the form, and
   its glTF loader naming the glTF image.
"""

import os

import numpy as np
import pytest
import torch

from paperrenderer_tpu_torch.io.image import read_image

import test_torch_io as IO


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's tests (tier-1 runs
    several pytest workers on the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trns_case(case):
    from paperrenderer_tpu.io.image import read_image as jax_read

    color, depth, key = case
    rng = np.random.default_rng(key + depth)
    c = {0: 1, 2: 3}[color]
    img = rng.integers(0, 60000 if depth == 16 else 256, (9, 13, c)).astype(
        np.uint16 if depth == 16 else np.uint8)
    if c == 1:   # the gray the key's low byte names, and one above 255
        img[0, :3, 0] = [200, 232, 1000] if depth == 16 else key & 0xFF
    trns = np.array([key] * c, ">u2")
    for interlace in (0, 1):
        data = IO._png_raw(img, color, depth, interlace, trns=trns)
        want, got = jax_read(data), read_image(data)
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_array_equal(got, want)
        if color == 0 and depth == 16:   # the key really makes alpha 0
            assert (want[..., 3] == 0).any(), case


def test_gray16_trns_matches_jax():
    """A 16-bit gray PNG with a tRNS key decodes to PIL's RGBA alpha (the
    port once left every pixel opaque): keys 200, 1000 (low byte 232)
    and 65000, above every sample (low byte 232); 8-bit gray, 8-bit RGB
    and 16-bit RGB keys, which PIL ignores, stay ignored."""
    cases = [(0, 16, k) for k in (200, 1000, 65000)]
    cases += [(0, 8, 77), (2, 8, 77), (2, 16, 1000)]
    IO._each(cases, _trns_case)


_SOF = dict(sof5=0xC5, sof6=0xC6, sof7=0xC7, sof11=0xCB, sof13=0xCD)


def _refused(case):
    """``case``'s JPEG: a writer's file with its precision or SOF marker
    changed, a 2-component file, or 3:2 sampling."""
    cs = IO._writers()
    img = np.random.default_rng(4).integers(0, 256, (16, 24), np.uint8)
    kind, *arg = case.split("_")
    if kind == "fractional":
        return cs.write_jpeg([img] * 3, [(3, 1), (2, 1), (1, 1)])
    if kind == "components":
        return cs.write_jpeg([img] * int(arg[0]))
    lossless = kind in ("lossless", "sof7", "sof11")
    data = bytearray(cs.write_lossless_jpeg([img]) if lossless
                     else cs.write_jpeg([img] * 3))
    sof = data.index(b"\xff\xc3" if lossless else b"\xff\xc0")
    if arg:
        data[sof + 4] = int(arg[0])           # the sample precision
    else:
        data[sof + 1] = _SOF[kind]
    return bytes(data)


REFUSED = {"bits_12": "12-bit", "bits_16": "16-bit", "lossless_12": "12-bit",
           "sof5": "hierarchical", "sof6": "hierarchical",
           "sof7": "hierarchical", "sof11": "arithmetic-coded lossless",
           "sof13": "arithmetic-coded hierarchical",
           "components_2": "2 components", "fractional": "sampling"}


def test_refused_jpegs_match_jax(tmp_path):
    """12- and 16-bit, hierarchical, arithmetic lossless, 2-component and
    3:2-sampled JPEGs: the JAX package refuses each (PIL's OSError or
    UnidentifiedImageError), the port raises NotImplementedError naming
    the form; as glTF image 0 of a .gltf, the port's loader names the
    image and the JAX loader refuses it too."""
    from paperrenderer_tpu.io import gltf as JG
    from paperrenderer_tpu.io.image import read_image as jax_read
    from paperrenderer_tpu_torch.io import gltf as TG

    import paperrenderer_tpu as JPKG
    import paperrenderer_tpu_torch as TPKG

    def check(case):
        data = _refused(case)
        with pytest.raises(OSError):      # UnidentifiedImageError is one
            jax_read(data)
        with pytest.raises(NotImplementedError, match=REFUSED[case]):
            read_image(data)
        if case in ("bits_12", "sof5"):
            d = os.path.join(str(tmp_path), case)
            os.makedirs(d)
            path = IO._make_gltf(d, data)
            with pytest.raises(NotImplementedError,
                               match=f"glTF image 0: .*{REFUSED[case]}"):
                TG.load_gltf(path, TPKG.GeometryArena())
            with pytest.raises(OSError):
                JG.load_gltf(path, JPKG.GeometryArena())

    IO._each(list(REFUSED), check)
