"""The PyTorch port's ``read_image`` on what its imaging-library reference
(the JAX package's ``read_image``, PIL) makes of PNG transparency keys,
of the container formats BMP/DIB, TGA, GIF, WebP, DDS, TIFF, Netpbm, QOI,
ICO/CUR, PSD, SGI, PCX/DCX, BLP and FTEX, and on the forms both packages
refuse, on the CPU.

Thirteen tests (the PNG and JPEG forms both decode are
tests/test_torch_io.py::test_image_formats_match_jax):

1. a gray PNG's ``tRNS`` key: 16-bit gray (PIL's "I;16" -> RGBA compares
   the clipped gray with the key's low byte: key 200 makes the pixels of
   200 transparent, key 1000 those of 232, none of 1000), with the 8-bit
   gray, 8-bit RGB and 16-bit RGB keys PIL ignores, bitwise;
2. 12- and 16-bit, hierarchical (SOF5-SOF7, SOF13), arithmetic lossless
   (SOF11), 2-component and non-integral-sampling JPEGs: both packages
   refuse them, the port with NotImplementedError naming the form, and
   its glTF loader naming the glTF image;
3. BMP, TGA and GIF, bitwise, at 1x1, 17x3, 33x31 and 64x64: what PIL
   writes (BMP and DIB in 1, L, P, RGB and RGBA; TGA in L, LA, P, RGB and
   RGBA, raw and run-length, both orientations; GIF as P with and
   without transparency, interlaced, from L, and animated) and what
   chip_smoke.py's numpy writers write (``test_bmp_tga_gif_match_jax``);
4. WebP, bitwise: lossless (exact and not, methods 0, 4 and 6; 2, 4, 16,
   200 and many colours), lossy (quality 5, 50, 95, methods 0 and 6),
   lossy with alpha (alpha_quality 100 and 30), a two-frame animation,
   one whose first frame is offset in the canvas, and PIL's lossy files
   re-encoded for the simple loop filter, for sharpness 3 and 6 and over
   2, 4 and 8 token partitions (options PIL does not offer);
5. refusals: BMP bitfields outside Pillow's sets, BI_JPEG, BI_PNG, 2-bit
   BMPs, 32-bit and 15-bit TGA colour maps, a TGA run past its row, DDS,
   TIFF and QOI headers with no image, PAM and colour PFM, a TIFF with a
   broken JPEG strip, a big-endian BigTIFF, 16-bit / ZIP / PSB PSDs, BLP2
   raw BGRA, ...: the port names the form where PIL raises; the forms PIL
   reads and the port leaves for later (TIFF CCITT, CIELab, old-style
   JPEG, Zstandard; PSD LAB) are named "not yet ported"; chip_smoke.py's
   GLTF_CONTAINERS2 and GLTF_CONTAINERS3 forms decode bitwise; a .gltf
   with an external .webp image and one with an embedded BMP load as the
   JAX loader loads them;
6-9. DDS, TIFF / BigTIFF, Netpbm + QOI and ICO / CUR, bitwise at the four
   sizes of 3: PIL's writers' files, chip_smoke.py's numpy writers'
   (``write_dds`` and ``encode_bcn``, ``write_tiff``, ``write_ppm``,
   ``write_qoi``, ``write_ico``) and seeded random BC blocks;
10-13. PSD, the TIFF forms PIL reads through libtiff (JPEG, YCbCr, LZMA,
   old-style LZW, 12-bit gray), SGI + PCX / DCX and BLP / FTEX, bitwise
   (or refused by both where PIL refuses, each case compared bitwise at
   one size at least) at 1x1, 7x5 and 33x17: PIL's
   writers where it has one (SGI, PCX, BLP palettes, TIFF JPEG and LZMA)
   and chip_smoke.py's numpy writers (``write_psd``, ``write_tiff``,
   ``write_sgi``, ``write_pcx``, ``write_dcx``, ``write_blp``,
   ``write_ftex``).
"""

import io
import json
import os
import struct

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


# -- 3-5: the container formats --------------------------------------------

_SIZES = ((1, 1), (3, 17), (31, 33), (64, 64))      # (h, w)


def _same(data, case):
    """The port's read_image bitwise the JAX package's on ``data``."""
    from paperrenderer_tpu.io.image import read_image as jax_read

    want, got = jax_read(data), read_image(data)
    assert got.dtype == want.dtype == np.uint8, case
    assert got.shape == want.shape, (case, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(case))


def _pil(img, fmt, **kw):
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


_BMP_MASKS = ((0xFF0000, 0xFF00, 0xFF, 0xFF000000),
              (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
              (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
              (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
              (0xFF000000, 0xFF0000, 0xFF00, 0x0))


def _container(case, h, w):
    """``case``'s file at h x w: PIL's writer ("pil_...") or chip_smoke.py's
    numpy writers (the forms PIL reads but does not write)."""
    from PIL import Image

    cs = IO._writers()
    rng = np.random.default_rng([h, w, sum(map(ord, case))])
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 4)).astype(np.uint8)
    blocky = ((np.arange(w)[None] // 5 + np.arange(h)[:, None] // 3) % 16
              ).astype(np.uint8)
    kind, *rest = case.split("_")
    if kind == "pil":          # pil_<format>_<mode>[_<rle>_<orientation>]
        fmt, mode = rest[0].upper(), rest[1]
        img = {"1": Image.fromarray(idx > 127).convert("1"),
               "L": Image.fromarray(idx), "LA": Image.fromarray(
                   np.stack([idx, idx[::-1]], -1), "LA"),
               "P": Image.fromarray(rgb).quantize(13),
               "RGB": Image.fromarray(rgb),
               "RGBA": Image.fromarray(rgba)}.get(mode)
        if fmt == "TGA":
            kw = dict(orientation=int(rest[3]))
            if rest[2] == "rle":
                kw["compression"] = "tga_rle"
            return _pil(img, fmt, **kw)
        if fmt == "GIF":
            if mode == "anim":
                frames = [Image.fromarray(rgb).quantize(20),
                          Image.fromarray(rgb[::-1]).quantize(20)]
                return _pil(frames[0], fmt, save_all=True,
                            append_images=frames[1:])
            kw = dict(trans=dict(transparency=3),
                      interlace=dict(interlace=True, transparency=5)).get(
                          mode, {})
            img = Image.fromarray(idx) if mode == "L" else \
                Image.fromarray(rgb).quantize(13)
            return _pil(img, fmt, **kw)
        return _pil(img, fmt)
    if kind in ("bmp", "dib"):
        form = rest[0]
        if form.isdigit():     # bmp_<bits>[_short|_core|_topdown|_ramp]
            bits = int(form)
            n = 1 << bits
            p = pal[:n, :3]
            kw = dict(file_header=kind == "bmp")
            if rest[1:] == ["short"]:
                p = p[:max(1, n // 2)]
            elif rest[1:] == ["core"]:
                kw["header"] = 12
            elif rest[1:] == ["topdown"]:
                kw["top_down"] = True
            elif rest[1:] == ["ramp"]:   # the gray ramp: read as "L"
                p = np.repeat(np.arange(n, dtype=np.uint8)[:, None], 3, 1)
            return cs.write_bmp((idx.astype(int) % n).astype(np.uint8), bits,
                                p, **kw)
        if form == "bw":       # black and white: read as "1"
            return cs.write_bmp(idx % 2, 8, np.array([[0] * 3, [255] * 3]))
        if form.startswith("rle"):   # rle<bits>[_delta|_ramp]
            bits = int(form[3:])
            ix = (blocky * (13 if bits == 8 else 1)).astype(np.uint8)
            if rest[1:] == ["noisy"]:
                ix = (idx.astype(int) % (1 << bits)).astype(np.uint8)
            p = (np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
                 if rest[1:] == ["ramp"] else pal[:, :3])[:1 << bits]
            deltas = ((1, 2, 3, 1),) if rest[1:] == ["delta"] else ()
            return cs.write_bmp(ix, bits, p, compression=1 if bits == 8 else 2,
                                body=cs.bmp_rle(ix, bits == 4, deltas))
        if form in ("bf565", "bf555"):   # bmp_<bf565|bf555>_<header>
            masks = ((0xF800, 0x7E0, 0x1F) if form == "bf565"
                     else (0x7C00, 0x3E0, 0x1F))
            v = cs.pack_rgb(rgb, (5, 6, 5) if form == "bf565" else (5, 5, 5))
            return cs.write_bmp(v, 16, compression=3, masks=masks,
                                header=int(rest[1]))
        if form == "16rgb":
            return cs.write_bmp(idx.astype(np.uint16) * 257, 16)
        if form == "32rgb":    # BI_RGB: the fourth byte dropped
            return cs.write_bmp(cs.pack_masks(rgba, _BMP_MASKS[0]), 32)
        if form == "24bf":
            return cs.write_bmp(rgb, 24, compression=3,
                                masks=(0xFF0000, 0xFF00, 0xFF))
        if form == "v5":       # bmp_v5_<mask set>_<header>: alpha masks
            masks = _BMP_MASKS[int(rest[1])]
            header = int(rest[2])
            return cs.write_bmp(cs.pack_masks(rgba, masks), 32, compression=3,
                                masks=masks if header > 52 else masks[:3],
                                header=header)
    if kind == "tga":
        form = rest[0]
        if form in ("gray", "la"):    # tga_<gray|la>_<type>_<origin>
            px = idx if form == "gray" else np.stack([idx, 255 - idx], -1)
            return cs.write_tga(px, int(rest[1]), 8 if form == "gray" else 16,
                                origin=rest[2],
                                alpha_bits=0 if form == "gray" else 8)
        if form in ("16", "16noalpha"):   # tga_<16|16noalpha>_<type>
            v = rng.integers(0, 65536, (h, w)).astype(np.uint16)
            v = v if form == "16" else v & 0x7FFF
            return cs.write_tga(v, int(rest[1]), 16,
                                alpha_bits=1 if form == "16" else 0)
        if form == "rgba":            # tga_rgba_<type>_<origin>
            return cs.write_tga(rgba, int(rest[1]), 32, origin=rest[2],
                                alpha_bits=8)
        if form == "rows":            # literal packets across rows
            return cs.write_tga(np.repeat(blocky[..., None] * 16, 3, -1), 10,
                                24)
        if form == "id":              # an image ID field before the pixels
            return cs.write_tga(rgba, 2, 32, image_id=b"grid texture")
        if form == "cmap":            # tga_cmap_<type>_<map depth>_<start>
            start = int(rest[3])
            return cs.write_tga((blocky * 2 + start).astype(np.uint8),
                                int(rest[1]), 8, colormap=pal[:40],
                                map_depth=int(rest[2]), map_start=start)
    if kind == "gif":
        small = (idx % 16).astype(np.uint8)
        frame = (small, 0, 0, None, False)
        if rest[0] == "local":
            return cs.write_gif([(small, 0, 0, pal[16:32, :3], True)],
                                pal[:16, :3])
        if rest[0] == "ramp":          # read as "L", the transparency ignored
            return cs.write_gif([frame], np.repeat(
                np.arange(16, dtype=np.uint8)[:, None], 3, 1), transparency=3)
        if rest[0] == "none":          # no colour table: "L"
            return cs.write_gif([frame])
        if rest[0] == "offset":        # gif_offset_<transparency>
            t = int(rest[1]) if rest[1:] else None
            return cs.write_gif([(small, 3, 2, None, t is not None)],
                                pal[:16, :3], screen=(w + 7, h + 5),
                                transparency=t)
        if rest[0] == "beyond":        # the frame past the screen's edge
            return cs.write_gif([(small, 2, 1, None, False)], pal[:16, :3],
                                screen=(max(1, w - 1), max(1, h - 1)))
        if rest[0] == "short":         # indices past a 4-entry table
            return cs.write_gif([frame], pal[:4, :3])
        if rest[0] == "full":          # the table fills, no clear code
            return cs.write_gif([(idx, 0, 0, None, True)], pal[:, :3],
                                clear_when_full=False, literal=True)
    raise ValueError(case)


def test_bmp_tga_gif_match_jax():
    """BMP/DIB, TGA and GIF bitwise the JAX package's (PIL's decode) at four
    sizes: PIL's own files in every mode it writes, and chip_smoke.py's
    writers' RLE4/RLE8 (with a delta), 1/2/4/8-bit palettes (short, gray
    ramp, OS/2 core header, top-down), black/white, 16-bit 5-6-5 / 5-5-5
    bitfields at header sizes 40 and 124, 16-bit BI_RGB, 24-bit bitfields,
    32-bit BI_RGB and five 32-bit mask sets with alpha at headers 40-124;
    TGA gray and gray + alpha in both run-length forms and four origins,
    15/16-bit truecolour with and without the alpha bit, RGBA, literal
    packets across rows, an image ID field, 16 and 24-bit colour maps at
    first index 0 and 5; GIF with a local table (interlaced), a gray ramp
    (read as "L"), no table, an offset first frame with and without a
    transparency index, a frame past the screen, indices past a short
    table and an LZW table filled without a clear code."""
    cases = [f"pil_{f}_{m}" for f in ("bmp", "dib")
             for m in ("1", "L", "P", "RGB", "RGBA")]
    cases += [f"pil_tga_{m}_{c}_{o}" for m in ("L", "LA", "P", "RGB", "RGBA")
              for c in ("raw", "rle") for o in ("-1", "1")]
    cases += [f"pil_gif_{m}" for m in ("P", "trans", "interlace", "L",
                                       "anim")]
    cases += [f"bmp_{b}{v}" for b in (1, 2, 4, 8)
              for v in ("", "_short", "_core", "_topdown", "_ramp")
              if f"bmp_{b}{v}" != "bmp_4_ramp"]        # refused: test 5
    cases += ["dib_4", "dib_8_ramp", "bmp_bw", "bmp_16rgb", "bmp_32rgb",
              "bmp_24bf"]
    cases += [f"bmp_rle{b}{v}" for b in (4, 8)
              for v in ("", "_delta", "_ramp", "_noisy")]
    cases += [f"bmp_{f}_{hd}" for f in ("bf565", "bf555") for hd in (40, 124)]
    cases += [f"bmp_v5_{k}_{hd}" for k in range(len(_BMP_MASKS))
              for hd in (40, 56, 108, 124) if (k, hd) != (1, 40)]   # test 5
    cases += [f"tga_{f}_{t}_{o}" for f in ("gray", "la") for t in (3, 11)
              for o in ("bottom-left", "bottom-right", "top-left",
                        "top-right")]
    cases += [f"tga_{f}_{t}" for f in ("16", "16noalpha") for t in (2, 10)]
    cases += ["tga_rgba_10_top-left", "tga_rgba_2_bottom-right", "tga_rows",
              "tga_id"]
    cases += [f"tga_cmap_{t}_{d}_{s}" for t in (1, 9) for d in (16, 24)
              for s in (0, 5)]
    cases += [f"gif_{g}" for g in ("local", "ramp", "none", "offset",
                                   "offset_9", "beyond", "short", "full")]

    def check(case):
        for h, w in _SIZES:
            data = _container(case, h, w)
            if case.split("_")[:2] == ["bmp", "2"]:   # PIL refuses 2 bits
                with pytest.raises(NotImplementedError, match="2-bit"):
                    read_image(data)
                continue
            _same(data, (case, h, w))

    IO._each(cases, check)


def _riff_chunk(kind, body):
    pad = b"\x00" * (len(body) & 1)
    return kind + struct.pack("<I", len(body)) + body + pad


def _frame_chunks(data):
    """A still WebP's ALPH / VP8 / VP8L chunks, as an ANMF frame holds them."""
    out, pos = b"", 12
    while pos < len(data):
        kind, (n,) = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)
        if kind in (b"ALPH", b"VP8 ", b"VP8L"):
            out += data[pos:pos + 8 + n + (n & 1)]
        pos += 8 + n + (n & 1)
    return out


def _offset_animation(first, second, x0, y0, cw, ch, alpha):
    """An animated WebP whose first frame (a still WebP's chunks) sits at
    (x0, y0) of a cw x ch canvas, the second covering it all."""
    body = _riff_chunk(b"VP8X", bytes([0x02 | (0x10 if alpha else 0), 0, 0, 0])
                       + (cw - 1).to_bytes(3, "little")
                       + (ch - 1).to_bytes(3, "little"))
    body += _riff_chunk(b"ANIM", struct.pack("<IH", 0xFF102030, 0))
    for (x, y, w, h), still in (((x0, y0) + first[1], first[0]),
                                ((0, 0, cw, ch), second)):
        head = b"".join(v.to_bytes(3, "little")
                        for v in (x // 2, y // 2, w - 1, h - 1, 100))
        body += _riff_chunk(b"ANMF", head + b"\x00" + _frame_chunks(still))
    return b"RIFF" + struct.pack("<I", len(body) + 4) + b"WEBP" + body


def _bool_encode(bits):
    """RFC 6386's boolean encoder over (probability, bit) pairs, padded
    with 40 zero bits at probability 128 so that no reader runs out."""
    out = bytearray()
    bottom, rng, count = 0, 255, 24
    for prob, bit in list(bits) + [(128, 0)] * 40:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom, rng = bottom + split, rng - split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):          # carry into the written bytes
                k = len(out) - 1
                while out[k] == 255:
                    out[k] = 0
                    k -= 1
                out[k] += 1
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if not count:
                out.append(bottom >> 24)
                bottom &= 0xFFFFFF
                count = 8
    return bytes(out)


def _recode(data, simple=None, sharpness=None, partitions=1):
    """PIL's lossy WebP decoded by the port's boolean decoder, every bit
    and its probability kept, and encoded again with the loop filter's
    type or sharpness changed or its token rows dealt over 2, 4 or 8
    partitions (row y to partition y mod n): options PIL does not offer
    (its encoder writes the normal filter at sharpness 0, one partition).
    """
    from paperrenderer_tpu_torch.io import vp8

    k = data.index(b"VP8 ")
    (size,) = struct.unpack_from("<I", data, k + 4)
    frame = data[k + 8:k + 8 + size]
    w, h, first, rest = vp8._header(frame)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    bits, marks, rows = [], {}, []

    class Recorded(vp8._Bool):
        sink = None

        def bit(self, prob):
            b = super().bit(prob)
            self.sink.append([prob, b])
            return b

        def literal(self, n):
            if self.sink is bits and n in (2, 3):   # partitions, sharpness
                marks.setdefault(n, len(bits))
            return super().literal(n)

    class Rows:        # the token partition, one recorded list a row
        def __len__(self):
            return 1

        def __getitem__(self, i):
            rows.append([])
            parts[0].sink = rows[-1]
            return parts[0]

    plain = vp8._Bool
    vp8._Bool = Recorded
    try:
        br = Recorded(first)
        br.sink = bits
        seg, _, parts, quant, bands, skip_p = vp8._parse_header(br, rest)
        segs, skips, i4s, _, _ = vp8._intra_modes(br, mbw, mbh, seg, skip_p)
        vp8._residuals(Rows(), mbw, mbh, i4s, skips, segs, quant, bands)
    finally:
        vp8._Bool = plain
    at = marks[3]
    if simple is not None:
        bits[at - 7][1] = simple
    if sharpness is not None:
        for i in range(3):
            bits[at + i][1] = (sharpness >> (2 - i)) & 1
    for i in range(2):
        bits[marks[2] + i][1] = (partitions.bit_length() - 1 >> (1 - i)) & 1
    part = _bool_encode(bits)
    tokens = [_bool_encode(b for r in rows[p::partitions] for b in r)
              for p in range(partitions)]
    tag = (len(part) << 5) | (frame[0] & 0x1F)
    frame = (tag.to_bytes(3, "little") + frame[3:10] + part
             + b"".join(len(t).to_bytes(3, "little") for t in tokens[:-1])
             + b"".join(tokens))
    body = _riff_chunk(b"VP8 ", frame)
    return b"RIFF" + struct.pack("<I", len(body) + 4) + b"WEBP" + body


def _webp(case, h, w):
    """``case``'s WebP at h x w (PIL writes it, libwebp 1.6 encodes)."""
    rng = np.random.default_rng([h, w, sum(map(ord, case))])
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([(xx * 7) % 256, (yy * 5) % 256, ((xx + yy) * 3) % 256],
                      -1)
    rgb = np.clip(smooth + rng.integers(-30, 30, smooth.shape), 0,
                  255).astype(np.uint8)
    alpha = np.where((xx // 8 + yy // 8) % 2, 255,
                     rng.integers(0, 256, (h, w))).astype(np.uint8)
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    kind, *rest = case.split("_")
    if kind == "lossless":     # lossless_<colours>_<exact>_<method>
        n = rest[0]
        if n == "many":
            img = rgba
        else:
            pal = rng.integers(0, 256, (int(n), 4)).astype(np.uint8)
            pick = ((xx // 3 + yy // 5) % int(n) if n == "200"
                    else rng.integers(0, int(n), (h, w)))
            img = pal[pick]
        return _pil(img, "WEBP", lossless=True, exact=rest[1] == "exact",
                    method=int(rest[2]))
    if kind == "lossy":        # lossy_<quality>_<method>
        return _pil(rgb, "WEBP", quality=int(rest[0]), method=int(rest[1]))
    if kind == "alpha":        # alpha_<alpha quality>
        return _pil(rgba, "WEBP", quality=60, alpha_quality=int(rest[0]))
    if kind == "anim":
        from PIL import Image

        frames = [Image.fromarray(rgb), Image.fromarray(rgb[::-1])]
        return _pil(frames[0], "WEBP", save_all=True,
                    append_images=frames[1:], duration=100)
    if kind == "offset":       # offset_<lossless|lossy|alpha>
        fh, fw = max(1, h // 2), max(1, w // 3)
        kw = dict(lossless=dict(lossless=True), lossy=dict(quality=50),
                  alpha=dict(quality=50, alpha_quality=50))[rest[0]]
        part = rgba[:fh, :fw] if rest[0] == "alpha" else rgb[:fh, :fw]
        first = (_pil(part, "WEBP", **kw), (fw, fh))
        x0, y0 = 2 * ((w - fw) // 4), 2 * ((h - fh) // 4)
        return _offset_animation(first, _pil(rgb, "WEBP", lossless=True), x0,
                                 y0, w, h, rest[0] == "alpha")
    if kind == "recode":       # recode_<simple|sharp3|sharp6|parts4>_<m>
        data = _pil(rgb, "WEBP", quality=40, method=int(rest[1]))
        if rest[0] == "simple":
            return _recode(data, simple=1)
        if rest[0].startswith("parts"):
            return _recode(data, partitions=int(rest[0][5:]))
        return _recode(data, sharpness=int(rest[0][5:]))
    raise ValueError(case)


def test_webp_matches_jax():
    """WebP bitwise the JAX package's (PIL over libwebp 1.6) at four sizes:
    lossless from 2, 4, 16, 200 and many colours, exact and not, methods
    0, 4 and 6 (colour indexing with bundling, the predictor,
    cross-colour, subtract-green, the colour cache, LZ77); lossy at
    quality 5, 50 and 95 with methods 0 and 6 (segments, filter levels);
    lossy with alpha at alpha_quality 100 and 30 (filtered, compressed
    ALPH); a two-frame animation; first frames offset in the canvas
    (lossless, lossy, lossy with alpha); and lossy files re-encoded for
    the simple loop filter, for sharpness 3 and 6, and over 2, 4 and 8
    token partitions."""
    cases = [f"lossless_{n}_{e}_{m}" for n in ("2", "4", "16", "200", "many")
             for e in ("exact", "default") for m in (0, 4, 6)]
    cases += [f"lossy_{q}_{m}" for q in (5, 50, 95) for m in (0, 6)]
    cases += ["alpha_100", "alpha_30", "anim", "offset_lossless",
              "offset_lossy", "offset_alpha"]
    cases += [f"recode_{f}_{m}" for f in ("simple", "sharp3", "sharp6")
              for m in (0, 4)]
    cases += [f"recode_parts{n}_4" for n in (2, 4, 8)]
    IO._each(cases, lambda case: [_same(_webp(case, h, w), (case, h, w))
                                  for h, w in _SIZES])


# (case, the form the port names); PIL refuses each
_REFUSED_CONTAINERS = (
    ("bmp_bitfields", "bitfields layout"), ("bmp_v5_1_40", "bitfields layout"),
    ("bmp_jpeg", "BI_JPEG"), ("bmp_png", "BI_PNG"), ("bmp_2", "2-bit"),
    ("bmp_4_ramp", "L rows longer"), ("tga_cmap_1_32_0", "32-bit colour map"),
    ("tga_cmap_9_15_0", "15-bit colour map"),
    ("tga_run", "past its row's end"), ("tga_15", "unknown"),
    ("bmp_cut", "BMP: truncated header"), ("gif_cut", "GIF"),
    ("webp_cut", "WebP"), ("dds", "DDS"), ("tiff", "TIFF"), ("qoi", "QOI"),
    ("pam", "PAM"), ("pfm", "colour PFM"), ("tiff_jpeg", "TIFF .*JPEG"),
    ("bigtiff_mm", "big-endian BigTIFF"), ("dds_bc4s", "DDS: FourCC"),
    ("ppm_maxval", "Netpbm P3: a sample"), ("psd_16", "PSD gray, 16-bit"),
    ("psd_zip", "PSD .*compression 2"), ("psd_psb", "PSB"),
    ("tiff_ycbcr_planar", "planar: YCbCr subsampling 2x2"),
    ("tiff_ycbcr_gray", "YCbCr of three samples"),
    ("sgi_la", "SGI 8-bit, dimension 3, 2 channels"),
    ("sgi_comp2", "SGI 8-bit, dimension 3, 3 channels: compression 2"),
    ("pcx_2planes", "unknown PCX mode"), ("dcx_empty", "DCX: no pages"),
    ("blp_bgra", "BLP2 .*encoding 3"), ("blp2_jpeg", "BLP2 compression 0"),
    ("ftex_formats", "FTEX with 2 formats"))
# (case, the form named): PIL reads these, the port leaves them for later
_NOT_YET = (("tiff_ccitt", "CCITT group 3: not yet ported"),
            ("tiff_g4", "CCITT group 4: not yet ported"),
            ("tiff_lab", "CIELab.*not yet ported"),
            ("tiff_ojpeg", "old-style JPEG.*not yet ported"),
            ("tiff_zstd", "Zstandard.*not yet ported"),
            ("psd_lab", "PSD LAB, 8-bit: not yet ported"))


def _ojpeg_tiff(rgb):
    """An old-style JPEG TIFF (compression 6): one strip holding a whole
    4:2:0 JPEG, which JPEGInterchangeFormat points at too."""
    cs = IO._writers()
    jpg = cs.write_jpeg(cs.rgb_to_ycc(rgb), [(2, 2), (1, 1), (1, 1)],
                        jfif=False)
    h, w = rgb.shape[:2]
    n = len(jpg)
    tags = [(256, 3, [w]), (257, 3, [h]), (258, 3, [8, 8, 8]),
            (259, 3, [6]), (262, 3, [6]), (273, 4, [8]), (277, 3, [3]),
            (278, 3, [h]), (279, 4, [n]), (513, 4, [8]), (514, 4, [n]),
            (530, 3, [2, 2])]
    pos = 8 + n + n % 2
    spill = pos + 2 + 12 * len(tags) + 4     # BitsPerSample's three shorts
    entries = b"".join(
        struct.pack("<HHL", tag, typ, len(vals))
        + (struct.pack("<L", spill) if len(vals) == 3 else struct.pack(
            f"<{len(vals)}{'H' if typ == 3 else 'L'}", *vals).ljust(
            4, b"\x00"))
        for tag, typ, vals in tags)
    return (b"II*\x00" + struct.pack("<L", pos) + jpg + bytes(n % 2)
            + struct.pack("<H", len(tags)) + entries + bytes(4)
            + struct.pack("<3H", 8, 8, 8))


def _refused_container(case):
    cs = IO._writers()
    rgb = np.random.default_rng(6).integers(0, 256, (6, 9, 3)).astype(np.uint8)
    if case == "bmp_bitfields":    # 5-5-5 with its fields in another order
        return cs.write_bmp(cs.pack_rgb(rgb, (5, 5, 5)), 16, compression=3,
                            masks=(0x1F, 0x3E0, 0x7C00))
    if case in ("bmp_jpeg", "bmp_png"):
        return cs.write_bmp(rgb, 24, body=b"\xff\xd8\xff\xe0" + bytes(32),
                            compression=4 if case == "bmp_jpeg" else 5)
    if case == "tga_run":          # a repeat packet across the row's end
        return cs.write_tga(rgb[:1, :4], 10, 24)[:18] + bytes(
            (0x85, 1, 2, 3, 0x81, 4, 5, 6))
    if case == "tga_15":           # 15-bit pixels: not a TGA to Pillow
        return cs.write_tga(cs.pack_rgb(rgb, (5, 5, 5)), 2, 15)
    if case.endswith("_cut"):      # a file cut inside its header
        whole = (_container("bmp_8", 6, 9) if case == "bmp_cut" else
                 _container("gif_local", 6, 9) if case == "gif_cut" else
                 _webp("lossy_50_0", 6, 9))
        return whole[:20]
    if case == "dds":
        return b"DDS " + struct.pack("<7I", 124, 0x1007, 6, 9, 0, 0, 0) + \
            bytes(100)
    if case == "tiff":
        return b"II*\x00" + struct.pack("<I", 8) + bytes(16)
    if case == "qoi":
        return b"qoif" + struct.pack(">IIBB", 9, 6, 3, 0) + bytes(8)
    if case == "pam":              # PAM and colour PFM: no Pillow plugin
        return (b"P7\nWIDTH 9\nHEIGHT 6\nDEPTH 3\nMAXVAL 255\n"
                b"TUPLTYPE RGB\nENDHDR\n" + rgb.tobytes())
    if case == "pfm":
        return b"PF\n9 6\n-1.0\n" + rgb.astype("<f4").tobytes()
    if case == "tiff_jpeg":        # JPEG compression over bytes not a JPEG
        return cs.write_tiff(rgb).replace(struct.pack("<HHLH", 259, 3, 1, 1),
                                          struct.pack("<HHLH", 259, 3, 1, 7))
    if case == "tiff_ccitt":       # CCITT group 3: PIL's libtiff reads it
        return cs.write_tiff(rgb[..., 0] & 1, bits=1, compression=3)
    if case in ("tiff_g4", "tiff_zstd"):   # PIL's own writer
        from PIL import Image

        img = Image.fromarray(rgb[..., 0] > 127) if case == "tiff_g4" \
            else Image.fromarray(rgb)
        return _pil(img, "TIFF", compression=case[5:].replace(
            "g4", "group4"))
    if case == "tiff_lab":         # CIELab: PIL converts it with LittleCMS
        return cs.write_tiff(rgb, photometric=8)
    if case == "tiff_ojpeg":
        return _ojpeg_tiff(rgb)
    if case == "tiff_ycbcr_planar":    # planar YCbCr 2x2: no libtiff put
        return cs.write_tiff(rgb, photometric=6, planar=2, compression=5)
    if case == "tiff_ycbcr_gray":      # one YCbCr sample: libtiff refuses
        return cs.write_tiff(rgb[..., 0], photometric=6, compression=5)
    if case.startswith("psd_"):    # 16 bits, ZIP, PSB, LAB
        bands = [rgb[..., 0].astype(np.uint16) * 257] if case == "psd_16" \
            else [rgb[..., k] for k in range(3)]
        return cs.write_psd(bands, 9 if case == "psd_lab" else 1 if len(
            bands) == 1 else 3, 16 if case == "psd_16" else 8,
            2 if case == "psd_zip" else 0,
            version=2 if case == "psd_psb" else 1)
    if case == "sgi_la":           # gray and alpha: no SGI mode in Pillow
        return cs.write_sgi(rgb[..., :2], dimension=3)
    if case == "sgi_comp2":        # neither verbatim nor RLE: no tile
        data = bytearray(cs.write_sgi(rgb))
        data[2] = 2
        return bytes(data)
    if case == "pcx_2planes":      # 8 bits in 2 planes: no PCX mode
        return cs.write_pcx(rgb[..., :2], 8, 2)
    if case == "dcx_empty":
        return cs.write_dcx([])
    if case == "blp_bgra":         # BLP2 raw BGRA: Pillow's decoder lacks it
        return cs.write_blp(2, 9, 6, rgb.tobytes() * 2, encoding=3, alpha=8)
    if case == "blp2_jpeg":        # JPEG in a BLP2: Pillow reads BLP1's only
        return cs.write_blp(2, 9, 6, bytes(64), compression=0, encoding=1)
    if case == "ftex_formats":     # Pillow reads single-format files only
        data = bytearray(cs.write_ftex(9, 6, rgb.tobytes()))
        data[20:24] = struct.pack("<i", 2)
        return bytes(data)
    if case == "bigtiff_mm":       # Pillow reads it as a classic TIFF
        return cs.write_tiff(rgb, big=True, order=">")
    if case == "dds_bc4s":         # a FourCC Pillow does not map
        return cs.write_dds(9, 6, bytes(48), b"BC4S")
    if case == "ppm_maxval":       # a plain sample above the maxval
        return b"P3\n1 1\n7\n1 9 2\n"
    return _container(case, 6, 9)


def test_refused_containers_and_gltf_match_jax(tmp_path):
    """Both packages refuse BMP bitfields outside Pillow's sets, BI_JPEG,
    BI_PNG, 2-bit BMPs, a 4-bit gray-ramp BMP (read as 8-bit "L"), 32 and
    15-bit TGA colour maps, a TGA repeat packet across a row's end, 15-bit
    TGA pixels, BMP, GIF and WebP files cut after 20 bytes, DDS, TIFF and
    QOI headers with no image, PAM (P7) and colour PFM (PF), which PIL
    does not open, a TIFF whose JPEG strip is no JPEG, a big-endian
    BigTIFF (PIL reads it as classic TIFF), DDS's BC4S FourCC, a plain
    PPM sample above its maxval, 16-bit, ZIP-compressed and PSB PSDs,
    planar YCbCr TIFFs subsampled and one-sample YCbCr TIFFs, an SGI of
    gray and alpha, an SGI of compression 2, an 8-bit 2-plane PCX, a DCX without pages, BLP2 raw
    BGRA and JPEG, and an FTEX of two formats: the port raises
    NotImplementedError naming the form. The forms PIL reads and the port
    leaves for later (TIFF CCITT group 3 and 4, CIELab, old-style JPEG
    and Zstandard; PSD LAB) raise it naming the form and "not yet
    ported". chip_smoke.py's GLTF_CONTAINERS2 and GLTF_CONTAINERS3 forms
    (DDS, TIFF, BigTIFF, PPM, QOI; PSD, TIFF JPEG and LZMA, BLP, FTEX,
    SGI, PCX) at 40x36 decode bitwise as the JAX package decodes them. A
    .gltf whose image 2 is an
    external .webp (lossy, with alpha) and one whose image 0 is an
    embedded 32-bit BMP with an alpha mask load as the JAX loader loads
    them."""
    from paperrenderer_tpu.io import gltf as JG
    from paperrenderer_tpu.io.image import read_image as jax_read
    from paperrenderer_tpu_torch.io import gltf as TG

    import paperrenderer_tpu as JPKG
    import paperrenderer_tpu_torch as TPKG

    def refused(item):
        case, form = item
        data = _refused_container(case)
        with pytest.raises(Exception):   # PIL's OSError, ValueError, ...
            jax_read(data)
        with pytest.raises(NotImplementedError, match=form):
            read_image(data)

    def loads(case):
        d = os.path.join(str(tmp_path), case)
        os.makedirs(d)
        if case == "webp":
            path = IO._make_gltf(d)
            with open(path) as f:
                gltf = json.load(f)
            gltf["images"][2] = {"uri": "palette.webp"}
            with open(path, "w") as f:
                json.dump(gltf, f)
            with open(os.path.join(d, "palette.webp"), "wb") as f:
                f.write(_webp("alpha_30", 24, 20))
            name, key = "palette-base", "base_texture"
        else:
            path = IO._make_gltf(d, _container("bmp_v5_0_124", 16, 16))
            name, key = "rgb-base", "base_texture"
        gt = TG.load_gltf(path, TPKG.GeometryArena())
        gj = JG.load_gltf(path, JPKG.GeometryArena())
        got = [getattr(m, key) for m in gt.materials if m.name == name]
        want = [getattr(m, key) for m in gj.materials if m.name == name]
        assert len(got) == len(want) == 1
        assert got[0].shape == want[0].shape and got[0].shape[2] == 4
        np.testing.assert_array_equal(got[0], want[0])

    def not_yet(item):
        case, form = item
        data = _refused_container(case)
        jax_read(data)
        with pytest.raises(NotImplementedError, match=form):
            read_image(data)

    cs = IO._writers()

    def containers2(item):     # the gltf phase's forms, at a small size
        key, form = item
        _, smooth, _ = _images(36, 40, form)
        gray = "BC4" in form or "gray" in form or key == "occlusion_texture"
        encode = cs.encode_container2 if item in forms2 else \
            cs.encode_container3
        _same(encode(form, smooth[..., 1] if gray else smooth), form)

    forms2 = [(k, f) for _, k, f in cs.GLTF_CONTAINERS2]
    IO._each(list(_REFUSED_CONTAINERS), refused)
    IO._each(list(_NOT_YET), not_yet)
    IO._each(["webp", "bmp"], loads)
    IO._each(forms2 + [(k, f) for _, k, f in cs.GLTF_CONTAINERS3],
             containers2)


# -- 6-9: DDS, TIFF, Netpbm + QOI, ICO/CUR ----------------------------------

def _images(h, w, case):
    """Seeded test pictures at h x w: random bytes, a smooth RGB and an
    RGBA with chip_smoke.py's alpha pattern."""
    rng = np.random.default_rng([h, w, sum(map(ord, case))])
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([(xx * 9) % 256, (yy * 7) % 256, ((xx + yy) * 4) % 256],
                      -1).astype(np.uint8)
    return rng, smooth, rng.integers(0, 256, (h, w, 4)).astype(np.uint8)


# DDS cases: PIL's writer ("pil_<pixel format or mode>"), chip_smoke.py's
# block encoders ("enc_<BC kind>"), uncompressed layouts through bit masks
# ("mask_<name>"), seeded random blocks ("rand_<FourCC or DXGI>")
_DDS_MASKS = dict(
    bgr565=(0x40, 16, (0xF800, 0x7E0, 0x1F, 0)),
    argb1555=(0x41, 16, (0x7C00, 0x3E0, 0x1F, 0x8000)),
    a2r10g10b10=(0x41, 32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000)),
    bgrx=(0x40, 32, (0xFF0000, 0xFF00, 0xFF, 0)),
    rgb24=(0x40, 24, (0xFF, 0xFF00, 0xFF0000, 0)),
    l8=(0x20000, 8, (0xFF, 0, 0, 0)), la8=(0x20001, 16, (0xFF, 0, 0, 0xFF00)))
_DDS_RANDOM = dict(DXT1=(b"DXT1", None, 8), DXT3=(b"DXT3", None, 16),
                   DXT5=(b"DXT5", None, 16), ATI1=(b"ATI1", None, 8),
                   BC4U=(b"BC4U", None, 8), ATI2=(b"ATI2", None, 16),
                   BC5S=(b"BC5S", None, 16), dx84=(b"DX10", 84, 16),
                   dx95=(b"DX10", 95, 16), dx96=(b"DX10", 96, 16),
                   dx97=(b"DX10", 97, 16), dx99=(b"DX10", 99, 16),
                   dx80=(b"DX10", 80, 8), dx71=(b"DX10", 71, 8))


def _dds(case, h, w):
    cs = IO._writers()
    rng, smooth, rgba = _images(h, w, case)
    kind, form = case.split("_", 1)
    if kind == "pil":
        from PIL import Image

        if form in ("RGB", "RGBA", "L", "LA"):
            img = Image.fromarray(rgba[..., :len(form)].copy(), form) \
                if form != "L" else Image.fromarray(rgba[..., 0])
            return _pil(img, "DDS")
        img = Image.fromarray(smooth if form == "BC5" else np.concatenate(
            [smooth, rgba[..., 3:]], -1))
        return _pil(img, "DDS", pixel_format=form)
    if kind == "enc":          # enc_<kind>: 1 BC1, 3 BC3, 4 BC4, 7 BC7
        k = int(form)
        img = {1: smooth, 3: np.concatenate([smooth, rgba[..., 3:]], -1),
               4: smooth[..., 1], 7: np.concatenate([smooth, rgba[..., 3:]],
                                                    -1)}[k]
        fourcc, dxgi = {1: (b"DXT1", None), 3: (b"DXT5", None),
                        4: (b"ATI1", None), 7: (b"DX10", 98)}[k]
        return cs.write_dds(w, h, cs.encode_bcn(img, k), fourcc, dxgi)
    if kind == "mask":
        flags, bits, masks = _DDS_MASKS[form]
        return cs.write_dds(w, h, rng.bytes(w * h * bits // 8), flags=flags,
                            bits=bits, masks=masks)
    if kind == "pal":          # 8-bit indices, a 256-entry RGBA palette
        return cs.write_dds(w, h, rng.bytes(w * h), flags=0x20, bits=8,
                            palette=rng.bytes(1024))
    if kind == "rgba":         # DX10 R8G8B8A8
        return cs.write_dds(w, h, rgba.tobytes(), b"DX10", 28)
    fourcc, dxgi, size = _DDS_RANDOM[form]
    n = ((w + 3) // 4) * ((h + 3) // 4)
    return cs.write_dds(w, h, rng.bytes(n * size), fourcc, dxgi)


def test_dds_matches_jax():
    """DDS bitwise the JAX package's (PIL's decode) at four sizes: PIL's
    own DXT1/3/5, BC2/3/5 and uncompressed RGB(A)/L/LA files;
    chip_smoke.py's BC1, BC3 (alpha), BC4 and BC7 mode 6 encoders;
    uncompressed layouts through bit masks (5-6-5, 1-5-5-5, 2-10-10-10,
    BGRX, 24-bit, L, LA), an 8-bit palette with RGBA entries and DX10's
    R8G8B8A8; seeded random blocks of every decoded format (BC1-BC3's
    three-colour blocks, BC4, BC5 and BC5S, BC6H UF16 / SF16 over every
    mode, the reserved ones included, BC7 over all eight modes and
    reserved blocks)."""
    cases = [f"pil_{f}" for f in ("DXT1", "DXT3", "DXT5", "BC2", "BC3",
                                  "BC5", "RGB", "RGBA", "L", "LA")]
    cases += [f"enc_{k}" for k in (1, 3, 4, 7)]
    cases += [f"mask_{m}" for m in _DDS_MASKS] + ["pal_8", "rgba_dx10"]
    cases += [f"rand_{r}" for r in _DDS_RANDOM]
    IO._each(cases, lambda case: [_same(_dds(case, h, w), (case, h, w))
                                  for h, w in _SIZES])


def _tiff(case, h, w):
    """``case``'s TIFF at h x w: PIL's writer ("pil_<compression>_<mode>")
    or chip_smoke.py's write_tiff ("np_<form>_<compression>")."""
    cs = IO._writers()
    rng, smooth, rgba = _images(h, w, case)
    kind, *rest = case.split("_")
    if kind == "pil":
        from PIL import Image

        comp, mode = "_".join(rest[:-1]), rest[-1]
        img = {"1": Image.fromarray(rgba[..., 0] > 127),
               "P": Image.fromarray(smooth).quantize(13),
               "CMYK": Image.fromarray(rgba, "RGBA").convert("CMYK"),
               "I;16": Image.fromarray(rng.integers(0, 65536, (h, w)).astype(
                   np.uint16)),
               "I": Image.fromarray(rng.integers(-300, 600, (h, w)).astype(
                   np.int32)),
               "F": Image.fromarray(rng.uniform(-9, 300, (h, w)).astype(
                   np.float32))}.get(mode)
        if img is None:
            img = Image.fromarray(rgba[..., 0] if mode == "L" else
                                  rgba[..., :len(mode)].copy())
        return _pil(img, "TIFF", compression=comp)
    form, comp = rest[0], int(rest[1])
    g16 = rng.integers(0, 65536, (h, w))
    pal = rng.integers(0, 65536, 768)
    forms = dict(
        tiles=(rgba[..., :3], dict(tile=(16, 16))),
        planar=(rgba, dict(planar=2, extra=(2,))),
        planartiles=(rgba[..., :3], dict(planar=2, tile=(16, 32))),
        big=(rgba, dict(big=True, extra=(2,), tile=(32, 16))),
        mm=(g16, dict(bits=16, order=">", rows_per_strip=3)),
        mmrgb16=(rng.integers(0, 65536, (h, w, 3)), dict(bits=16,
                                                        order=">")),
        pred2=(smooth, dict(predictor=2, rows_per_strip=5)),
        pred2g16=(g16, dict(bits=16, predictor=2, order=">")),
        pred3=(rng.uniform(-9, 300, (h, w)), dict(bits=32, sample_format=3,
                                                   predictor=3)),
        pred3mm=(rng.uniform(-9, 300, (h, w)), dict(
            bits=32, sample_format=3, predictor=3, order=">")),
        white1=(rgba[..., 0] & 1, dict(bits=1, photometric=0)),
        white4=(rgba[..., 0] & 15, dict(bits=4, photometric=0)),
        white8=(rgba[..., 0], dict(photometric=0)),
        gray2=(rgba[..., 0] & 3, dict(bits=2)),
        fill2=(rgba[..., 0] & 1, dict(bits=1, fill_order=2)),
        fill2rgb=(smooth, dict(fill_order=2, rows_per_strip=2)),
        extra0=(rgba, dict(extra=(0,))),
        extra1=(rgba, dict(extra=(1,))),
        extra1planar=(rgba, dict(extra=(1,), planar=2)),
        extra2=(rgba, dict(extra=(2,))),
        rgba16a=(rng.integers(0, 65536, (h, w, 4)), dict(bits=16,
                                                         extra=(1,))),
        pal4=(rgba[..., 0] & 15, dict(bits=4, colormap=pal[:48])),
        pal8=(rgba[..., 0], dict(colormap=pal)),
        pa=(rgba[..., :2], dict(extra=(2,), colormap=pal)),
        la=(rgba[..., :2], dict(extra=(2,), photometric=1)),
        cmyk16=(rng.integers(0, 65536, (h, w, 4)), dict(bits=16,
                                                        photometric=5)),
        int16=(rng.integers(-300, 600, (h, w)), dict(bits=16,
                                                     sample_format=2)),
        int32mm=(rng.integers(-300, 600, (h, w)), dict(
            bits=32, sample_format=2, order=">")),
        orient6=(rgba[..., :3], dict(orientation=6)),
        orient7=(rgba[..., 0], dict(orientation=7, tile=(16, 16))))
    samples, kw = forms[form]
    return cs.write_tiff(np.asarray(samples), compression=comp, **kw)


_TIFF_NP = ("tiles_5", "planar_8", "planartiles_32946", "big_32773",
            "big_1", "mm_5", "mmrgb16_1", "pred2_5", "pred2g16_8",
            "pred3_8", "pred3mm_5", "white1_32773", "white4_1", "white8_5",
            "gray2_8", "fill2_1", "fill2_5", "fill2rgb_1", "fill2rgb_8",
            "extra0_32773", "extra1_5", "extra1planar_8", "extra2_1",
            "rgba16a_8", "pal4_5", "pal8_1", "pa_32773", "la_8",
            "cmyk16_5", "int16_8", "int32mm_5", "orient6_8", "orient7_1",
            "planar_1", "tiles_1")


def test_tiff_matches_jax():
    """TIFF and BigTIFF bitwise the JAX package's (PIL over libtiff) at four
    sizes: PIL's raw, PackBits, LZW, deflate and Adobe deflate files in
    modes 1, L, P, RGB, RGBA, CMYK, I;16, I and F; chip_smoke.py's
    write_tiff: tiles, planar strips and tiles, BigTIFF, big-endian 16-bit
    gray and RGB and 32-bit int, predictor 2 (8 and 16-bit) and 3
    (both byte orders), min-is-white 1/4/8-bit, 2-bit gray, FillOrder 2
    raw and LZW, ExtraSamples 0/1/2 (associated alpha unpremultiplied,
    planar too, 16-bit), 4/8-bit palettes, palette and gray with alpha,
    16-bit CMYK, signed 16-bit and the Orientation tag."""
    cases = [f"pil_{c}_{m}" for c in ("raw", "packbits", "tiff_lzw",
                                      "tiff_deflate", "tiff_adobe_deflate")
             for m in ("1", "L", "P", "RGB", "RGBA", "CMYK", "I;16", "I",
                       "F")]
    cases += [f"np_{c}" for c in _TIFF_NP]
    IO._each(cases, lambda case: [_same(_tiff(case, h, w), (case, h, w))
                                  for h, w in _SIZES])


def _netpbm_qoi(case, h, w):
    cs = IO._writers()
    rng, smooth, rgba = _images(h, w, case)
    kind, *rest = case.split("_")
    if kind == "pil":          # pil_<PPM|QOI>_<mode>
        from PIL import Image

        img = Image.fromarray(rgba[..., 0] > 127) if rest[1] == "1" else \
            Image.fromarray(rgba[..., :{"L": 1, "RGB": 3, "RGBA": 4}[
                rest[1]]].squeeze(-1) if rest[1] == "L" else
                rgba[..., :len(rest[1])].copy())
        return _pil(img, rest[0])
    if kind == "qoi":          # qoi_<rgb|rgba>, the reference encoder's ops
        px = np.where(rng.random((h, w, 1)) < 0.6, smooth[..., :1], smooth)
        px = np.concatenate([px, rgba[..., 3:] | 0xF0], -1)
        return cs.write_qoi(px[..., :3] if rest[0] == "rgb" else px)
    if kind == "qoiquirk":     # a run first, then INDEX of its pixel
        head = b"qoif" + struct.pack(">IIBB", w, h, 4, 0)
        return head + bytes([0xC0 + min(61, w * h - 1)]) + bytes(
            [53] * (w * h)) + b"\x00" * 7 + b"\x01"
    magic, maxval = rest[0], int(rest[1]) if len(rest) > 1 else 255
    bands = {"P1": 1, "P4": 1, "P2": 1, "P5": 1, "P3": 3, "P6": 3,
             "P0CMYK": 4, "PyP": 1, "PyRGBA": 4, "PyCMYK": 4}.get(magic)
    if magic == "Pf":
        return cs.write_ppm(rng.uniform(-9, 300, (h, w)).astype(np.float32),
                            "Pf")
    if magic in ("P1", "P4"):
        return cs.write_ppm(rgba[..., 0] & 1, magic)
    v = rng.integers(0, maxval + 1, (h, w, bands))
    return cs.write_ppm(v.squeeze(-1) if bands == 1 else v, magic, maxval)


def test_netpbm_qoi_match_jax():
    """Netpbm and QOI bitwise the JAX package's (PIL's decode) at four
    sizes: P1-P6 plain and binary with a header comment, maxvals 1, 7,
    100, 255, 1000 and 65535 (gray above 255 reads as "I": 500 of 1000
    clips to 255; P5 of maxval 100 scales 50 -> 128, P2 of maxval 7
    3 -> 109), a bottom-up little-endian Pf, Pillow's P0CMYK, PyP,
    PyRGBA and PyCMYK; PIL's PPM writer; QOI from PIL's writer and the
    reference encoder's ops, RGB and RGBA, and a file that opens with a
    run (Pillow's index leaves its pixel out)."""
    cases = [f"pnm_{m}" for m in ("P1", "P4", "Pf")]
    cases += [f"pnm_{m}_{v}" for m in ("P2", "P5") for v in (1, 7, 100, 255,
                                                            1000, 65535)]
    cases += [f"pnm_{m}_{v}" for m in ("P3", "P6") for v in (7, 255, 1000)]
    cases += [f"pnm_{m}_{v}" for m in ("P0CMYK", "PyP", "PyRGBA", "PyCMYK")
              for v in (255, 100)]
    cases += [f"pil_PPM_{m}" for m in ("1", "L", "RGB")]
    cases += [f"pil_QOI_{m}" for m in ("RGB", "RGBA")]
    cases += ["qoi_rgb", "qoi_rgba", "qoiquirk"]
    IO._each(cases, lambda case: [_same(_netpbm_qoi(case, h, w),
                                        (case, h, w)) for h, w in _SIZES])


def _icon(case, h, w):
    """``case``'s icon with h x w its largest entry: PIL's writer or
    chip_smoke.py's write_ico over PNG and BMP entries."""
    from PIL import Image

    cs = IO._writers()
    rng, smooth, rgba = _images(h, w, case)
    kind, *rest = case.split("_")
    if kind == "pil":          # pil_<png|bmp>
        return _pil(Image.fromarray(rgba), "ICO", sizes=[(w, h), (1, 1)],
                    bitmap_format=rest[0])
    mask = rng.random((h, w)) < 0.3

    def bmp(bits, hh=h, ww=w):
        pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
        if bits == 32:
            return cs.write_bmp(cs.pack_masks(rgba[:hh, :ww], (
                0xFF0000, 0xFF00, 0xFF, 0xFF000000)), 32, file_header=False)
        if bits == 24:
            return cs.write_bmp(rgba[:hh, :ww, :3], 24, file_header=False)
        idx = (rgba[:hh, :ww, 0].astype(int) % (1 << bits)).astype(np.uint8)
        return cs.write_bmp(idx, bits, pal[:1 << bits], file_header=False)

    png = IO._png_raw(rgba[..., :3], 2, 8, 0)
    ptrns = IO._png_raw(rgba[..., :1] % 4, 3, 2, 0, palette=rng.integers(
        0, 256, (4, 3)).astype(np.uint8), trns=np.array([0, 90], np.uint8))
    small = cs.write_bmp(rgba[:1, :1, :3], 24, file_header=False)
    if kind == "ico":          # ico_<entries>: the largest is read
        entries = dict(
            bmp32=[("bmp", bmp(32), (w, h), 32)],
            bmp8=[("bmp", small, (1, 1), 24),
                  ("bmp", bmp(8), (w, h), 8, mask)],
            bmp4=[("bmp", bmp(4), (w, h), 4, mask)],
            bmp1=[("bmp", bmp(1), (w, h), 1, mask)],
            bmp24=[("bmp", bmp(24), (w, h), 24, mask),
                   ("png", png, (w, h), 32)],    # equal size: fewer bits
            png=[("bmp", small, (1, 1), 24), ("png", png, (w, h), 32)],
            pngtrns=[("png", ptrns, (w, h), 2)],
            zero=[("bmp", bmp(32), (w, h), 0, mask)])[rest[0]]
        return cs.write_ico(entries)
    entries = [("bmp", small, (1, 1), 24), ("bmp", bmp(8), (w, h), 8, mask)]
    return cs.write_ico(entries, cursor=True)


def test_ico_cur_matches_jax():
    """ICO and CUR bitwise the JAX package's (PIL's decode) at four sizes:
    PIL's ICO writer (PNG and BMP entries); chip_smoke.py's write_ico
    with several entries (the largest, then the fewest bits, is read):
    32-bit BMPs (alpha from the fourth bytes), 1/4/8/24-bit BMPs with AND
    masks, a directory bit count of 0 over a 32-bit DIB (the AND mask
    then), PNG entries (a palette PNG's tRNS dropped as the icon drops
    it); a CUR whose larger entry is an 8-bit BMP (no mask)."""
    cases = ["pil_png", "pil_bmp"] + [f"ico_{e}" for e in (
        "bmp32", "bmp8", "bmp4", "bmp1", "bmp24", "png", "pngtrns", "zero")]
    cases += ["cur_8"]
    IO._each(cases, lambda case: [_same(_icon(case, h, w), (case, h, w))
                                  for h, w in _SIZES])


# -- 10-13: PSD, the libtiff TIFF forms, SGI + PCX/DCX, BLP/FTEX ------------

_SIZES3 = ((1, 1), (5, 7), (17, 33))                # (h, w)


def _agree(data, case):
    """The port's read_image bitwise the JAX package's, or both refusing
    (the port with NotImplementedError) where PIL refuses -> whether the
    images were compared."""
    from paperrenderer_tpu.io.image import read_image as jax_read

    try:
        jax_read(data)
    except Exception:   # noqa: BLE001 - PIL's OSError, ValueError, ...
        with pytest.raises(NotImplementedError):
            read_image(data)
        return False
    _same(data, case)
    return True


def _agree_sizes(make, case):
    """``_agree`` on ``make(case, h, w)`` at each of _SIZES3, the images
    compared bitwise at one size at least (PIL reads every case's file at
    one size or more)."""
    compared = [_agree(make(case, h, w), (case, h, w)) for h, w in _SIZES3]
    assert any(compared), f"{case}: refused by PIL at every size"


def _psd(cs, case, h, w):
    """``case``'s PSD (<mode>_<compression>) at h x w by write_psd."""
    rng, smooth, rgba = _images(h, w, case)
    form, comp = case.rsplit("_", 1)
    pal = rng.integers(0, 256, (3, 256)).astype(np.uint8).tobytes()
    mode, bands, data = dict(
        bitmap=(0, [rgba[..., 0] & 1], b""), gray=(1, [rgba[..., 0]], b""),
        duotone=(8, [rgba[..., 0]], b"duotone data"),
        multi=(7, [rgba[..., 0], rgba[..., 1]], b""),
        indexed=(2, [rgba[..., 0]], pal), nopalette=(2, [rgba[..., 0]], b""),
        rgb=(3, [smooth[..., k] for k in range(3)], b""),
        rgba=(3, [rgba[..., k] for k in range(4)], b""),
        rgb5=(3, [rgba[..., k] for k in range(4)] + [smooth[..., 0]], b""),
        cmyk=(4, [rgba[..., k] for k in range(4)], b""),
        grayalpha=(1, [rgba[..., 0], rgba[..., 3]], b""))[form]
    return cs.write_psd(bands, mode, 1 if form == "bitmap" else 8, int(comp),
                        data, resources=[(1039, b"icc", b"profile"),
                                         (1005, b"", b"res")],
                        layers=b"\x00\x00\x00\x04layr")


def test_psd_matches_jax():
    """PSD's merged composite bitwise the JAX package's (PIL's decode) at
    1x1, 7x5 and 33x17, raw and PackBits, with image resources and a layer
    section: bitmap ("1"), gray, duotone and multichannel ("L"), indexed
    with and without its 768-byte palette ("P"), RGB, RGBA, RGB of five
    channels (a PackBits file's counts read for three: PIL decodes the
    rest of the table as data, or refuses), CMYK (inverted) and gray with
    an alpha channel."""
    cs = IO._writers()
    forms = ("bitmap", "gray", "duotone", "multi", "indexed", "nopalette",
             "rgb", "rgba", "rgb5", "cmyk", "grayalpha")
    cases = [f"{f}_{c}" for f in forms for c in (0, 1)]
    IO._each(cases, lambda case: _agree_sizes(
        lambda *a: _psd(cs, *a), case))


def _libtiff(cs, case, h, w):
    """``case``'s TIFF at h x w: PIL's writer ("pil_<compression>_<mode>")
    or write_tiff ("ycc_<h><v>_<compression>_<layout>", "jpeg_...",
    ...)."""
    rng, smooth, rgba = _images(h, w, case)
    kind, *rest = case.split("_")
    if kind == "pil":
        from PIL import Image

        img = Image.fromarray(np.concatenate([smooth, rgba[..., 3:]], -1))
        return _pil(img.convert(rest[1]), "TIFF", compression=rest[0])
    ycc = np.stack(cs.rgb_to_ycc(smooth), -1)
    layouts = dict(strip={}, rows4=dict(rows_per_strip=4),
                   rows8=dict(rows_per_strip=8), tile=dict(tile=(16, 16)),
                   wide=dict(tile=(32, 16)))
    if kind in ("ycc", "jpeg"):   # <kind>_<h><v>_<compression>_<layout>
        sub = (int(rest[0][0]), int(rest[0][1]))
        comp = 7 if kind == "jpeg" else int(rest[1])
        samples = ycc if kind == "jpeg" else rgba[..., :3]
        return cs.write_tiff(samples, photometric=6, compression=comp,
                             subsampling=sub, **layouts[rest[-1]])
    g12 = rng.integers(0, 4096, (h, w))
    g12.flat[0] = 100                      # one sample below 255
    forms = dict(
        jpegrgb=(smooth, dict(compression=7, tile=(16, 16))),
        jpeggray=(smooth[..., 0], dict(compression=7, rows_per_strip=3)),
        ycoef=(rgba[..., :3], dict(
            photometric=6, compression=5, subsampling=(2, 2),
            coefficients=[(2990, 10000), (5870, 10000), (1140, 10000)],
            reference=[(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                       (240, 1)])),
        y709=(rgba[..., :3], dict(
            photometric=6, compression=8, subsampling=(2, 1),
            coefficients=[(2126, 10000), (7152, 10000), (722, 10000)],
            reference=[(0, 1), (255, 1), (129, 2), (255, 1), (128, 1),
                       (250, 1)])),
        ypred=(rgba[..., :3], dict(photometric=6, compression=8,
                                   subsampling=(2, 2), predictor=2)),
        yplanar=(rgba[..., :3], dict(photometric=6, planar=2, compression=5,
                                     subsampling=(1, 1), rows_per_strip=4)),
        yraw=(rgba[..., :3], dict(photometric=6, subsampling=(2, 1))),
        lzma=(smooth, dict(compression=34925, predictor=2,
                           rows_per_strip=4)),
        lzma16=(rgba[..., 0].astype(np.uint16) * 257, dict(
            bits=16, compression=34925, predictor=2)),
        oldlzw=(rgba[..., :3], dict(compression=5, old_lzw=True,
                                    rows_per_strip=4)),
        gray12=(g12, dict(bits=12, rows_per_strip=3)),
        lzw12=(g12, dict(bits=12, compression=5)),
        deflate12=(g12, dict(bits=12, compression=8, tile=(16, 16))))
    samples, kw = forms[kind]
    return cs.write_tiff(samples, **kw)


def test_tiff_libtiff_forms_match_jax():
    """The TIFF forms PIL reads through libtiff, bitwise the JAX package's
    at 1x1, 7x5 and 33x17: PIL's JPEG (gray, RGB, RGBA, CMYK; photometric
    RGB, the components as they are) and LZMA files; write_tiff's YCbCr
    JPEGs (4:4:4, 4:2:2, 4:2:0; strips, a short last strip, tiles clipped
    at the right and bottom; JPEGTables; libjpeg's upsampling and colour),
    an RGB JPEG in tiles and a gray one in strips; compressed YCbCr
    through libtiff's RGBA interface at every subsampling it puts (1x1,
    1x2, 2x1, 2x2, 4x1, 4x2, 4x4 over LZW, deflate and PackBits, strips
    and tiles, libtiff's 4x4 skew in clipped tiles), with
    YCbCrCoefficients and ReferenceBlackWhite, predictor 2 and planar 1x1;
    uncompressed YCbCr (Pillow's raw "RGBX", or its refusal); LZMA with
    predictor 2 (8 and 16 bits); old-style LZW; 12-bit gray raw, LZW and
    deflate."""
    cs = IO._writers()
    cases = [f"pil_{c}_{m}" for c in ("jpeg", "lzma")
             for m in ("L", "RGB", "RGBA", "CMYK")]
    cases += [f"jpeg_{s}_{lay}" for s, lay in (
        ("11", "strip"), ("11", "wide"), ("21", "rows8"), ("21", "tile"),
        ("22", "rows8"), ("22", "tile"), ("22", "wide"))]
    subs = ("11", "12", "21", "22", "41", "42", "44")
    cases += [f"ycc_{s}_{c}_{lay}" for i, s in enumerate(subs)
              for c, lay in (((5, 8, 32773)[i % 3], "strip"),
                             ((8, 32773, 5)[i % 3], "rows4"),
                             ((32773, 5, 8)[i % 3], "tile"))]
    cases += ["jpegrgb", "jpeggray", "ycoef", "y709", "ypred", "yplanar",
              "yraw", "lzma", "lzma16", "oldlzw", "gray12", "lzw12",
              "deflate12"]
    IO._each(cases, lambda case: _agree_sizes(
        lambda *a: _libtiff(cs, *a), case))


def _sgi_pcx(cs, case, h, w):
    """``case``'s SGI, PCX or DCX file at h x w: PIL's writers
    ("pil_<format>_<mode>") or chip_smoke.py's numpy writers."""
    rng, smooth, rgba = _images(h, w, case)
    kind, *rest = case.split("_")
    if kind == "pil":
        from PIL import Image

        fmt, mode = rest[0], rest[1]
        img = {"1": Image.fromarray(rgba[..., 0] > 127),
               "L": Image.fromarray(rgba[..., 0]),
               "P": Image.fromarray(smooth).quantize(13),
               "RGB": Image.fromarray(smooth),
               "RGBA": Image.fromarray(rgba)}[mode]
        kw = dict(bpc=2) if rest[2:] == ["16"] else {}
        return _pil(img, fmt.upper(), **kw)
    if kind == "tgapcx":       # a PCX header with an empty box: a TGA
        data = bytearray(cs.write_tga(smooth, 2, 24, image_id=bytes(10)))
        data[7] = 24                        # colour-map entry size, unused
        return bytes(data)
    if kind == "sgistop":      # a row's length field ends on a count
        data = bytearray(cs.write_sgi(rgba[..., :3], 1, True))
        r = h // 2                          # its channel 1: image stops
        struct.pack_into(">I", data, 512 + 4 * 3 * h + 4 * (r + h), 1)
        return bytes(data)
    if kind == "sgi":          # sgi_<bytes a channel>_<raw|rle>_<channels>
        bpc, z = int(rest[0]), int(rest[2])
        v = rgba[..., :z].astype(np.uint32) * (257 if bpc == 2 else 1)
        if bpc == 2:
            v[..., 0] ^= np.arange(w, dtype=np.uint32) % 3   # low bytes vary
        return cs.write_sgi(v[..., 0] if z == 1 else v, bpc,
                            rest[1] == "rle")
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    pages = dict(
        ega2=lambda: cs.write_pcx(rgba[..., 0] % 4, 1, 2, 2, ega=pal[:16]),
        ega4=lambda: cs.write_pcx(rgba[..., 0] % 16, 1, 4, 2, ega=pal[:16]),
        ega4packed=lambda: cs.write_pcx(rgba[..., 0] % 16, 1, 4, 2,
                                        ega=pal[:16], stride=(w + 7) // 8),
        rgb=lambda: cs.write_pcx(smooth, 8, 3),
        rgbpacked=lambda: cs.write_pcx(smooth, 8, 3, stride=w),
        pal=lambda: cs.write_pcx(rgba[..., 0], 8, 1, palette=pal),
        ramp=lambda: cs.write_pcx(rgba[..., 0], 8, 1, palette=ramp,
                                  stride=w),
        bits=lambda: cs.write_pcx(rgba[..., 0] & 1, 1, 1, 3))
    if kind == "dcx":          # dcx_<first page>_<second page>
        return cs.write_dcx([pages[rest[0]](), pages[rest[1]]()])
    return pages[rest[0]]()


def test_sgi_pcx_dcx_match_jax():
    """SGI, PCX and DCX bitwise the JAX package's (PIL's decode) at 1x1,
    7x5 and 33x17: PIL's SGI (L, RGB, RGBA; 8 and 16 bits) and PCX (1, L,
    P, RGB; Pillow's own 1x1 RGB file it then refuses) writers; write_sgi
    verbatim and RLE, 8 and 16 bits, 1, 3 and 4 channels (16-bit samples
    keep their high bytes), and an RLE row whose length field runs out on
    a count (Pillow ends the image there); write_pcx's 2 and 4-plane EGA files (padded
    and packed strides), 24-bit colour lines (padded: Pillow's fix-up, or
    its misread at widths 1 and 3; packed), 8-bit palette and gray-ramp
    files and a 1-bit one; DCX files whose first page is read, its
    palette taken from the end of the file (the last page's); a TGA whose
    header opens as a PCX with an empty box or, at 1x1, under 68 bytes
    (PIL's PCX plugin turns it down and its TGA plugin reads it)."""
    cs = IO._writers()
    cases = [f"pil_sgi_{m}" for m in ("L", "RGB", "RGBA")]
    cases += [f"pil_sgi_{m}_16" for m in ("L", "RGBA")]
    cases += [f"pil_pcx_{m}" for m in ("1", "L", "P", "RGB")]
    cases += [f"sgi_{b}_{r}_{z}" for b in (1, 2) for r in ("raw", "rle")
              for z in (1, 3, 4)] + ["sgistop"]
    cases += [f"pcx_{p}" for p in ("ega2", "ega4", "ega4packed", "rgb",
                                   "rgbpacked", "pal", "ramp", "bits")]
    cases += ["dcx_rgb_pal", "dcx_pal_rgb", "dcx_ega4_ramp"]
    cases += ["tgapcx"]
    IO._each(cases, lambda case: _agree_sizes(
        lambda *a: _sgi_pcx(cs, *a), case))


def _blp(cs, case, h, w):
    """``case``'s BLP or FTEX file at h x w: PIL's BLP writer ("pil_<BLP1 |
    BLP2>") or chip_smoke.py's write_blp / write_ftex."""
    rng, smooth, rgba = _images(h, w, case)
    kind, *rest = case.split("_")
    if kind == "pil":
        from PIL import Image

        return _pil(Image.fromarray(smooth).quantize(13), "BLP",
                    blp_version=rest[0])
    if kind == "pal":          # pal_<version>_<alpha depth>
        version, alpha = int(rest[0]), int(rest[1])
        bgra = rng.integers(0, 256, (256, 4)).astype(np.uint8)
        return cs.write_blp(version, w, h, rgba[..., 0].tobytes(), 1,
                            1 if version == 2 else 4 + alpha % 2, alpha,
                            palette=bgra)
    if kind == "dxt":          # dxt_<alpha encoding>_<alpha depth>
        enc, alpha = int(rest[0]), int(rest[1])
        size = 8 if enc == 0 else 16
        blocks = rng.bytes(((w + 3) // 4) * ((h + 3) // 4) * size)
        return cs.write_blp(2, w, h, blocks, 1, 2, alpha, enc)
    if kind == "jpeg":         # jpeg_<ycc | gray | ycck>_<alpha depth>
        bgr = smooth[..., ::-1]
        jpg = {"ycc": lambda: cs.write_jpeg(cs.rgb_to_ycc(bgr),
                                            [(2, 2), (1, 1), (1, 1)]),
               "gray": lambda: cs.write_jpeg([smooth[..., 0]]),
               "ycck": lambda: cs.write_jpeg(
                   [bgr[..., k] for k in range(3)] + [rgba[..., 0]],
                   adobe=2, jfif=False)}[rest[0]]()
        head, body = cs.jpeg_split(jpg)
        return cs.write_blp(1, w, h, body, 0, 0, int(rest[1]),
                            jpeg_header=b"".join(head))
    if kind == "ftexraw":
        return cs.write_ftex(w, h, smooth.tobytes(), 1)
    return cs.write_ftex(w, h, cs.encode_bcn(smooth, 1), 0)


def test_blp_ftex_match_jax():
    """BLP and FTEX bitwise the JAX package's (PIL's decode) at 1x1, 7x5
    and 33x17: PIL's BLP1 and BLP2 palette writers; write_blp's BLP1 and
    BLP2 palettes at alpha depths 0, 1, 4 and 8 (the palette's alpha),
    BLP2 DXT1 / DXT3 / DXT5 with and without alpha over seeded random
    blocks (Pillow's Python decoders: unreplicated 5-6-5 endpoints, rows
    of whole blocks re-read w pixels a row, RGB keeping three bytes of
    four), BLP1 JPEGs (YCbCr, gray, YCCK read as CMYK; RGB and RGBA) re-read
    as BGR; FTEX raw RGB and DXT1."""
    cs = IO._writers()
    cases = ["pil_BLP1", "pil_BLP2"]
    cases += [f"pal_{v}_{a}" for v in (1, 2) for a in (0, 1, 4, 8)]
    cases += [f"dxt_{e}_{a}" for e in (0, 1, 7) for a in (0, 8)]
    cases += [f"jpeg_{k}_{a}" for k in ("ycc", "gray", "ycck")
              for a in (0, 8)]
    cases += ["ftexraw", "ftexdxt1"]
    IO._each(cases, lambda case: _agree_sizes(
        lambda *a: _blp(cs, *a), case))
