"""The PyTorch port's ``read_image`` on what its imaging-library reference
(the JAX package's ``read_image``, PIL) makes of PNG transparency keys,
of the container formats BMP/DIB, TGA, GIF and WebP, and on the forms
both packages refuse, on the CPU.

Five tests (the PNG and JPEG forms both decode are
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
   BMPs, 32-bit and 15-bit TGA colour maps, a TGA run past its row and
   DDS, TIFF and QOI headers: the port names the form where PIL raises;
   a .gltf with an external .webp image and one with an embedded BMP load
   as the JAX loader loads them.
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
    ("webp_cut", "WebP"), ("dds", "DDS"), ("tiff", "TIFF"), ("qoi", "QOI"))


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
    return _container(case, 6, 9)


def test_refused_containers_and_gltf_match_jax(tmp_path):
    """Both packages refuse BMP bitfields outside Pillow's sets, BI_JPEG,
    BI_PNG, 2-bit BMPs, a 4-bit gray-ramp BMP (read as 8-bit "L"), 32 and
    15-bit TGA colour maps, a TGA repeat packet across a row's end, 15-bit
    TGA pixels, BMP, GIF and WebP files cut after 20 bytes, and DDS, TIFF
    and QOI headers: the port raises NotImplementedError naming the form. A .gltf whose image 2 is an
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

    IO._each(list(_REFUSED_CONTAINERS), refused)
    IO._each(["webp", "bmp"], loads)
