"""Image output/input: the swapchain-present analogue for a headless renderer.

PyTorch-port counterpart of ``paperrenderer_tpu/io/image.py``, written with
``zlib``, ``struct`` and numpy only (no imaging library). ``read_image``
decodes what the JAX package's imaging library (PIL) turns into its arrays:

  * PNG, Adam7-interlaced or not: 8-bit gray, RGB and RGBA as they are;
    2- and 4-bit gray as 8-bit gray scaled by 85 and 17 (PIL's "L;2" /
    "L;4", no transparency); palette (1/2/4/8-bit, with ``tRNS``) and
    gray + alpha as RGBA; 16-bit RGB, RGBA and gray + alpha by their high
    bytes; 1-bit gray (0 / 255) and 16-bit gray (clipped to 255) as RGBA
    with the ``tRNS`` key's alpha, as PIL's "1" / "I;16" -> "RGBA"
    conversion compares it (the converted gray against the key's low
    byte; "1": any nonzero key is 255);
  * JPEG as ``io.jpeg.read_jpeg`` decodes it: baseline, extended,
    progressive (block-smoothed where its scans leave coefficients
    unfinished), lossless and arithmetic-coded 8-bit files, gray, YCbCr,
    RGB, CMYK or YCCK (as RGBA), at any integral sampling, to the bit of
    PIL's libjpeg-turbo;
  * BMP and DIB (``io.bmp``), TGA (``io.tga``) and GIF's first frame
    (``io.gif``) in PIL's mode, turned into the JAX package's array by
    ``pil_convert`` (PIL's ``convert("RGBA")`` of every mode but "L",
    "RGB" and "RGBA"): 1/4/8-bit palettes (gray ramps as gray), 16, 24
    and 32 bits, Pillow's bitfield sets, RLE4/RLE8, any BMP header;
    colour-mapped, gray and truecolour TGAs, raw or run-length, any
    origin; GIFs with global or local tables, interlaced, with a
    transparency index or a frame offset in the screen;
  * WebP (``io.webp``): lossless (``io.vp8l``), lossy (``io.vp8``, with
    libwebp's fancy upsampling and integer YUV -> RGB), lossy with an
    ALPH plane, and the first frame of an animation, as RGBA where the
    file has alpha, else RGB, to the bit of PIL's libwebp;
  * DDS (``io.dds`` over ``io.bcn``: BC1-BC7, uncompressed masks,
    luminance, palette), TIFF and BigTIFF (``io.tiff``: raw, PackBits,
    LZW and deflate, strips and tiles, chunky and planar, predictors),
    Netpbm (``io.netpbm``: P1-P6, Pf and Pillow's own headers), QOI
    (``io.qoi``) and ICO / CUR (``io.ico``: the entry Pillow picks, PNG or
    BMP with its mask), in PIL's modes, ``pil_convert`` adding the modes
    they bring ("I;16", "I", "F", "CMYK", "RGBa", "PA").

``read_image`` dispatches by signature (PNG, JPEG, ``BM``, ``GIF87a`` /
``GIF89a``, ``RIFF....WEBP``, a DIB's header size, ``P`` and a Netpbm
letter, ``DDS ``, ICO / CUR with entries, ``qoif``, the TIFF and BigTIFF
byte-order marks) and tries TGA, which has none, last. 12- and 16-bit,
hierarchical and arithmetic lossless JPEGs, PNGs of other bit depths,
the forms of each container PIL refuses, PAM and colour PFM (which PIL
does not open), and the formats left (PSD, SGI, PCX, JPEG 2000, ...;
``_describe`` names them by signature, "not yet ported"), with the forms
of these formats left for later (JPEG and CCITT TIFFs, YCbCr and CIELab,
...), raise ``NotImplementedError`` naming the form.
``encode_png`` and ``write_png`` write 8-bit gray / RGB / RGBA PNGs.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .bmp import read_bmp
from .dds import read_dds
from .gif import read_gif
from .ico import read_ico
from .jpeg import _cmyk_rgba, read_jpeg
from .netpbm import read_netpbm
from .qoi import read_qoi
from .tga import is_tga, read_tga
from .tiff import read_tiff, unpremultiply
from .webp import read_webp

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples/pixel
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                6: "RGBA"}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image) -> bytes:
    """Encode an image as PNG bytes. Accepts f32 [H, W, 3] in [0, 1] (a
    tensor on any device too) or u8 [H, W], [H, W, 1|3|4]."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    return b"".join((
        _SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
        _chunk(b"IEND", b"")))


def write_png(path: str, image) -> None:
    """Write an image to PNG (``encode_png``'s inputs)."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _unfilter(data: bytes, h: int, stride: int, bpp: int,
              pos: int = 0) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) of the h rows at ``pos``
    -> u8 [h, stride]."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = row
        elif ftype == 1:      # Sub: running sum per channel along the row
            cur = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:      # Up
            cur = (row + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = row.tolist()
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(raw: bytes, pos: int, w: int, h: int, c: int, depth: int):
    """The w x h image of c samples a pixel at ``pos`` of the inflated
    stream -> (samples [h, w, c]: u8, u16 for 16-bit, sub-byte indices
    unpacked; the next position)."""
    stride = -(-w * c * depth // 8)
    rows = _unfilter(raw, h, stride, max(1, c * depth // 8), pos)
    pos += h * (stride + 1)
    if depth == 16:
        rows = rows.view(">u2").astype(np.uint16)
    elif depth < 8:   # unpack the sub-byte samples, high bits first
        per = 8 // depth
        shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1))
        rows = rows.reshape(h, -1)
    return rows[:, :w * c].reshape(h, w, c), pos


# the formats the imaging library opens and ``read_image`` does not decode
# yet, by signature: (offset, the bytes there, name)
_LEFT = ((0, b"8BPS", "PSD"), (0, b"\x01\xda", "SGI"),
         (0, b"icns", "ICNS"), (0, b"\xffO\xffQ", "JPEG 2000 codestream"),
         (4, b"jP  \r\n\x87\n", "JPEG 2000"), (4, b"ftypavi", "AVIF"),
         (0, b"BLP", "BLP"), (0, b"FTEX", "FTEX"),
         (0, b"\x59\xa6\x6a\x95", "Sun raster"), (0, b"DanM", "MSP"),
         (0, b"LinS", "MSP"), (0, b"\xb1\x68\xde\x3a", "DCX"),
         (0, b"SIMPLE", "FITS"), (0, b"%!PS", "EPS"),
         (0, b"\xc5\xd0\xd3\xc6", "EPS"), (0, b"\xd7\xcd\xc6\x9a", "WMF"),
         (40, b" EMF", "EMF"), (0, b"\x00\x00\x01\xb3", "MPEG"),
         (0, b"BUFR", "BUFR"), (0, b"GRIB", "GRIB"),
         (0, b"\x89HDF\r\n\x1a\n", "HDF5"), (0, b"\x80\xe8\x00\x00", "PIXAR"),
         (0, b"#define", "XBM"), (0, b"/* XPM */", "XPM"),
         (0, b"P7 332", "XV thumbnail"))
# the Netpbm relatives the imaging library does not open: refused by both
_REFUSED = ((0, b"PF", "colour PFM (PF)"), (0, b"P7", "PAM (P7)"))
_TIFF = (b"MM\x00*", b"II*\x00", b"MM*\x00", b"II\x00*", b"MM\x00+",
         b"II+\x00")
_DIB_SIZES = (12, 40, 52, 56, 64, 108, 124)   # a DIB starts with its header


def _describe(data: bytes) -> str:
    """A name for a format ``read_image`` does not decode, by signature."""
    for off, sig, name in _LEFT:
        if data[off:off + len(sig)] == sig:
            return name + ", not yet ported"
    for off, sig, name in _REFUSED:
        if data[off:off + len(sig)] == sig:
            return name + ", which the imaging library does not open"
    if data[:1] == b"\x0a" and data[1:2] in (b"\x00", b"\x02", b"\x03",
                                             b"\x05"):
        return "PCX"
    if data[:4] == b"RIFF":
        return "RIFF (not a WebP of VP8, VP8L or VP8X)"
    if data[:4] == b"\x00\x00\x01\x00":
        return "ICO without entries"
    return "unknown (no signature read_image knows, and not a TGA)"


def pil_convert(mode: str, px: np.ndarray, palette=None,
                transparency=None) -> np.ndarray:
    """PIL's mode step: an image in PIL's ``mode`` -> what the JAX
    ``read_image`` returns, which keeps "L", "RGB" and "RGBA" and makes
    every other mode ``convert("RGBA")``: "1" (0 / 255) and "LA" as gray
    with alpha; "I;16" / "I;16B" (u16) and "I" (i32) clipped to [0, 255],
    "F" (f32) clipped and truncated (NaN 0); "CMYK" through Pillow's
    ``cmyk2rgb``; "RGBa" unpremultiplied; "P" and "PA" through the
    palette ([n, 3] or [n, 4]; an index past it reads opaque black) with
    ``transparency`` an index (its alpha 0) or bytes (the alphas of the
    first entries), "PA" with its own alpha band."""
    if mode in ("L", "RGB", "RGBA"):
        return px
    if mode == "RGBa":
        return unpremultiply(px)
    if mode == "CMYK":
        return _cmyk_rgba(*(255 - px[..., k] for k in range(4)))
    if mode in ("I;16", "I;16B", "I", "F"):
        if mode == "F":
            px = np.where(np.isnan(px), 0, px)
        px = np.clip(px, 0, 255).astype(np.uint8)
        mode = "L"
    if mode in ("1", "L"):
        px = np.stack([px, np.full_like(px, 255)], -1)
        mode = "LA"
    if mode == "LA":
        return px[..., [0, 0, 0, 1]]
    lut = np.zeros((256, 4), np.uint8)
    lut[:, 3] = 255
    if palette is not None:
        n = min(len(palette), 256)
        lut[:n, :palette.shape[1]] = palette[:n]
    if isinstance(transparency, int):
        lut[transparency, 3] = 0
    elif transparency is not None:
        alpha = np.frombuffer(transparency, np.uint8)[:256]
        lut[:alpha.size, 3] = alpha
    if mode == "PA":
        out = lut[px[..., 0]]
        out[..., 3] = px[..., 1]
        return out
    return lut[px]


def _decoded(name: str, decode, *args) -> np.ndarray:
    """``decode(*args)``, a file cut short or inconsistent inside raising
    NotImplementedError naming the format, as the others do."""
    try:
        return decode(*args)
    except (struct.error, IndexError, ValueError) as exc:
        raise NotImplementedError(f"{name}: a malformed file ({exc})") \
            from exc


def read_image(data_or_path) -> np.ndarray:
    """Decode an image from bytes or a path -> u8 [H, W, C] ([H, W] for
    gray), as the JAX package's ``read_image`` returns it: gray, RGB and
    RGBA as they are, RGBA for the other forms (module docstring).
    Dispatches by signature (PNG, JPEG, BMP, GIF, WebP, a DIB's header
    size), then tries TGA, which has none. Raises NotImplementedError
    naming the format for the other formats and forms."""
    if isinstance(data_or_path, (bytes, bytearray, memoryview)):
        data = bytes(data_or_path)
    else:
        with open(data_or_path, "rb") as f:
            data = f.read()
    if data[:3] == b"\xff\xd8\xff":
        return read_jpeg(data)
    if data[:8] == _SIGNATURE:
        return _read_png(data)
    if data[:2] == b"BM":
        return pil_convert(*_decoded("BMP", read_bmp, data))
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return pil_convert(*_decoded("GIF", read_gif, data))
    if (data[:4] == b"RIFF" and data[8:12] == b"WEBP"
            and data[12:16] in (b"VP8 ", b"VP8L", b"VP8X")):
        return _decoded("WebP", read_webp, data)
    if len(data) >= 4 and struct.unpack_from("<I", data)[0] in _DIB_SIZES:
        return pil_convert(*_decoded("DIB", read_bmp, data, True))
    if data[:1] == b"P" and len(data) >= 2 and data[1] in b"0123456fy":
        return pil_convert(*_decoded("Netpbm", read_netpbm, data))
    if data[:4] == b"DDS ":
        return pil_convert(*_decoded("DDS", read_dds, data))
    if data[:4] in (b"\x00\x00\x01\x00", b"\x00\x00\x02\x00") \
            and data[4:6] != b"\x00\x00":   # entries (else a TGA may start so)
        return _icon(data, data[2] == 2)
    if data[:4] == b"qoif":
        return pil_convert(*_decoded("QOI", read_qoi, data))
    if data[:4] in _TIFF:
        name = "BigTIFF" if data[2] == 43 else "TIFF"
        return pil_convert(*_decoded(name, read_tiff, data))
    name = _describe(data)
    if name.startswith("unknown") and is_tga(data):
        return pil_convert(*_decoded("TGA", read_tga, data))
    raise NotImplementedError(
        f"image format {name}: PNG, JPEG, BMP/DIB, GIF, WebP, TGA, DDS, "
        "TIFF, Netpbm, QOI and ICO/CUR are decoded")


def _icon(data: bytes, cursor: bool) -> np.ndarray:
    """An ICO or CUR file as the imaging library reads it (``io.ico``):
    a PNG entry's PNG without its transparency; a BMP entry made RGBA with
    its alpha (ICO), or in the DIB's mode (CUR)."""
    name = "CUR" if cursor else "ICO"
    kind, *rest = _decoded(name, read_ico, data, cursor)
    if kind == "png":
        return _decoded(f"{name} PNG entry", _read_png, rest[0], False)
    mode, px, palette, alpha = rest
    img = pil_convert(mode, px, palette)
    if alpha is None:
        return img
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    return np.concatenate([img[..., :3], alpha[..., None]], -1)


def _read_png(data: bytes, transparency: bool = True) -> np.ndarray:
    """A PNG -> the JAX package's array; ``transparency=False`` ignores
    its ``tRNS`` (an ICO's PNG entry, whose icon keeps no transparency)."""
    pos, idat, header, palette, trns = 8, [], None, None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS" and transparency:
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    fmt = (f"PNG {_COLOR_NAMES.get(color, f'colour type {color}')}, "
           f"{depth}-bit{', interlaced' if interlace else ''}")
    ok_depth = (depth in (1, 2, 4, 8) if color == 3 else
                depth in (1, 2, 4, 8, 16) if color == 0 else depth in (8, 16))
    if color not in _CHANNELS or not ok_depth or interlace not in (0, 1):
        raise NotImplementedError(
            f"{fmt}: only 1/2/4/8/16-bit gray, 8/16-bit gray+alpha/RGB/RGBA "
            "and 1/2/4/8-bit palette PNGs are decoded")
    c = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        img = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:   # an empty pass has no bytes at all
                img[y0::dy, x0::dx], pos = _samples(raw, pos, pw, ph, c,
                                                    depth)
    else:
        img, _ = _samples(raw, 0, w, h, c, depth)
    if color == 0 and depth in (1, 16):
        # PIL's "1" (0/255) and "I;16" (the gray clipped at 255) convert to
        # RGBA with the tRNS key: alpha 0 where the converted gray equals
        # the key's low byte ("1": 255 for any nonzero key), as Pillow's
        # rgbT2rgba compares bytes
        g = (img * 255 if depth == 1 else np.minimum(img, 255)).astype(
            np.uint8)
        a = np.full_like(g, 255)
        if trns is not None:
            (key,) = struct.unpack(">H", trns[:2])
            key = (255 if key else 0) if depth == 1 else key & 0xFF
            a[g == key] = 0
        return np.concatenate([g, g, g, a], axis=-1)
    if color == 0 and depth < 8:   # PIL's "L;2" / "L;4": scaled, no tRNS
        return (img.reshape(h, w) * (255 // ((1 << depth) - 1))).astype(
            np.uint8)
    if depth == 16:
        img = (img >> 8).astype(np.uint8)   # PIL keeps the high bytes
    if color == 3:
        lut = np.full((256, 4), 255, np.uint8)
        lut[:palette.shape[0], :3] = palette
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            lut[:alpha.shape[0], 3] = alpha
        return lut[img[..., 0]]
    if color == 4:   # gray + alpha -> RGBA
        return np.concatenate([img[..., :1].repeat(3, axis=-1), img[..., 1:]],
                              axis=-1)
    return img if c > 1 else img.reshape(h, w)
