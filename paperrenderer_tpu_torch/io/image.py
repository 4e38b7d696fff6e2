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
    PIL's libjpeg-turbo.

12- and 16-bit, hierarchical and arithmetic lossless JPEGs, PNGs of other
bit depths and other formats (GIF, BMP, WebP, ...) raise
``NotImplementedError`` naming the form. ``encode_png`` and ``write_png``
write 8-bit gray / RGB / RGBA PNGs.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .jpeg import read_jpeg

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


def _describe(data: bytes) -> str:
    """A name for a format ``read_image`` does not decode."""
    if data[:4] in (b"GIF8", b"RIFF") or data[:2] == b"BM":
        return {b"GIF8": "GIF", b"RIFF": "WebP/RIFF"}.get(data[:4], "BMP")
    return "unknown (not a PNG or JPEG)"


def read_image(data_or_path) -> np.ndarray:
    """Decode a PNG or a JPEG from bytes or a path -> u8 [H, W, C] ([H, W]
    for gray), as the JAX package's ``read_image`` returns it: gray and RGB
    as they are, RGBA for the other forms (module docstring). Raises
    NotImplementedError naming the format for the other formats and
    forms."""
    if isinstance(data_or_path, (bytes, bytearray, memoryview)):
        data = bytes(data_or_path)
    else:
        with open(data_or_path, "rb") as f:
            data = f.read()
    if data[:3] == b"\xff\xd8\xff":
        return read_jpeg(data)
    if data[:8] != _SIGNATURE:
        raise NotImplementedError(
            f"image format {_describe(data)}: only PNG and JPEG are decoded")
    return _read_png(data)


def _read_png(data: bytes) -> np.ndarray:
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
        elif kind == b"tRNS":
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
