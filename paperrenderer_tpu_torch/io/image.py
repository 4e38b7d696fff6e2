"""Image output/input: the swapchain-present analogue for a headless renderer.

PyTorch-port counterpart of ``paperrenderer_tpu/io/image.py``, written with
``zlib``, ``struct`` and numpy only (no imaging library). ``read_image``
decodes non-interlaced PNGs: 8-bit gray, RGB and RGBA as they are, and
palette (1/2/4/8-bit, with ``tRNS``) and 8-bit gray + alpha into RGBA, the
forms the JAX package's imaging library turns into RGBA. JPEG, 16-bit and
interlaced PNGs raise ``NotImplementedError`` naming the format.
``encode_png`` and ``write_png`` write 8-bit gray / RGB / RGBA PNGs.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

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


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) -> u8 [h, stride]."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
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


def _describe(data: bytes) -> str:
    """A name for a non-PNG image format, for the refusal message."""
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:4] in (b"GIF8", b"RIFF") or data[:2] == b"BM":
        return {b"GIF8": "GIF", b"RIFF": "WebP/RIFF"}.get(data[:4], "BMP")
    return "unknown (not a PNG)"


def read_image(data_or_path) -> np.ndarray:
    """Decode a PNG from bytes or a path -> u8 [H, W, C] ([H, W] for gray):
    gray, RGB and RGBA as stored; palette and gray + alpha as RGBA (a
    palette's ``tRNS`` alphas, 255 past them). Raises NotImplementedError
    naming the format for JPEG and the other formats, 16-bit samples,
    sub-byte gray and interlaced PNGs."""
    if isinstance(data_or_path, (bytes, bytearray, memoryview)):
        data = bytes(data_or_path)
    else:
        with open(data_or_path, "rb") as f:
            data = f.read()
    if data[:8] != _SIGNATURE:
        raise NotImplementedError(
            f"image format {_describe(data)}: only PNG is decoded")
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
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    fmt = (f"PNG {_COLOR_NAMES.get(color, f'colour type {color}')}, "
           f"{depth}-bit{', interlaced' if interlace else ''}")
    ok_depth = depth in (1, 2, 4, 8) if color == 3 else depth == 8
    if color not in _CHANNELS or not ok_depth or interlace:
        raise NotImplementedError(
            f"{fmt}: only non-interlaced 8-bit gray/gray+alpha/RGB/RGBA and "
            "1/2/4/8-bit palette PNGs are decoded")
    c = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if color == 3:
        stride = -(-w * depth // 8)
        rows = _unfilter(raw, h, stride, 1)
        if depth < 8:   # unpack the sub-byte indices, high bits first
            per = 8 // depth
            shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
            rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1))
            rows = rows.reshape(h, -1)
        idx = rows[:, :w]
        lut = np.full((256, 4), 255, np.uint8)
        lut[:palette.shape[0], :3] = palette
        if trns is not None:
            lut[:trns.shape[0], 3] = trns
        return lut[idx]
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    if color == 4:   # gray + alpha -> RGBA
        return np.concatenate([img[..., :1].repeat(3, axis=-1), img[..., 1:]],
                              axis=-1)
    return img if c > 1 else img.reshape(h, w)
