"""WebP decoding for ``io.image.read_image``, with numpy only: the RIFF
container and the RGB(A) output, to the bit of what the JAX package's
imaging library (Pillow 12 over libwebp 1.6's ``WebPAnimDecoder``)
returns.

  * chunks VP8 (``io.vp8``), VP8L (``io.vp8l``) and VP8X; ICCP, EXIF, XMP
    and unknown chunks are skipped;
  * ALPH: raw or VP8L-compressed (``io.vp8l.decode_alpha``), with the
    none / horizontal / vertical / gradient filters undone as libwebp's
    unfilters do; no alpha dithering (libwebp's default);
  * ANIM / ANMF: the first frame, decoded into a zeroed canvas at its
    offset (``WebPAnimDecoder`` blends only later frames);
  * lossy output: libwebp's "fancy" upsampling of the 4:2:0 chroma (each
    output sample (9 near + 3 + 3 + 1 far) / 16 in its two rounding steps)
    and its fixed-point YUV -> RGB (``VP8YUVToR/G/B``: 14-bit constants,
    ``MultHi``); alpha stays straight, never premultiplied.

The result is RGBA where the file says it has alpha (the VP8X flag or the
VP8L header's hint), else RGB, as Pillow's mode is. Malformed files raise
NotImplementedError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import vp8, vp8l


def _bad(what: str):
    raise NotImplementedError(f"WebP: {what}")


def _chunks(data: bytes, pos: int, end: int):
    """The RIFF chunks between pos and end -> [(fourcc, payload)]."""
    out = []
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + size > end:
            _bad(f"a truncated {kind.decode('latin-1')} chunk")
        out.append((kind, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _fancy(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler of a chroma plane [(h + 1) / 2, (w + 1) / 2]
    -> [h, w]: the near sample (the one whose area holds the pixel), the
    two next to it and the far one, (diag + near) >> 1 with
    diag = (near + 3 * (side + side) + far + 8) >> 3."""
    c = c.astype(np.int32)
    ys, xs = np.arange(h), np.arange(w)
    ny, nx = ys >> 1, xs >> 1
    fy = np.clip(np.where(ys & 1, (ys + 1) >> 1, (ys - 1) >> 1), 0,
                 c.shape[0] - 1)
    fx = np.clip(np.where(xs & 1, (xs + 1) >> 1, (xs - 1) >> 1), 0,
                 c.shape[1] - 1)
    near = c[ny[:, None], nx[None, :]]
    side = c[ny[:, None], fx[None, :]] + c[fy[:, None], nx[None, :]]
    far = c[fy[:, None], fx[None, :]]
    diag = (near + 3 * side + far + 8) >> 3
    return (diag + near) >> 1


def _mult_hi(v, coeff):
    return (v * coeff) >> 8


def _clip8(v):
    """libwebp's ``VP8Clip8``: 14-bit fixed point -> 0..255."""
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(y, u, v) -> np.ndarray:
    """libwebp's ``VP8YuvToRgb`` over 4:2:0 planes (fancy upsampling)
    -> u8 [h, w, 3]."""
    h, w = y.shape
    y = y.astype(np.int32)
    u, v = _fancy(u, h, w), _fancy(v, h, w)
    yy = _mult_hi(y, 19077)
    r = _clip8(yy + _mult_hi(v, 26149) - 14234)
    g = _clip8(yy - _mult_hi(u, 6419) - _mult_hi(v, 13320) + 8708)
    b = _clip8(yy + _mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _alpha(chunk: bytes, w: int, h: int) -> np.ndarray:
    """An ALPH chunk -> alpha u8 [h, w]."""
    if not chunk:
        _bad("an empty ALPH chunk")
    method, filt = chunk[0] & 3, (chunk[0] >> 2) & 3
    if method > 1 or (chunk[0] >> 4) & 3 > 1 or chunk[0] >> 6:
        _bad(f"an ALPH header of {chunk[0]:#04x}")
    if method == 0:
        if len(chunk) - 1 < w * h:
            _bad("a truncated raw ALPH plane")
        a = np.frombuffer(chunk, np.uint8, w * h, 1).reshape(h, w)
    else:
        a = vp8l.decode_alpha(chunk[1:], w, h)
    if filt == 0:
        return a.copy()
    a = a.astype(np.int64)
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0]) & 0xFF             # the first row: from the left
    for y in range(1, h):
        prev = out[y - 1]
        if filt == 1:                             # horizontal
            out[y] = (prev[0] + np.cumsum(a[y])) & 0xFF
        elif filt == 2:                           # vertical
            out[y] = (prev + a[y]) & 0xFF
        else:                                     # gradient
            row, left, tl = a[y].tolist(), int(prev[0]), int(prev[0])
            top = prev.tolist()
            res = []
            for x in range(w):
                g = left + top[x] - tl
                left = (row[x] + (g if 0 <= g <= 255 else 0 if g < 0 else
                                  255)) & 0xFF
                tl = top[x]
                res.append(left)
            out[y] = res
    return out.astype(np.uint8)


def _frame(chunks):
    """A frame's chunks (ALPH? + VP8, or VP8L) -> RGBA u8 [h, w, 4]."""
    kinds = dict(chunks)
    if b"VP8L" in kinds:
        argb, _ = vp8l.decode(kinds[b"VP8L"])
        px = argb[..., None] >> np.array([16, 8, 0, 24], np.uint32)
        return (px & 0xFF).astype(np.uint8)
    if b"VP8 " not in kinds:
        _bad("no VP8 or VP8L chunk in the frame")
    y, u, v = vp8.decode(kinds[b"VP8 "])
    h, w = y.shape
    alpha = (_alpha(kinds[b"ALPH"], w, h) if b"ALPH" in kinds
             else np.full((h, w), 255, np.uint8))
    return np.concatenate([yuv_to_rgb(y, u, v), alpha[..., None]], -1)


def read_webp(data: bytes) -> np.ndarray:
    """A WebP file -> u8 [H, W, 4] with alpha, else [H, W, 3]."""
    (riff_size,) = struct.unpack_from("<I", data, 4)
    end = min(len(data), 8 + riff_size)
    chunks = _chunks(data, 12, end)
    kind, body = chunks[0]
    if kind == b"VP8 ":
        return _frame(chunks[:1])[..., :3]
    if kind == b"VP8L":
        if len(body) < 5:
            _bad("a truncated VP8L header")
        rgba = _frame(chunks[:1])
        return rgba if (body[4] >> 4) & 1 else rgba[..., :3]
    if len(body) < 10:
        _bad("a truncated VP8X chunk")
    flags = body[0]
    cw = 1 + int.from_bytes(body[4:7], "little")
    ch = 1 + int.from_bytes(body[7:10], "little")
    has_alpha = bool(flags & 0x10)
    canvas = np.zeros((ch, cw, 4), np.uint8)
    if flags & 0x02:                              # animation: the first frame
        frames = [c for k, c in chunks if k == b"ANMF"]
        if not frames:
            _bad("an animation without frames")
        f = frames[0]
        x0 = 2 * int.from_bytes(f[0:3], "little")
        y0 = 2 * int.from_bytes(f[3:6], "little")
        img = _frame(_chunks(f, 16, len(f)))
    else:
        x0 = y0 = 0
        img = _frame([c for c in chunks
                      if c[0] in (b"ALPH", b"VP8 ", b"VP8L")])
    fh, fw = img.shape[:2]
    if x0 + fw > cw or y0 + fh > ch:
        _bad("a frame outside the canvas")
    canvas[y0:y0 + fh, x0:x0 + fw] = img
    return canvas if has_alpha else canvas[..., :3]
