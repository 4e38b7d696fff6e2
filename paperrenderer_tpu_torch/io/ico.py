"""ICO and CUR decoding for ``io.image.read_image``, with ``struct`` and
numpy only.

Picks the entry the JAX package's imaging library (Pillow 12's
``IcoImagePlugin`` / ``CurImagePlugin``) picks and reads it as Pillow
does, to the bit:

  * ICO: the entries sorted by colour depth (the bit count, else
    ceil(log2) of the colour count, else 256), then by area, largest
    first (stable sorts); the first one is read. A PNG entry is the PNG
    in Pillow's mode, without its ``tRNS`` (the icon does not keep the
    PNG's transparency); a BMP entry is a DIB whose header height counts
    the AND mask too: its first half of the rows in the DIB's mode, made
    RGBA, with the alpha of the fourth bytes of the pixel data (the
    entry's bit count 32) or of the AND mask at the entry's end (1 bit a
    pixel, rows of 32 bits, bottom-up; a set bit is transparent);
  * CUR: the first entry, or a later one wider and taller in the
    directory's bytes; its DIB read as a BMP of half its height, in the
    DIB's mode (no mask).

``read_ico`` returns ("png", the entry's bytes) or ("bmp", Pillow's mode,
pixels, palette, alpha or None); ``io.image`` decodes the PNG and makes
the RGBA. A file cut short raises NotImplementedError naming the form,
where Pillow raises too.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .bmp import read_bmp

_PNG = b"\x89PNG\r\n\x1a\n"


def _depth(bpp: int, colors: int) -> int:
    return bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256


def read_ico(data: bytes, cursor: bool = False):
    """An ICO (``cursor``: CUR) file -> ("png", bytes) or ("bmp", mode,
    pixels, palette, alpha u8 [h, w] or None)."""
    name = "CUR" if cursor else "ICO"
    (count,) = struct.unpack_from("<H", data, 4)
    entries = [struct.unpack_from("<BBBBHHII", data, 6 + 16 * k)
               for k in range(count)]
    if not entries:
        raise NotImplementedError(f"{name}: no entries")
    if cursor:
        pick = entries[0]
        for e in entries[1:]:
            if e[0] > pick[0] and e[1] > pick[1]:
                pick = e
        return ("bmp",) + read_bmp(data[pick[7]:], True, True) + (None,)
    keyed = [((e[0] or 256) * (e[1] or 256), _depth(e[5], e[2]), e)
             for e in entries]
    keyed.sort(key=lambda k: k[1])
    keyed.sort(key=lambda k: k[0], reverse=True)
    *_, bpp, size, offset = keyed[0][2]
    blob = data[offset:]
    if blob[:8] == _PNG:
        return "png", blob
    mode, px, palette, start = read_bmp(blob, True, True, with_start=True)
    hh, ww = px.shape[:2]
    if bpp == 32:
        raw = blob[start:start + 4 * ww * hh]
        if len(raw) < 4 * ww * hh:
            raise NotImplementedError(f"{name}: truncated 32-bit entry")
        alpha = np.frombuffer(raw, np.uint8)[3::4].reshape(hh, ww)[::-1]
    else:
        padded = ww + (-ww % 32)
        total = padded * hh // 8
        pos = offset + size - total
        raw = data[pos:pos + total] if pos >= 0 else b""
        if len(raw) < total:
            raise NotImplementedError(f"{name}: truncated AND mask")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(
            hh, padded // 8), axis=1)[:, :ww][::-1]
        alpha = np.where(bits, 0, 255).astype(np.uint8)
    return "bmp", mode, px, palette, alpha
