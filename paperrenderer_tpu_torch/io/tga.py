"""TGA (Truevision Targa) decoding for ``io.image.read_image``, with
``struct`` and numpy only.

Reads what the JAX package's imaging library (Pillow 12's
``TgaImagePlugin``) reads, to the bit, and returns the image in Pillow's
mode (``io.image.pil_convert`` turns it into ``read_image``'s array):

  * image types 1 / 2 / 3 and their run-length forms 9 / 10 / 11;
  * gray: 1 bit ("1"), 8 bits ("L"), 16 bits (gray and alpha, "LA");
  * truecolour: 16 bits (5-5-5 scaled by 255 / 31; the top bit set is
    alpha 0, as Pillow's "BGRA;15Z"), 24 bits (RGB) and 32 bits (RGBA);
  * colour-mapped 8-bit indices with a map of 16 (the top bit set is
    alpha 0) or 24-bit entries that starts at any first index (the
    entries below it are black);
  * run-length literal packets that cross rows (one pixel stream);
  * the four origins: bottom-left, bottom-right, top-left and top-right
    (a right origin is flipped horizontally, as Pillow's ``load_end``).

TGA has no signature: ``is_tga`` makes the checks Pillow's ``_open`` makes,
and ``read_image`` asks it only after every format with a signature has
failed. 15-bit pixels, 15 or 32-bit map entries and a map on an image
that is not colour-mapped (Pillow 12 cannot load them), a repeat packet
that runs past its row's end (Pillow's "buffer overrun") and other depth
/ type pairs raise NotImplementedError naming the form, where Pillow
raises too.
"""

from __future__ import annotations

import struct

import numpy as np

from .bmp import unpack_rows

# (image type & 7, depth) -> Pillow's raw mode
_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
        (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
_MAP_RAW = {16: "BGRA;15Z", 24: "BGR"}


def is_tga(data: bytes) -> bool:
    """Pillow's ``TgaImageFile._open`` header checks: a colour-map type of
    0 or 1, a nonzero size, a depth of 1, 8, 16, 24 or 32 bits and a known
    image type."""
    if len(data) < 18:
        return False
    w, h = struct.unpack_from("<HH", data, 12)
    return (data[1] in (0, 1) and w > 0 and h > 0
            and data[16] in (1, 8, 16, 24, 32)
            and data[2] in (1, 2, 3, 9, 10, 11))


def _rle(data: bytes, pos: int, w: int, n: int, size: int, form: str) -> bytes:
    """The run-length packets at ``pos`` -> n pixels of ``size`` bytes, as
    Pillow's ``TgaRleDecode`` reads them: literal packets run on across
    rows; a repeat packet that runs past its row's end is an overrun."""
    out, want, row = bytearray(), n * size, w * size
    while len(out) < want:
        if pos >= len(data):
            raise NotImplementedError(f"{form}: truncated pixel data")
        head = data[pos]
        count = (head & 0x7F) + 1
        if head & 0x80:                 # one pixel, repeated
            if len(out) % row + count * size > row:
                raise NotImplementedError(
                    f"{form}: a run-length packet past its row's end")
            px = data[pos + 1:pos + 1 + size]
            pos += 1 + size
            if len(px) < size:
                raise NotImplementedError(f"{form}: truncated pixel data")
            out += px * count
        else:                           # count literal pixels
            run = data[pos + 1:pos + 1 + count * size]
            pos += 1 + count * size
            if len(run) < count * size:
                raise NotImplementedError(f"{form}: truncated pixel data")
            out += run
    return bytes(out[:want])


def read_tga(data: bytes):
    """A TGA file -> (Pillow's mode, pixels, palette [n, 3|4] or None):
    pixels as ``io.bmp.unpack_rows`` gives them."""
    id_len, maptype, itype = data[0], data[1], data[2]
    start, size, mapdepth = struct.unpack_from("<HHB", data, 3)
    w, h, depth, flags = struct.unpack_from("<HHBB", data, 12)
    form = f"TGA type {itype}, {depth}-bit"
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if maptype else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    orient = flags & 0x30
    orientation = 1 if orient in (0x20, 0x30) else -1
    pos = 18 + id_len
    palette = None
    if maptype:    # Pillow loads a map of 16 or 24 bits on indices alone
        if mode != "P" or mapdepth not in _MAP_RAW:
            raise NotImplementedError(
                f"{form}: a {mapdepth}-bit colour map (only 16 and 24-bit "
                "maps on colour-mapped images are read)")
        k = mapdepth // 8
        table = bytes(k * start) + data[pos:pos + k * size]
        pos += k * size
        palette = unpack_rows(table, 0, len(table) // k, 1,
                              _MAP_RAW[mapdepth], 0, 1, form)[0]
    raw = _RAW.get((itype & 7, depth))
    if raw is None or (itype & 8 and depth == 1):
        raise NotImplementedError(f"{form}: not a depth Pillow decodes for "
                                  "this image type")
    if itype & 8:
        pix = _rle(data, pos, w, w * h, depth // 8, form)
        px = unpack_rows(pix, 0, w, h, raw, 0, orientation, form)
    else:
        px = unpack_rows(data, pos, w, h, raw, 0, orientation, form)
    if orient in (0x10, 0x30):
        px = px[:, ::-1]
    return mode, np.ascontiguousarray(px), palette
