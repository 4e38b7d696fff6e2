"""SGI image decoding for ``io.image.read_image``, with ``struct`` and
numpy only.

Reads what the JAX package's imaging library (Pillow 12's
``SgiImagePlugin``) reads, to the bit: the 512-byte header, Pillow's modes
by (bytes a channel, dimension, channels) ("L", "RGB", "RGBA"; 16-bit
channels keep their high bytes, as its "L;16B" / "RGB;16B" /
"RGBA;16B" raw modes do), the rows stored bottom up, a plane a channel;

  * verbatim planes (Pillow's raw decoder, or its "SGI16" decoder);
  * RLE rows through their offset and length tables, as Pillow's
    ``SgiRleDecode.c`` expands them: a run or a literal of 1-127 atoms,
    0 ending the row; one row buffer kept from a row to the next (a row
    that ends early keeps the last row's samples after it); a table entry
    before the header's end, a row reading past the file's end, a run
    past the row, or a literal reaching the file's last byte fail (a
    length field past the file does not), and a row whose length runs out
    on a nonzero count ends the image there (the rows after it stay 0),
    as they do in Pillow.

Other modes, other compressions and a short file raise NotImplementedError naming the form,
where Pillow raises too.
"""

from __future__ import annotations

import struct

import numpy as np

from .tiff import unpack

MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
         (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
         (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def _expand_row(buf, dest, c, z, xsize, pos, n, bpc):
    """One channel's RLE row at ``pos`` (``n`` its length field) into the
    interleaved row buffer ``dest`` ([xsize * z, bpc] atoms) -> 0 (done),
    1 (stop the image) or -1 (fail), as ``expandrow`` / ``expandrow2``."""
    last = len(buf) - 1                       # the file's last byte
    x = 0
    for k in range(n, 0, -1):
        if pos + bpc - 1 > last:
            return -1
        pixel = int(buf[pos + bpc - 1])
        pos += bpc
        if k == 1 and pixel:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > xsize:
            return -1
        at = slice(x * z + c, (x + count) * z, z)
        if pixel & 0x80:
            if pos + bpc * count > last:
                return -1
            dest[at] = buf[pos:pos + bpc * count].reshape(count, bpc)
            pos += bpc * count
        else:
            if pos + 2 * (bpc - 1) > last:
                return -1
            dest[at] = buf[pos:pos + bpc]
            pos += bpc
        x += count
    return 0


def read_sgi(data: bytes):
    """An SGI file -> (Pillow's mode, pixels u8 [h, w] or [h, w, c])."""
    compression, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">HHHH", data, 4)
    if len(data) < 512:
        raise NotImplementedError("SGI: truncated header")
    form = f"SGI {8 * bpc}-bit, dimension {dim}, {z} channels"
    if (bpc, dim, z) not in MODES:
        raise NotImplementedError(f"{form}: unsupported mode")
    rawmode = MODES[bpc, dim, z]
    mode = rawmode.split(";")[0]
    bands = len(mode)
    img = np.zeros((h, w, bands), np.uint8)
    if compression == 0:
        page = w * h * bpc
        for k in range(bands):
            off = 512 + k * page
            if off + page > len(data):
                raise NotImplementedError(f"{form}: truncated pixel data")
            rows = np.frombuffer(data, np.uint8, page, off).reshape(h, -1)
            img[..., k] = unpack("L;16B" if bpc == 2 else "L", rows[::-1], w)
    elif compression == 1:
        body = np.frombuffer(data, np.uint8, len(data) - 512, 512)
        n = bands * h
        if len(body) < 8 * n:
            raise NotImplementedError(f"{form}: RLE tables past the file")
        starts = np.frombuffer(data, ">u4", n, 512).astype(np.int64)
        lengths = np.frombuffer(data, ">u4", n, 512 + 4 * n).astype(np.int64)
        row = np.zeros((w * bands, bpc), np.uint8)
        for r in range(h):
            for c in range(bands):
                start, length = starts[r + c * h], lengths[r + c * h]
                if start < 512:
                    raise NotImplementedError(
                        f"{form}: an RLE row inside the header")
                status = _expand_row(body, row, c, bands, w, start - 512,
                                     length, bpc)
                if status < 0:
                    raise NotImplementedError(f"{form}: a broken RLE row")
                if status:
                    return mode, img[..., 0] if bands == 1 else img
            px = unpack(rawmode, row.reshape(1, -1), w)
            img[h - 1 - r] = px.reshape(w, bands)
    else:
        raise NotImplementedError(f"{form}: compression {compression}")
    px = img[..., 0] if bands == 1 else img
    return mode, px
