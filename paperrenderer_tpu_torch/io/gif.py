"""GIF decoding for ``io.image.read_image``, with numpy only: the first
frame, as the JAX package's imaging library (Pillow 12's
``GifImagePlugin`` and ``GifDecode.c``) opens it, to the bit.

  * the logical screen, global and local colour tables (a table that is
    the identity gray ramp 0, 1, 2, ... is dropped and the frame read as
    "L", as Pillow's ``_is_palette_needed`` does), extensions skipped
    but for the graphic control's transparency index;
  * LZW: clear and end codes, code sizes growing to 12 bits, and a full
    4,096-entry table kept (no more entries, no wider codes) until the
    next clear;
  * interlaced rows (the four passes);
  * a first frame smaller than the logical screen or offset in it: the
    screen grows to hold the frame, and the pixels outside it are the
    transparency index where the frame has one, else index 0.

Returns the image in Pillow's mode ("P" with its palette and transparency
index, or "L"); ``io.image.pil_convert`` turns it into ``read_image``'s
array. Broken LZW codes raise NotImplementedError.
"""

from __future__ import annotations

import struct

import numpy as np


def _palette(table: bytes):
    """A colour table -> [n, 3], or None for the identity gray ramp."""
    n = len(table) // 3
    pal = np.frombuffer(table, np.uint8, 3 * n).reshape(n, 3)
    return None if (pal == np.arange(n)[:, None]).all() else pal


def _sub_blocks(data: bytes, pos: int):
    """The data sub-blocks at ``pos`` -> (their bytes, the position after
    the terminator)."""
    parts = []
    while pos < len(data) and data[pos]:
        parts.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    return b"".join(parts), pos + 1


def _lzw(stream: bytes, bits: int, n: int) -> np.ndarray:
    """GIF's variable-width LZW (codes packed from the low bit up) -> at
    most n indices (u8)."""
    if not 0 <= bits <= 11:
        raise NotImplementedError(f"GIF: LZW minimum code size {bits}")
    clear, end = 1 << bits, (1 << bits) + 1
    out = bytearray()
    table = [bytes((k,)) for k in range(clear)] + [b"", b""]
    size, nxt, prev = bits + 1, clear + 2, None
    acc = nbits = 0
    pos, total = 0, len(stream)
    while len(out) < n:
        while nbits < size and pos < total:
            acc |= stream[pos] << nbits
            nbits += 8
            pos += 1
        if nbits < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == clear:
            del table[clear + 2:]
            size, nxt, prev = bits + 1, clear + 2, None
            continue
        if code == end:
            break
        if prev is None:
            if code > clear:
                raise NotImplementedError("GIF: broken LZW code")
            entry = table[code]
        else:
            if code < nxt:
                entry = table[code]
                first = entry[:1]
            elif code == nxt:
                first = table[prev][:1]
                entry = table[prev] + first
            else:
                raise NotImplementedError("GIF: broken LZW code")
            if nxt < 4096:
                table.append(table[prev] + first)
                if nxt == (1 << size) - 1 and size < 12:
                    size += 1
                nxt += 1
        out += entry
        prev = code
    return np.frombuffer(bytes(out[:n]), np.uint8)


def _rows(h: int, interlace: bool):
    """The frame's rows in stream order."""
    if not interlace:
        return np.arange(h)
    return np.concatenate([np.arange(s, h, d)
                           for s, d in ((0, 8), (4, 8), (2, 4), (1, 2))])


def read_gif(data: bytes):
    """A GIF file's first frame -> (Pillow's mode, pixels u8 [H, W],
    palette [n, 3] or None, transparency index or None)."""
    sw, sh, flags = struct.unpack_from("<HHB", data, 6)
    pos = 13
    global_pal = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        global_pal = _palette(data[pos:pos + n])
        pos += n
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise NotImplementedError("GIF: no image in the first frame")
        kind = data[pos]
        pos += 1
        if kind == 0x21:                         # extension
            label = data[pos]
            block, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(block) >= 4 and block[0] & 1:
                transparency = block[3]
        elif kind == 0x2C:                       # image descriptor
            x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            pal = global_pal
            if fflags & 0x80:
                n = 3 << ((fflags & 7) + 1)
                pal = _palette(data[pos:pos + n])
                pos += n
            bits = data[pos]
            stream, _ = _sub_blocks(data, pos + 1)
            break
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    img = np.full((h, w), transparency or 0, np.uint8)
    idx = _lzw(stream, bits, fw * fh)
    if idx.size < fw * fh:
        raise NotImplementedError("GIF: truncated LZW data")
    img[y0 + _rows(fh, fflags & 0x40), x0:x0 + fw] = idx.reshape(fh, fw)
    return ("P" if pal is not None else "L"), img, pal, transparency
