"""BMP and DIB decoding for ``io.image.read_image``, with ``struct`` and
numpy only.

Reads what the JAX package's imaging library (Pillow 12's
``BmpImagePlugin``) reads, to the bit, and returns the image in Pillow's
mode (``io.image.pil_convert`` turns it into ``read_image``'s array):

  * the BITMAPCOREHEADER (12 bytes: 16-bit sizes, 3-byte palette entries)
    and the 40, 52, 56, 64, 108 and 124-byte headers (4-byte entries); a
    DIB is the same without the 14-byte file header;
  * 1, 4 and 8-bit palettes, short ones included (an index past the
    palette reads black); a palette of the gray ramp 0, 1, 2, ... is read
    as "L" and a black/white one of two entries as "1", as Pillow's
    ``grayscale`` check does;
  * 16-bit BI_RGB (5-5-5, each field scaled by 255 / 31 as Pillow's
    "BGR;15" unpacks it), 24 bits, 32-bit BI_RGB (read as RGB: the fourth
    byte is dropped);
  * BI_BITFIELDS in exactly Pillow's mask sets (16-bit 5-6-5 and 5-5-5,
    24-bit, eight 32-bit layouts, four with alpha); any other set is
    refused;
  * RLE8 and RLE4 as Pillow's ``BmpRleDecoder`` reads them: end of line,
    end of bitmap, absolute runs (word-aligned by file position) and
    deltas (whose offsets are the second pair of the four bytes after the
    escape);
  * bottom-up and top-down (negative height) row order.

2-bit and other depths, BI_JPEG, BI_PNG and other compressions, other
header sizes and truncated pixel data raise NotImplementedError naming the
form, where Pillow raises too. ``unpack_rows`` (Pillow's raw decoder) is
shared with ``io.tga``.
"""

from __future__ import annotations

import struct

import numpy as np

# Pillow's raw modes: bits a pixel; channel byte orders of the 8-bit ones
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "LA": 16,
             "BGR;15": 16, "BGR;16": 16, "BGRA;15Z": 16, "BGR": 24}
_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
             16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# BmpImagePlugin's SUPPORTED bitfield sets -> raw mode
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_COMPRESSIONS = {0: "BI_RGB", 1: "RLE8", 2: "RLE4", 3: "BI_BITFIELDS",
                 4: "BI_JPEG", 5: "BI_PNG"}


def _scale(v, bits):
    """An n-bit field -> 8 bits as Pillow's unpackers scale it."""
    return (v * 255 // ((1 << bits) - 1)).astype(np.uint8)


def unpack_rows(data: bytes, pos: int, w: int, h: int, rawmode: str,
                stride: int, orientation: int, form: str) -> np.ndarray:
    """Pillow's raw decoder: h rows of ``stride`` bytes (0: packed) at
    ``pos``, the first the bottom row for orientation -1, unpacked from
    ``rawmode`` -> u8 [h, w] (indices, gray, "1" as 0 / 255) or
    [h, w, C] (its channels in R, G, B, A order, X dropped)."""
    bits = _RAW_BITS.get(rawmode, 8 * len(rawmode))
    need = (w * bits + 7) // 8
    stride = stride or need
    if stride < need:   # Pillow's codec configuration error
        raise NotImplementedError(
            f"{form}: {rawmode} rows longer than the stored rows")
    if pos + stride * (h - 1) + need > len(data):
        raise NotImplementedError(f"{form}: truncated pixel data")
    buf = np.frombuffer(data, np.uint8, stride * (h - 1) + need, pos)
    rows = np.pad(buf, (0, stride - need)).reshape(h, stride)[:, :need]
    if orientation < 0:
        rows = rows[::-1]
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        px = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)
        px = px[:, :w]
        return px * np.uint8(255) if rawmode == "1" else px
    if bits == 8:
        return rows[:, :w].copy()
    if rawmode == "LA":
        return rows.reshape(h, w, 2)
    if bits == 16:
        v = rows.reshape(h, w, 2).astype(np.int32)
        v = v[..., 0] | (v[..., 1] << 8)
        if rawmode == "BGR;16":
            r, g, b = _scale(v >> 11 & 31, 5), _scale(v >> 5 & 63, 6), \
                _scale(v & 31, 5)
            return np.stack([r, g, b], -1)
        rgb = [_scale(v >> s & 31, 5) for s in (10, 5, 0)]
        if rawmode == "BGRA;15Z":   # alpha: the top bit set is transparent
            rgb.append(np.where(v & 0x8000, 0, 255).astype(np.uint8))
        return np.stack(rgb, -1)
    px = rows.reshape(h, w, len(rawmode))
    return np.stack([px[..., rawmode.index(c)] for c in "RGBA"
                     if c in rawmode], -1)


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """Pillow's ``BmpRleDecoder``: the RLE8 / RLE4 stream at ``pos`` ->
    the index bytes, row after row in file order."""
    out = bytearray()
    x, n_out, end = 0, w * h, len(data)
    while len(out) < n_out:
        if pos + 2 > end:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:                               # encoded run
            if x + count > w:                   # clipped at the row's end
                count = max(0, w - x)
            if rle4:
                pair = bytes((byte >> 4, byte & 15))
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:                         # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:                         # end of bitmap
            break
        elif byte == 2:                         # delta
            if pos + 2 > end:
                break
            if pos + 4 > end:
                raise NotImplementedError("BMP RLE: truncated delta")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:                                   # absolute run
            nbytes = byte // 2 if rle4 else byte
            run = data[pos:pos + nbytes]
            pos += len(run)
            if rle4:
                out += bytes(v for b in run for v in (b >> 4, b & 15))
            else:
                out += run
            if len(run) < nbytes:
                break
            x += byte
            pos += pos % 2                      # word-align (file position)
    return bytes(out)


def read_bmp(data: bytes, dib: bool = False, half: bool = False,
             with_start: bool = False):
    """A BMP file (a DIB without its file header) -> (Pillow's mode,
    pixels, palette [n, 3] or None): pixels as ``unpack_rows`` gives
    them; ``half``: the first half of the rows (an ICO or CUR entry's
    colour bitmap, whose header counts its AND mask too), as Pillow's
    ``IcoFile`` and ``CurImageFile`` cut the size; ``with_start``: the
    pixel data's offset too, last."""
    name = "DIB" if dib else "BMP"
    hpos, offset = (0, 0) if dib else (14,
                                       struct.unpack_from("<I", data, 10)[0])
    (hsize,) = struct.unpack_from("<I", data, hpos)
    hd = data[hpos + 4:hpos + hsize]
    pos = hpos + hsize
    if len(hd) < hsize - 4:
        raise NotImplementedError(f"{name}: truncated header")
    masks = None
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", hd)
        comp, colors, padding, direction = 0, 0, 3, -1
    elif hsize in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        direction = 1 if flip else -1
        w, h, _, bits, comp = struct.unpack_from("<IIHHI", hd)
        h = 2 ** 32 - h if flip else h
        (colors,) = struct.unpack_from("<I", hd, 28)
        padding = 4
        if comp == 3:
            if len(hd) >= 48:
                alpha = (struct.unpack_from("<I", hd, 48) if len(hd) >= 52
                         else (0,))
                masks = struct.unpack_from("<III", hd, 36) + alpha
            else:
                masks = struct.unpack_from("<III", data, pos) + (0,)
                pos += 12
    else:
        raise NotImplementedError(f"{name}: header size {hsize} (only 12, "
                                  "40, 52, 56, 64, 108 and 124 are read)")
    if half:
        h = h // 2
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    mode, raw = _BIT2MODE.get(bits, ("", ""))
    if not mode:
        raise NotImplementedError(f"{name}: {bits}-bit pixels (1, 4, 8, 16, "
                                  "24 and 32 bits are read)")
    coding = _COMPRESSIONS.get(comp, f"compression {comp}")
    what = f"{name} {bits}-bit {coding}"
    if comp == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _MASK_MODES:
            raise NotImplementedError(
                f"{what}: unsupported bitfields layout "
                f"({', '.join(hex(m) for m in masks)})")
        raw = _MASK_MODES[key]
        if "A" in raw:
            mode = "RGBA"
    elif comp not in (0, 1, 2):
        raise NotImplementedError(f"{what}: only BI_RGB, RLE8, RLE4 and "
                                  "BI_BITFIELDS are decoded")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise NotImplementedError(f"{what}: palette of {colors} colours")
        table = data[pos:pos + padding * colors]
        pos += len(table)
        gray = (0, 255) if colors == 2 else range(colors)
        if all(table[k * padding:k * padding + 3] == bytes((v & 255,)) * 3
               for k, v in enumerate(gray)):
            mode = raw = "1" if colors == 2 else "L"
        else:
            if len(table) > 256 * padding:
                raise NotImplementedError(
                    f"{what}: palette of {colors} colours")
            n = len(table) // padding
            palette = np.frombuffer(table, np.uint8, n * padding).reshape(
                n, padding)[:, 2::-1]
    start = offset or pos
    if comp in (1, 2):
        if mode == "1":
            raise NotImplementedError(f"{what}: a black/white palette")
        idx = _rle(data, start, w, h, comp == 2)
        if len(idx) < w * h:
            raise NotImplementedError(f"{what}: not enough image data")
        px = unpack_rows(idx, 0, w, h, "L", 0, direction, what)
    else:
        px = unpack_rows(data, start, w, h, raw,
                         ((w * bits + 31) >> 3) & ~3, direction, what)
    return (mode, px, palette) + ((start,) if with_start else ())
