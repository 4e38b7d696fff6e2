"""TIFF and BigTIFF decoding for ``io.image.read_image``, with ``struct``,
``zlib`` and numpy only.

Reads the first image file directory as the JAX package's imaging library
(Pillow 12's ``TiffImagePlugin``, over libtiff 4 for compressed files)
reads it, to the bit, and returns the image in Pillow's mode
(``io.image.pil_convert`` turns it into ``read_image``'s array):

  * classic TIFF and BigTIFF, little and big-endian (Pillow reads a file
    as BigTIFF only when its third byte is 43, so a big-endian BigTIFF is
    refused, as Pillow refuses it);
  * Pillow's mode table (``OPEN_INFO``): min-is-white and min-is-black
    gray of 1, 2, 4, 8, 16 and 32 bits (unsigned, signed and float), gray
    and palette with alpha, RGB and CMYK of 8 and 16 bits with their
    ``ExtraSamples`` (0: dropped, 1: associated alpha, unpremultiplied as
    Pillow's "RGBa" unpacker does, 2: alpha), 1/2/4/8-bit palettes (the
    16-bit colour map's high bytes); ``FillOrder`` 2;
  * strips and tiles, chunky and planar layouts;
  * uncompressed files as Pillow's own raw decoder reads them (a tile or
    strip a call, the planar bands by the raw mode's letters, the
    ``FillOrder`` 2 modes' bit reversal), and PackBits, LZW (the
    early-change codes) and deflate (8 and 32946) as Pillow's libtiff
    decoder does: the raw bytes bit-reversed for ``FillOrder`` 2, the
    horizontal predictor (2) on 8, 16 and 32-bit samples and the
    floating-point predictor (3), 16 and 32-bit samples in the host's
    (little-endian) order, and Pillow's raw mode applied after, the one
    it keeps for big-endian files included (its "F;32BF", "I;32BS" and
    "I;16BS" then read the little-endian words as big-endian);
  * the ``Orientation`` tag, applied after decoding as Pillow's
    ``exif_transpose`` does.

JPEG (6 / 7), CCITT (2 / 3 / 4) and the other libtiff codecs, YCbCr and
CIELab photometrics and 12-bit gray raise NotImplementedError naming the
form and "not yet ported"; what Pillow refuses (modes outside its table,
old-style LZW, truncated strips) raises NotImplementedError naming the
form.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# Pillow's OPEN_INFO for both byte orders: (photometric, sample formats,
# fill order, bits a sample, extra samples) -> (mode, raw mode); "MM" or
# "II" before a line: that byte order only
_TABLE = """
0 1 1 1 - 1 1;I|0 1 2 1 - 1 1;IR|1 1 1 1 - 1 1|1 1 2 1 - 1 1;R
0 1 1 2 - L L;2I|0 1 2 2 - L L;2IR|1 1 1 2 - L L;2|1 1 2 2 - L L;2R
0 1 1 4 - L L;4I|0 1 2 4 - L L;4IR|1 1 1 4 - L L;4|1 1 2 4 - L L;4R
0 1 1 8 - L L;I|0 1 2 8 - L L;IR|1 1 1 8 - L L|1 2 1 8 - L L
1 1 2 8 - L L;R
II 1 1 1 12 - I;16 I;12|II 0 1 1 16 - I;16 I;16|II 1 1 1 16 - I;16 I;16
MM 1 1 1 16 - I;16B I;16B|II 1 1 2 16 - I;16 I;16R
II 1 2 1 16 - I I;16S|MM 1 2 1 16 - I I;16BS
II 0 3 1 32 - F F;32F|MM 0 3 1 32 - F F;32BF|II 1 1 1 32 - I I;32N
II 1 2 1 32 - I I;32S|MM 1 2 1 32 - I I;32BS|II 1 3 1 32 - F F;32F
MM 1 3 1 32 - F F;32BF|1 1 1 8,8 2 LA LA
2 1 1 8,8,8 - RGB RGB|2 1 2 8,8,8 - RGB RGB;R
2 1 1 8,8,8,8 - RGBA RGBA|2 1 1 8,8,8,8 0 RGB RGBX
2 1 1 8,8,8,8,8 0,0 RGB RGBXX|2 1 1 8,8,8,8,8,8 0,0,0 RGB RGBXXX
2 1 1 8,8,8,8 1 RGBA RGBa|2 1 1 8,8,8,8,8 1,0 RGBA RGBaX
2 1 1 8,8,8,8,8,8 1,0,0 RGBA RGBaXX|2 1 1 8,8,8,8 2 RGBA RGBA
2 1 1 8,8,8,8,8 2,0 RGBA RGBAX|2 1 1 8,8,8,8,8,8 2,0,0 RGBA RGBAXX
2 1 1 8,8,8,8 999 RGBA RGBA
II 2 1 1 16,16,16 - RGB RGB;16L|MM 2 1 1 16,16,16 - RGB RGB;16B
II 2 1 1 16,16,16,16 - RGBA RGBA;16L|MM 2 1 1 16,16,16,16 - RGBA RGBA;16B
II 2 1 1 16,16,16,16 0 RGB RGBX;16L|MM 2 1 1 16,16,16,16 0 RGB RGBX;16B
II 2 1 1 16,16,16,16 1 RGBA RGBa;16L|MM 2 1 1 16,16,16,16 1 RGBA RGBa;16B
II 2 1 1 16,16,16,16 2 RGBA RGBA;16L|MM 2 1 1 16,16,16,16 2 RGBA RGBA;16B
3 1 1 1 - P P;1|3 1 2 1 - P P;1R|3 1 1 2 - P P;2|3 1 2 2 - P P;2R
3 1 1 4 - P P;4|3 1 2 4 - P P;4R|3 1 1 8 - P P|3 1 1 8,8 0 P PX
3 1 1 8,8 2 PA PA|3 1 2 8 - P P;R
5 1 1 8,8,8,8 - CMYK CMYK|5 1 1 8,8,8,8,8 0 CMYK CMYKX
5 1 1 8,8,8,8,8,8 0,0 CMYK CMYKXX
II 5 1 1 16,16,16,16 - CMYK CMYK;16L|MM 5 1 1 16,16,16,16 - CMYK CMYK;16B
6 1 1 8 - L L|6 1 1 8,8,8 - RGB RGBX|8 1 1 8,8,8 - LAB LAB
"""


def _open_info() -> dict:
    out = {}
    for line in _TABLE.replace("\n", "|").split("|"):
        f = line.split()
        if not f:
            continue
        orders = (f.pop(0),) if f[0] in ("II", "MM") else ("II", "MM")
        photo, fmt, fill = int(f[0]), int(f[1]), int(f[2])
        bits = tuple(int(b) for b in f[3].split(","))
        extra = () if f[4] == "-" else tuple(int(e) for e in f[4].split(","))
        for bo in orders:
            out[(bo, photo, (fmt,), fill, bits, extra)] = (f[5], f[6])
    return out


OPEN_INFO = _open_info()
_COMPRESSIONS = {1: "raw", 2: "CCITT RLE", 3: "CCITT group 3",
                 4: "CCITT group 4", 5: "LZW", 6: "old-style JPEG",
                 7: "JPEG", 8: "Adobe deflate", 32771: "raw 16-bit padded",
                 32773: "PackBits", 32809: "ThunderScan", 32946: "deflate",
                 34676: "SGILog", 34677: "SGILog24", 34925: "LZMA",
                 50000: "Zstandard", 50001: "WebP"}
_PORTED = (1, 5, 8, 32773, 32946)
_PHOTOMETRICS = {0: "min-is-white", 1: "min-is-black", 2: "RGB",
                 3: "palette", 4: "transparency mask", 5: "CMYK",
                 6: "YCbCr", 8: "CIELab"}
# the integer value types (the tags read here): type -> (bytes, code)
_INT_TYPES = {1: (1, "B"), 3: (2, "H"), 4: (4, "L"), 6: (1, "b"),
              8: (2, "h"), 9: (4, "l"), 13: (4, "L"), 16: (8, "Q")}
# tags whose Pillow length is 1 (one value, not a tuple)
_SINGLE = (256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323)
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _ifd(data: bytes, bo: str, big: bool, pos: int) -> dict:
    """The IFD at ``pos`` as Pillow keeps it: integer tags -> an int (the
    tags of length 1) or a tuple; entries past the file's end skipped, and
    those of other types (no tag read here has one)."""
    e = "<" if bo == "II" else ">"
    (count,) = struct.unpack_from(e + ("Q" if big else "H"), data, pos)
    pos += 8 if big else 2
    entry = 20 if big else 12
    inline = 8 if big else 4
    tags = {}
    for i in range(count):
        tag, typ, n = struct.unpack_from(e + ("HHQ" if big else "HHL"), data,
                                         pos + i * entry)
        vpos = pos + i * entry + (12 if big else 8)
        if typ not in _INT_TYPES:
            continue
        unit, code = _INT_TYPES[typ]
        size = unit * n
        if size > inline:
            (vpos,) = struct.unpack_from(e + ("Q" if big else "L"), data, vpos)
        if not size or vpos + size > len(data):
            continue                          # Pillow skips the tag
        values = struct.unpack_from(f"{e}{n}{code}", data, vpos)
        tags[tag] = values[0] if tag in _SINGLE else values
    return tags


def _packbits(raw: bytes, need: int) -> bytes:
    """libtiff's PackBits decoder: ``need`` bytes (a run past them cut)."""
    out, pos, end = bytearray(), 0, len(raw)
    while len(out) < need and pos < end:
        n = raw[pos]
        pos += 1
        if n < 128:
            out += raw[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            if pos >= end:
                break
            out += raw[pos:pos + 1] * (257 - n)
            pos += 1
    return bytes(out[:need])


def _lzw(raw: bytes, need: int) -> bytes:
    """libtiff's LZW decoder (new style: codes high bits first, the width
    growing one code early) -> up to ``need`` bytes."""
    if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
        raise NotImplementedError("TIFF LZW: old-style (LSB-first) codes "
                                  "not yet ported")
    table = [bytes((i,)) for i in range(256)] + [b"", b""]
    buf = raw + b"\x00\x00\x00"
    nbits, pos, end = 9, 0, 8 * len(raw)
    out, prev = bytearray(), None
    while len(out) < need and pos + nbits <= end:
        k = pos >> 3
        code = (int.from_bytes(buf[k:k + 3], "big") >> (24 - (pos & 7)
                                                        - nbits)) & (
            (1 << nbits) - 1)
        pos += nbits
        if code == 256:                       # clear
            del table[258:]
            nbits, prev = 9, None
            continue
        if code == 257:                       # end of information
            break
        if prev is None:
            if code > 255:
                raise NotImplementedError("TIFF LZW: corrupted table")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):              # the code being defined
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise NotImplementedError("TIFF LZW: corrupted table")
        out += entry
        prev = entry
        if len(table) + 1 >= 1 << nbits and nbits < 12:
            nbits += 1
    return bytes(out)


def _inflate(raw: bytes, need: int) -> bytes:
    try:
        return zlib.decompressobj().decompress(raw, need)
    except zlib.error as exc:
        raise NotImplementedError(f"TIFF deflate: {exc}") from exc


class _Layout:
    """What the decoders need of the directory."""

    def __init__(self, tags, bo, bits, spp, planar, fill, fmt):
        self.bo, self.bits, self.spp, self.fmt = bo, bits, spp, fmt
        self.planar, self.fill = planar, fill
        self.w, self.h = tags[256], tags[257]
        self.bps = bits[0]
        self.tiled = 324 in tags and 273 not in tags
        if self.tiled:
            self.tw, self.tl = tags.get(322), tags.get(323)
            self.offsets = tags[324]
            self.counts = tags.get(325)
        else:
            rps = tags.get(278, 2 ** 32 - 1)
            self.tw, self.tl = self.w, min(rps, self.h) or self.h
            self.offsets = tags.get(273)
            self.counts = tags.get(279)
        if not isinstance(self.tw, int) or not isinstance(self.tl, int):
            raise NotImplementedError("TIFF: invalid tile dimensions")


def _predict(buf: np.ndarray, rows: int, row_bytes: int, bps: int,
             stride: int, predictor: int, swap: bool) -> np.ndarray:
    """libtiff's decoded strip or tile (bytes, file order) -> its samples
    in the host's order with the predictor undone, as bytes."""
    a = buf[:rows * row_bytes].reshape(rows, row_bytes)
    if predictor == 3:                        # floating point: byte planes
        nb = bps // 8
        acc = a.reshape(rows, -1, stride).cumsum(1, dtype=np.uint8)
        acc = acc.reshape(rows, nb, -1)       # planes, most significant 1st
        return np.ascontiguousarray(acc[:, ::-1].transpose(0, 2, 1)).reshape(
            rows, row_bytes)
    if bps in (16, 32, 64):
        dt = np.dtype(f"u{bps // 8}").newbyteorder(">" if swap else "<")
        v = a[:, :row_bytes // (bps // 8) * (bps // 8)].view(dt).astype(
            dt.newbyteorder("<"))
        if predictor == 2:
            v = v.reshape(rows, -1, stride).cumsum(1, dtype=v.dtype).reshape(
                rows, -1)
        out = a.copy()
        out[:, :v.shape[1] * (bps // 8)] = v.view(np.uint8)
        return out
    if predictor == 2:
        if bps != 8:
            raise NotImplementedError(
                f"TIFF: the horizontal predictor on {bps}-bit samples")
        return a[:, :row_bytes // stride * stride].reshape(
            rows, -1, stride).cumsum(1, dtype=np.uint8).reshape(rows, -1)
    return a


def _decoded(lay: _Layout, data: bytes, comp: int, predictor: int, index: int,
             rows: int, row_bytes: int, stride: int) -> np.ndarray:
    """Strip or tile ``index`` through libtiff's reading: [rows,
    row_bytes] bytes, the samples in the host's order."""
    off, cnt = lay.offsets[index], lay.counts[index]
    raw = data[off:off + cnt]
    if lay.fill == 2:
        raw = _BITREV[np.frombuffer(raw, np.uint8)].tobytes()
    need = rows * row_bytes
    if comp == 1:
        out = raw[:need]
    elif comp == 32773:
        out = _packbits(raw, need)
    elif comp == 5:
        out = _lzw(raw, need)
    else:
        out = _inflate(raw, need)
    if len(out) < need:
        raise NotImplementedError(
            f"TIFF {_COMPRESSIONS[comp]}: not enough data in strip or tile "
            f"{index}")
    buf = np.frombuffer(out, np.uint8, need)
    if comp == 32773:
        predictor = 1                         # PackBits has none
    if predictor not in (1, 2, 3):
        raise NotImplementedError(f"TIFF: predictor {predictor}")
    if predictor == 3 and (lay.bps not in (16, 24, 32, 64)
                           or lay.fmt != (3,)):
        raise NotImplementedError(
            f"TIFF: the floating-point predictor on {lay.bps}-bit samples "
            f"of format {lay.fmt}")
    return _predict(buf, rows, row_bytes, lay.bps, stride, predictor,
                    lay.bo == "MM")


# raw-mode letters -> output channel
_CHANNELS = {"R": 0, "G": 1, "B": 2, "A": 3, "C": 0, "M": 1, "Y": 2, "K": 3}
# the raw modes of the table that Pillow's unpackers lack (its raw decoder
# refuses them), and the one-letter modes its planar tiles take, by mode
_NO_UNPACKER = ("L;IR", "P;1R", "P;2R", "P;4R")
_PLANAR_LETTERS = {"1": "1", "L": "L", "P": "P", "I": "I", "F": "F",
                   "RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK"}
_LETTER_RAW = {"1": "1", "L": "L", "P": "P", "I": "I;32N", "F": "F;32F"}


def _rawbits(rawmode: str) -> int:
    """Bits a pixel of one of Pillow's raw modes used here."""
    base, _, suffix = rawmode.partition(";")
    if base in ("1", "P", "L") and suffix[:1] in "124" and suffix:
        return int(suffix[0])
    if base in ("1",):
        return 1
    if base in ("I", "F"):
        return int("".join(c for c in suffix if c.isdigit()))
    width = 16 if suffix.startswith("16") else 8
    return width * len(base)


def unpack(rawmode: str, rows: np.ndarray, w: int) -> np.ndarray:
    """Pillow's unpacker ``rawmode`` over rows of bytes [h, n] -> [h, w]
    or [h, w, channels] in the raw mode's image mode: "1" 0 / 255, "L" /
    "P" bytes, "I;16" u16, "I" i32, "F" f32, and RGB(A) / CMYK / LA / PA
    bytes (associated alpha left premultiplied: ``unpremultiply``)."""
    h = rows.shape[0]
    base, _, suffix = rawmode.partition(";")
    if "R" in suffix:
        rows = _BITREV[rows]
    if base in ("1", "L", "P") and suffix[:1] in ("2", "4") or base == "1" \
            or base == "P" and suffix[:1] == "1":
        bits = int(suffix[0]) if suffix[:1] in ("1", "2", "4") else 1
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        v = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(
            h, -1)[:, :w]
        if "I" in suffix:
            v = (1 << bits) - 1 - v
        if base == "1":
            return (v * 255).astype(np.uint8)
        return (v * (255 // ((1 << bits) - 1))).astype(np.uint8) \
            if base == "L" else v.astype(np.uint8)
    if base in ("L", "P") and suffix in ("", "I", "R", "IR"):
        v = rows[:, :w]
        return (255 - v).astype(np.uint8) if "I" in suffix else v.copy()
    if base == "I" and suffix.startswith("16"):
        order = ">" if "B" in suffix else "<"
        kind = "i" if "S" in suffix else "u"
        v = rows[:, :2 * w].copy().view(f"{order}{kind}2")
        return v.astype(np.int32) if kind == "i" else v.astype(np.uint16)
    if base in ("I", "F"):                    # 32-bit words
        order = ">" if "B" in suffix else "<"
        kind = "f" if base == "F" else "u" if suffix == "32N" else "i"
        v = rows[:, :4 * w].copy().view(f"{order}{kind}4")
        return v.astype(np.float32 if base == "F" else np.int32)
    size = 2 if suffix.startswith("16") else 1
    hi = 0 if suffix.endswith("B") else size - 1
    px = rows[:, :w * len(base) * size].reshape(h, w, len(base), size)[
        ..., hi]
    chans = [k for k, c in enumerate(base) if c != "X"]
    out = px[..., chans]
    return out[..., 0] if out.shape[-1] == 1 else out


def unpremultiply(px: np.ndarray) -> np.ndarray:
    """Pillow's "RGBa" unpacker: alpha 0 -> all 0, 255 -> as is, else each
    colour * 255 // alpha, clipped to 255."""
    a = px[..., 3:].astype(np.int64)
    rgb = np.minimum(px[..., :3].astype(np.int64) * 255 // np.maximum(a, 1),
                     255)
    rgb = np.where(a == 255, px[..., :3], rgb)
    out = np.concatenate([rgb, a], -1)
    return np.where(a == 0, 0, out).astype(np.uint8)


def _new(mode: str, h: int, w: int) -> np.ndarray:
    """Pillow's new image of ``mode`` (zeros) in this module's layout."""
    dtype = {"I;16": np.uint16, "I;16B": np.uint16, "I": np.int32,
             "F": np.float32}.get(mode, np.uint8)
    c = {"RGB": 3, "RGBA": 4, "CMYK": 4, "LA": 2, "PA": 2}.get(mode)
    return np.zeros((h, w, c) if c else (h, w), dtype)


def _put(img, px, y, x, band=None):
    """Write unpacked pixels (a band's, for the planar layouts) at y, x."""
    hh, ww = px.shape[:2]
    if band is None:
        img[y:y + hh, x:x + ww] = px
    else:
        img[y:y + hh, x:x + ww, band] = px


def _raw_tiles(lay, data, mode, rawmode, img, layers):
    """Pillow's own decoding of an uncompressed file: one raw-decoder tile
    a strip or tile, from its offset, planar bands by the raw mode's
    letters."""
    offsets = lay.offsets
    if lay.tw == lay.w and lay.tl == lay.h and lay.planar != 2:
        offsets = offsets[-1:]
    x = y = layer = 0
    for off in offsets:
        ew, eh = min(x + lay.tw, lay.w) - x, min(y + lay.tl, lay.h) - y
        stride = lay.tw * sum(lay.bits) / 8 if x + lay.tw > lay.w else 0
        raw = rawmode
        if lay.planar == 2:
            raw = rawmode[layer] if layer < len(rawmode) else ""
            if raw not in _PLANAR_LETTERS.get(mode, ""):
                raise NotImplementedError(
                    f"TIFF planar {mode}: no raw mode {raw!r} for band "
                    f"{layer}")
            stride /= layers
            if img.ndim == 2:
                raw = _LETTER_RAW[raw]
        stride = int(stride)
        need = ew if img.ndim == 3 and lay.planar == 2 else -(
            -ew * _rawbits(raw) // 8)
        stride = stride or need
        if stride < need or off + stride * (eh - 1) + need > len(data):
            raise NotImplementedError(f"TIFF {mode}: truncated pixel data")
        rows = np.frombuffer(data, np.uint8, stride * (eh - 1) + need, off)
        rows = np.pad(rows, (0, stride - need)).reshape(eh, stride)[:, :need]
        if lay.planar == 2 and img.ndim == 3:   # one band's bytes
            _put(img, rows[:, :ew], y, x, _CHANNELS[raw])
        else:
            _put(img, unpack(raw, rows, ew), y, x)
        x += lay.tw
        if x >= lay.w:
            x, y = 0, y + lay.tl
            if y >= lay.h:
                y, layer = 0, layer + 1


def _libtiff(lay, data, comp, predictor, mode, rawmode, img):
    """Pillow's libtiff decoding: strips or tiles through libtiff, a
    plane at a time for the planar layouts (8 and 16-bit samples, one
    band of the image each), unpacked with Pillow's raw mode."""
    bands = img.shape[2] if img.ndim == 3 else 1
    planar = lay.planar == 2 and bands > 1
    planes = bands if planar else 1
    if planar and lay.bps not in (8, 16):
        raise NotImplementedError(
            f"TIFF planar: {lay.bps}-bit samples")
    spp_row = 1 if lay.planar == 2 else lay.spp
    row_bytes = -(-lay.tw * spp_row * lay.bps // 8)
    if not lay.tiled and (lay.w * _rawbits(rawmode) // planes + 7) // 8 > -(
            -lay.w * spp_row * lay.bps // 8):
        raise NotImplementedError(f"TIFF {mode}: rows shorter than the raw "
                                  f"mode {rawmode}")
    stride = spp_row
    across = -(-lay.w // lay.tw)
    down = -(-lay.h // lay.tl)
    for y in range(0, lay.h, lay.tl):
        for plane in range(planes):
            for x in range(0, lay.w, lay.tw) if lay.tiled else (0,):
                index = plane * across * down + (y // lay.tl) * across + \
                    x // lay.tw
                rows = lay.tl if lay.tiled else min(lay.tl, lay.h - y)
                buf = _decoded(lay, data, comp, predictor, index, rows,
                               row_bytes, stride)
                keep = min(lay.tl, lay.h - y)
                ew = min(lay.tw, lay.w - x)
                if planar:   # a plane's high bytes into byte ``plane``
                    if mode in ("LA", "PA") and plane == 1:
                        continue   # Pillow's byte 1 of LA is not alpha
                    px = buf[:keep, (lay.bps // 8 - 1)::lay.bps // 8][:, :ew]
                    img[y:y + keep, x:x + ew, plane] = px
                else:
                    rows = buf[:keep]
                    need = -(-ew * _rawbits(rawmode) // 8)
                    if need > row_bytes:   # the unpacker reads on, as
                        # Pillow's does, into the rows below (zeros past)
                        flat = np.pad(buf.reshape(-1), (0, need))
                        rows = flat[np.arange(keep)[:, None] * row_bytes
                                    + np.arange(need)]
                    _put(img, unpack(rawmode, rows, ew), y, x)


_TRANSPOSE = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
              4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
              6: lambda a: a.swapaxes(0, 1)[:, ::-1],
              7: lambda a: a[::-1, ::-1].swapaxes(0, 1),
              8: lambda a: a.swapaxes(0, 1)[::-1]}


def read_tiff(data: bytes):
    """A TIFF or BigTIFF file -> (Pillow's mode, pixels, palette [n, 3] or
    None): "1" 0 / 255, "L" / "P" bytes, "I;16" / "I;16B" u16, "I" i32,
    "F" f32, "LA" / "PA" / "RGB" / "RGBA" / "CMYK" bytes [h, w, c], and
    "RGBa" for associated alpha (premultiplied: Pillow's unpacker
    unpremultiplies it, as ``pil_convert`` does)."""
    bo = data[:2].decode("latin-1")
    e = "<" if bo == "II" else ">"
    big = data[2] == 43
    name = "BigTIFF" if big else "TIFF"
    if data[2:4] in (b"\x00\x2b",):
        raise NotImplementedError(
            "TIFF: a big-endian BigTIFF (read as classic TIFF, unreadable)")
    (first,) = struct.unpack_from(e + ("Q" if big else "L"), data,
                                  8 if big else 4)
    tags = _ifd(data, bo, big, first)
    if 0xBC01 in tags:
        raise NotImplementedError(f"{name}: a Windows Media Photo file")
    comp = tags.get(259, 1)
    if comp not in _COMPRESSIONS:
        raise NotImplementedError(f"{name}: compression {comp}")
    cname = _COMPRESSIONS[comp]
    photo = tags.get(262, 0)
    if comp == 6:
        photo = 6
    fill = tags.get(266, 1)
    if 256 not in tags or 257 not in tags:
        raise NotImplementedError(f"{name}: missing dimensions")
    fmt = tags.get(339, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bits = tags.get(258, (1,))
    extra = tags.get(338, ())
    n_base = 3 if photo in (2, 6, 8) else 4 if photo == 5 else 1
    spp = tags.get(277, 3 if comp == 6 and photo in (2, 6) else 1)
    if spp > 6:
        raise NotImplementedError(f"{name}: {spp} samples a pixel")
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    pname = _PHOTOMETRICS.get(photo, f"photometric {photo}")
    form = (f"{name} {pname}, {'/'.join(map(str, bits))}-bit, "
            f"{cname}")
    if len(bits) != spp:
        raise NotImplementedError(f"{form}: unknown data organization")
    key = (bo, photo, tuple(fmt), fill, tuple(bits), tuple(extra))
    if key not in OPEN_INFO:
        raise NotImplementedError(
            f"{form}: no mode (sample format {fmt}, fill order {fill}, "
            f"extra samples {extra})")
    mode, rawmode = OPEN_INFO[key]
    if comp not in _PORTED or photo in (6, 8) or rawmode == "I;12":
        raise NotImplementedError(f"{form}: not yet ported")
    planar = tags.get(284, 1)
    lay = _Layout(tags, bo, bits, spp, planar, fill, tuple(fmt))
    if lay.offsets is None:
        raise NotImplementedError(f"{form}: unknown data organization")
    img = _new(mode, lay.h, lay.w)
    if comp == 1:
        if rawmode in _NO_UNPACKER:
            raise NotImplementedError(f"{form}: no unpacker for {rawmode}")
        _raw_tiles(lay, data, mode, rawmode, img, n_base + len(extra))
    else:
        if lay.counts is None:
            raise NotImplementedError(f"{form}: no strip byte counts")
        if fill == 2:
            mode, rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
        if rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
        if rawmode.endswith(";16N"):
            rawmode = rawmode[:-1] + "L"
        _libtiff(lay, data, comp, tags.get(317, 1), mode, rawmode, img)
    if "a" in rawmode:   # associated alpha: Pillow's "RGBa" unpacker,
        mode = "RGBa"    # the planar layouts' too
    orientation = tags.get(274)
    if orientation in _TRANSPOSE:
        img = np.ascontiguousarray(_TRANSPOSE[orientation](img))
    palette = None
    if mode in ("P", "PA"):
        cmap = np.asarray(tags[320]) // 256
        n = len(cmap) // 3
        palette = cmap[:3 * n].reshape(3, n).T.astype(np.uint8)
    return mode, img, palette
