"""DDS (DirectDraw Surface) decoding for ``io.image.read_image``, with
``struct`` and numpy only.

Reads what the JAX package's imaging library (Pillow 12's
``DdsImagePlugin``) reads, to the bit, and returns the image in Pillow's
mode (``io.image.pil_convert`` turns it into ``read_image``'s array):

  * the 124-byte header and its pixel format, tested in Pillow's order:
    uncompressed RGB(A) through any bit masks, each channel scaled to a
    byte as Pillow's ``DdsRgbDecoder`` scales it (the field over its
    mask's largest value, times 255, truncated; a short file reads zeros);
    luminance "L" (8 bits) and "LA" (16 bits with alpha); 8-bit palette
    indices with a 256-entry RGBA palette; FourCC blocks;
  * the FourCCs DXT1, DXT3, DXT5, BC4U / ATI1 (BC4, "L"), BC5U / ATI2 and
    BC5S ("RGB"), and DX10's DXGI formats BC1-BC5 (typeless and unorm),
    BC5 snorm, BC6H UF16 and SF16 ("RGB"), BC7 (typeless, unorm and
    sRGB) and R8G8B8A8 (typeless, unorm and sRGB, raw), decoded by
    ``io.bcn``;
  * the first surface only (mipmaps, cube faces and volume slices
    follow it and are not read); sizes that are not multiples of 4 are
    cropped from whole blocks.

Other header sizes, FourCCs (DXT2/DXT4, BC4S, ...), DXGI formats and
pixel-format flags raise NotImplementedError naming the form, where
Pillow raises too.
"""

from __future__ import annotations

import struct

import numpy as np

from . import bcn

_RGB, _LUMINANCE, _PAL8, _FOURCC, _ALPHAPIXELS = 0x40, 0x20000, 0x20, 0x4, 1
_FOURCCS = {b"DXT1": (1, False), b"DXT3": (2, False), b"DXT5": (3, False),
            b"BC4U": (4, False), b"ATI1": (4, False), b"BC5S": (5, True),
            b"BC5U": (5, False), b"ATI2": (5, False)}
# DXGI format -> (BC kind, signed); 0: raw RGBA
_DXGI = {70: (1, False), 71: (1, False), 73: (2, False), 74: (2, False),
         76: (3, False), 77: (3, False), 79: (4, False), 80: (4, False),
         82: (5, False), 83: (5, False), 84: (5, True), 95: (6, False),
         96: (6, True), 97: (7, False), 98: (7, False), 99: (7, False),
         27: (0, False), 28: (0, False), 29: (0, False)}
_MODES = {1: "RGBA", 2: "RGBA", 3: "RGBA", 4: "L", 5: "RGB", 6: "RGB",
          7: "RGBA", 0: "RGBA"}


def _raw(data: bytes, pos: int, w: int, h: int, c: int, form: str):
    """c bytes a pixel, rows packed, at ``pos`` -> u8 [h, w(, c)]."""
    n = w * h * c
    if pos + n > len(data):
        raise NotImplementedError(f"{form}: truncated pixel data")
    px = np.frombuffer(data, np.uint8, n, pos).reshape(h, w, c)
    return px[..., 0] if c == 1 else px


def _masked(data: bytes, pos: int, w: int, h: int, bits: int, masks):
    """Pillow's ``DdsRgbDecoder``: w * h values of bits // 8 bytes, little
    endian, each mask's field over the mask's largest value, times 255,
    truncated (a short file reads zeros) -> u8 [h, w, len(masks)]."""
    size, n = bits // 8, w * h
    raw = np.frombuffer(data[pos:pos + size * n].ljust(size * n, b"\x00"),
                        np.uint8).reshape(n, size)[:, :4].astype(np.uint64)
    value = (raw << (8 * np.arange(raw.shape[1], dtype=np.uint64))).sum(
        1) if size else np.zeros(n, np.uint64)
    out = np.zeros((n, len(masks)), np.uint8)
    for k, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        field = (value & np.uint64(mask)) >> np.uint64(shift)
        out[:, k] = (field.astype(np.float64) / total * 255).astype(np.uint8)
    return out.reshape(h, w, len(masks))


def read_dds(data: bytes):
    """A DDS file -> (Pillow's mode, pixels, palette [256, 4] or None)."""
    (hsize,) = struct.unpack_from("<I", data, 4)
    if hsize != 124:
        raise NotImplementedError(f"DDS: header size {hsize} (only 124 is "
                                  "read)")
    if len(data) < 128:
        raise NotImplementedError("DDS: truncated header")
    h, w = struct.unpack_from("<II", data, 12)
    pfflags, fourcc, bits = struct.unpack_from("<I4sI", data, 80)
    if pfflags & _RGB:
        n = 4 if pfflags & _ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{n}I", data, 92)
        return ("RGBA" if n == 4 else "RGB",
                _masked(data, 128, w, h, bits, masks), None)
    if pfflags & _LUMINANCE:
        if bits == 8:
            return "L", _raw(data, 128, w, h, 1, "DDS luminance"), None
        if bits == 16 and pfflags & _ALPHAPIXELS:
            return "LA", _raw(data, 128, w, h, 2, "DDS luminance"), None
        raise NotImplementedError(f"DDS luminance: {bits}-bit pixels (8, "
                                  "or 16 with alpha, are read)")
    if pfflags & _PAL8:
        palette = np.frombuffer(data[128:1152], np.uint8)
        palette = palette[:len(palette) // 4 * 4].reshape(-1, 4)
        return "P", _raw(data, 1152, w, h, 1, "DDS palette"), palette
    if not pfflags & _FOURCC:
        raise NotImplementedError(f"DDS: pixel format flags {pfflags:#x} "
                                  "(RGB, luminance, palette or FourCC are "
                                  "read)")
    pos = 128
    if fourcc == b"DX10":
        (dxgi,) = struct.unpack_from("<I", data, 128)
        if dxgi not in _DXGI:
            raise NotImplementedError(f"DDS: DXGI format {dxgi}")
        kind, signed = _DXGI[dxgi]
        pos += 20
        if kind == 0:
            return "RGBA", _raw(data, pos, w, h, 4, "DDS R8G8B8A8"), None
    elif fourcc in _FOURCCS:
        kind, signed = _FOURCCS[fourcc]
    else:
        raise NotImplementedError(f"DDS: FourCC {fourcc!r}")
    return _MODES[kind], bcn.decode(kind, data[pos:], w, h, signed), None
