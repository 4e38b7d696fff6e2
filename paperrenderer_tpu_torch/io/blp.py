"""BLP (Blizzard Mipmap) and FTEX decoding for ``io.image.read_image``,
with ``struct`` and numpy only.

Reads the first mip as the JAX package's imaging library (Pillow 12's
``BlpImagePlugin`` and ``FtexImagePlugin``) reads it, to the bit:

  * BLP1 JPEG (compression 0): the shared JPEG header and the first
    mip's bytes (read from the header's end or the mip's offset, which
    ever is later) decoded as one JPEG (``io.jpeg``; four components
    read as CMYK, Adobe's YCCK transform ignored, as Pillow's BLP plugin
    sets the decoder), made RGB, its bytes re-read as "BGR";
  * BLP1 palette (compression 1, encoding 4 or 5) and BLP2 palette
    (encoding 1): the 256-entry BGRA palette, each index byte of the mip
    an (R, G, B) pixel, with its palette alpha when the alpha depth is
    not 0 (of any depth: 1, 4 or 8);
  * BLP2 DXT1 / DXT3 / DXT5 (encoding 2 by alpha encoding 0 / 1 / 7):
    Pillow's Python block decoders (``io.bcn`` with the 5-6-5 endpoints
    shifted, not replicated), a row of blocks giving four whole rows of
    pixels;
  * FTEX: its DXT1 (``io.bcn``'s BC1, as Pillow's C decoder) and raw
    RGB formats.

The BLP mode is "RGBA" when the header's alpha is not 0, else "RGB", and
the decoded bytes fill it as Pillow's raw decoder fills it: a row of w
pixels after another, so a width that is not a multiple of 4 shears the
DXT forms' padded rows, and an RGB image keeps three of every DXT3 /
DXT5 pixel's four bytes, as in Pillow. BLP2 raw BGRA (encoding 3), BLP2
JPEG, other encodings and short files raise NotImplementedError naming
the form, where Pillow raises too.
"""

from __future__ import annotations

import struct

import numpy as np

from . import bcn
from .jpeg import read_jpeg

_DXT = {0: (1, 8), 1: (2, 16), 7: (3, 16)}   # alpha encoding -> (BC, bytes)


def _fill(flat: np.ndarray, w: int, h: int, bands: int, form: str):
    """Pillow's ``set_as_raw``: the bytes as rows of w pixels of ``bands``
    bytes -> u8 [h, w, bands]."""
    need = w * h * bands
    if flat.size < need:
        raise NotImplementedError(f"{form}: not enough image data")
    return flat[:need].reshape(h, w, bands)


def _read(data: bytes, pos: int, n: int, form: str) -> bytes:
    """Pillow's ``_safe_read``: n bytes at ``pos`` or a truncated file."""
    if n < 0 or pos + n > len(data):
        raise NotImplementedError(f"{form}: truncated file")
    return data[pos:pos + n]


def _palette(data: bytes, pos: int, form: str) -> np.ndarray:
    """The 256-entry BGRA palette at ``pos`` -> [256, 4] RGBA."""
    return np.frombuffer(_read(data, pos, 1024, form), np.uint8).reshape(
        256, 4)[:, [2, 1, 0, 3]]


def read_blp(data: bytes):
    """A BLP1 or BLP2 file -> (mode, pixels u8 [h, w, 3 | 4])."""
    version = data[:4].decode("latin-1")
    (compression,) = struct.unpack_from("<i", data, 4)
    if version == "BLP1":
        (alpha,) = struct.unpack_from("<I", data, 8)
        w, h, encoding = struct.unpack_from("<IIi", data, 12)
        pos, alpha_enc = 28, None
    else:
        encoding, alpha, alpha_enc = struct.unpack_from("<bbb", data, 8)
        w, h = struct.unpack_from("<II", data, 12)
        pos = 20
    mode = "RGBA" if alpha else "RGB"
    bands = len(mode)
    form = f"{version} compression {compression}, encoding {encoding}"
    offsets = struct.unpack_from("<16I", _read(data, pos, 64, form))
    lengths = struct.unpack_from("<16I", _read(data, pos + 64, 64, form))
    pos += 128
    if version == "BLP1" and compression == 0:
        (size,) = struct.unpack("<I", _read(data, pos, 4, form))
        header = _read(data, pos + 4, size, form)
        pos = max(pos + 4 + size, offsets[0])
        stream = header + _read(data, pos, lengths[0], form)
        try:
            rgb = read_jpeg(stream, "cmyk")
        except (ValueError, IndexError, KeyError, StopIteration,
                struct.error) as exc:
            raise NotImplementedError(f"{form} (JPEG): {exc}") from exc
        if rgb.ndim == 2:
            rgb = rgb[..., None].repeat(3, -1)
        bgr = _fill(rgb[..., :3].reshape(-1), w, h, 3, form)[..., ::-1]
        if mode == "RGBA":
            bgr = np.concatenate([bgr, np.full_like(bgr[..., :1], 255)], -1)
        return mode, bgr
    if compression != 1 or version == "BLP1" and encoding not in (4, 5) or \
            version == "BLP2" and encoding not in (1, 2):
        raise NotImplementedError(f"{form}: not decoded by the imaging "
                                  "library")
    palette = _palette(data, pos, form)
    if version == "BLP2":
        pos = offsets[0]
    else:
        pos += 1024
    if encoding != 2:
        idx = np.frombuffer(_read(data, pos, lengths[0], form), np.uint8)
        return mode, _fill(palette[idx, :bands].reshape(-1), w, h, bands,
                           form)
    if alpha_enc not in _DXT:
        raise NotImplementedError(f"{form}: alpha encoding {alpha_enc}")
    kind, size = _DXT[alpha_enc]
    nbx, nby = (w + 3) // 4, (h + 3) // 4
    blocks = _read(data, pos, nbx * nby * size, form)
    px = bcn.decode(kind, blocks, 4 * nbx, 4 * nby, replicate=False)
    if kind == 1 and not alpha:
        px = px[..., :3]
    return mode, _fill(px.reshape(-1), w, h, bands, form)


def read_ftex(data: bytes):
    """An FTEX file -> (mode, pixels): "RGBA" for DXT1, "RGB" raw."""
    w, h, _, formats, fmt, where = struct.unpack_from("<iiiiii", data, 8)
    if formats != 1:
        raise NotImplementedError(f"FTEX with {formats} formats")
    (size,) = struct.unpack_from("<i", data, where)
    body = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt == 0:
        if len(body) < (w + 3) // 4 * ((h + 3) // 4) * 8:
            raise NotImplementedError("FTEX DXT1: truncated block data")
        return "RGBA", bcn.decode(1, body, w, h)
    if fmt == 1:
        if len(body) < w * h * 3:
            raise NotImplementedError("FTEX raw RGB: truncated pixel data")
        return "RGB", np.frombuffer(body, np.uint8, w * h * 3).reshape(
            h, w, 3)
    raise NotImplementedError(f"FTEX texture format {fmt}")
