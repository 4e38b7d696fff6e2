"""PSD (Adobe Photoshop) decoding for ``io.image.read_image``, with
``struct`` and numpy only.

Reads the merged composite (frame 0) as the JAX package's imaging library
(Pillow 12's ``PsdImagePlugin``) reads it, to the bit, and returns the
image in Pillow's mode (``io.image.pil_convert`` turns it into
``read_image``'s array):

  * the colour modes of Pillow's table at 8 bits (1 bit for bitmap):
    bitmap "1" (a set bit is white, as Pillow's raw "1" reads it), gray,
    duotone and multichannel "L", indexed "P" (the colour-mode data as a
    768-byte "RGB;L" palette), RGB ("RGBA" at exactly four channels),
    CMYK read inverted ("C;I", ...); the channels past the mode's are not
    read, and a PackBits file's byte counts are read for the mode's
    channels only, as Pillow reads them;
  * the image resources walked as Pillow walks them, the layer and mask
    section skipped (layers are not decoded);
  * compression 0 (raw planes) and 1 (PackBits, Pillow's decoder: each
    channel one stream from its first row's offset, a packet cut at its
    row's end).

16- and 32-bit depths, PSB and the modes outside the table raise
NotImplementedError naming the form, where Pillow raises too; LAB (mode
9), which Pillow converts through LittleCMS, is "not yet ported".
"""

from __future__ import annotations

import struct

import numpy as np

from .tiff import unpack

# (Photoshop colour mode, bits) -> (Pillow mode, channels read)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}
_NAMES = {0: "bitmap", 1: "gray", 2: "indexed", 3: "RGB", 4: "CMYK",
          7: "multichannel", 8: "duotone", 9: "LAB"}


def packbits_rows(data: bytes, pos: int, row_bytes: int, rows: int,
                  form: str) -> np.ndarray:
    """Pillow's PackBits decoder from ``pos``: packets (a literal of n + 1
    bytes, a run of 257 - n copies, 128 nothing) filling rows of
    ``row_bytes``, a packet's bytes past its row's end dropped ->
    u8 [rows, row_bytes]."""
    out = np.zeros((rows, row_bytes), np.uint8)
    y = x = 0
    end = len(data)
    while y < rows:
        if pos >= end:
            raise NotImplementedError(f"{form}: truncated PackBits data")
        n = data[pos]
        if n == 128:
            pos += 1
            continue
        if n > 128:
            if pos + 2 > end:
                raise NotImplementedError(f"{form}: truncated PackBits data")
            k = min(257 - n, row_bytes - x)
            out[y, x:x + k] = data[pos + 1]
            pos += 2
        else:
            if pos + n + 2 > end:
                raise NotImplementedError(f"{form}: truncated PackBits data")
            k = min(n + 1, row_bytes - x)
            out[y, x:x + k] = np.frombuffer(data, np.uint8, k, pos + 1)
            pos += n + 2
        x += k
        if x >= row_bytes:
            y, x = y + 1, 0
    return out


def read_psd(data: bytes):
    """A PSD file -> (Pillow's mode, pixels, palette [256, 3] or None):
    "1" 0 / 255, "L" / "P" bytes [h, w], "RGB" / "RGBA" / "CMYK" bytes
    [h, w, c]."""
    version, = struct.unpack_from(">H", data, 4)
    if version != 1:
        raise NotImplementedError(f"PSD version {version} (PSB): not a PSD "
                                  "file to the imaging library")
    channels, h, w, bits, psd_mode = struct.unpack_from(">HIIHH", data, 12)
    form = f"PSD {_NAMES.get(psd_mode, f'mode {psd_mode}')}, {bits}-bit"
    if (psd_mode, bits) not in MODES:
        raise NotImplementedError(f"{form}: no mode in the imaging library")
    mode, need = MODES[psd_mode, bits]
    if need > channels:
        raise NotImplementedError(f"{form}: not enough channels ({channels})")
    if mode == "LAB":
        raise NotImplementedError(f"{form}: not yet ported")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    pos = 26
    (size,) = struct.unpack_from(">I", data, pos)
    palette = None
    if mode == "P" and size == 768:
        palette = np.frombuffer(data, np.uint8, 768, pos + 4).reshape(
            3, 256).T
    pos += 4 + size
    (size,) = struct.unpack_from(">I", data, pos)   # image resources
    pos += 4
    end = pos + size
    while pos < end:
        (n,) = struct.unpack_from(">B", data, pos + 6)
        name = data[pos + 7:pos + 7 + n]
        pos += 7 + len(name) + (0 if len(name) & 1 else 1)
        (n,) = struct.unpack_from(">I", data, pos)
        body = data[pos + 4:pos + 4 + n]
        pos += 4 + len(body) + (len(body) & 1)
    (size,) = struct.unpack_from(">I", data, pos)   # layers and masks
    pos += 4
    if size:
        struct.unpack_from(">I", data, pos)
        pos += size
    (compression,) = struct.unpack_from(">H", data, pos)
    pos += 2
    row_bytes = -(-w * bits // 8)
    letters = {"1": ["1"], "L": ["L"], "P": ["P"], "RGB": list("RGB"),
               "RGBA": list("RGBA"), "CMYK": ["L;I"] * 4}[mode]
    bands = []
    if compression == 0:
        for k, raw in enumerate(letters):
            off = pos + k * w * h
            if off + row_bytes * h > len(data):
                raise NotImplementedError(f"{form}: truncated pixel data")
            rows = np.frombuffer(data, np.uint8, row_bytes * h, off)
            bands.append(unpack(raw, rows.reshape(h, row_bytes), w))
    elif compression == 1:
        counts = data[pos:pos + need * h * 2]
        off = pos + len(counts)
        starts = []
        for k in range(need):
            starts.append(off)
            off += sum(struct.unpack_from(f">{h}H", counts, 2 * k * h))
        for raw, start in zip(letters, starts):
            rows = packbits_rows(data, start, row_bytes, h, form)
            bands.append(unpack(raw, rows, w))
    else:
        raise NotImplementedError(f"{form}: compression {compression}")
    px = bands[0] if len(bands) == 1 else np.stack(bands, -1)
    return mode, px, palette
