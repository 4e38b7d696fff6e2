"""PCX and DCX decoding for ``io.image.read_image``, with ``struct`` and
numpy only.

Reads what the JAX package's imaging library (Pillow 12's
``PcxImagePlugin`` and ``DcxImagePlugin``) reads, to the bit, and returns
the image in Pillow's mode (``io.image.pil_convert`` turns it into
``read_image``'s array):

  * Pillow's modes: 1 bit, 1 plane "1"; 1 bit, 2 or 4 planes "P" from
    the header's 16-colour palette ("P;2L" / "P;4L" bit planes); version
    5, 8 bits, 1 plane "L", or "P" where the file's last 769 bytes are
    0x0C and a palette that is not the gray ramp (a file under 769 bytes
    is "L"); version 5, 8 bits, 3 planes "RGB" ("RGB;L" colour lines);
  * Pillow's stride (the header's bytes a line when it is the packed
    size, else the packed size rounded up to even), its run-length
    decoder (a run past its row's end fails) and its fix-up of padded
    plane lines (``PcxDecode.c``: each line after the first moved up to
    follow the one before, bit planes of ceil(w / 8) bytes, else as many
    lines of w bytes as the row holds, where that step exceeds a line; so
    a 24-bit file 1 or 3 pixels wide keeps its padding, as in Pillow);
  * DCX: the first page of the offset table, its trailing palette read
    from the end of the whole file, as Pillow reads it.

The RLE is decoded with numpy over the whole body: every byte that
follows a run marker is data, and the markers are the even positions of
each stretch of bytes of 0xC0 or more (a stretch always starts a code).
Other modes, an empty box and a short file raise NotImplementedError
naming the form, where Pillow raises too; ``read_image`` tries a file
whose header ``is_pcx`` turns down as a TGA, as Pillow's open does.
"""

from __future__ import annotations

import struct

import numpy as np

from .tiff import unpack


def _rle(data: bytes, pos: int, row_bytes: int, rows: int,
         form: str) -> np.ndarray:
    """Pillow's PCX run-length decoder from ``pos`` -> u8 [rows,
    row_bytes]."""
    buf = np.frombuffer(data, np.uint8, len(data) - pos, pos)
    n = buf.size
    high = buf >= 0xC0
    idx = np.arange(n)
    first = high & ~np.concatenate([[False], high[:-1]])
    seg = np.maximum.accumulate(np.where(first, idx, 0))
    marker = high & ((idx - seg) % 2 == 0)
    code = ~np.concatenate([[False], marker[:-1]])
    at = np.flatnonzero(code)
    counts = np.where(marker[at], buf[at] & 0x3F, 1).astype(np.int64)
    total = rows * row_bytes
    ends = np.cumsum(counts)
    k = int(np.searchsorted(ends, total))     # the code that fills it
    if k >= at.size or marker[at[k]] and at[k] + 1 >= n:
        raise NotImplementedError(f"{form}: truncated pixel data")
    counts, ends, at = counts[:k + 1], ends[:k + 1], at[:k + 1]
    starts = ends - counts
    cross = (counts > 0) & (starts // row_bytes != (ends - 1) // row_bytes)
    if cross.any():
        raise NotImplementedError(f"{form}: a run past its row's end")
    values = buf[np.where(marker[at], at + 1, at)]
    return np.repeat(values, counts).reshape(rows, row_bytes)


def is_pcx(data: bytes) -> bool:
    """Pillow's ``PcxImageFile._open`` header checks that, failing, let
    its open try the formats after PCX (TGA among them): a 68-byte header,
    its first two bytes and a nonempty box."""
    if len(data) < 68 or data[0] != 10 or data[1] not in (0, 2, 3, 5):
        return False
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    return x1 + 1 > x0 and y1 + 1 > y0


def read_pcx(data: bytes, start: int = 0, name: str = "PCX"):
    """The PCX image at ``start`` of ``data`` (a DCX page: its palette is
    the last 769 bytes of ``data``) -> (Pillow's mode, pixels, palette
    [n, 3] or None)."""
    s = data[start:start + 68]
    if not is_pcx(s):
        raise NotImplementedError(f"{name}: not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    version, bits, planes = s[1], s[3], s[65]
    (provided,) = struct.unpack_from("<H", s, 66)
    form = f"{name} version {version}, {bits}-bit, {planes} planes"
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = np.frombuffer(s, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if not (pal == np.arange(256)[:, None]).all():
                mode = rawmode = "P"
                palette = pal
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise NotImplementedError(f"{form}: unknown PCX mode")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    row_bytes = planes * stride
    rows = _rle(data, start + 128, row_bytes, h, form)
    # Pillow's fix-up of padded plane lines: bit planes of ceil(w / 8)
    # bytes, else as many lines of w bytes as the row holds
    line = -(-w // 8) if rawmode.startswith("P;") else w
    bands = planes if rawmode.startswith("P;") else row_bytes // line
    step = row_bytes // bands if bands else 0
    if step > line:
        moved = rows.copy()
        for i in range(1, bands):
            moved[:, i * line:(i + 1) * line] = rows[:, i * step:
                                                     i * step + line]
        rows = moved
    return mode, unpack(rawmode, rows, w), palette


def read_dcx(data: bytes):
    """A DCX file's first page -> ``read_pcx``'s result."""
    offsets = []
    for i in range(1024):
        (off,) = struct.unpack_from("<I", data, 4 + 4 * i)
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise NotImplementedError("DCX: no pages")
    return read_pcx(data, offsets[0], "DCX page 0")
