"""QOI ("Quite OK Image") decoding for ``io.image.read_image``, with
``struct`` and numpy only.

Reads what the JAX package's imaging library (Pillow 12's
``QoiImagePlugin``) reads, to the bit: "RGB" for 3 channels, "RGBA" for
any other count; the ops RGB, RGBA, INDEX, DIFF, LUMA and RUN from the
pixel (0, 0, 0, 255), with Pillow's index: a RUN adds nothing to it (so a
file that opens with a run leaves (0, 0, 0, 255) out) and an empty slot
reads (0, 0, 0, 0). A file that ends before its pixels raises
NotImplementedError naming the form, where Pillow raises too.
"""

from __future__ import annotations

import struct

import numpy as np


def read_qoi(data: bytes):
    """A QOI file -> (mode, pixels u8 [h, w, 3 | 4])."""
    w, h = struct.unpack_from(">II", data, 4)
    bands = 3 if data[12] == 3 else 4
    n = w * h
    out = np.empty(n, np.uint32)      # r | g << 8 | b << 16 | a << 24
    index = [0] * 64
    prev = 255 << 24
    pos, k, end = 14, 0, len(data)
    try:
        while k < n:
            byte = data[pos]
            pos += 1
            if byte == 0xFE:          # RGB
                r, g, b = data[pos], data[pos + 1], data[pos + 2]
                pos += 3
                px = r | g << 8 | b << 16 | (prev & 0xFF000000)
            elif byte == 0xFF:        # RGBA
                px = int.from_bytes(data[pos:pos + 4], "little")
                if pos + 4 > end:
                    raise IndexError
                pos += 4
            elif byte < 0x40:         # INDEX
                px = index[byte]
            elif byte < 0x80:         # DIFF
                r = ((prev & 255) + ((byte >> 4) & 3) - 2) & 255
                g = ((prev >> 8 & 255) + ((byte >> 2) & 3) - 2) & 255
                b = ((prev >> 16 & 255) + (byte & 3) - 2) & 255
                px = r | g << 8 | b << 16 | (prev & 0xFF000000)
            elif byte < 0xC0:         # LUMA
                second = data[pos]
                pos += 1
                dg = (byte & 0x3F) - 32
                dr, db = (second >> 4) - 8, (second & 15) - 8
                r = ((prev & 255) + dg + dr) & 255
                g = ((prev >> 8 & 255) + dg) & 255
                b = ((prev >> 16 & 255) + dg + db) & 255
                px = r | g << 8 | b << 16 | (prev & 0xFF000000)
            else:                     # RUN: the index is left as it is
                run = min((byte & 0x3F) + 1, n - k)
                out[k:k + run] = prev
                k += run
                continue
            prev = px
            index[((px & 255) * 3 + (px >> 8 & 255) * 5 + (px >> 16 & 255)
                   * 7 + (px >> 24) * 11) % 64] = px
            out[k] = px
            k += 1
    except IndexError as exc:
        raise NotImplementedError(
            f"QOI: the data ends at pixel {k} of {n}") from exc
    px = out.view(np.uint8).reshape(h, w, 4)
    return ("RGB", px[..., :3].copy()) if bands == 3 else ("RGBA", px)
