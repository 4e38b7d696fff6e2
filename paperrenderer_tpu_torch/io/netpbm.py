"""Netpbm decoding for ``io.image.read_image``, with numpy only.

Reads what the JAX package's imaging library (Pillow 12's
``PpmImagePlugin``) reads, to the bit, and returns the image in Pillow's
mode (``io.image.pil_convert`` turns it into ``read_image``'s array):

  * P1-P6, plain (ASCII) and binary, their header tokens read as Pillow
    reads them (a ``#`` skips to the end of its line, even inside a
    token; a token is at most 10 characters);
  * P1 / P4 as "1" (1 is black); P2 / P5 as "L", or as "I" when the
    maxval is above 255 (scaled to 65535); P3 / P6 as "RGB";
  * a maxval other than 255 (and 65535 for gray) scaled as Pillow scales
    it: each sample over the maxval times 255 (65535 for "I"), rounded
    half to even, clipped in the binary forms; two big-endian bytes a
    sample above 255;
  * "Pf", gray PFM: float32 rows bottom-up, little-endian for a negative
    scale, big-endian else ("F");
  * Pillow's own headers P0CMYK ("CMYK"), PyP ("P", with no palette:
    every index reads black), PyRGBA and PyCMYK.

PAM (P7) and colour PFM (PF) are not Netpbm forms Pillow opens: both
packages refuse them (``io.image`` names them). Truncated data, samples
above the maxval in the plain forms and tokens past 10 characters raise
NotImplementedError naming the form, where Pillow raises too.
"""

from __future__ import annotations

import math

import numpy as np

MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_WHITESPACE = b" \t\n\x0b\x0c\r"
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def magic(data: bytes) -> bytes:
    """Pillow's ``_read_magic``: up to 6 bytes before a whitespace."""
    out = b""
    for k in range(min(6, len(data))):
        c = data[k:k + 1]
        if c in _WHITESPACE:
            break
        out += c
    return out


class _Header:
    """Pillow's header tokens: ``#`` comments skipped to the line's end."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n=1) -> bytes:
        c = self.data[self.pos:self.pos + n]
        self.pos += len(c)
        return c

    def token(self, form: str) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.read()
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.read() not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok:
            raise NotImplementedError(f"{form}: end of file in the header")
        if len(tok) > 10:
            raise NotImplementedError(f"{form}: a header token longer than "
                                      "10 characters")
        return tok


def _scaled(values: np.ndarray, maxval: int, top: int) -> np.ndarray:
    """Pillow's ``round(value / maxval * top)`` in doubles."""
    return np.round(values.astype(np.float64) / maxval * top)


def _plain_tokens(data: bytes, pos: int) -> bytes:
    """The plain forms' data with Pillow's comment removal: a ``#`` drops
    the rest of its line (to the nearer of LF and CR)."""
    body = data[pos:]
    out, k = [], 0
    while True:
        c = body.find(b"#", k)
        if c < 0:
            out.append(body[k:])
            break
        out.append(body[k:c])
        ends = [e for e in (body.find(b"\n", c), body.find(b"\r", c))
                if e >= 0]
        if not ends:
            break
        k = min(ends) + 1
    return b"".join(out)


def read_netpbm(data: bytes):
    """A Netpbm file -> (Pillow's mode, pixels): "1" 0 / 255, "L" / "P"
    bytes, "I" i32, "F" f32, "RGB" / "RGBA" / "CMYK" bytes [h, w, c]."""
    m = magic(data)
    if m not in MODES:
        raise NotImplementedError(f"Netpbm: magic {m!r} (P1-P6, Pf, P0CMYK, "
                                  "PyP, PyRGBA and PyCMYK are read)")
    form = f"Netpbm {m.decode()}"
    mode = MODES[m]
    hd = _Header(data, len(m) + (1 if len(data) > len(m)
                                 and data[len(m):len(m) + 1] in _WHITESPACE
                                 else 0))
    try:
        w, h = int(hd.token(form)), int(hd.token(form))
    except ValueError as exc:
        raise NotImplementedError(f"{form}: a bad size ({exc})") from exc
    plain = m in (b"P1", b"P2", b"P3")
    if mode == "1":
        if plain:
            body = _plain_tokens(data, hd.pos)
            tokens = b"".join(body.split())
            if set(tokens) - {48, 49}:
                raise NotImplementedError(f"{form}: a token other than 0 / 1")
            tokens = tokens[:w * h]
            if len(tokens) < w * h:
                raise NotImplementedError(f"{form}: not enough image data")
            v = np.frombuffer(tokens, np.uint8).reshape(h, w)
            return "1", np.where(v == 48, 255, 0).astype(np.uint8)
        stride = (w + 7) // 8
        if hd.pos + stride * h > len(data):
            raise NotImplementedError(f"{form}: truncated pixel data")
        rows = np.frombuffer(data, np.uint8, stride * h, hd.pos).reshape(
            h, stride)
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return "1", np.where(bits, 0, 255).astype(np.uint8)
    if mode == "F":
        try:
            scale = float(hd.token(form))
        except ValueError as exc:
            raise NotImplementedError(f"{form}: a bad scale") from exc
        if scale == 0.0 or not math.isfinite(scale):
            raise NotImplementedError(f"{form}: scale {scale}")
        if hd.pos + 4 * w * h > len(data):
            raise NotImplementedError(f"{form}: truncated pixel data")
        v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h, hd.pos)
        return "F", v.reshape(h, w)[::-1].astype(np.float32)
    try:
        maxval = int(hd.token(form))
    except ValueError as exc:
        raise NotImplementedError(f"{form}: a bad maxval") from exc
    if not 0 < maxval < 65536:
        raise NotImplementedError(f"{form}: maxval {maxval}")
    if maxval > 255 and mode == "L":
        mode = "I"
    bands = _BANDS[mode]
    top = 65535 if mode == "I" else 255
    n = w * h * bands
    shape = (h, w, bands) if bands > 1 else (h, w)
    if plain:
        body = _plain_tokens(data, hd.pos)
        tokens = body.split()[:n]
        if any(len(t) > 10 for t in tokens):
            raise NotImplementedError(f"{form}: a data token longer than 10 "
                                      "characters")
        try:
            v = np.array([int(t) for t in tokens], np.int64)
        except ValueError as exc:
            raise NotImplementedError(f"{form}: a bad sample") from exc
        if (v < 0).any() or (v > maxval).any():
            raise NotImplementedError(f"{form}: a sample outside 0..maxval")
        if len(v) < n:
            raise NotImplementedError(f"{form}: not enough image data")
        v = _scaled(v, maxval, top)
    else:
        size = 1 if maxval < 256 else 2
        if hd.pos + n * size > len(data):
            raise NotImplementedError(f"{form}: truncated pixel data")
        v = np.frombuffer(data, np.uint8 if size == 1 else ">u2", n, hd.pos)
        if maxval not in (255, 65535) or (maxval == 65535 and mode != "I"):
            v = np.minimum(_scaled(v, maxval, top), top)
    v = v.reshape(shape)
    return mode, v.astype(np.int32 if mode == "I" else np.uint8)
