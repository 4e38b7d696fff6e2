"""WebP lossless (VP8L) decoding for ``io.webp``, with numpy only, to the
bit of libwebp's ``vp8l_dec.c`` (the decoder behind the JAX package's
imaging library):

  * the 5-byte header (0x2f, 14-bit width and height less one, the alpha
    hint, a 3-bit version of 0);
  * the transforms, undone in the reverse of their order in the stream:
    the predictor (14 modes, 14 and 15 acting as 0; the first row
    predicted from the left, the first column from above, the top-right
    pixel of the last column the row's own first pixel), cross-colour,
    subtract-green and colour indexing (2, 4 and 16 colours bundled 8, 4
    and 2 to a pixel; an index past the palette is transparent black);
  * prefix codes: simple (one or two symbols) and normal (code-length
    codes, the repeat codes 16-18, a maximum symbol count); a code of one
    symbol takes no bits; incomplete codes are refused;
  * meta prefix codes chosen per block from the entropy image;
  * the colour cache (hash 0x1e35a7bd) and LZ77 backward references with
    the 120-entry distance map;
  * ``decode_alpha``: the headerless stream of a WebP ALPH chunk, whose
    image is the green channel.

``decode`` returns ARGB as u32 [H, W]; malformed streams raise
NotImplementedError.
"""

from __future__ import annotations

import numpy as np

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15)
# the 120 short distance codes -> (dx, dy): distance dx + dy * width
_DIST_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1),
    (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1),
    (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0), (1, 4),
    (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2),
    (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0), (1, 5),
    (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4),
    (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0), (1, 6),
    (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5),
    (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3), (0, 7),
    (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1), (4, 6),
    (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2), (3, 7),
    (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0),
    (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6),
    (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7), (-6, 7),
    (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))
_ALPHABET = (256 + 24, 256, 256, 256, 40)   # green (+ cache), R, B, A, dist


class _Bits:
    """The LSB-first bit reader of a VP8L stream (zeros past its end)."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.acc, self.n = data, 0, 0, 0

    def fill(self):
        chunk = self.data[self.pos:self.pos + 8]
        self.acc |= int.from_bytes(chunk, "little") << self.n
        self.n += 64
        self.pos += 8

    def read(self, k: int) -> int:
        if self.n < k:
            self.fill()
        v = self.acc & ((1 << k) - 1)
        self.acc >>= k
        self.n -= k
        return v

    def past_end(self) -> bool:
        return self.pos - self.n // 8 > len(self.data)


def _bad(what: str):
    raise NotImplementedError(f"WebP lossless: {what}")


def _code(lengths) -> tuple:
    """Code lengths -> (lookup list over the next ``maxlen`` bits of entries
    symbol << 4 | length, maxlen); canonical codes, read LSB first."""
    lengths = np.asarray(lengths, np.int64)
    used = np.flatnonzero(lengths)
    if used.size == 0:
        _bad("an empty prefix code")
    if used.size == 1:
        return [int(used[0]) << 4], 0
    if sum(2.0 ** -lengths[used]) != 1.0:
        _bad("an incomplete prefix code")
    maxlen = int(lengths.max())
    lut = np.zeros(1 << maxlen, np.int64)
    order = used[np.lexsort((used, lengths[used]))]
    code, prev = 0, int(lengths[order[0]])
    for sym in order.tolist():
        ln = int(lengths[sym])
        code <<= ln - prev
        prev = ln
        rev = int(format(code, f"0{ln}b")[::-1], 2)
        lut[rev::1 << ln] = (sym << 4) | ln
        code += 1
    return lut.tolist(), maxlen


def _read_code(br: _Bits, alphabet: int) -> tuple:
    """One prefix code of the stream (simple or normal)."""
    lengths = [0] * alphabet
    if br.read(1):                                   # simple
        two = br.read(1)
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if two:
            lengths[br.read(8)] = 1
        return _code(lengths)
    cl = [0] * 19
    for k in range(br.read(4) + 4):
        cl[_CODE_LENGTH_ORDER[k]] = br.read(3)
    lut, maxlen = _code(cl)
    max_symbol = alphabet
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            _bad("a code-length count past the alphabet")
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        if br.n < 15:
            br.fill()
        e = lut[br.acc & ((1 << maxlen) - 1)]
        br.acc >>= e & 15
        br.n -= e & 15
        v = e >> 4
        if v < 16:
            lengths[sym] = v
            sym += 1
            if v:
                prev = v
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[v - 16]
            rep = br.read(extra) + offset
            if sym + rep > alphabet:
                _bad("a code-length repeat past the alphabet")
            lengths[sym:sym + rep] = [prev if v == 16 else 0] * rep
            sym += rep
    return _code(lengths)


def _prefix_value(sym: int, br: _Bits) -> int:
    """A length or distance prefix symbol and its extra bits -> value."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _sub_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _image(br: _Bits, w: int, h: int, level0: bool) -> np.ndarray:
    """One entropy-coded image (the transforms read by the caller) ->
    ARGB u32 [h, w]."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            _bad(f"a colour cache of {cache_bits} bits")
    meta_bits, meta = 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = _sub_size(w, meta_bits)
        meta = ((_image(br, mw, _sub_size(h, meta_bits), False) >> 8)
                & 0xFFFF).reshape(-1).tolist()
    n_groups = max(meta) + 1 if meta else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = [[_read_code(br, a + (cache_size if k == 0 else 0))
               for k, a in enumerate(_ALPHABET)] for _ in range(n_groups)]
    if br.past_end():
        _bad("truncated prefix codes")
    total = w * h
    out = [0] * total
    cache = [0] * cache_size
    shift = 32 - cache_bits
    dist_of = [max(1, dx + dy * w) for dx, dy in _DIST_MAP]
    mask = (1 << meta_bits) - 1 if meta else -1
    mw = _sub_size(w, meta_bits) if meta else 0
    data = br.data
    acc, n, pos = br.acc, br.n, br.pos
    i = x = y = 0
    cached = 0
    g = groups[0]
    (gl, gm), (rl, rm), (bl, bm), (al, am), (dl, dm) = g
    while i < total:
        if meta and (x & mask) == 0:
            g = groups[meta[(y >> meta_bits) * mw + (x >> meta_bits)]]
            (gl, gm), (rl, rm), (bl, bm), (al, am), (dl, dm) = g
        if n < 64:
            acc |= int.from_bytes(data[pos:pos + 8], "little") << n
            n += 64
            pos += 8
        e = gl[acc & ((1 << gm) - 1)]
        acc >>= e & 15
        n -= e & 15
        code = e >> 4
        if code < 256:                                   # literal
            e = rl[acc & ((1 << rm) - 1)]
            acc >>= e & 15
            n -= e & 15
            red = e >> 4
            e = bl[acc & ((1 << bm) - 1)]
            acc >>= e & 15
            n -= e & 15
            blue = e >> 4
            e = al[acc & ((1 << am) - 1)]
            acc >>= e & 15
            n -= e & 15
            out[i] = (e >> 4) << 24 | red << 16 | code << 8 | blue
            i += 1
            x += 1
            if x >= w:
                x = 0
                y += 1
        elif code < 280:                                 # backward reference
            br.acc, br.n, br.pos = acc, n, pos
            length = _prefix_value(code - 256, br)
            if br.n < 64:
                br.fill()
            e = dl[br.acc & ((1 << dm) - 1)]
            br.acc >>= e & 15
            br.n -= e & 15
            dcode = _prefix_value(e >> 4, br)
            acc, n, pos = br.acc, br.n, br.pos
            dist = dist_of[dcode - 1] if dcode <= 120 else dcode - 120
            if dist > i or length > total - i:
                _bad("a backward reference out of the image")
            if dist >= length:
                out[i:i + length] = out[i - dist:i - dist + length]
            else:
                for k in range(i, i + length):
                    out[k] = out[k - dist]
            i += length
            x += length
            while x >= w:
                x -= w
                y += 1
            if meta and i < total and x & mask:
                g = groups[meta[(y >> meta_bits) * mw + (x >> meta_bits)]]
                (gl, gm), (rl, rm), (bl, bm), (al, am), (dl, dm) = g
        else:                                            # colour cache
            key = code - 280
            if key >= cache_size:
                _bad("a colour-cache symbol past the cache")
            for k in range(cached, i):
                v = out[k]
                cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = v
            cached = i
            out[i] = cache[key]
            i += 1
            x += 1
            if x >= w:
                x = 0
                y += 1
    br.acc, br.n, br.pos = acc, n, pos
    if br.past_end():
        _bad("truncated image data")
    return np.asarray(out, np.uint32).reshape(h, w)


def _add(a, b):
    """Per-channel sum of ARGB words, mod 256."""
    a, b = a.astype(np.uint32), b.astype(np.uint32)
    lo = ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF
    hi = ((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00
    return lo | hi


def _channels(v):
    return [(v >> s) & 0xFF for s in (24, 16, 8, 0)]


def _pack(ch):
    return (ch[0] << 24) | (ch[1] << 16) | (ch[2] << 8) | ch[3]


def _avg(a, b):
    return _pack([(p + q) >> 1 for p, q in zip(_channels(a), _channels(b))])


def _predict(mode: int, left: int, top: int, tr: int, tl: int) -> int:
    """libwebp's predictor ``mode`` on the ARGB neighbours."""
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg(_avg(left, tr), top)
    if mode == 6:
        return _avg(left, tl)
    if mode == 7:
        return _avg(left, top)
    if mode == 8:
        return _avg(tl, top)
    if mode == 9:
        return _avg(top, tr)
    if mode == 10:
        return _avg(_avg(left, tl), _avg(top, tr))
    cl, ct, ctl = _channels(left), _channels(top), _channels(tl)
    if mode == 11:   # Select: whichever of top and left lies nearer
        d = sum(abs(b - c) - abs(a - c) for a, b, c in zip(ct, cl, ctl))
        return top if d <= 0 else left
    if mode == 12:
        return _pack([min(255, max(0, a + b - c))
                      for a, b, c in zip(cl, ct, ctl)])
    if mode == 13:
        half = []
        for a, b, c in zip(cl, ct, ctl):
            m = (a + b) >> 1
            d = m - c
            half.append(min(255, max(0, m + (abs(d) // 2 if d >= 0
                                             else -(abs(d) // 2)))))
        return _pack(half)
    return 0xFF000000                                  # modes 0, 14, 15


def _unpredict(res: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    """Undo the predictor transform of the residual image ``res``."""
    h, w = res.shape
    r = res.tolist()
    out = [[0] * w for _ in range(h)]
    mode_rows = ((modes >> 8) & 0xF).tolist()

    def add(a, b):
        return (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF) | \
            (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)

    row = out[0]
    row[0] = add(r[0][0], 0xFF000000)
    for x in range(1, w):
        row[x] = add(r[0][x], row[x - 1])
    for y in range(1, h):
        up, row, rr = out[y - 1], out[y], r[y]
        mrow = mode_rows[y >> bits]
        row[0] = add(rr[0], up[0])
        for x in range(1, w):
            tr = up[x + 1] if x + 1 < w else row[0]
            m = mrow[x >> bits]
            p = (row[x - 1] if m == 1 else up[x] if m == 2 else
                 _predict(m, row[x - 1], up[x], tr, up[x - 1]))
            row[x] = add(rr[x], p)
    return np.asarray(out, np.uint32)


def _uncross(img: np.ndarray, bits: int, codes: np.ndarray) -> np.ndarray:
    """Undo the cross-colour transform."""
    h, w = img.shape
    c = codes[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]
    s8 = lambda v: ((v.astype(np.int64) & 0xFF) ^ 0x80) - 0x80  # noqa: E731
    g2r, g2b, r2b = s8(c), s8(c >> 8), s8(c >> 16)
    green = s8(img >> 8)
    red = (((img >> 16) & 0xFF).astype(np.int64) + ((g2r * green) >> 5)) & 0xFF
    blue = ((img & 0xFF).astype(np.int64) + ((g2b * green) >> 5)
            + ((r2b * s8(red)) >> 5)) & 0xFF
    keep = img & np.uint32(0xFF00FF00)
    return keep | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)


def decode_stream(br: _Bits, w: int, h: int) -> np.ndarray:
    """A level-0 VP8L image (transforms, then the entropy-coded image) of
    w x h -> ARGB u32 [h, w]."""
    transforms, seen, cw = [], set(), w
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            _bad(f"transform {kind} twice")
        seen.add(kind)
        if kind in (0, 1):                           # predictor, cross-colour
            bits = br.read(3) + 2
            sub = _image(br, _sub_size(cw, bits), _sub_size(h, bits), False)
            transforms.append((kind, cw, bits, sub))
        elif kind == 2:                              # subtract green
            transforms.append((kind, cw, 0, None))
        else:                                        # colour indexing
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            pal = _image(br, n, 1, False).reshape(-1)
            pal = np.frombuffer(np.cumsum(pal.view(np.uint8).reshape(-1, 4),
                                          axis=0, dtype=np.uint8).tobytes(),
                                np.uint32)
            full = np.zeros(256, np.uint32)
            full[:n] = pal
            transforms.append((kind, cw, bits, full))
            cw = _sub_size(cw, bits)
    img = _image(br, cw, h, True)
    for kind, tw, bits, sub in reversed(transforms):
        if kind == 0:
            img = _unpredict(img, bits, sub)
        elif kind == 1:
            img = _uncross(img, bits, sub)
        elif kind == 2:
            g = (img >> 8) & 0xFF
            img = _add(img, (g << 16) | g)
        else:
            if bits:
                per = 1 << bits
                bpp = 8 >> bits
                xs = np.arange(tw)
                g = (img[:, xs >> bits] >> 8) & 0xFF
                idx = (g >> ((xs & (per - 1)) * bpp)) & ((1 << bpp) - 1)
            else:
                idx = (img >> 8) & 0xFF
            img = sub[idx]
    return img


def decode(data: bytes):
    """A VP8L chunk's payload -> (ARGB u32 [H, W], the alpha hint)."""
    if len(data) < 5 or data[0] != 0x2F:
        _bad("no 0x2f signature")
    br = _Bits(data[1:])
    w, h, alpha, version = (br.read(14) + 1, br.read(14) + 1, br.read(1),
                            br.read(3))
    if version != 0:
        _bad(f"version {version}")
    return decode_stream(br, w, h), bool(alpha)


def decode_alpha(data: bytes, w: int, h: int) -> np.ndarray:
    """The headerless VP8L stream of an ALPH chunk -> its green channel,
    u8 [h, w]."""
    return ((decode_stream(_Bits(data), w, h) >> 8) & 0xFF).astype(np.uint8)
