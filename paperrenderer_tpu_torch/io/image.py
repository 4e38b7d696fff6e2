"""Image output/input: the swapchain-present analogue for a headless renderer.

PyTorch-port counterpart of ``paperrenderer_tpu/io/image.py``, written with
``zlib``, ``struct`` and numpy only (no imaging library). ``read_image``
decodes what the JAX package's imaging library (PIL) turns into its arrays:

  * PNG, Adam7-interlaced or not: 8-bit gray, RGB and RGBA as they are;
    palette (1/2/4/8-bit, with ``tRNS``) and gray + alpha as RGBA; 16-bit
    RGB, RGBA and gray + alpha by their high bytes, 16-bit gray as RGBA
    with the gray clipped to 255 (PIL's "I;16" -> "RGBA" conversion);
  * baseline and progressive JPEG (SOF0/SOF1/SOF2, Huffman, 8-bit, gray
    or YCbCr/RGB, 4:4:4, 4:2:2 and 4:2:0, restart markers; progressive
    scans by spectral selection and successive approximation of DC and
    AC with end-of-band runs, as libjpeg's ``jdphuff.c``), decoded as
    libjpeg decodes it by default: the integer IDCT (``jidctint.c``),
    "fancy" triangle-filter chroma upsampling (``jdsample.c``) and the
    integer YCbCr tables (``jdcolor.c``), so the pixels are PIL's to the
    bit. A progressive file whose scans leave a coefficient unfinished
    would take libjpeg's block smoothing; it raises instead.

Arithmetic-coded, lossless, hierarchical and 12-bit JPEGs and sub-byte
gray PNGs raise ``NotImplementedError`` naming the format. ``encode_png`` and
``write_png`` write 8-bit gray / RGB / RGBA PNGs.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples/pixel
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                6: "RGBA"}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image) -> bytes:
    """Encode an image as PNG bytes. Accepts f32 [H, W, 3] in [0, 1] (a
    tensor on any device too) or u8 [H, W], [H, W, 1|3|4]."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    return b"".join((
        _SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
        _chunk(b"IEND", b"")))


def write_png(path: str, image) -> None:
    """Write an image to PNG (``encode_png``'s inputs)."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _unfilter(data: bytes, h: int, stride: int, bpp: int,
              pos: int = 0) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) of the h rows at ``pos``
    -> u8 [h, stride]."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = row
        elif ftype == 1:      # Sub: running sum per channel along the row
            cur = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:      # Up
            cur = (row + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = row.tolist()
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(raw: bytes, pos: int, w: int, h: int, c: int, depth: int):
    """The w x h image of c samples a pixel at ``pos`` of the inflated
    stream -> (samples [h, w, c]: u8, u16 for 16-bit, sub-byte indices
    unpacked; the next position)."""
    stride = -(-w * c * depth // 8)
    rows = _unfilter(raw, h, stride, max(1, c * depth // 8), pos)
    pos += h * (stride + 1)
    if depth == 16:
        rows = rows.view(">u2").astype(np.uint16)
    elif depth < 8:   # unpack the sub-byte samples, high bits first
        per = 8 // depth
        shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1))
        rows = rows.reshape(h, -1)
    return rows[:, :w * c].reshape(h, w, c), pos


def _describe(data: bytes) -> str:
    """A name for a format ``read_image`` does not decode."""
    if data[:4] in (b"GIF8", b"RIFF") or data[:2] == b"BM":
        return {b"GIF8": "GIF", b"RIFF": "WebP/RIFF"}.get(data[:4], "BMP")
    return "unknown (not a PNG or JPEG)"


def read_image(data_or_path) -> np.ndarray:
    """Decode a PNG or a baseline JPEG from bytes or a path -> u8 [H, W, C]
    ([H, W] for gray), as the JAX package's ``read_image`` returns it: gray
    and RGB as they are, RGBA for PNG's other forms (module docstring).
    Raises NotImplementedError naming the format for the other formats and
    forms."""
    if isinstance(data_or_path, (bytes, bytearray, memoryview)):
        data = bytes(data_or_path)
    else:
        with open(data_or_path, "rb") as f:
            data = f.read()
    if data[:3] == b"\xff\xd8\xff":
        return _read_jpeg(data)
    if data[:8] != _SIGNATURE:
        raise NotImplementedError(
            f"image format {_describe(data)}: only PNG and JPEG are decoded")
    return _read_png(data)


def _read_png(data: bytes) -> np.ndarray:
    pos, idat, header, palette, trns = 8, [], None, None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    fmt = (f"PNG {_COLOR_NAMES.get(color, f'colour type {color}')}, "
           f"{depth}-bit{', interlaced' if interlace else ''}")
    ok_depth = depth in (1, 2, 4, 8) if color == 3 else depth in (8, 16)
    if color not in _CHANNELS or not ok_depth or interlace not in (0, 1):
        raise NotImplementedError(
            f"{fmt}: only 8/16-bit gray/gray+alpha/RGB/RGBA and 1/2/4/8-bit "
            "palette PNGs are decoded")
    c = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        img = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:   # an empty pass has no bytes at all
                img[y0::dy, x0::dx], pos = _samples(raw, pos, pw, ph, c,
                                                    depth)
    else:
        img, _ = _samples(raw, 0, w, h, c, depth)
    if depth == 16:
        if color == 0:   # PIL: "I;16" -> "RGBA" clips the gray at 255
            g = np.minimum(img, 255).astype(np.uint8)
            return np.concatenate([g, g, g, np.full_like(g, 255)], axis=-1)
        img = (img >> 8).astype(np.uint8)   # PIL keeps the high bytes
    if color == 3:
        lut = np.full((256, 4), 255, np.uint8)
        lut[:palette.shape[0], :3] = palette
        if trns is not None:
            lut[:trns.shape[0], 3] = trns
        return lut[img[..., 0]]
    if color == 4:   # gray + alpha -> RGBA
        return np.concatenate([img[..., :1].repeat(3, axis=-1), img[..., 1:]],
                              axis=-1)
    return img if c > 1 else img.reshape(h, w)


# -- baseline JPEG ---------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63], np.int64)   # zigzag index -> natural index
_SOF_NAMES = {0xC3: "lossless", 0xC5: "differential",
              0xC6: "differential progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless",
              0xCD: "arithmetic-coded differential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


def _huffman_lut(counts, symbols) -> np.ndarray:
    """A DHT table -> i32[65536]: the next 16 bits -> (code length << 8 |
    symbol), 0 where no code matches."""
    lut = np.zeros(65536, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut


def _decode_segment(seg: bytes, comps, blocks, mcus, dc_pred, dc_luts,
                    ac_luts, mcu_layout, single, bpr):
    """Huffman-decode the MCUs ``mcus`` of one restart interval from the
    byte-unstuffed ``seg`` into ``blocks`` (per component i32[nby, nbx,
    64], natural order)."""
    buf = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.int64)
    words = ((buf[:-3] << 24) | (buf[1:-2] << 16) | (buf[2:-1] << 8)
             | buf[3:]).tolist()
    nbits = len(seg) * 8
    pos = 0
    zz = _ZIGZAG.tolist()

    def peek16(p):
        return (words[p >> 3] >> (16 - (p & 7))) & 0xFFFF

    def receive(p, s):   # s bits at p -> the sign-extended value
        v = (words[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    for mcu in mcus:
        for ci, by_off, bx_off in mcu_layout:
            if single:
                by, bx = divmod(mcu, bpr)
            else:
                my, mx = divmod(mcu, bpr)
                h, v = comps[ci]["h"], comps[ci]["v"]
                by, bx = my * v + by_off, mx * h + bx_off
            blk = [0] * 64
            e = dc_luts[ci][peek16(pos)]
            if e == 0 or pos > nbits + 64:
                raise ValueError("corrupt JPEG: bad Huffman code")
            pos += e >> 8
            s = e & 0xFF
            if s:
                dc_pred[ci] += receive(pos, s)
                pos += s
            blk[0] = dc_pred[ci]
            ac = ac_luts[ci]
            k = 1
            while k < 64:
                e = ac[peek16(pos)]
                if e == 0:
                    raise ValueError("corrupt JPEG: bad Huffman code")
                pos += e >> 8
                rs = e & 0xFF
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    blk[zz[k]] = receive(pos, s)
                    pos += s
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            blocks[ci][by, bx] = blk


class _Bits:
    """An MSB-first bit reader over one unstuffed restart interval; past
    its end it reads zeros, as libjpeg's fill does."""

    def __init__(self, seg: bytes):
        buf = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.int64)
        self.words = ((buf[:-3] << 24) | (buf[1:-2] << 16) | (buf[2:-1] << 8)
                      | buf[3:]).tolist()
        self.nbits = len(seg) * 8
        self.pos = 0

    def huff(self, lut):
        p = self.pos
        e = lut[(self.words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if e == 0 or p > self.nbits + 64:
            raise ValueError("corrupt JPEG: bad Huffman code")
        self.pos = p + (e >> 8)
        return e & 0xFF

    def bits(self, s):
        """s raw bits (s <= 16) as an unsigned value."""
        if s == 0:
            return 0
        p = self.pos
        self.pos = p + s
        return (self.words[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)

    def extend(self, s):
        """s bits as JPEG's sign-extended magnitude category value."""
        v = self.bits(s)
        return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _decode_progressive(seg: bytes, comps, blocks, mcus, dc_pred, dc_luts,
                        ac_luts, mcu_layout, single, bpr, spectral):
    """One restart interval of a progressive scan (libjpeg's ``jdphuff.c``:
    DC first / refine, AC first / refine with end-of-band runs) added into
    ``blocks`` (coefficients, natural order, not yet dequantized)."""
    ss, se, ah, al = spectral
    rd = _Bits(seg)
    zz = _ZIGZAG.tolist()
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    for mcu in mcus:
        for ci, by_off, bx_off in mcu_layout:
            if single:
                by, bx = divmod(mcu, bpr)
            else:
                my, mx = divmod(mcu, bpr)
                by = my * comps[ci]["v"] + by_off
                bx = mx * comps[ci]["h"] + bx_off
            blk = blocks[ci][by, bx]
            if ss == 0:                           # DC scans
                if ah == 0:
                    dc_pred[ci] += rd.extend(rd.huff(dc_luts[ci]))
                    blk[0] = dc_pred[ci] * p1
                elif rd.bits(1):
                    blk[0] |= p1
                continue
            ac = ac_luts[ci]
            if ah == 0:                           # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = rd.huff(ac)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[zz[k]] = rd.extend(s) * p1
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + rd.bits(r) - 1
                        break
                    k += 1
                continue
            k = ss                                # AC refine
            coef = blk.tolist()
            if eobrun == 0:
                while k <= se:
                    rs = rd.huff(ac)
                    r, s = rs >> 4, rs & 15
                    if s:               # a newly nonzero coefficient, +-1
                        s = p1 if rd.bits(1) else m1
                    elif r != 15:
                        eobrun = (1 << r) + rd.bits(r)
                        break
                    while k <= se:      # skip r zeros, refining the others
                        c = coef[zz[k]]
                        if c:
                            if rd.bits(1) and not c & p1:
                                coef[zz[k]] = c + (p1 if c >= 0 else m1)
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if s and k <= se:
                        coef[zz[k]] = s
                    k += 1
            if eobrun:      # the band's rest: correction bits only
                while k <= se:
                    c = coef[zz[k]]
                    if c and rd.bits(1) and not c & p1:
                        coef[zz[k]] = c + (p1 if c >= 0 else m1)
                    k += 1
                eobrun -= 1
            blk[:] = coef


def _idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg's accurate integer IDCT (``jidctint.c``, CONST_BITS 13,
    PASS1_BITS 2) of i32[N, 64] coefficient blocks (natural order) with the
    quantization table q i32[64] -> u8[N, 8, 8], range-limited as libjpeg
    does (``x & 1023`` into its post-IDCT table)."""
    c = coef.astype(np.int64).reshape(-1, 8, 8) * q.astype(np.int64).reshape(8, 8)

    def one_d(r0, r1, r2, r3, r4, r5, r6, r7):
        z1 = (r2 + r6) * 4433
        tmp2 = z1 + r6 * -15137
        tmp3 = z1 + r2 * 6270
        tmp0 = (r0 + r4) << 13
        tmp1 = (r0 - r4) << 13
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        o0, o1, o2, o3 = r7, r5, r3, r1
        z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
        z5 = (z3 + z4) * 9633
        o0, o1, o2, o3 = o0 * 2446, o1 * 16819, o2 * 25172, o3 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
        return (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                t13 - o0, t12 - o1, t11 - o2, t10 - o3)

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    # pass 1: columns (c[:, row, col]: input rows are frequencies in y)
    cols = one_d(*(c[:, i, :] for i in range(8)))
    ws = np.stack([descale(v, 11) for v in cols], axis=1)    # [N, 8, 8]
    rows = one_d(*(ws[:, :, i] for i in range(8)))
    out = np.stack([descale(v, 18) for v in rows], axis=2)   # [N, 8, 8]
    return _RANGE_LIMIT[out & 1023]


def _post_idct_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit (``prepare_range_limit_table``),
    indexed by the descaled value & 1023."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(0, 128)
    return t


_RANGE_LIMIT = _post_idct_table()


def _ycc_tables():
    """``jdcolor.c``'s build_ycc_rgb_table: Cr->R, Cb->B, Cr->G, Cb->G."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)   # noqa: E731
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


def _upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """``jdsample.c``'s "fancy" upsampling of a u8 [h, w] component by
    (fx, fy) in {(1, 1), (2, 1), (2, 2)}: the triangle filter with the
    edges replicated, or plain replication where the component is 2
    samples wide or less (libjpeg's rule)."""
    p = plane.astype(np.int64)
    h, w = p.shape
    if (fx, fy) == (1, 1):
        return plane
    if w <= 2:
        return np.repeat(np.repeat(plane, fx, axis=1), fy, axis=0)
    if fy == 1:   # h2v1: 3/4 nearer + 1/4 further, biases 1 and 2
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        out = np.empty((h, w, 2), np.int64)
        out[..., 0] = (3 * p + left + 1) >> 2
        out[..., 1] = (3 * p + right + 2) >> 2
        return out.reshape(h, 2 * w).astype(np.uint8)
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((h, 2, w, 2), np.int64)
    for dy, far in ((0, above), (1, below)):
        cs = 3 * p + far                                  # column sums
        last = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        nxt = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        out[:, dy, :, 0] = (3 * cs + last + 8) >> 4
        out[:, dy, :, 1] = (3 * cs + nxt + 7) >> 4
    return out.reshape(2 * h, 2 * w).astype(np.uint8)


def _read_jpeg(data: bytes) -> np.ndarray:
    qt, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart, adobe, jfif = None, 0, None, False
    progressive = False
    comps = []
    blocks = None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: expected a marker")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:          # fill byte
            pos -= 1
            continue
        if marker == 0xD9:          # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _SOF_NAMES:
            raise NotImplementedError(
                f"{_SOF_NAMES[marker]} JPEG: only baseline and progressive "
                "(SOF0/SOF1/SOF2, Huffman, 8-bit) JPEGs are decoded")
        if marker in (0xC0, 0xC1, 0xC2):
            progressive = marker == 0xC2
            precision, hgt, wid, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(
                    f"{precision}-bit JPEG: only 8-bit samples are decoded")
            if nc not in (1, 3):
                raise NotImplementedError(
                    f"JPEG with {nc} components: only gray and 3-component "
                    "JPEGs are decoded")
            comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4,
                          v=body[7 + 3 * i] & 15, tq=body[8 + 3 * i])
                     for i in range(nc)]
            frame = (wid, hgt)
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
            blocks = [np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int32)
                      for c in comps]
        elif marker == 0xC4:        # DHT
            i = 0
            while i < len(body):
                tc_th = body[i]
                counts = list(body[i + 1:i + 17])
                n = sum(counts)
                lut = _huffman_lut(counts, list(body[i + 17:i + 17 + n]))
                (ac_tabs if tc_th >> 4 else dc_tabs)[tc_th & 15] = lut
                i += 17 + n
        elif marker == 0xCC:
            raise NotImplementedError(
                "arithmetic-coded JPEG: only Huffman JPEGs are decoded")
        elif marker == 0xDB:        # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n],
                                     ">u2" if pq else np.uint8)
                tab = np.zeros(64, np.int32)
                tab[_ZIGZAG] = vals
                qt[tq] = tab
                i += 1 + n
        elif marker == 0xDD:        # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe = body[11] if len(body) > 11 else None
        elif marker == 0xDA:        # SOS: the entropy-coded data follows
            if frame is None:
                raise ValueError("corrupt JPEG: scan before frame header")
            ns = body[0]
            sel = []
            for i in range(ns):
                cid, tdta = body[1 + 2 * i], body[2 + 2 * i]
                ci = next(k for k, c in enumerate(comps) if c["id"] == cid)
                sel.append((ci, tdta >> 4, tdta & 15))
                # libjpeg latches a component's table at its first scan
                comps[ci].setdefault("q", qt[comps[ci]["tq"]].copy())
            ss, se, ahl = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            end = pos
            while True:             # the scan runs to the next non-RST marker
                end = data.index(b"\xff", end)
                nxt = data[end + 1]
                if nxt == 0 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
                    end += 1 if nxt == 0xFF else 2
                    continue
                break
            spectral = (ss, se, ahl >> 4, ahl & 15) if progressive else None
            _decode_scan(data[pos:end], sel, comps, frame, blocks, dc_tabs,
                         ac_tabs, restart, spectral)
            pos = end
    if frame is None:
        raise ValueError("corrupt JPEG: no frame header")
    if progressive:
        for c in comps:
            if c.get("done", 0) != (1 << 64) - 1:
                raise NotImplementedError(
                    "progressive JPEG whose scans leave coefficients "
                    "unfinished (libjpeg's block smoothing): only complete "
                    "progressive JPEGs are decoded")
    return _jpeg_pixels(comps, frame, blocks, qt, adobe, jfif)


def _decode_scan(scan: bytes, sel, comps, frame, blocks, dc_tabs, ac_tabs,
                 restart, spectral=None):
    """One scan's entropy-coded data (restart markers included) into
    ``blocks``; ``spectral`` = (Ss, Se, Ah, Al) of a progressive scan, whose
    coefficients it adds to the blocks' (None: a baseline scan)."""
    wid, hgt = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    single = len(sel) == 1
    if single:   # a non-interleaved scan: MCU = one block of the component
        c = comps[sel[0][0]]
        bpr = -(-(-(-wid * c["h"] // hmax)) // 8)
        rows = -(-(-(-hgt * c["v"] // vmax)) // 8)
        n_mcus = bpr * rows
        layout = [(sel[0][0], 0, 0)]
    else:
        bpr = -(-wid // (8 * hmax))
        n_mcus = bpr * -(-hgt // (8 * vmax))
        layout = [(ci, by, bx) for ci, _, _ in sel
                  for by in range(comps[ci]["v"])
                  for bx in range(comps[ci]["h"])]
    # a progressive scan reads only its own kind of table: DC first scans
    # the DC ones, AC scans the AC ones, DC refinements none
    ss, se, ah, _ = spectral or (0, 63, 0, 0)
    dc_luts = ({ci: dc_tabs[td].tolist() for ci, td, _ in sel}
               if ss == 0 and ah == 0 else {})
    ac_luts = {ci: ac_tabs[ta].tolist() for ci, _, ta in sel} if se else {}
    # split at the restart markers, then unstuff 0xFF00 -> 0xFF
    segs, start, i = [], 0, 0
    while True:
        i = scan.find(b"\xff", i)
        if i < 0 or i + 1 >= len(scan):
            break
        if 0xD0 <= scan[i + 1] <= 0xD7:
            segs.append(scan[start:i])
            start = i + 2
        i += 2
    segs.append(scan[start:])
    per = restart if restart else n_mcus
    if spectral is not None:
        ss, se, ah, al = spectral
        if ss > se or se > 63 or (ss == 0) != (se == 0) or (ss and not single):
            raise ValueError("corrupt JPEG: bad progressive scan parameters")
        bits = ((1 << (se + 1)) - 1) ^ ((1 << ss) - 1)
        for ci, _, _ in sel:    # the coefficients finished at Al = 0
            if al == 0:
                comps[ci]["done"] = comps[ci].get("done", 0) | bits
    for k, seg in enumerate(segs):
        mcus = range(k * per, min(n_mcus, (k + 1) * per))
        if not mcus:
            break
        dc_pred = {ci: 0 for ci, _, _ in sel}
        seg = seg.replace(b"\xff\x00", b"\xff")
        if spectral is None:
            _decode_segment(seg, comps, blocks, mcus, dc_pred, dc_luts,
                            ac_luts, layout, single, bpr)
        else:
            _decode_progressive(seg, comps, blocks, mcus, dc_pred, dc_luts,
                                ac_luts, layout, single, bpr, spectral)


def _jpeg_pixels(comps, frame, blocks, qt, adobe, jfif) -> np.ndarray:
    """Dequantize + IDCT every block, upsample the chroma, convert to RGB:
    u8 [H, W, 3], or [H, W] for gray."""
    wid, hgt = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for c, blk in zip(comps, blocks):
        nby, nbx, _ = blk.shape
        pix = _idct_islow(blk.reshape(-1, 64), c.get("q", qt[c["tq"]]))
        pix = pix.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(
            nby * 8, nbx * 8)
        cw, ch = -(-wid * c["h"] // hmax), -(-hgt * c["v"] // vmax)
        fx, fy = hmax // c["h"], vmax // c["v"]
        if (fx, fy) not in ((1, 1), (2, 1), (2, 2)) or hmax % c["h"] \
                or vmax % c["v"]:
            raise NotImplementedError(
                f"JPEG with {hmax}x{vmax} / {c['h']}x{c['v']} sampling: only "
                "4:4:4, 4:2:2 and 4:2:0 are decoded")
        planes.append(_upsample(pix[:ch, :cw], fx, fy)[:hgt, :wid])
    if len(comps) == 1:
        return planes[0]
    ids = tuple(c["id"] for c in comps)
    # libjpeg's guess (jdapimin.c): JFIF is YCbCr; else Adobe's transform
    # flag; else the component ids 'R', 'G', 'B' mean RGB
    rgb = not jfif and (adobe == 0 if adobe is not None
                        else ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, axis=-1)
    y, cb, cr = (p.astype(np.int64) for p in planes)
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
