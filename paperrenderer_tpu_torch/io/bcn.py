"""Block-compressed texture decoding (BC1-BC7) for ``io.dds``, with numpy
only, vectorised over the blocks.

Decodes each block as Pillow 12's ``BcnDecode.c`` does, to the bit:

  * BC1 (DXT1): the 5-6-5 endpoints widened by bit replication; four
    colours when c0 > c1 (thirds, truncated), else three and a transparent
    black; BC2 (DXT3) and BC3 (DXT5) always take the four colours;
  * BC2's 4-bit alphas times 17; BC3's and BC4's alpha blocks (eight
    sevenths, truncated, when a0 > a1, else six fifths, 0 and 255);
  * BC5: two such blocks as red and green (blue 0); BC5S reads the
    endpoints as signed bytes biased by 128 and fills blue with 128;
  * BC6H, unsigned (UF16) and signed (SF16): the 14 modes' endpoint
    layouts, deltas, unquantization and interpolation of the format (the
    signed modes' endpoint sums left masked, as Pillow leaves them), each
    half then turned into a byte as Pillow does: clamped to [0, 1] and
    truncated after a float32 multiply by 255; the reserved modes are
    black;
  * BC7: the eight modes with their 2- and 3-subset partitions, anchor
    indices, p-bits, rotation and index selection; a block whose first
    byte is 0 (no mode) is opaque black.

``decode(kind, payload, w, h)`` returns the w x h image: [H, W] for BC4,
[H, W, 3] for BC5/BC6H and [H, W, 4] for the others. Sizes that are not
multiples of 4 are cropped from whole blocks.
"""

from __future__ import annotations

import numpy as np

# bytes a block, channels out
BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}

# 2-subset partitions, one bit a pixel (BC6H uses the first 32)
_P2 = (0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
       0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
       0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
       0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
       0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
       0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
       0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
       0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22)
# 3-subset partitions, the pixels' subsets row by row
_P3 = """
0011001102212222 0001001122112221 0000200122112211 0222002200110111
0000000011221122 0011001100220022 0022002211111111 0011001122112211
0000000011112222 0000111111112222 0000111122222222 0012001200120012
0112011201120112 0122012201220122 0011011211221222 0011200122002220
0001001101121122 0111001120012200 0000112211221122 0022002200221111
0111011102220222 0001000122212221 0000001101220122 0000110022102210
0122012200110000 0012001211222222 0110122112210110 0000011012211221
0022110211020022 0110011020022222 0011012201220011 0000200022112221
0000000211221222 0222002200120011 0011001200220222 0120012001200120
0000111122220000 0120120120120120 0120201212010120 0011220011220011
0011112222000011 0101010122222222 0000000021212121 0022112200221122
0022001100220011 0220122102201221 0101222222220101 0000212121212121
0101010101012222 0222011102220111 0002111200021112 0000211221122112
0222011101110222 0002111211120002 0110011001102222 0000000021122112
0110011022222222 0022001100110022 0022112211220022 0000000000002112
0002000100020001 0222122202221222 0101222222222222 0111201122012220
"""
# anchor pixels: the second subset of two, the second and third of three
_A2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
       15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
       15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
       6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_A3B = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
        3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
        8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
        3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_A3C = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
        15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
        15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
        15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
_WEIGHTS = {2: np.array([0, 21, 43, 64]),
            3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
            4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51,
                         55, 60, 64])}


def _subsets() -> dict:
    """Partition index -> the 16 pixels' subsets, for 1, 2 and 3 subsets."""
    two = (np.array(_P2)[:, None] >> np.arange(16)) & 1
    three = np.array([[int(c) for c in row] for row in _P3.split()])
    return {1: np.zeros((64, 16), np.int64), 2: two, 3: three}


_SUBSETS = _subsets()


def _anchors(ns: int, partition: np.ndarray, subset: np.ndarray) -> np.ndarray:
    """[n, 16] True where a pixel's index has one bit less: pixel 0, and
    the anchors of the other subsets (Pillow's tests, in its order)."""
    i = np.arange(16)
    out = np.broadcast_to(i == 0, subset.shape).copy()
    if ns == 2:
        out |= i == np.array(_A2)[partition][:, None]
    elif ns == 3:
        out |= (subset == 1) & (i == np.array(_A3B)[partition][:, None])
        out |= (subset == 2) & (i == np.array(_A3C)[partition][:, None])
    return out


class _Bits:
    """The blocks' bits, least significant first: [n, 128]."""

    def __init__(self, blocks: np.ndarray):
        self.bits = np.unpackbits(blocks, axis=1, bitorder="little").astype(
            np.int64)
        self.rows = np.arange(len(blocks))

    def take(self, start, count, per_block=False):
        """Fields of ``count`` bits at ``start`` -> int64 [n, ...]: the
        same fields in every block, or ``per_block`` arrays [n, ...]."""
        start, count = np.broadcast_arrays(np.asarray(start, np.int64),
                                           np.asarray(count, np.int64))
        if not per_block:
            start = np.broadcast_to(start, (len(self.rows),) + start.shape)
            count = np.broadcast_to(count, start.shape)
        k = np.arange(max(int(count.max()) if count.size else 0, 1))
        pos = np.minimum(start[..., None] + k, 127)
        rows = self.rows.reshape((-1,) + (1,) * (pos.ndim - 1))
        v = self.bits[rows, pos] * (k < count[..., None])
        return (v << k).sum(-1)


def _alpha8(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """BC3 / BC4 alpha blocks [n, 8] -> [n, 16] bytes."""
    b = blocks.astype(np.int64)
    a0, a1 = b[:, 0], b[:, 1]
    if signed:   # signed bytes biased by 128
        a0, a1 = a0 ^ 128, a1 ^ 128
    big = (a0 > a1)[:, None]
    k = np.arange(1, 7)
    seven = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    k5 = np.arange(1, 5)
    five = ((5 - k5) * a0[:, None] + k5 * a1[:, None]) // 5
    five = np.concatenate([five, np.zeros_like(five[:, :1]),
                           np.full_like(five[:, :1], 255)], 1)
    table = np.concatenate([a0[:, None], a1[:, None],
                            np.where(big, seven, five)], 1)
    lut = b[:, 2:5] @ (1 << 8 * np.arange(3))
    lut2 = b[:, 5:8] @ (1 << 8 * np.arange(3))
    sel = np.concatenate([(lut[:, None] >> 3 * np.arange(8)) & 7,
                          (lut2[:, None] >> 3 * np.arange(8)) & 7], 1)
    return np.take_along_axis(table, sel, 1).astype(np.uint8)


def _bc1(blocks: np.ndarray, four: bool) -> np.ndarray:
    """BC1 colour blocks [n, 8] -> [n, 16, 4] RGBA; ``four``: always four
    colours (BC2 / BC3)."""
    b = blocks.astype(np.int64)
    c0, c1 = b[:, 0] | b[:, 1] << 8, b[:, 2] | b[:, 3] << 8

    def rgb(c):
        r = (c & 0xF800) >> 8
        g = (c & 0x7E0) >> 3
        bl = (c & 0x1F) << 3
        return np.stack([r | r >> 5, g | g >> 6, bl | bl >> 5], -1)

    p0, p1 = rgb(c0), rgb(c1)
    opaque = np.full(len(b), 255)
    split = np.ones(len(b), bool) if four else c0 > c1
    p2 = np.where(split[:, None], (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(split[:, None], (p0 + 2 * p1) // 3, 0)
    pal = np.stack([np.concatenate([p, a[:, None]], 1) for p, a in (
        (p0, opaque), (p1, opaque), (p2, opaque),
        (p3, np.where(split, 255, 0)))], 1)
    lut = b[:, 4:8] @ (1 << 8 * np.arange(4))
    sel = (lut[:, None] >> 2 * np.arange(16)) & 3
    return np.take_along_axis(pal, sel[..., None], 1).astype(np.uint8)


def _bc7(blocks: np.ndarray) -> np.ndarray:
    """BC7 blocks [n, 16] -> [n, 16, 4] RGBA."""
    out = np.zeros((len(blocks), 16, 4), np.uint8)
    out[..., 3] = 255                       # no mode: opaque black
    first = blocks[:, 0].astype(np.int64)
    low = first & -first
    mode_of = np.where(first > 0, np.log2(np.maximum(low, 1)).astype(int), 8)
    # ns, partition bits, rotation bits, index-selection bits, colour
    # bits, alpha bits, p-bit per endpoint, p-bit per subset, index bits,
    # second index bits
    modes = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
             (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
             (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
             (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
    for mode, (ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2) in enumerate(modes):
        sel = np.nonzero(mode_of == mode)[0]
        if not sel.size:
            continue
        bits = _Bits(blocks[sel])
        n, bit = len(sel), mode + 1
        partition = bits.take(bit, pb)
        rotation = bits.take(bit + pb, rb)
        index_sel = bits.take(bit + pb + rb, isb)
        bit += pb + rb + isb
        numep = 2 * ns
        ep = np.full((n, numep, 4), 255, np.int64)
        for c in range(3):
            ep[:, :, c] = bits.take(bit + cb * np.arange(numep), cb)
            bit += cb * numep
        if ab:
            ep[:, :, 3] = bits.take(bit + ab * np.arange(numep), ab)
            bit += ab * numep
        chans = 4 if ab else 3
        if epb:
            p = bits.take(bit + np.arange(numep), 1)
            bit += numep
        elif spb:
            p = np.repeat(bits.take(bit + np.arange(ns), 1), 2, axis=1)
            bit += ns
        if epb or spb:
            ep[:, :, :chans] = ep[:, :, :chans] << 1 | p[..., None]
            cb, ab = cb + 1, ab + 1 if ab else 0
        for c in range(chans):   # widened by bit replication
            width = cb if c < 3 else ab
            v = (ep[..., c] << (8 - width)) & 0xFF
            ep[..., c] = v | v >> width
        subset = _SUBSETS[ns][partition]
        anchor = _anchors(ns, partition, subset)
        widths = ib - anchor
        starts = bit + np.cumsum(widths, 1) - widths
        i0 = bits.take(starts, widths, True)
        cw = _WEIGHTS[ib][i0]
        if ab and ib2:
            w2 = ib2 - (np.arange(16) == 0)
            astart = bit + 16 * ib - ns + np.cumsum(w2) - w2
            i1 = bits.take(astart, w2)
            aw = _WEIGHTS[ib2][i1]
            swap = index_sel[:, None] == 1
            s_col, s_alpha = np.where(swap, aw, cw), np.where(swap, cw, aw)
        else:
            s_col = s_alpha = cw
        e0 = np.take_along_axis(ep, 2 * subset[..., None], 1)
        e1 = np.take_along_axis(ep, 2 * subset[..., None] + 1, 1)
        s = np.concatenate([np.repeat(s_col[..., None], 3, -1),
                            s_alpha[..., None]], -1)
        px = ((64 - s) * e0 + s * e1 + 32) >> 6
        for r in (1, 2, 3):   # rotation r swaps channel r - 1 with alpha
            m = rotation == r
            px[m, :, r - 1], px[m, :, 3] = px[m, :, 3], px[m, :, r - 1].copy()
        out[sel] = px.astype(np.uint8)
    return out


# BC6H: (regions, transformed, endpoint bits, delta bits r, g, b) of the 14
# modes, numbered as Pillow numbers them (mode bits 00, 01, then the
# five-bit 10xxx and 11xxx codes)
_BC6_MODES = ((2, 1, 10, 5, 5, 5), (2, 1, 7, 6, 6, 6), (2, 1, 11, 5, 4, 4),
              (2, 1, 11, 4, 5, 4), (2, 1, 11, 4, 4, 5), (2, 1, 9, 5, 5, 5),
              (2, 1, 8, 6, 5, 5), (2, 1, 8, 5, 6, 5), (2, 1, 8, 5, 5, 6),
              (2, 0, 6, 6, 6, 6), (1, 0, 10, 10, 10, 10),
              (1, 1, 11, 9, 9, 9), (1, 1, 12, 8, 8, 8), (1, 1, 16, 4, 4, 4))
# the endpoint bits of each mode in stream order, after its mode bits:
# "word:first:last" runs from the word's bit first to its bit last
_BC6_LAYOUT = (
    "g2:4 b2:4 b3:4 r0:0:9 g0:0:9 b0:0:9 r1:0:4 g3:4 g2:0:3 g1:0:4 b3:0 "
    "g3:0:3 b1:0:4 b3:1 b2:0:3 r2:0:4 b3:2 r3:0:4 b3:3",
    "g2:5 g3:4 g3:5 r0:0:6 b3:0 b3:1 b2:4 g0:0:6 b2:5 b3:2 g2:4 b0:0:6 "
    "b3:3 b3:5 b3:4 r1:0:5 g2:0:3 g1:0:5 g3:0:3 b1:0:5 b2:0:3 r2:0:5 "
    "r3:0:5",
    "r0:0:9 g0:0:9 b0:0:9 r1:0:4 r0:10 g2:0:3 g1:0:3 g0:10 b3:0 g3:0:3 "
    "b1:0:3 b0:10 b3:1 b2:0:3 r2:0:4 b3:2 r3:0:4 b3:3",
    "r0:0:9 g0:0:9 b0:0:9 r1:0:3 r0:10 g3:4 g2:0:3 g1:0:4 g0:10 g3:0:3 "
    "b1:0:3 b0:10 b3:1 b2:0:3 r2:0:3 b3:0 b3:2 r3:0:3 g2:4 b3:3",
    "r0:0:9 g0:0:9 b0:0:9 r1:0:3 r0:10 b2:4 g2:0:3 g1:0:3 g0:10 b3:0 "
    "g3:0:3 b1:0:4 b0:10 b2:0:3 r2:0:3 b3:1 b3:2 r3:0:3 b3:4 b3:3",
    "r0:0:8 b2:4 g0:0:8 g2:4 b0:0:8 b3:4 r1:0:4 g3:4 g2:0:3 g1:0:4 b3:0 "
    "g3:0:3 b1:0:4 b3:1 b2:0:3 r2:0:4 b3:2 r3:0:4 b3:3",
    "r0:0:7 g3:4 b2:4 g0:0:7 b3:2 g2:4 b0:0:7 b3:3 b3:4 r1:0:5 g2:0:3 "
    "g1:0:4 b3:0 g3:0:3 b1:0:4 b3:1 b2:0:3 r2:0:5 r3:0:5",
    "r0:0:7 b3:0 b2:4 g0:0:7 g2:5 g2:4 b0:0:7 g3:5 b3:4 r1:0:4 g3:4 "
    "g2:0:3 g1:0:5 g3:0:3 b1:0:4 b3:1 b2:0:3 r2:0:4 b3:2 r3:0:4 b3:3",
    "r0:0:7 b3:1 b2:4 g0:0:7 b2:5 g2:4 b0:0:7 b3:5 b3:4 r1:0:4 g3:4 "
    "g2:0:3 g1:0:4 b3:0 g3:0:3 b1:0:5 b2:0:3 r2:0:4 b3:2 r3:0:4 b3:3",
    "r0:0:5 g3:4 b3:0 b3:1 b2:4 g0:0:5 g2:5 b2:5 b3:2 g2:4 b0:0:5 g3:5 "
    "b3:3 b3:5 b3:4 r1:0:5 g2:0:3 g1:0:5 g3:0:3 b1:0:5 b2:0:3 r2:0:5 "
    "r3:0:5",
    "r0:0:9 g0:0:9 b0:0:9 r1:0:9 g1:0:9 b1:0:9",
    "r0:0:9 g0:0:9 b0:0:9 r1:0:8 r0:10 g1:0:8 g0:10 b1:0:8 b0:10",
    "r0:0:9 g0:0:9 b0:0:9 r1:0:7 r0:11:10 g1:0:7 g0:11:10 b1:0:7 b0:11:10",
    "r0:0:9 g0:0:9 b0:0:9 r1:0:3 r0:15:10 g1:0:3 g0:15:10 b1:0:3 b0:15:10")


def _bc6_packing(layout: str) -> np.ndarray:
    """A layout string -> [bits, 2]: (endpoint word r0 g0 b0 r1 ... b3,
    bit) of each stream bit."""
    out = []
    for field in layout.split():
        name, *span = field.split(":")
        word = 3 * int(name[1]) + "rgb".index(name[0])
        first, last = int(span[0]), int(span[-1])
        step = 1 if last >= first else -1
        out += [(word, b) for b in range(first, last + step, step)]
    return np.array(out)


_BC6_PACKINGS = [_bc6_packing(s) for s in _BC6_LAYOUT]


def _sign_extend(v, bits):
    bits = np.asarray(bits)
    return np.where(v & (1 << (bits - 1)), v | (-1 << bits), v)


def _bc6(blocks: np.ndarray, signed: bool) -> np.ndarray:
    """BC6H blocks [n, 16] -> [n, 16, 3] bytes."""
    out = np.zeros((len(blocks), 16, 3), np.uint8)
    code = blocks[:, 0].astype(np.int64) & 0x1F
    low = code & 3
    mode_of = np.where(low < 2, low, np.where(low == 2, 2 + (code >> 2),
                                              10 + (code >> 2)))
    for mode, (ns, tr, epb, rb, gb, bb) in enumerate(_BC6_MODES):
        sel = np.nonzero(mode_of == mode)[0]
        if not sel.size:
            continue
        bits = _Bits(blocks[sel])
        n = len(sel)
        bit = 2 if mode < 2 else 5
        packing = _BC6_PACKINGS[mode]
        ep = np.zeros((n, 12), np.int64)
        stream = bits.bits[:, bit:bit + len(packing)]
        np.add.at(ep.T, packing[:, 0], (stream << packing[:, 1]).T)
        bit += len(packing)
        pb = 5 if ns == 2 else 0
        partition = bits.take(bit, pb)
        bit += pb
        numep = 6 * ns
        ep = ep[:, :numep]
        if signed:
            ep[:, :3] = _sign_extend(ep[:, :3], epb)
        delta = np.tile([rb, gb, bb], numep // 3 - 1)
        if signed or tr:
            ep[:, 3:] = _sign_extend(ep[:, 3:], delta)
        if tr:
            mask = (1 << epb) - 1
            # the sums stay masked, unsigned, in the signed modes too (as
            # Pillow leaves them: no sign extension after the deltas)
            ep[:, 3:] = (ep[:, 3:] + np.tile(ep[:, :3], numep // 3 - 1)) \
                & mask
        ep = _unquantize(ep, epb, signed)
        subset = _SUBSETS[ns][partition]
        ib = 3 if ns == 2 else 4
        anchor = _anchors(ns, partition, subset)
        widths = ib - anchor
        starts = bit + np.cumsum(widths, 1) - widths
        s = _WEIGHTS[ib][bits.take(starts, widths, True)][..., None]
        e = ep.reshape(n, ns * 2, 3)
        e0 = np.take_along_axis(e, 2 * subset[..., None], 1)
        e1 = np.take_along_axis(e, 2 * subset[..., None] + 1, 1)
        out[sel] = _half_byte((e0 * (64 - s) + e1 * s) >> 6, signed)
    return out


def _unquantize(x, prec, signed):
    if not signed:
        if prec >= 15:
            return x
        top = (1 << prec) - 1
        return np.where(x == 0, 0, np.where(x == top, 0xFFFF,
                                             ((x << 15) + 0x4000) >>
                                             (prec - 1)))
    x = ((x & 0xFFFF) ^ 0x8000) - 0x8000        # the 16-bit word, signed
    if prec >= 16:
        return x
    a = np.abs(x)
    a = np.where(a == 0, 0, np.where(a >= (1 << (prec - 1)) - 1, 0x7FFF,
                                     ((a << 15) + 0x4000) >> (prec - 1)))
    return np.where(x < 0, -a, a)


def _half_byte(v, signed):
    """The interpolated values -> halfs (Pillow's ``bc6_finalize``) ->
    bytes: clamped to [0, 1], times 255 in float32, truncated."""
    if signed:
        h = np.where(v < 0, 0x8000 | ((-v) * 31) // 32, (v * 31) // 32)
    else:
        h = (v * 31) // 64
    f = (h & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    byte = np.where(f < 0, np.float32(0),
                    np.where(f > 1, np.float32(255), f * np.float32(255)))
    return byte.astype(np.uint8)


def decode(kind: int, payload: bytes, w: int, h: int, signed: bool = False
           ) -> np.ndarray:
    """The BC``kind`` blocks in ``payload`` (rows of ceil(w / 4) blocks)
    -> the w x h image; ``signed``: BC5S / BC6H SF16."""
    nbx, nby = (w + 3) // 4, (h + 3) // 4
    size = BLOCK_BYTES[kind]
    need = nbx * nby * size
    if len(payload) < need:
        raise NotImplementedError(
            f"DDS BC{kind}: truncated block data ({len(payload)} of {need} "
            "bytes)")
    blocks = np.frombuffer(payload, np.uint8, need).reshape(-1, size)
    if kind == 1:
        px = _bc1(blocks, False)
    elif kind == 2:
        px = _bc1(blocks[:, 8:], True)
        a = blocks[:, :8, None] >> np.array([0, 4], np.uint8) & 15
        px[..., 3] = a.reshape(-1, 16) * 17
    elif kind == 3:
        px = _bc1(blocks[:, 8:], True)
        px[..., 3] = _alpha8(blocks[:, :8])
    elif kind == 4:
        px = _alpha8(blocks)[..., None]
    elif kind == 5:
        px = np.full((len(blocks), 16, 3), 128 if signed else 0, np.uint8)
        px[..., 0] = _alpha8(blocks[:, :8], signed)
        px[..., 1] = _alpha8(blocks[:, 8:], signed)
    elif kind == 6:
        px = _bc6(blocks, signed)
    else:
        px = _bc7(blocks)
    c = px.shape[-1]
    img = px.reshape(nby, nbx, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(
        4 * nby, 4 * nbx, c)[:h, :w]
    return img[..., 0] if kind == 4 else img
