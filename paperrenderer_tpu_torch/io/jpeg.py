"""JPEG decoding for ``io.image.read_image``, with ``struct`` and numpy only.

Decodes what the JAX package's imaging library (PIL, libjpeg-turbo 3)
decodes, to the bit, by following libjpeg-turbo's integer paths:

  * sequential DCT (SOF0/SOF1), Huffman (``jdhuff.c``) or arithmetic-coded
    (SOF9, ``jdarith.c``: T.81's QM decoder, Table D.2's states, the DC
    and AC statistics bins under the ``DAC`` conditioning, zero fill after
    a marker); restart intervals (statistics reset at each);
  * progressive DCT (SOF2 Huffman as ``jdphuff.c``, SOF10 arithmetic):
    spectral selection, successive approximation of DC and AC, end-of-band
    runs; a file whose scans leave one of the first nine AC coefficients
    (or the DC) unfinished takes libjpeg-turbo 3's block smoothing
    (``jdcoefct.c``: ``smoothing_ok``, ``decompress_smooth_data``'s 5x5
    neighbourhood, DC interpolation when no AC is known);
  * lossless (SOF3, ``jdlossls.c`` / ``jddiffct.c`` / ``jdlhuff.c``):
    predictors 1-7 with the first-row and first-column rules (again after
    each restart), the point transform; subsampled planes replicated;
  * 8-bit samples, 1, 3 or 4 components, any sampling libjpeg accepts:
    ``jdsample.c``'s fancy h2v1 / h1v2 / h2v2 triangle filters where a
    component is more than 2 samples wide, box replication for the other
    integral ratios; the accurate integer IDCT (``jidctint.c``);
  * colour as libjpeg guesses it (``jdapimin.c``): gray; YCbCr (integer
    ``jdcolor.c`` tables) or RGB; CMYK or YCCK (Adobe transform 0 / 2,
    ``ycck_cmyk_convert``), then Pillow's inverted "CMYK;I" read and its
    CMYK -> RGBA conversion (``Convert.c`` ``cmyk2rgb``).

``read_jpeg`` raises NotImplementedError naming the form for what PIL
refuses too: 12- and 16-bit samples, hierarchical (SOF5-SOF7,
SOF13-SOF15) and arithmetic lossless (SOF11) JPEGs, other component
counts, non-integral sampling ratios.
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63], np.int64)   # zigzag index -> natural index
# SOF marker -> (entropy coding, process)
_SOF_MODES = {0xC0: ("huffman", "sequential"), 0xC1: ("huffman", "sequential"),
              0xC2: ("huffman", "progressive"), 0xC3: ("huffman", "lossless"),
              0xC9: ("arithmetic", "sequential"),
              0xCA: ("arithmetic", "progressive")}
_REFUSED_SOF = {0xC5: "hierarchical (differential sequential)",
                0xC6: "hierarchical (differential progressive)",
                0xC7: "hierarchical (differential lossless)",
                0xC8: "JPG-extension (SOF8)",
                0xCB: "arithmetic-coded lossless",
                0xCD: "arithmetic-coded hierarchical (differential sequential)",
                0xCE: "arithmetic-coded hierarchical (differential progressive)",
                0xCF: "arithmetic-coded hierarchical (differential lossless)"}
_SUPPORTED = ("baseline, extended, progressive and lossless Huffman and "
              "sequential and progressive arithmetic-coded 8-bit JPEGs are "
              "decoded")


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


def _block_at(mcu, comps, ci, by_off, bx_off, single, bpr):
    """The (block row, block column) of a component's block in an MCU."""
    if single:
        return divmod(mcu, bpr)
    my, mx = divmod(mcu, bpr)
    return my * comps[ci]["v"] + by_off, mx * comps[ci]["h"] + bx_off


# -- Huffman ---------------------------------------------------------------------

def _decode_segment(seg: bytes, comps, blocks, mcus, dc_pred, dc_luts,
                    ac_luts, mcu_layout, single, bpr):
    """Huffman-decode the MCUs ``mcus`` of one restart interval of a
    sequential scan from the byte-unstuffed ``seg`` into ``blocks`` (per
    component i32[nby, nbx, 64], natural order)."""
    buf = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.int64)
    words = ((buf[:-3] << 24) | (buf[1:-2] << 16) | (buf[2:-1] << 8)
             | buf[3:]).tolist()
    nbits = len(seg) * 8
    pos = 0
    zz = ZIGZAG.tolist()

    def peek16(p):
        return (words[p >> 3] >> (16 - (p & 7))) & 0xFFFF

    def receive(p, s):   # s bits at p -> the sign-extended value
        v = (words[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    for mcu in mcus:
        for ci, by_off, bx_off in mcu_layout:
            by, bx = _block_at(mcu, comps, ci, by_off, bx_off, single, bpr)
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
    """One restart interval of a progressive Huffman scan (libjpeg's
    ``jdphuff.c``: DC first / refine, AC first / refine with end-of-band
    runs) added into ``blocks`` (coefficients, natural order, not yet
    dequantized)."""
    ss, se, ah, al = spectral
    rd = _Bits(seg)
    zz = ZIGZAG.tolist()
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    for mcu in mcus:
        for ci, by_off, bx_off in mcu_layout:
            blk = blocks[ci][_block_at(mcu, comps, ci, by_off, bx_off, single,
                                       bpr)]
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


# -- arithmetic ------------------------------------------------------------------

# T.81 Table D.2 as libjpeg's jaricom.c holds it: (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS) per state; state 113 is the fixed 0.5
# estimate of the sign and refinement bins
_QE_TABLE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
QE = [q for q, _, _, _ in _QE_TABLE]
NEXT_LPS = [lps | switch << 7 for _, lps, _, switch in _QE_TABLE]
NEXT_MPS = [mps for _, _, mps, _ in _QE_TABLE]
FIXED_STATE = 113
DC_BINS, AC_BINS = 64, 256


def _arith_decoder(seg: bytes):
    """T.81's QM decoder over one unstuffed restart interval, as
    ``jdarith.c``'s ``arith_decode``; past the interval's end it reads
    zeros (libjpeg's fill after a marker). -> ``decode(bins, i)``: the
    decision coded with the statistics bin ``bins[i]`` (updated)."""
    data, n = seg, len(seg)
    c = a = pos = 0
    ct = -16                       # two bytes to read before the first
    qe, nl, nm = QE, NEXT_LPS, NEXT_MPS

    def decode(st, i):
        nonlocal c, a, ct, pos
        while a < 0x8000:          # renormalize, reading bytes (D.2.6)
            ct -= 1
            if ct < 0:
                c = (c << 8) | (data[pos] if pos < n else 0)
                pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        s = sv & 0x7F
        q = qe[s]
        a -= q
        temp = a << ct
        if c >= temp:              # the LPS interval, or an exchange
            c -= temp
            if a < q:
                a = q
                st[i] = (sv & 0x80) ^ nm[s]
            else:
                a = q
                st[i] = (sv & 0x80) ^ nl[s]
                sv ^= 0x80
        elif a < 0x8000:
            if a < q:
                st[i] = (sv & 0x80) ^ nl[s]
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm[s]
        return sv >> 7

    return decode


def _arith_magnitude(decode, st, i, x_bin):
    """F.23 / F.24: the magnitude of a nonzero value whose category
    decision starts at ``st[i]`` (the X bins from ``x_bin`` on) -> |v|."""
    m = decode(st, i)
    if m:
        if x_bin is None:          # DC: X1 is bin 20
            i = 20
            while decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("corrupt JPEG: arithmetic magnitude "
                                     "overflow")
                i += 1
        elif decode(st, i):        # AC: a second decision at S0
            m <<= 1
            i = x_bin
            while decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("corrupt JPEG: arithmetic magnitude "
                                     "overflow")
                i += 1
    return m, i + 14


def _arith_bits(decode, st, i, m):
    """F.24: the bits of a magnitude below its top bit ``m``."""
    v = m
    m >>= 1
    while m:
        if decode(st, i):
            v |= m
        m >>= 1
    return v + 1


def _arith_dc(decode, st, ctx, cond):
    """F.19-F.24: one DC difference with the statistics ``st`` and the
    conditioning ``ctx`` -> (difference, next context); ``cond`` = the
    table's (L, U)."""
    if decode(st, ctx) == 0:
        return 0, 0
    sign = decode(st, ctx + 1)
    m, i = _arith_magnitude(decode, st, ctx + 2 + sign, None)
    lo, hi = cond
    if m < (1 << lo) >> 1:
        ctx = 0
    elif m > (1 << hi) >> 1:
        ctx = 12 + sign * 4
    else:
        ctx = 4 + sign * 4
    v = _arith_bits(decode, st, i, m)
    return (-v if sign else v), ctx


def _arith_ac_value(decode, st, i, k, kx, fixed):
    """F.21-F.24: a nonzero AC value at zigzag index k whose S0 bin is
    ``st[i + 2]``; ``kx`` the table's Kx."""
    sign = decode(fixed, 0)
    m, i = _arith_magnitude(decode, st, i + 2, 189 if k <= kx else 217)
    v = _arith_bits(decode, st, i, m)
    return -v if sign else v


def _int16(v):
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def _decode_arith(seg: bytes, sel, comps, blocks, mcus, layout, single, bpr,
                  spectral, cond):
    """One restart interval of an arithmetic-coded scan (``jdarith.c``'s
    ``decode_mcu`` and its four progressive forms) into ``blocks``; every
    statistics area of the scan starts at zero (a scan or restart start).
    ``cond`` = (DC (L, U) per table, AC Kx per table)."""
    ss, se, ah, al = spectral or (0, 63, 0, 0)
    progressive = spectral is not None     # sequential: 0-63, Ah = Al = 0
    dc_cond, ac_k = cond
    decode = _arith_decoder(seg)
    zz = ZIGZAG.tolist()
    fixed = [FIXED_STATE]
    dc_stats = {td: [0] * DC_BINS for _, td, _ in sel}
    ac_stats = {ta: [0] * AC_BINS for _, _, ta in sel}
    last_dc = {ci: 0 for ci, _, _ in sel}
    ctx = {ci: 0 for ci, _, _ in sel}
    tables = {ci: (td, ta) for ci, td, ta in sel}
    p1 = 1 << al
    for mcu in mcus:
        for ci, by_off, bx_off in layout:
            at = _block_at(mcu, comps, ci, by_off, bx_off, single, bpr)
            td, ta = tables[ci]
            if ah:                                   # refinement scans
                blk = blocks[ci][at]
                if ss == 0:
                    if decode(fixed, 0):
                        blk[0] |= p1
                    continue
                coef = blk.tolist()
                st = ac_stats[ta]
                kex = se
                while kex > 0 and not coef[zz[kex]]:
                    kex -= 1
                k = ss
                while k <= se:
                    i = 3 * (k - 1)
                    if k > kex and decode(st, i):
                        break                        # EOB
                    while True:
                        n = zz[k]
                        if coef[n]:                  # correction bit
                            if decode(st, i + 2):
                                coef[n] += -p1 if coef[n] < 0 else p1
                            break
                        if decode(st, i + 1):        # newly nonzero
                            coef[n] = -p1 if decode(fixed, 0) else p1
                            break
                        i += 3
                        k += 1
                        if k > se:
                            raise ValueError("corrupt JPEG: arithmetic "
                                             "spectral overflow")
                    k += 1
                blk[:] = coef
                continue
            blk = blocks[ci][at]
            if ss == 0:                              # DC (sequential, first)
                diff, ctx[ci] = _arith_dc(decode, dc_stats[td], ctx[ci],
                                          dc_cond[td])
                last_dc[ci] = (last_dc[ci] + diff) & 0xFFFF
                blk[0] = _int16(last_dc[ci] << al)
                if progressive:
                    continue
            st, kx = ac_stats[ta], ac_k[ta]
            k = max(ss, 1)
            while k <= se:
                i = 3 * (k - 1)
                if decode(st, i):
                    break                            # EOB
                while not decode(st, i + 1):
                    i += 3
                    k += 1
                    if k > se:
                        raise ValueError("corrupt JPEG: arithmetic spectral "
                                         "overflow")
                blk[zz[k]] = _int16(_arith_ac_value(decode, st, i, k, kx,
                                                    fixed) << al)
                k += 1


# -- lossless --------------------------------------------------------------------

def _undifference(diff, width, pred, pt, first, above):
    """``jdlossls.c``'s undifferencing of one sample row (ints mod 2^16):
    the first row of the scan or of a restart interval (``first``) is
    predicted from the row start value 2^(7 - Pt), then from the left; the
    other rows' first sample from above, the rest by predictor ``pred``."""
    out = [0] * width
    if first:
        ra = (diff[0] + (1 << (7 - pt))) & 0xFFFF
        out[0] = ra
        for x in range(1, width):
            ra = (diff[x] + ra) & 0xFFFF
            out[x] = ra
        return out
    rb = above[0]
    ra = (diff[0] + rb) & 0xFFFF
    out[0] = ra
    for x in range(1, width):
        rc, rb = rb, above[x]
        if pred == 1:
            p = ra
        elif pred == 2:
            p = rb
        elif pred == 3:
            p = rc
        elif pred == 4:
            p = ra + rb - rc
        elif pred == 5:
            p = ra + ((rb - rc) >> 1)
        elif pred == 6:
            p = rb + ((ra - rc) >> 1)
        else:
            p = (ra + rb) >> 1
        ra = (diff[x] + p) & 0xFFFF
        out[x] = ra
    return out


def _decode_lossless(scan_segs, sel, comps, frame, restart, pred, pt,
                     dc_tabs, planes):
    """A lossless scan (Huffman-coded differences, ``jdlhuff.c``; restart
    every restart-interval / MCUs-a-row MCU rows, as ``jddiffct.c``) ->
    each selected component's u8 plane in ``planes``."""
    if not 1 <= pred <= 7:
        raise ValueError(f"corrupt JPEG: lossless predictor {pred}")
    wid, hgt = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    single = len(sel) == 1
    dims = {ci: (-(-wid * comps[ci]["h"] // hmax),
                 -(-hgt * comps[ci]["v"] // vmax)) for ci, _, _ in sel}
    if single:
        ci0 = sel[0][0]
        mpr, mrows = dims[ci0]
        layout = [(ci0, 0, 0)]
    else:
        mpr, mrows = -(-wid // hmax), -(-hgt // vmax)
        layout = [(ci, y, x) for ci, _, _ in sel
                  for y in range(comps[ci]["v"]) for x in range(comps[ci]["h"])]
    luts = {ci: dc_tabs[td].tolist() for ci, td, _ in sel}
    diffs = {ci: np.zeros((mrows * (1 if single else comps[ci]["v"]),
                           mpr * (1 if single else comps[ci]["h"])), np.int64)
             for ci, _, _ in sel}
    rows_per = restart // mpr if restart else mrows
    if restart and rows_per == 0:
        raise NotImplementedError(
            "lossless JPEG whose restart interval is shorter than an MCU "
            "row: libjpeg restarts by MCU rows")
    starts = set()
    for k, seg in enumerate(scan_segs):
        r0 = k * rows_per
        if r0 >= mrows:
            break
        starts.add(r0)
        rd = _Bits(seg.replace(b"\xff\x00", b"\xff"))
        for my in range(r0, min(mrows, r0 + rows_per)):
            rows = {ci: [[0] * diffs[ci].shape[1]
                         for _ in range(1 if single else comps[ci]["v"])]
                    for ci in diffs}
            for mx in range(mpr):
                for ci, y, x in layout:
                    s = rd.huff(luts[ci])
                    if s == 16:
                        d = 32768
                    else:
                        d = rd.extend(s)
                    rows[ci][y][mx * (1 if single else comps[ci]["h"]) + x] = d
            for ci in diffs:
                v = 1 if single else comps[ci]["v"]
                diffs[ci][my * v:(my + 1) * v] = rows[ci]
    for ci, _, _ in sel:
        cw, ch = dims[ci]
        v = 1 if single else comps[ci]["v"]
        d = diffs[ci].tolist()
        out = np.zeros((ch, cw), np.int64)
        above = None
        for y in range(ch):
            first = y == 0 or (y % v == 0 and y // v in starts)
            above = _undifference(d[y], cw, pred, pt, first, above)
            out[y] = above
        planes[ci] = ((out << pt) & 0xFF).astype(np.uint8)


# -- block smoothing ---------------------------------------------------------------

# jdcoefct.c's estimates: (zigzag index, 5x5 weights over the neighbouring
# blocks' DC values, rows top to bottom) with AC knowledge, then with DC
# interpolation (no AC coefficient known)
_W = lambda *rows: np.array(rows, np.int64)   # noqa: E731
_SMOOTH_AC = {
    1: _W([0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5),
    2: _W([0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0] * 5, [0, 0, -50, 0, 0],
          [0, 0, 7, 0, 0]),
    3: _W([0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0],
          [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]),
    4: _W([0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5, [1, -10, 0, 10, -1],
          [0, 1, 0, -1, 0]),
    5: _W([0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5),
}
_SMOOTH_DC_INTERP = {
    1: _W([-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
          [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]),
    2: _W([-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0] * 5,
          [1, -13, -38, -13, 1], [1, 3, 3, 3, 1]),
    3: _W([0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
          [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]),
    4: _W([-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5, [0, -9, 0, 9, 0],
          [1, 0, 0, 0, -1]),
    5: _W([0] * 5, [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0],
          [0] * 5),
    6: _W([0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0],
          [0] * 5),
    7: _W([0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0], [0] * 5),
    8: _W([0] * 5, [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0],
          [0] * 5),
    9: _W([0] * 5, [0, 1, 2, 1, 0], [0] * 5, [0, -1, -2, -1, 0], [0] * 5),
    0: _W([-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
          [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]),
}
_SAVED_COEFS = 10


def _smoothing_ok(comps) -> bool:
    """``smoothing_ok``: every component's quantizers of the DC and the
    first nine AC coefficients nonzero, its DC at least partly known, and
    one of those AC coefficients not known to full precision."""
    useful = False
    for c in comps:
        q = c.get("q")
        if q is None or not q[ZIGZAG[:_SAVED_COEFS]].all():
            return False
        bits = c["coef_bits"]
        if bits[0] < 0:
            return False
        useful |= any(b != 0 for b in bits[1:_SAVED_COEFS])
    return useful


def _smooth_rows(hgt_blocks, vs, total_rows):
    """The 5 block rows (two above to two below) that
    ``decompress_smooth_data`` reads for each of a component's block rows:
    its edge tests count rows as iMCU row x the block rows of *that* iMCU
    row, so the last iMCU row's neighbours follow its own count."""
    last_rows = hgt_blocks % vs or vs
    out = []
    for r in range(total_rows):
        brows = vs if r < total_rows - 1 else last_rows
        for br in range(brows):
            row, ib, nib = r * vs + br, r * brows + br, brows * total_rows
            p = row - 1 if ib > 0 else row
            pp = row - 2 if ib > 1 else p
            nx = row + 1 if ib < nib - 1 else row
            nn = row + 2 if ib < nib - 2 else nx
            out.append((pp, p, row, nx, nn))
    return np.array(out, np.int64).reshape(-1, 5)


def _smooth_cols(wid_blocks):
    """The 5 block columns (two left to two right) of each block column,
    clamped at the component's edges."""
    return np.clip(np.arange(wid_blocks)[:, None] + np.arange(-2, 3), 0,
                   wid_blocks - 1)


def _smooth_blocks(c, blk, hgt_blocks, wid_blocks, total_rows):
    """``decompress_smooth_data`` on one component: its coefficient blocks
    i32[nby, nbx, 64] with the estimates of libjpeg-turbo 3's 5x5
    neighbourhood written where a coefficient is zero and not exact."""
    bits = c["coef_bits"]
    change_dc = all(b == -1 for b in bits[1:_SAVED_COEFS])
    q = c["q"].astype(np.int64)
    rows = _smooth_rows(hgt_blocks, c["v"], total_rows)
    cols = _smooth_cols(wid_blocks)
    dc = blk[..., 0].astype(np.int64)
    grid = dc[rows[:, None, :, None], cols[None, :, None, :]]   # [R, C, 5, 5]
    out = blk.copy()
    cur = out[:hgt_blocks, :wid_blocks]
    weights = _SMOOTH_DC_INTERP if change_dc else _SMOOTH_AC
    for k, w in weights.items():
        if k == 0:
            continue
        al = bits[k]
        pos = int(ZIGZAG[k])
        if al == 0:
            continue
        num = q[0] * np.einsum("rcij,ij->rc", grid, w)
        qk = int(q[pos])
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        zero = cur[..., pos] == 0
        cur[..., pos] = np.where(zero, pred, cur[..., pos])
    if change_dc:
        num = q[0] * np.einsum("rcij,ij->rc", grid, weights[0])
        q0 = int(q[0])
        pred = ((q0 << 7) + np.abs(num)) // (q0 << 8)
        cur[..., 0] = np.where(num >= 0, pred, -pred)
    return out


# -- pixels ------------------------------------------------------------------------

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


def _ycc_rgb(y, cb, cr):
    """``jdcolor.c``'s integer YCbCr -> RGB, unclamped (int64 planes)."""
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    return (y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb])


def _upsample(plane: np.ndarray, fx: int, fy: int,
              fancy: bool = True) -> np.ndarray:
    """``jdsample.c``'s upsampling of a u8 [h, w] component by integral
    (fx, fy): the "fancy" triangle filters for h2v1, h1v2 and h2v2 where
    the component is more than 2 samples wide (edges replicated), box
    replication otherwise (``int_upsample`` and the plain h2v1 / h2v2) and
    for a lossless file's planes (``fancy`` False: libjpeg-turbo turns the
    filters off in lossless mode)."""
    h, w = plane.shape
    if (fx, fy) == (1, 1):
        return plane
    if not fancy or w <= 2 or (fx, fy) not in ((2, 1), (1, 2), (2, 2)):
        return np.repeat(np.repeat(plane, fx, axis=1), fy, axis=0)
    p = plane.astype(np.int64)
    if fy == 1:   # h2v1: 3/4 nearer + 1/4 further, biases 1 and 2
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        out = np.empty((h, w, 2), np.int64)
        out[..., 0] = (3 * p + left + 1) >> 2
        out[..., 1] = (3 * p + right + 2) >> 2
        return out.reshape(h, 2 * w).astype(np.uint8)
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    if fx == 1:   # h1v2: the column sums alone, biases 1 and 2
        out = np.stack([(3 * p + above + 1) >> 2, (3 * p + below + 2) >> 2],
                       axis=1)
        return out.reshape(2 * h, w).astype(np.uint8)
    out = np.empty((h, 2, w, 2), np.int64)
    for dy, far in ((0, above), (1, below)):
        cs = 3 * p + far                                  # column sums
        last = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        nxt = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        out[:, dy, :, 0] = (3 * cs + last + 8) >> 4
        out[:, dy, :, 1] = (3 * cs + nxt + 7) >> 4
    return out.reshape(2 * h, 2 * w).astype(np.uint8)


def _cmyk_rgba(c, m, y, k) -> np.ndarray:
    """libjpeg's CMYK samples -> Pillow's RGBA: read inverted ("CMYK;I",
    Adobe's convention), then ``cmyk2rgb``: nk - nk * x / 255 with its
    rounded MULDIV255."""
    nk = k.astype(np.int64)        # 255 - (255 - K)
    out = [nk - (((t >> 8) + t) >> 8)
           for t in ((255 - x.astype(np.int64)) * nk + 128 for x in (c, m, y))]
    out.append(np.full_like(nk, 255))
    return np.clip(np.stack(out, axis=-1), 0, 255).astype(np.uint8)


def _color(planes, ids, adobe, jfif, lossless) -> np.ndarray:
    """libjpeg's colour-space guess (``jdapimin.c``) and conversion."""
    if len(planes) == 1:
        return planes[0]
    if len(planes) == 4:
        c, m, y, k = planes
        if adobe is not None and adobe != 0:   # YCCK (transform 2 or other)
            r, g, b = _ycc_rgb(*(p.astype(np.int64) for p in (c, m, y)))
            c, m, y = (np.clip(255 - x, 0, 255) for x in (r, g, b))
        return _cmyk_rgba(c, m, y, k)
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:          # the component ids: 'R' 'G' 'B'; lossless assumes RGB
        rgb = ids == (82, 71, 66) or lossless
    if rgb:
        return np.stack(planes, axis=-1)
    r, g, b = _ycc_rgb(*(p.astype(np.int64) for p in planes))
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _dct_planes(comps, frame, blocks, qt, progressive):
    """Dequantize + IDCT every component's blocks (block-smoothed where
    libjpeg smooths) -> u8 planes at the components' own sizes."""
    wid, hgt = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    smooth = progressive and _smoothing_ok(comps)
    total_rows = -(-hgt // (8 * vmax))
    planes = []
    for c, blk in zip(comps, blocks):
        cw, ch = -(-wid * c["h"] // hmax), -(-hgt * c["v"] // vmax)
        if smooth:
            blk = _smooth_blocks(c, blk, -(-ch // 8), -(-cw // 8), total_rows)
        nby, nbx, _ = blk.shape
        pix = _idct_islow(blk.reshape(-1, 64), c.get("q", qt.get(c["tq"])))
        pix = pix.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(
            nby * 8, nbx * 8)
        planes.append(pix[:ch, :cw])
    return planes


# -- the file ---------------------------------------------------------------------

def _scan_end(data: bytes, pos: int) -> int:
    """The position of the marker that ends the entropy-coded data at
    ``pos`` (restart markers and stuffed bytes belong to the data)."""
    end = pos
    while True:
        end = data.index(b"\xff", end)
        nxt = data[end + 1]
        if nxt == 0 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            end += 1 if nxt == 0xFF else 2
            continue
        return end


def _restart_segments(scan: bytes):
    """A scan's entropy-coded data split at its restart markers (still
    byte-stuffed)."""
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
    return segs


def read_jpeg(data: bytes, colorspace: str | None = None) -> np.ndarray:
    """Decode a JPEG (module docstring) -> u8 [H, W] gray, [H, W, 3] RGB or
    [H, W, 4] RGBA (CMYK / YCCK), PIL's arrays to the bit. ``colorspace``
    overrides libjpeg's guess as libtiff does for a JPEG-in-TIFF strip:
    "ycbcr" converts three components to RGB, "none" returns the upsampled
    components as they are, [H, W] or [H, W, components]; "cmyk" reads
    four components as CMYK, Adobe's YCCK transform ignored (Pillow's
    "CMYK" JPEG mode, as its BLP plugin sets it)."""
    qt, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart, adobe, jfif, mode = None, 0, None, False, None
    dc_cond = {t: (0, 1) for t in range(16)}     # DAC defaults: L 0, U 1
    ac_k = {t: 5 for t in range(16)}             # Kx 5
    comps, blocks, planes = [], None, {}
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
        if marker in _REFUSED_SOF:
            raise NotImplementedError(
                f"{_REFUSED_SOF[marker]} JPEG: only {_SUPPORTED}")
        if marker in _SOF_MODES:
            mode = _SOF_MODES[marker]
            precision, hgt, wid, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(
                    f"{precision}-bit JPEG: only 8-bit samples are decoded")
            if nc not in (1, 3, 4):
                raise NotImplementedError(
                    f"JPEG with {nc} components: only gray, 3-component "
                    "and CMYK/YCCK JPEGs are decoded")
            comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4,
                          v=body[7 + 3 * i] & 15, tq=body[8 + 3 * i],
                          coef_bits=[-1] * 64)
                     for i in range(nc)]
            if any(not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4) for c in comps):
                raise ValueError("corrupt JPEG: sampling factor outside 1-4")
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            for c in comps:
                if hmax % c["h"] or vmax % c["v"]:
                    raise NotImplementedError(
                        f"JPEG with {c['h']}x{c['v']} sampling under "
                        f"{hmax}x{vmax}: libjpeg upsamples integral ratios "
                        "only")
            frame = (wid, hgt)
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
        elif marker == 0xCC:        # DAC
            for i in range(0, len(body) - 1, 2):
                index, val = body[i], body[i + 1]
                if index >= 16:
                    ac_k[index - 16] = val
                elif (val & 15) > (val >> 4):
                    raise ValueError("corrupt JPEG: DAC L above U")
                else:
                    dc_cond[index] = (val & 15, val >> 4)
        elif marker == 0xDB:        # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n],
                                     ">u2" if pq else np.uint8)
                tab = np.zeros(64, np.int32)
                tab[ZIGZAG] = vals
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
                if mode[1] != "lossless":
                    # libjpeg latches a component's table at its first scan
                    comps[ci].setdefault("q", qt[comps[ci]["tq"]].copy())
            ss, se, ahl = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            end = _scan_end(data, pos)
            segs = _restart_segments(data[pos:end])
            if mode[1] == "lossless":
                _decode_lossless(segs, sel, comps, frame, restart, ss,
                                 ahl & 15, dc_tabs, planes)
            else:
                spectral = ((ss, se, ahl >> 4, ahl & 15)
                            if mode[1] == "progressive" else None)
                _decode_scan(segs, sel, comps, frame, blocks, dc_tabs,
                             ac_tabs, restart, spectral,
                             (dc_cond, ac_k) if mode[0] == "arithmetic"
                             else None)
            pos = end
    if frame is None:
        raise ValueError("corrupt JPEG: no frame header")
    lossless = mode[1] == "lossless"
    if lossless:
        missing = [c["id"] for ci, c in enumerate(comps) if ci not in planes]
        if missing:
            raise ValueError(f"corrupt JPEG: no scan of components {missing}")
        planes = [planes[ci] for ci in range(len(comps))]
    else:
        planes = _dct_planes(comps, frame, blocks, qt,
                             mode[1] == "progressive")
    wid, hgt = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = [_upsample(p, hmax // c["h"], vmax // c["v"],
                        not lossless)[:hgt, :wid]
              for p, c in zip(planes, comps)]
    if colorspace == "none":
        return planes[0] if len(planes) == 1 else np.stack(planes, -1)
    if colorspace == "ycbcr" and len(planes) == 3:
        jfif = True
    if colorspace == "cmyk" and len(planes) == 4:
        adobe = 0
    return _color(planes, tuple(c["id"] for c in comps), adobe, jfif,
                  lossless)


def _decode_scan(segs, sel, comps, frame, blocks, dc_tabs, ac_tabs, restart,
                 spectral=None, arith=None):
    """One DCT scan's restart intervals into ``blocks``; ``spectral`` =
    (Ss, Se, Ah, Al) of a progressive scan, whose coefficients it adds to
    the blocks' (None: a sequential scan); ``arith`` = the DAC
    conditioning of an arithmetic-coded scan (None: Huffman)."""
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
        if len(layout) > 10:
            raise ValueError("corrupt JPEG: more than 10 blocks an MCU")
    ss, se, ah, al = spectral or (0, 63, 0, 0)
    if spectral is not None:
        if ss > se or se > 63 or (ss == 0) != (se == 0) or (ss and not single):
            raise ValueError("corrupt JPEG: bad progressive scan parameters")
        for ci, _, _ in sel:    # libjpeg's coef_bits: each band's last Al
            comps[ci]["coef_bits"][ss:se + 1] = [al] * (se + 1 - ss)
    if arith is None:
        # a progressive scan reads only its own kind of table: DC first
        # scans the DC ones, AC scans the AC ones, DC refinements none
        dc_luts = ({ci: dc_tabs[td].tolist() for ci, td, _ in sel}
                   if ss == 0 and ah == 0 else {})
        ac_luts = ({ci: ac_tabs[ta].tolist() for ci, _, ta in sel}
                   if se else {})
    per = restart if restart else n_mcus
    for k, seg in enumerate(segs):
        mcus = range(k * per, min(n_mcus, (k + 1) * per))
        if not mcus:
            break
        seg = seg.replace(b"\xff\x00", b"\xff")
        if arith is not None:
            _decode_arith(seg, sel, comps, blocks, mcus, layout, single, bpr,
                          spectral, arith)
            continue
        dc_pred = {ci: 0 for ci, _, _ in sel}
        if spectral is None:
            _decode_segment(seg, comps, blocks, mcus, dc_pred, dc_luts,
                            ac_luts, layout, single, bpr)
        else:
            _decode_progressive(seg, comps, blocks, mcus, dc_pred, dc_luts,
                                ac_luts, layout, single, bpr, spectral)
