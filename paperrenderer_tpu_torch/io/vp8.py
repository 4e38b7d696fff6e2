"""WebP lossy (VP8 key frame) decoding for ``io.webp``, with numpy only, to
the bit of libwebp 1.6's decoder (``vp8_dec.c``, ``tree_dec.c``,
``quant_dec.c``, ``frame_dec.c`` and ``dsp/dec.c``), the one behind the
JAX package's imaging library:

  * the boolean decoder and the key frame header: segments (quantizer and
    filter-level updates, absolute or delta, and the segment map),
    simple or normal loop filter with level, sharpness and the mode and
    reference deltas, 1-8 token partitions, the quantizer indices with
    their five deltas, coefficient probability updates and the skip flag;
  * dequantization as libwebp does it: the y2 DC doubled, the y2 AC at
    ``* 155 / 100`` and at least 8, the uv DC index clipped to 117;
  * intra prediction: the 16x16 and chroma modes (DC with its no-top /
    no-left forms), the ten 4x4 modes, the frame's 127 (above) and 129
    (left) edges, and the top-right pixels of every 4x4 row taken from the
    macroblock above and to the right (replicated on the last column);
  * the inverse WHT and DCT (20091 / 35468), added to the prediction with
    clipping; prediction reads the unfiltered reconstruction;
  * the simple and normal loop filters with a key frame's hev thresholds
    and interior limits, the inner edges skipped where a 16x16 macroblock
    has no non-zero coefficient. Filtering runs macroblock by macroblock
    in libwebp's order; macroblocks x + 2y apart from each other touch no
    common pixel, so each such diagonal is filtered at once.

``decode`` returns the Y, U and V planes cropped to the picture
(4:2:0); ``io.webp`` upsamples and converts them. Other frames and
malformed streams raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np

# RFC 6386 13.5: default coefficient probabilities [4][8][3][11]
_COEFFS_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88fe"
    "ffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2"
    "ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff808080"
    "8080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faff"
    "ee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae180"
    "808080805081d3ffc2e080808080800101ff8080808080808080f601ff80808080808080"
    "80ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0"
    "bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2"
    "ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7"
    "ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5ff808080"
    "8080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af"
    "0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba80"
    "80808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080"
    "808d7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff80808080809501"
    "ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080"
    "808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6"
    "fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe080"
    "80809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b"
    "66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080a8aff6fc"
    "ebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff80808080808080"
    "80ee01ff8080808080808080")
# RFC 6386 13.4: coefficient update probabilities [4][8][3][11]
_COEFFS_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ff"
    "ffffffffffffffffdff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffff"
    "ffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffff"
    "ffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefeff"
    "fffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefeff"
    "fffffffffffffff8fefffffffffffffffff9feffffffffffffffffffffffffffffffffff"
    "fffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdffffff"
    "fffffffffffafffffffffffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffea"
    "fbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffff"
    "fffffffffffffffffffffffffffffffffefffffffffffffffffffefeffffffffffffffff"
    "fffefffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfd"
    "fffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffffffffffff"
    "fffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdfffffffffffffffffc"
    "fdfefffffffffffffffffffefffffffffffffffffffffcfffffffffffffffffff9fffeff"
    "fffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffff"
    "ffffffffffffffffffffffff")
# RFC 6386 11.5: 4x4 intra mode probabilities [top][left][9]
_BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98"
    "721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce47"
    "3f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b50"
    "4266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216"
    "585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d"
    "271c55ab3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e172"
    "2213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d1"
    "6450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c0171952"
    "8a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39"
    "363970b8052926a6d51e221a8598740a2086271335dd1a722049ff1f0941ea020f017649"
    "4b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c4966012262"
    "7d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a"
    "39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25"
    "442d8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c955"
    "4b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d1"
    "2d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420"
    "654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418")
# RFC 6386 14.1: DC dequantization by index
_DC_TABLE = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c1d1e1f20"
    "212223242525262728292a2b2c2d2e2e2f303132333435363738393a3b3c3d3e3f404142"
    "434445464748494a4b4c4c4d4e4f505152535455565758595b5d5f6062646566686a6c6e"
    "707274767a7c7e80828486888a8c8f9194979a9d")
# RFC 6386 14.1: AC dequantization by index
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96,
    98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177,
    181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239,
    245, 249, 254, 259, 264, 269, 274, 279, 284)

_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT_PROBAS = ((173, 148, 140), (176, 155, 140, 135),
               (180, 157, 141, 134, 130),
               (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# normalisation: shifts that bring a range of 1..255 back to 128..255
_SHIFT = [0] + [7 - r.bit_length() + 1 for r in range(1, 256)]
# 4x4 modes (libwebp's order); 16x16 and chroma reuse the first four
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)


def _bad(what: str):
    raise NotImplementedError(f"WebP lossy (VP8): {what}")


class _Bool:
    """VP8's boolean decoder over one partition, in libwebp's form
    (``range`` kept less one, ``value`` buffered 56 bits at a time; a load
    past the end shifts in zeros and marks ``eof``)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.value, self.bits, self.range = 0, -8, 254
        self.eof = False

    def load(self):
        chunk = self.data[self.pos:self.pos + 7]
        if not chunk:
            self.eof = True
            chunk = b"\x00"
        self.pos += len(chunk)
        self.value = (self.value << (8 * len(chunk))) | int.from_bytes(
            chunk, "big")
        self.bits += 8 * len(chunk)

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self.load()
        split = (self.range * prob) >> 8
        if (self.value >> self.bits) > split:
            rng = self.range - split
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            rng = split + 1
            bit = 0
        s = _SHIFT[rng]
        self.range = (rng << s) - 1
        self.bits -= s
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(0x80)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(0x80) else v

    def optional_signed(self, n: int) -> int:
        return self.signed(n) if self.bit(0x80) else 0


def _header(data: bytes):
    """The frame tag, the key frame start code and sizes -> (width,
    height, first partition, the rest)."""
    if len(data) < 10:
        _bad("a frame shorter than its header")
    tag = data[0] | data[1] << 8 | data[2] << 16
    if tag & 1:
        _bad("an inter frame")
    if (tag >> 1) & 7 > 3 or not (tag >> 4) & 1:
        _bad("a bad key frame tag")
    if data[3:6] != b"\x9d\x01\x2a":
        _bad("no key frame start code")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    size = tag >> 5
    if size > len(data) - 10:
        _bad("a first partition longer than the frame")
    return w, h, data[10:10 + size], data[10 + size:]


def _index(v: int, hi: int = 127) -> int:
    """A quantizer index clipped to the tables (0..hi)."""
    return min(max(v, 0), hi)


def _parse_header(br: _Bool, rest: bytes):
    """Segments, loop filter, partitions, quantizers and probabilities."""
    br.bit(0x80)                                         # colour space
    br.bit(0x80)                                         # clamping type
    seg = dict(use=br.bit(0x80), update_map=0, absolute=1,
               quant=[0] * 4, level=[0] * 4, probs=[255] * 3)
    if seg["use"]:
        seg["update_map"] = br.bit(0x80)
        if br.bit(0x80):
            seg["absolute"] = br.bit(0x80)
            seg["quant"] = [br.optional_signed(7) for _ in range(4)]
            seg["level"] = [br.optional_signed(6) for _ in range(4)]
        if seg["update_map"]:
            seg["probs"] = [br.literal(8) if br.bit(0x80) else 255
                            for _ in range(3)]
    filt = dict(simple=br.bit(0x80), level=br.literal(6),
                sharpness=br.literal(3), use_delta=br.bit(0x80),
                ref=[0] * 4, mode=[0] * 4)
    if filt["use_delta"] and br.bit(0x80):
        for key in ("ref", "mode"):
            for k in range(4):
                if br.bit(0x80):
                    filt[key][k] = br.signed(6)
    n_parts = 1 << br.literal(2)
    if len(rest) < 3 * (n_parts - 1):
        _bad("truncated partition sizes")
    start, parts = 3 * (n_parts - 1), []
    for p in range(n_parts - 1):
        size = rest[3 * p] | rest[3 * p + 1] << 8 | rest[3 * p + 2] << 16
        size = min(size, len(rest) - start)
        parts.append(_Bool(rest[start:start + size]))
        start += size
    if start >= len(rest):
        _bad("truncated token partitions")
    parts.append(_Bool(rest[start:]))
    base = br.literal(7)
    dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = (br.optional_signed(4)
                                              for _ in range(5))
    quant = []
    for s in range(4):
        if seg["use"]:
            q = seg["quant"][s] + (0 if seg["absolute"] else base)
        elif s:
            quant.append(quant[0])
            continue
        else:
            q = base
        y2_ac = _AC_TABLE[_index(q + dy2_ac)] * 101581 >> 16
        quant.append(dict(
            y1=(_DC_TABLE[_index(q + dy1_dc)], _AC_TABLE[_index(q)]),
            y2=(_DC_TABLE[_index(q + dy2_dc)] * 2, max(y2_ac, 8)),
            uv=(_DC_TABLE[_index(q + duv_dc, 117)],
                _AC_TABLE[_index(q + duv_ac)])))
    br.bit(0x80)                                   # refresh entropy probs
    probs = np.frombuffer(_COEFFS_PROBA0, np.uint8).tolist()
    update = _COEFFS_UPDATE_PROBA
    for k in range(len(probs)):
        if br.bit(update[k]):
            probs[k] = br.literal(8)
    skip_p = br.literal(8) if br.bit(0x80) else None
    # per type, per coefficient position (17: a sentinel), per context
    bands = [[[probs[((t * 8 + _BANDS[n]) * 3 + c) * 11:
                     ((t * 8 + _BANDS[n]) * 3 + c) * 11 + 11]
               for c in range(3)] for n in range(17)] for t in range(4)]
    return seg, filt, parts, quant, bands, skip_p


def _intra_modes(br: _Bool, mbw: int, mbh: int, seg, skip_p):
    """Each macroblock's segment, skip flag, 4x4 flag, luma modes (16 4x4
    modes, or the 16x16 mode) and chroma mode, from the first partition."""
    bm = _BMODES_PROBA
    segs, skips, i4s, ymodes, uvmodes = [], [], [], [], []
    top = [B_DC] * (4 * mbw)
    sp = seg["probs"]
    for _ in range(mbh):
        left = [B_DC] * 4
        for mx in range(mbw):
            if seg["update_map"]:
                segs.append(br.bit(sp[1]) if not br.bit(sp[0])
                            else 2 + br.bit(sp[2]))
            else:
                segs.append(0)
            skips.append(br.bit(skip_p) if skip_p is not None else 0)
            i4 = not br.bit(145)
            i4s.append(i4)
            if not i4:
                m = ((B_TM if br.bit(128) else B_HE) if br.bit(156) else
                     (B_VE if br.bit(163) else B_DC))
                top[4 * mx:4 * mx + 4] = [m] * 4
                left = [m] * 4
                ymodes.append(m)
            else:
                modes = []
                for y in range(4):
                    ym = left[y]
                    for x in range(4):
                        o = (top[4 * mx + x] * 10 + ym) * 9
                        if not br.bit(bm[o]):
                            ym = B_DC
                        elif not br.bit(bm[o + 1]):
                            ym = B_TM
                        elif not br.bit(bm[o + 2]):
                            ym = B_VE
                        elif not br.bit(bm[o + 3]):
                            ym = (B_HE if not br.bit(bm[o + 4]) else
                                  B_RD if not br.bit(bm[o + 5]) else B_VR)
                        elif not br.bit(bm[o + 6]):
                            ym = B_LD
                        elif not br.bit(bm[o + 7]):
                            ym = B_VL
                        else:
                            ym = B_HD if not br.bit(bm[o + 8]) else B_HU
                        top[4 * mx + x] = ym
                        modes.append(ym)
                    left[y] = ym
                ymodes.append(modes)
            uvmodes.append(B_DC if not br.bit(142) else
                           B_VE if not br.bit(114) else
                           B_TM if br.bit(183) else B_HE)
    if br.eof:
        _bad("truncated intra modes")
    return segs, skips, i4s, ymodes, uvmodes


def _large(bit, p) -> int:
    """libwebp's ``GetLargeValue``: a token of 2 or more -> its value."""
    if not bit(p[3]):
        return 2 if not bit(p[4]) else 3 + bit(p[5])
    if not bit(p[6]):
        if not bit(p[7]):
            return 5 + bit(159)
        return 7 + 2 * bit(165) + bit(145)
    cat = 2 * bit(p[8])
    cat += bit(p[9 + cat // 2])
    v = 0
    for prob in _CAT_PROBAS[cat]:
        v = v + v + bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(bit, prob, ctx: int, dq, n: int, out, base: int) -> int:
    """libwebp's ``GetCoeffs``: one 4x4 block's tokens from position n,
    dequantized into ``out[base + raster index]``; returns the position
    after its last non-zero coefficient (n if none)."""
    p = prob[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n                                 # end of block
        while not bit(p[1]):                         # a zero
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        if not bit(p[2]):
            v, p = 1, prob[n + 1][1]
        else:
            v, p = _large(bit, p), prob[n + 1][2]
        out[base + _ZIGZAG[n]] = (-v if bit(0x80) else v) * dq[n > 0]
        n += 1
    return 16


def _residuals(parts, mbw, mbh, i4s, skips, segs, quant, bands):
    """Every macroblock's coefficients -> (y2 [n, 16], y [n, 16, 16], uv
    [n, 8, 16], all dequantized in raster order)."""
    n_mb = mbw * mbh
    y2 = [0] * (16 * n_mb)
    coef = [0] * (384 * n_mb)
    top_nz = [0] * mbw          # libwebp's nz_ bits: 4 luma, 2 + 2 chroma
    top_dc = [0] * mbw
    for my in range(mbh):
        br = parts[my % len(parts)]
        bit = br.bit
        left_nz = left_dc = 0
        for mx in range(mbw):
            m = my * mbw + mx
            if skips[m]:
                left_nz = top_nz[mx] = 0
                if not i4s[m]:
                    left_dc = top_dc[mx] = 0
                continue
            q = quant[segs[m]]
            base = 384 * m
            if not i4s[m]:
                nz = _coeffs(bit, bands[1], top_dc[mx] + left_dc, q["y2"], 0,
                             y2, 16 * m)
                top_dc[mx] = left_dc = int(nz > 0)
                first, ac = 1, bands[0]
            else:
                first, ac = 0, bands[3]
            tnz, lnz = top_nz[mx] & 15, left_nz & 15
            for y in range(4):
                left = lnz & 1
                for x in range(4):
                    nz = _coeffs(bit, ac, left + (tnz & 1), q["y1"], first,
                                 coef, base + 64 * y + 16 * x)
                    left = int(nz > first)
                    tnz = (tnz >> 1) | (left << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (left << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz = top_nz[mx] >> (4 + ch)
                lnz = left_nz >> (4 + ch)
                for y in range(2):
                    left = lnz & 1
                    for x in range(2):
                        nz = _coeffs(bit, bands[2], left + (tnz & 1), q["uv"],
                                     0, coef,
                                     base + 256 + 32 * ch + 32 * y + 16 * x)
                        left = int(nz > 0)
                        tnz = (tnz >> 1) | (left << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (left << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mx], left_nz = out_t, out_l
        if br.eof:
            _bad("truncated token partition")
    coef = np.asarray(coef, np.int64).reshape(n_mb, 24, 16)
    return np.asarray(y2, np.int64).reshape(n_mb, 16), coef[:, :16], \
        coef[:, 16:]


def _wht(c):
    """The inverse Walsh-Hadamard transform of y2 [n, 16] -> the 16 luma
    DCs [n, 16]."""
    c = c.reshape(-1, 4, 4)
    a0, a1 = c[:, 0] + c[:, 3], c[:, 1] + c[:, 2]
    a2, a3 = c[:, 1] - c[:, 2], c[:, 0] - c[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1)   # [n, row, col]
    dc = t[:, :, 0] + 3
    b0, b1 = dc + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    b2, b3 = t[:, :, 1] - t[:, :, 2], dc - t[:, :, 3]
    return np.stack([(b0 + b1) >> 3, (b3 + b2) >> 3, (b0 - b1) >> 3,
                     (b3 - b2) >> 3], 2).reshape(-1, 16)


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c):
    """libwebp's ``TransformOne`` without the prediction: coefficients
    [..., 16] (raster) -> the residual [..., 16] it adds (v >> 3)."""
    c = c.reshape(-1, 4, 4)
    a, b = c[:, 0] + c[:, 2], c[:, 0] - c[:, 2]
    cc = _mul2(c[:, 1]) - _mul1(c[:, 3])
    d = _mul1(c[:, 1]) + _mul2(c[:, 3])
    t = np.stack([a + d, b + cc, b - cc, a - d], 1)   # [n, k, column]
    dc = t[:, :, 0] + 4
    a, b = dc + t[:, :, 2], dc - t[:, :, 2]
    cc = _mul2(t[:, :, 1]) - _mul1(t[:, :, 3])
    d = _mul1(t[:, :, 1]) + _mul2(t[:, :, 3])
    return np.stack([(a + d) >> 3, (b + cc) >> 3, (b - cc) >> 3,
                     (a - d) >> 3], 2).reshape(-1, 16)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _set(out, v, *cells):
    for x, y in cells:
        out[4 * y + x] = v


def _pred4(mode, t, lf, X, clip):
    """A 4x4 luma prediction (libwebp's ``VP8PredLuma4``): the top row and
    its four top-right pixels ``t`` (A..H), the left column ``lf`` (I..L),
    the corner X -> 16 pixels, row by row."""
    A, B, C, D, E, F, G, H = t
    I, J, K, L = lf
    if mode == B_DC:
        return [(A + B + C + D + I + J + K + L + 4) >> 3] * 16
    if mode == B_TM:
        return [clip[v + u - X] for v in lf for u in t[:4]]
    if mode == B_VE:
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(C, D, E)] * 4
    if mode == B_HE:
        return ([_avg3(X, I, J)] * 4 + [_avg3(I, J, K)] * 4
                + [_avg3(J, K, L)] * 4 + [_avg3(K, L, L)] * 4)
    if mode == B_RD:       # constant along down-right diagonals (x - y)
        d = (_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I),
             _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B))
        return [d[x - y + 3] for y in range(4) for x in range(4)]
    if mode == B_LD:       # constant along down-left diagonals (x + y)
        d = (_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
             _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H))
        return [d[x + y] for y in range(4) for x in range(4)]
    out = [0] * 16
    if mode == B_VR:
        _set(out, _avg2(X, A), (0, 0), (1, 2))
        _set(out, _avg2(A, B), (1, 0), (2, 2))
        _set(out, _avg2(B, C), (2, 0), (3, 2))
        _set(out, _avg2(C, D), (3, 0))
        _set(out, _avg3(K, J, I), (0, 3))
        _set(out, _avg3(J, I, X), (0, 2))
        _set(out, _avg3(I, X, A), (0, 1), (1, 3))
        _set(out, _avg3(X, A, B), (1, 1), (2, 3))
        _set(out, _avg3(A, B, C), (2, 1), (3, 3))
        _set(out, _avg3(B, C, D), (3, 1))
    elif mode == B_VL:
        _set(out, _avg2(A, B), (0, 0))
        _set(out, _avg2(B, C), (1, 0), (0, 2))
        _set(out, _avg2(C, D), (2, 0), (1, 2))
        _set(out, _avg2(D, E), (3, 0), (2, 2))
        _set(out, _avg3(A, B, C), (0, 1))
        _set(out, _avg3(B, C, D), (1, 1), (0, 3))
        _set(out, _avg3(C, D, E), (2, 1), (1, 3))
        _set(out, _avg3(D, E, F), (3, 1), (2, 3))
        _set(out, _avg3(E, F, G), (3, 2))
        _set(out, _avg3(F, G, H), (3, 3))
    elif mode == B_HD:
        _set(out, _avg2(I, X), (0, 0), (2, 1))
        _set(out, _avg2(J, I), (0, 1), (2, 2))
        _set(out, _avg2(K, J), (0, 2), (2, 3))
        _set(out, _avg2(L, K), (0, 3))
        _set(out, _avg3(A, B, C), (3, 0))
        _set(out, _avg3(X, A, B), (2, 0))
        _set(out, _avg3(I, X, A), (1, 0), (3, 1))
        _set(out, _avg3(J, I, X), (1, 1), (3, 2))
        _set(out, _avg3(K, J, I), (1, 2), (3, 3))
        _set(out, _avg3(L, K, J), (1, 3))
    else:                                            # B_HU
        _set(out, _avg2(I, J), (0, 0))
        _set(out, _avg2(J, K), (2, 0), (0, 1))
        _set(out, _avg2(K, L), (2, 1), (0, 2))
        _set(out, _avg3(I, J, K), (1, 0))
        _set(out, _avg3(J, K, L), (3, 0), (1, 1))
        _set(out, _avg3(K, L, L), (3, 1), (1, 2))
        _set(out, L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return out


def _pred_block(mode, rows, r0, c0, size, mx, my, clip):
    """A 16x16 luma or 8x8 chroma prediction over the padded plane
    ``rows`` (the block's top-left pixel at rows[r0 + 1][c0 + 1]) ->
    size rows of size pixels."""
    top = rows[r0][c0 + 1:c0 + 1 + size]
    left = [rows[r0 + 1 + j][c0] for j in range(size)]
    if mode == B_DC:
        shift = size.bit_length() - 1             # log2(size)
        if mx and my:
            dc = (sum(top) + sum(left) + size) >> (shift + 1)
        elif my:                                   # no left: the top alone
            dc = (sum(top) + (size >> 1)) >> shift
        elif mx:                                   # no top: the left alone
            dc = (sum(left) + (size >> 1)) >> shift
        else:
            dc = 0x80
        return [[dc] * size for _ in range(size)]
    if mode == B_VE:
        return [top] * size
    if mode == B_HE:
        return [[v] * size for v in left]
    X = rows[r0][c0]
    return [[clip[v + u - X] for u in top] for v in left]   # TrueMotion


def _reconstruct(mbw, mbh, i4s, ymodes, uvmodes, res_y, res_u, res_v):
    """Intra prediction plus residual, macroblock by macroblock, into
    planes padded with the frame edges (127 above, 129 to the left) ->
    Y, U, V u8 arrays of whole macroblocks."""
    clip = list(range(256)) + [255] * 1024 + [0] * 1024   # v: -1024..1279
    planes = []
    for size in (16, 8, 8):
        width = size * mbw + 1 + 4
        planes.append([[127] * width] + [[129] + [0] * (width - 1)
                                         for _ in range(size * mbh)])
    Y, U, V = planes
    for my in range(mbh):
        for mx in range(mbw):
            m = my * mbw + mx
            r0, c0 = 16 * my, 16 * mx
            ry = res_y[m]
            if not i4s[m]:
                pred = _pred_block(ymodes[m], Y, r0, c0, 16, mx, my, clip)
                for j in range(16):
                    Y[r0 + 1 + j][c0 + 1:c0 + 17] = [
                        clip[p + r] for p, r in zip(pred[j], ry[j])]
            else:
                if my == 0:
                    tr = [127] * 4
                elif mx == mbw - 1:
                    tr = [Y[r0][c0 + 16]] * 4
                else:
                    tr = Y[r0][c0 + 17:c0 + 21]
                modes = ymodes[m]
                for n in range(16):
                    sy, sx = n >> 2, n & 3
                    r, c = r0 + 4 * sy, c0 + 4 * sx
                    t = Y[r][c + 1:c + 5] + (Y[r][c + 5:c + 9] if sx < 3
                                              else tr)
                    lf = [Y[r + 1 + j][c] for j in range(4)]
                    pred = _pred4(modes[n], t, lf, Y[r][c], clip)
                    for j in range(4):
                        rr = ry[4 * sy + j]
                        Y[r + 1 + j][c + 1:c + 5] = [
                            clip[pred[4 * j + k] + rr[4 * sx + k]]
                            for k in range(4)]
            for P, res in ((U, res_u[m]), (V, res_v[m])):
                pred = _pred_block(uvmodes[m], P, 8 * my, 8 * mx, 8, mx, my,
                                   clip)
                for j in range(8):
                    P[8 * my + 1 + j][8 * mx + 1:8 * mx + 9] = [
                        clip[p + r] for p, r in zip(pred[j], res[j])]
    return [np.asarray(P, np.uint8)[1:, 1:size * mbw + 1]
            for P, size in ((Y, 16), (U, 8), (V, 8))]


def _filter_params(filt, seg, segs, i4s, nonzero):
    """Per macroblock (limit, interior limit, hev threshold, inner edges)
    as libwebp's ``PrecomputeFilterStrengths`` and ``VP8DecodeMB`` set
    them; a limit of 0 filters nothing."""
    table = {}
    for s in range(4):
        base = filt["level"]
        if seg["use"]:
            base = seg["level"][s] + (0 if seg["absolute"] else base)
        for i4 in (0, 1):
            level = base
            if filt["use_delta"]:
                level += filt["ref"][0] + (filt["mode"][0] if i4 else 0)
            level = min(max(level, 0), 63)
            if level == 0:
                table[s, i4] = (0, 0, 0)
                continue
            ilevel = level
            sharp = filt["sharpness"]
            if sharp:
                ilevel >>= 2 if sharp > 4 else 1
                ilevel = min(ilevel, 9 - sharp)
            ilevel = max(ilevel, 1)
            table[s, i4] = (2 * level + ilevel, ilevel,
                            2 if level >= 40 else 1 if level >= 15 else 0)
    p = np.asarray([table[s, int(i4)] for s, i4 in zip(segs, i4s)],
                   np.int64).reshape(-1, 3)
    inner = np.asarray(i4s, bool) | nonzero
    return p[:, 0], p[:, 1], p[:, 2], inner


def _filter(P, thresh, ithresh, hev_t, kind):
    """One edge across the last axis of P [n, lines, 8] (p3 .. q3), each
    macroblock's thresholds [n]; libwebp's ``DoFilter2/4/6`` where its
    ``NeedsFilter`` / ``Hev`` tests select them."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (P[..., k] for k in range(8))
    t2 = (2 * thresh + 1)[:, None]
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    out = P.copy()
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)      # DoFilter2
    f2p0 = np.clip(p0 + np.clip((a + 3) >> 3, -16, 15), 0, 255)
    f2q0 = np.clip(q0 - np.clip((a + 4) >> 3, -16, 15), 0, 255)
    if kind == "simple":
        out[..., 3] = np.where(need, f2p0, p0)
        out[..., 4] = np.where(need, f2q0, q0)
        return out
    it = ithresh[:, None]
    need &= ((np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it)
             & (np.abs(p1 - p0) <= it) & (np.abs(q3 - q2) <= it)
             & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0) <= it))
    hev = ((np.abs(p1 - p0) > hev_t[:, None])
           | (np.abs(q1 - q0) > hev_t[:, None]))
    two, other = need & hev, need & ~hev
    if kind == "edge":                                    # DoFilter6
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        new = (p2 + a3, p1 + a2, p0 + a1, q0 - a1, q1 - a2, q2 - a3)
        for k, v in zip(range(1, 7), new):
            out[..., k] = np.where(other, np.clip(v, 0, 255), out[..., k])
    else:                                                 # DoFilter4
        a = 3 * (q0 - p0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        new = (p1 + a3, p0 + a2, q0 - a1, q1 - a3)
        for k, v in zip(range(2, 6), new):
            out[..., k] = np.where(other, np.clip(v, 0, 255), out[..., k])
    out[..., 3] = np.where(two, f2p0, out[..., 3])
    out[..., 4] = np.where(two, f2q0, out[..., 4])
    return out


def _edge(plane, mx, my, size, off, vertical, thresh, ithresh, hev, kind):
    """Filter the edge ``off`` pixels into each listed macroblock (a
    vertical edge: across columns; else across rows)."""
    lines = np.arange(size)
    across = np.arange(-4, 4) + off
    if vertical:
        r = (size * my)[:, None, None] + lines[None, :, None]
        c = (size * mx)[:, None, None] + across[None, None, :]
    else:
        r = (size * my)[:, None, None] + across[None, None, :]
        c = (size * mx)[:, None, None] + lines[None, :, None]
    plane[r, c] = _filter(plane[r, c], thresh, ithresh, hev, kind)


def _loop_filter(planes, mbw, mbh, simple, limit, ilevel, hev, inner):
    """The loop filter, in place, over whole-macroblock planes (int64):
    per macroblock its left edge, inner vertical edges, top edge and inner
    horizontal edges, luma then chroma (normal filter only); one diagonal
    x + 2y at a time."""
    Y, U, V = planes
    xs, ys = np.meshgrid(np.arange(mbw), np.arange(mbh))
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    wave = xs + 2 * ys
    for t in range(int(wave.max()) + 1):
        sel = (wave == t) & (limit > 0)
        if not sel.any():
            continue
        for plane, size in ((Y, 16),) + (() if simple else ((U, 8), (V, 8))):
            inner_offs = (4, 8, 12) if size == 16 else (4,)
            kinds = ("simple", "simple") if simple else ("edge", "inner")
            for vertical in (True, False):
                first = xs if vertical else ys
                s = sel & (first > 0)
                if s.any():
                    _edge(plane, xs[s], ys[s], size, 0, vertical,
                          limit[s] + 4, ilevel[s], hev[s], kinds[0])
                s = sel & inner
                if s.any():
                    for off in inner_offs:
                        _edge(plane, xs[s], ys[s], size, off, vertical,
                              limit[s], ilevel[s], hev[s], kinds[1])


def decode(data: bytes):
    """A VP8 chunk's payload (a key frame) -> (Y [h, w], U, V [(h + 1) / 2,
    (w + 1) / 2]) u8."""
    w, h, first, rest = _header(data)
    if not w or not h:
        _bad("a zero-sized frame")
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    br = _Bool(first)
    seg, filt, parts, quant, bands, skip_p = _parse_header(br, rest)
    if br.eof:
        _bad("truncated frame header")
    segs, skips, i4s, ymodes, uvmodes = _intra_modes(br, mbw, mbh, seg,
                                                     skip_p)
    y2, yc, uvc = _residuals(parts, mbw, mbh, i4s, skips, segs, quant, bands)
    i16 = ~np.asarray(i4s, bool)
    yc[i16, :, 0] = _wht(y2[i16])
    nonzero = (yc != 0).any((1, 2)) | (uvc != 0).any((1, 2))
    n = mbw * mbh
    ry = _idct(yc).reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
    ruv = _idct(uvc).reshape(n, 2, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5)
    planes = _reconstruct(mbw, mbh, i4s, ymodes, uvmodes,
                          ry.reshape(n, 16, 16).tolist(),
                          ruv[:, 0].reshape(n, 8, 8).tolist(),
                          ruv[:, 1].reshape(n, 8, 8).tolist())
    if filt["level"]:
        planes = [p.astype(np.int64) for p in planes]
        _loop_filter(planes, mbw, mbh, filt["simple"],
                     *_filter_params(filt, seg, segs, i4s, nonzero))
        planes = [p.astype(np.uint8) for p in planes]
    Y, U, V = planes
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    return Y[:h, :w], U[:ch, :cw], V[:ch, :cw]
