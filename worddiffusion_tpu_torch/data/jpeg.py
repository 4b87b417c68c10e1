"""A JPEG decoder with the stdlib and numpy: the port's counterpart of
``np.asarray(Image.open(path).convert("RGB"))`` for JPEG word crops
(``worddiffusion_tpu/data/dataset.py:118-120``, ``cli/evaluate.py:28-34``).

Reads baseline, extended sequential and progressive Huffman JPEGs of 8-bit
samples with 1 or 3 components: any sampling factors, restart intervals,
sizes that are not a multiple of the MCU, JFIF, Adobe APP14 (transform 0:
RGB, 1: YCbCr) and the component-id rules for files with neither. The
output follows libjpeg-turbo's default decompression, as Pillow gives it:
the integer ``islow`` IDCT (``jidctint.c``), fancy (triangular) upsampling
for 2:1 factors and box replication for other integral ones
(``jdsample.c``), and the fixed-point YCbCr -> RGB tables (``jdcolor.c``),
all integer arithmetic, so the result is bitwise libjpeg-turbo's. One
component is grey, replicated to three channels as ``convert("RGB")`` does.

Refused, naming the mode: arithmetic coding, 12-bit samples, lossless and
hierarchical JPEG, and 4 components (CMYK / YCCK).

The entropy decode is the one Python loop: Huffman codes are looked up 9
bits at a time in a table (longer codes walk the canonical code lengths).
Everything after it (dequantisation, IDCT, upsampling, colour) runs in
numpy over all blocks at once.
"""

from __future__ import annotations

import array
import struct

import numpy as np

SOI = b"\xff\xd8"
# zigzag position k -> natural (row-major) index of the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_REFUSED_SOF = {0xC3: "lossless JPEG", 0xC5: "hierarchical JPEG", 0xC6: "hierarchical JPEG",
                0xC7: "hierarchical JPEG", 0xC9: "arithmetic coding",
                0xCA: "arithmetic coding (progressive)", 0xCB: "arithmetic coding (lossless)",
                0xCD: "arithmetic coding (hierarchical)", 0xCE: "arithmetic coding (hierarchical)",
                0xCF: "arithmetic coding (hierarchical)", 0xCC: "arithmetic coding"}
LOOKAHEAD = 9


class _Huffman:
    """A DHT table: a 2**LOOKAHEAD lookup of (code length << 8 | symbol), 0
    for codes longer than LOOKAHEAD bits, which ``slow`` decodes."""

    def __init__(self, counts: bytes, symbols: bytes):
        self.lut = [0] * (1 << LOOKAHEAD)
        self.maxcode = [-1] * 17
        self.offset = [0] * 17
        self.symbols = list(symbols)
        code = k = 0
        for length in range(1, 17):
            n = counts[length - 1]
            self.offset[length] = k - code
            for _ in range(n):
                if length <= LOOKAHEAD:
                    shift = LOOKAHEAD - length
                    base = code << shift
                    entry = (length << 8) | symbols[k]
                    for j in range(1 << shift):
                        self.lut[base + j] = entry
                code += 1
                k += 1
            self.maxcode[length] = code - 1 if n else -1
            code <<= 1

    def slow(self, bits16: int) -> tuple[int, int]:
        """The (symbol, length) of a code longer than LOOKAHEAD bits."""
        for length in range(LOOKAHEAD + 1, 17):
            c = bits16 >> (16 - length)
            if c <= self.maxcode[length]:
                return self.symbols[c + self.offset[length]], length
        return 0, 16  # no such code: libjpeg warns and decodes a 0


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None  # latched at the component's first scan, as libjpeg does


def _windows(seg: bytes) -> list[int]:
    """32-bit big-endian windows at every byte of an entropy-coded segment
    (byte stuffing removed), zero-padded past its end as libjpeg fills bits
    past a marker with zeros."""
    b = np.frombuffer(seg + bytes(12), np.uint8).astype(np.uint32)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


def _segments(raw: bytes, pos: int) -> tuple[list[bytes], int]:
    """The entropy-coded data from ``pos``, split at RSTn markers, each with
    its 0xFF00 stuffing removed -> (segments, position of the next marker)."""
    segs, start, n = [], pos, len(raw)
    while True:
        i = raw.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            segs.append(raw[start:].replace(b"\xff\x00", b"\xff"))
            return segs, n
        m = raw[i + 1]
        if m == 0x00:  # a stuffed data byte
            pos = i + 2
        elif m == 0xFF:  # a fill byte before a marker
            pos = i + 1
        elif 0xD0 <= m <= 0xD7:
            segs.append(raw[start:i].replace(b"\xff\x00", b"\xff"))
            start = pos = i + 2
        else:
            segs.append(raw[start:i].replace(b"\xff\x00", b"\xff"))
            return segs, i


class _Decoder:
    def __init__(self, raw: bytes, path: str):
        self.raw, self.path = raw, path
        self.qt: dict[int, np.ndarray] = {}
        self.dc: dict[int, _Huffman] = {}
        self.ac: dict[int, _Huffman] = {}
        self.restart = 0
        self.comps: list[_Component] = []
        self.progressive = False
        self.jfif = False
        self.adobe = None
        self.width = self.height = 0

    def fail(self, msg: str):
        raise ValueError(f"{self.path}: {msg}")

    # -- markers -------------------------------------------------------------
    def run(self) -> np.ndarray:
        raw = self.raw
        if raw[:2] != SOI:
            self.fail("not a JPEG file")
        pos, frame = 2, False
        while True:
            i = raw.find(b"\xff", pos)
            while 0 <= i < len(raw) - 1 and raw[i + 1] == 0xFF:
                i += 1
            if i < 0 or i + 1 >= len(raw):
                break
            m = raw[i + 1]
            pos = i + 2
            if m == 0xD9:  # EOI
                break
            if m in (0x01,) or 0xD0 <= m <= 0xD7:  # TEM, stray RSTn: no length
                continue
            (length,) = struct.unpack(">H", raw[pos:pos + 2]) if pos + 2 <= len(raw) else (0,)
            if length < 2 or pos + length > len(raw):
                self.fail(f"truncated marker segment (0xFF{m:02X})")
            body = raw[pos + 2:pos + length]
            pos += length
            if m in _REFUSED_SOF:
                self.fail(f"{_REFUSED_SOF[m]} (marker 0xFF{m:02X}) is not supported")
            if m in (0xC0, 0xC1, 0xC2):
                self._frame(body, progressive=m == 0xC2)
                frame = True
            elif m == 0xC4:
                self._dht(body)
            elif m == 0xDB:
                self._dqt(body)
            elif m == 0xDD:
                (self.restart,) = struct.unpack(">H", body[:2])
            elif m == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
                self.jfif = True
            elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                self.adobe = body[11]
            elif m == 0xDA:
                if not frame:
                    self.fail("scan before the frame header")
                pos = self._scan(body, pos)
        if not frame:
            self.fail("no frame header (SOF)")
        return self._output()

    def _frame(self, body: bytes, progressive: bool) -> None:
        precision, h, w, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            self.fail(f"{precision}-bit samples are not supported (8-bit only)")
        if n == 4:
            self.fail("4 components (CMYK / YCCK) are not supported")
        if n not in (1, 3):
            self.fail(f"{n} components are not supported (1 or 3)")
        if h == 0 or w == 0:
            self.fail(f"image size {w}x{h} is not supported (DNL)")
        self.width, self.height, self.progressive = w, h, progressive
        for k in range(n):
            cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                self.fail(f"sampling factors {hv >> 4}x{hv & 15} out of range")
            self.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-w // (8 * self.hmax))
        self.mcuy = -(-h // (8 * self.vmax))
        for c in self.comps:
            c.width = -(-w * c.h // self.hmax)   # downsampled size
            c.height = -(-h * c.v // self.vmax)
            c.bx, c.by = self.mcux * c.h, self.mcuy * c.v  # blocks, MCU-padded
            # zigzag order, block-major; an int32 array numpy then reads in place
            c.coef = array.array("i", bytes(4 * c.bx * c.by * 64))

    def _dht(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            tc_th = body[pos]
            counts = body[pos + 1:pos + 17]
            n = sum(counts)
            table = _Huffman(counts, body[pos + 17:pos + 17 + n])
            (self.ac if tc_th >> 4 else self.dc)[tc_th & 15] = table
            pos += 17 + n

    def _dqt(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            pq_tq = body[pos]
            if pq_tq >> 4:
                vals = np.frombuffer(body[pos + 1:pos + 129], ">u2").astype(np.int64)
                pos += 129
            else:
                vals = np.frombuffer(body[pos + 1:pos + 65], np.uint8).astype(np.int64)
                pos += 65
            self.qt[pq_tq & 15] = vals

    # -- entropy decoding ----------------------------------------------------
    def _scan(self, body: bytes, pos: int) -> int:
        ns = body[0]
        comps, tables = [], []
        for k in range(ns):
            cid, tdta = body[1 + 2 * k:3 + 2 * k]
            comp = next((c for c in self.comps if c.cid == cid), None)
            if comp is None:
                self.fail(f"scan names unknown component {cid}")
            if comp.quant is None:
                if comp.tq not in self.qt:
                    self.fail(f"quantisation table {comp.tq} is not defined")
                comp.quant = self.qt[comp.tq]
            comps.append(comp)
            tables.append((self.dc.get(tdta >> 4), self.ac.get(tdta & 15)))
        ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
        ah, al = ahal >> 4, ahal & 15
        if not self.progressive:
            ss, se, ah, al = 0, 63, 0, 0
        elif se > 63 or ss > se or (ss == 0) != (se == 0) or (ss and ns != 1) or al > 13:
            self.fail(f"invalid progressive scan (Ss {ss}, Se {se}, Al {al}, {ns} components)")
        segs, end = _segments(self.raw, pos)
        # the scan's blocks, in coding order: one MCU of the interleaved grid,
        # or one block of a lone component's own (unpadded) grid
        if ns == 1:
            c = comps[0]
            bw, bh = -(-c.width // 8), -(-c.height // 8)
            units = [[(0, (y * c.bx + x) * 64)] for y in range(bh) for x in range(bw)]
        else:
            units = []
            for my in range(self.mcuy):
                for mx in range(self.mcux):
                    unit = []
                    for k, c in enumerate(comps):
                        for v in range(c.v):
                            for h in range(c.h):
                                unit.append((k, ((my * c.v + v) * c.bx + mx * c.h + h) * 64))
                    units.append(unit)
        per = self.restart or len(units) or 1
        for s, start in enumerate(range(0, len(units), per)):
            win = _windows(segs[s] if s < len(segs) else b"")
            chunk = units[start:start + per]
            if ss == 0:
                if ah == 0:
                    self._dc_first(win, chunk, comps, tables, al, se if not self.progressive
                                   else 0)
                else:
                    self._dc_refine(win, chunk, comps, al)
            elif ah == 0:
                self._ac_first(win, chunk, comps[0], tables[0][1], ss, se, al)
            else:
                self._ac_refine(win, chunk, comps[0], tables[0][1], ss, se, al)
        return end

    def _dc_first(self, win, units, comps, tables, al, se) -> None:
        """A sequential scan (se = 63: DC and AC) or a progressive DC first
        scan (se = 0)."""
        pred = [0] * len(comps)
        coefs = [c.coef for c in comps]
        for t in tables:
            if t[0] is None or (se and t[1] is None):
                self.fail("scan uses an undefined Huffman table")
        dcs = [t[0].lut for t in tables]
        dcslow = [t[0] for t in tables]
        acs = [t[1].lut if se else None for t in tables]
        acslow = [t[1] for t in tables]
        p = 0
        for unit in units:
            for k, base in unit:
                # DC
                w = win[p >> 3]
                e = dcs[k][(w >> (23 - (p & 7))) & 0x1FF]
                if e:
                    p += e >> 8
                    s = e & 0xFF
                else:
                    s, n = dcslow[k].slow((w >> (16 - (p & 7))) & 0xFFFF)
                    p += n
                if s:
                    r = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if r < 1 << (s - 1):
                        r -= (1 << s) - 1
                    pred[k] += r
                coef = coefs[k]
                coef[base] = pred[k] << al
                if not se:
                    continue
                lut, slow = acs[k], acslow[k]
                i = 1
                while i < 64:
                    w = win[p >> 3]
                    e = lut[(w >> (23 - (p & 7))) & 0x1FF]
                    if e:
                        p += e >> 8
                        rs = e & 0xFF
                    else:
                        rs, n = slow.slow((w >> (16 - (p & 7))) & 0xFFFF)
                        p += n
                    s = rs & 15
                    if s:
                        i += rs >> 4
                        r = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                        p += s
                        if r < 1 << (s - 1):
                            r -= (1 << s) - 1
                        if i < 64:
                            coef[base + i] = r
                        i += 1
                    elif rs == 0xF0:
                        i += 16
                    else:
                        break

    def _dc_refine(self, win, units, comps, al) -> None:
        coefs = [c.coef for c in comps]
        bit = 1 << al
        p = 0
        for unit in units:
            for k, base in unit:
                if (win[p >> 3] >> (31 - (p & 7))) & 1:
                    coefs[k][base] |= bit
                p += 1

    def _ac_first(self, win, units, comp, table, ss, se, al) -> None:
        if table is None:
            self.fail("scan uses an undefined Huffman table")
        coef, lut = comp.coef, table.lut
        p = eobrun = 0
        for unit in units:
            if eobrun:
                eobrun -= 1
                continue
            base = unit[0][1]
            i = ss
            while i <= se:
                w = win[p >> 3]
                e = lut[(w >> (23 - (p & 7))) & 0x1FF]
                if e:
                    p += e >> 8
                    rs = e & 0xFF
                else:
                    rs, n = table.slow((w >> (16 - (p & 7))) & 0xFFFF)
                    p += n
                r, s = rs >> 4, rs & 15
                if s:
                    i += r
                    v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    if i < 64:
                        coef[base + i] = v * (1 << al)
                    i += 1
                elif r == 15:
                    i += 16
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                    eobrun -= 1
                    break

    def _ac_refine(self, win, units, comp, table, ss, se, al) -> None:
        """jdphuff.c's ``decode_mcu_AC_refine``: correction bits for the
        coefficients already nonzero, new ones of magnitude 1 << al."""
        if table is None:
            self.fail("scan uses an undefined Huffman table")
        coef, lut = comp.coef, table.lut
        p1, m1 = 1 << al, -1 << al
        p = eobrun = 0
        for unit in units:
            base = unit[0][1]
            k = ss
            if eobrun == 0:
                while k <= se:
                    w = win[p >> 3]
                    e = lut[(w >> (23 - (p & 7))) & 0x1FF]
                    if e:
                        p += e >> 8
                        rs = e & 0xFF
                    else:
                        rs, n = table.slow((w >> (16 - (p & 7))) & 0xFFFF)
                        p += n
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                            p += r
                        break
                    while k <= se:
                        c = coef[base + k]
                        if c:
                            if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                                coef[base + k] = c + (p1 if c >= 0 else m1)
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s and k < 64:
                        coef[base + k] = s
                    k += 1
            if eobrun:
                while k <= se:
                    c = coef[base + k]
                    if c:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                            coef[base + k] = c + (p1 if c >= 0 else m1)
                        p += 1
                    k += 1
                eobrun -= 1

    # -- the vectorised back end ---------------------------------------------
    def _output(self) -> np.ndarray:
        planes = []
        for c in self.comps:
            if c.quant is None:
                self.fail(f"component {c.cid} has no scan")
            zz = np.frombuffer(c.coef, np.int32).reshape(-1, 64) * c.quant
            nat = np.empty_like(zz)
            nat[:, ZIGZAG] = zz
            px = idct_islow(nat.reshape(-1, 8, 8)).reshape(c.by, c.bx, 8, 8)
            plane = px.transpose(0, 2, 1, 3).reshape(c.by * 8, c.bx * 8)[:c.height, :c.width]
            planes.append(self._upsample(plane, c))
        if len(planes) == 1:
            return np.repeat(planes[0][..., None], 3, axis=2)
        if self._colorspace() == "RGB":
            return np.ascontiguousarray(np.stack(planes, axis=2))
        return ycc_to_rgb(*planes)

    def _colorspace(self) -> str:
        """libjpeg-turbo's ``default_decompress_parms`` for 3 components."""
        if self.jfif:
            return "YCbCr"
        if self.adobe is not None:
            return "RGB" if self.adobe == 0 else "YCbCr"
        ids = tuple(c.cid for c in self.comps)
        return "RGB" if ids == (82, 71, 66) else "YCbCr"

    def _upsample(self, plane: np.ndarray, c: _Component) -> np.ndarray:
        """``jdsample.c``'s choice per component: full size, fancy h2v1 /
        h1v2 / h2v2 (h2 only above 2 columns), else box replication."""
        fh, fv = self.hmax // c.h, self.vmax // c.v
        if self.hmax % c.h or self.vmax % c.v:
            self.fail(f"non-integral sampling ratio {self.hmax}/{c.h} x {self.vmax}/{c.v}")
        p = plane.astype(np.int32)
        if (fh, fv) == (2, 1) and c.width > 2:
            out = h2v1_fancy(p)
        elif (fh, fv) == (1, 2):
            out = h1v2_fancy(p)
        elif (fh, fv) == (2, 2) and c.width > 2:
            out = h2v2_fancy(p)
        else:
            out = np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)
        return out[:self.height, :self.width].astype(np.uint8)


# -- jidctint.c: jpeg_idct_islow -----------------------------------------------
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172
# idct_sample_range_limit: the output's low 10 bits as a signed value, + 128,
# clamped to 0..255 (jdmaster.c's prepare_range_limit_table)
RANGE_LIMIT = np.clip(((np.arange(1024) + 512) % 1024) - 512 + 128, 0, 255).astype(np.uint8)


def _idct_1d(x):
    """One 8-point pass on the eight inputs -> the eight outputs before the
    descale (the even part's tmp10..13 and the odd part's tmp0..3)."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(blocks: np.ndarray) -> np.ndarray:
    """Dequantised coefficients [N, 8, 8] (row = vertical frequency), int64
    -> uint8 samples [N, 8, 8], bitwise libjpeg's ``jpeg_idct_islow`` (its
    zero-AC shortcuts give the same values as the full passes)."""
    x = blocks.astype(np.int64)
    n1 = CONST_BITS - PASS1_BITS
    cols = _idct_1d([x[:, k, :] for k in range(8)])             # pass 1: columns
    ws = np.stack([(o + (1 << (n1 - 1))) >> n1 for o in cols], axis=1)
    n2 = CONST_BITS + PASS1_BITS + 3
    rows = _idct_1d([ws[:, :, k] for k in range(8)])            # pass 2: rows
    out = np.stack([(o + (1 << (n2 - 1))) >> n2 for o in rows], axis=2)
    return RANGE_LIMIT[out & 1023]


# -- jdsample.c's fancy upsamplers (int32 samples in, out) -----------------------
def _pad_cols(p):
    return np.concatenate([p[:, :1], p, p[:, -1:]], axis=1)


def h2v1_fancy(p: np.ndarray) -> np.ndarray:
    """3/4 nearer + 1/4 further column, rounding alternately down and up.
    The edge columns repeated give libjpeg's special-cased first and last
    output columns (the edge sample itself)."""
    e = _pad_cols(p)
    cur, left, right = 3 * e[:, 1:-1], e[:, :-2], e[:, 2:]
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (cur + left + 1) >> 2
    out[:, 1::2] = (cur + right + 2) >> 2
    return out


def _vsums(p):
    """Per input row, the 3:1 column sums with the row above and below (edge
    rows repeated, as jdmainct.c's context pointers do)."""
    e = np.concatenate([p[:1], p, p[-1:]], axis=0)
    return 3 * e[1:-1] + e[:-2], 3 * e[1:-1] + e[2:]


def h1v2_fancy(p: np.ndarray) -> np.ndarray:
    up, down = _vsums(p)
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
    out[0::2], out[1::2] = (up + 1) >> 2, (down + 2) >> 2
    return out


def h2v2_fancy(p: np.ndarray) -> np.ndarray:
    """h1v2's column sums, then h2v1's weights on them (edges as there)."""
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    for v, colsum in enumerate(_vsums(p)):
        e = _pad_cols(colsum)
        cur, left, right = 3 * e[:, 1:-1], e[:, :-2], e[:, 2:]
        out[v::2, 0::2] = (cur + left + 8) >> 4
        out[v::2, 1::2] = (cur + right + 7) >> 4
    return out


# -- jdcolor.c: ycc_rgb_convert ----------------------------------------------------
_SCALEBITS, _ONE_HALF = 16, 1 << 15


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
CR_R = (_fix(1.40200) * _X + _ONE_HALF) >> _SCALEBITS
CB_B = (_fix(1.77200) * _X + _ONE_HALF) >> _SCALEBITS
CR_G = -_fix(0.71414) * _X
CB_G = -_fix(0.34414) * _X + _ONE_HALF


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 planes -> uint8 [H, W, 3] through libjpeg's fixed-point tables."""
    y = y.astype(np.int64)
    r = y + CR_R[cr]
    g = y + ((CB_G[cb] + CR_G[cr]) >> _SCALEBITS)
    b = y + CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)


def decode_jpeg(raw: bytes, path: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] RGB (``path`` names the file in errors)."""
    return _Decoder(raw, path).run()
