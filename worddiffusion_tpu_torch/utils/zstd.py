"""A zstd decoder in the standard library and numpy (RFC 8878).

The JAX package's checkpoints are orbax's: TensorStore OCDBT files and
zarr chunks, each a zstd frame. This module decodes them where no zstd
library is installed (the card's machine has none).

Scope: frames with and without a content size, single-segment or
windowed; skippable frames and several frames back to back; raw, RLE and
compressed blocks; literals raw, RLE, Huffman-coded in 1 or 4 streams or
treeless (the previous block's table); sequences in predefined, RLE,
FSE-compressed and repeat modes; the three repeat offsets; overlapping
matches. A frame's XXH64 checksum is verified where its flag is set. A
frame that names a dictionary is refused.

Python runs only the entropy loops. A Huffman stream's code lengths are
looked up for every bit position at once with numpy; the loop then only
chases positions, 16 symbols a step, through a jump table (the intermediate
positions are recovered with numpy afterwards). Literal runs and
non-overlapping matches are copied as slices.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE = range(0x184D2A50, 0x184D2A60)
BLOCK_MAX = 1 << 17

# literal length and match length codes: (baseline, extra bits), RFC 8878 3.1.1.3.2.1.1
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                             2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                1027, 2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

# the predefined distributions, RFC 8878 3.1.1.3.2.2
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3,
               2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (largest symbol, largest accuracy log) of each sequence table
LL_LIMITS, ML_LIMITS, OF_LIMITS = (35, 9), (52, 9), (31, 8)


class ZstdError(ValueError):
    """A malformed or unsupported zstd input."""


# -- FSE tables ----------------------------------------------------------------
class FSETable:
    """An FSE decoding table: for each state its symbol, the number of bits
    its update reads and the baseline they are added to (Python lists, for
    the sequence loop)."""

    def __init__(self, counts: list[int], log: int):
        size = 1 << log
        sym = [0] * size
        high = size - 1
        for s, c in enumerate(counts):
            if c == -1:  # "less than one": a cell each, from the top
                sym[high] = s
                high -= 1
        step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
        for s, c in enumerate(counts):
            for _ in range(max(c, 0)):
                sym[pos] = s
                pos = (pos + step) & mask
                while pos > high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ZstdError("FSE table: the spread did not close")
        nxt = [1 if c == -1 else c for c in counts]
        self.sym, self.nb, self.base, self.log = sym, [0] * size, [0] * size, log
        for u in range(size):
            s = sym[u]
            x = nxt[s]
            nxt[s] += 1
            nb = log - (x.bit_length() - 1)
            self.nb[u], self.base[u] = nb, (x << nb) - size

    @classmethod
    def rle(cls, symbol: int) -> "FSETable":
        t = cls.__new__(cls)
        t.sym, t.nb, t.base, t.log = [symbol], [0], [0], 0
        return t


def read_fse_counts(data, pos: int, max_symbol: int, max_log: int) -> tuple[list[int], int, int]:
    """An FSE table description at byte ``pos``: (normalised counts, accuracy
    log, the byte after it). RFC 8878 4.1.1."""
    bit = pos * 8
    end = len(data) * 8

    def peek(n):
        i = bit >> 3
        return (int.from_bytes(data[i:i + 4], "little") >> (bit & 7)) & ((1 << n) - 1)

    log = peek(4) + 5
    bit += 4
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts: list[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description: too many symbols")
        big = (2 * threshold - 1) - remaining
        v = peek(nbits)
        if (v & (threshold - 1)) < big:
            count = v & (threshold - 1)
            bit += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= big
            bit += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:  # 2-bit repeat flags: more zero counts
                r = peek(2)
                bit += 2
                counts.extend([0] * r)
                if r != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
        if bit > end:
            raise ZstdError("FSE table description runs past its input")
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("FSE table description: counts do not sum to the table")
    return counts, log, (bit + 7) >> 3


# -- backward bitstreams -------------------------------------------------------
def _stream_start(data, lo: int, hi: int) -> int:
    """The bit position of a backward stream's first data bit (below its
    final 1-bit) over ``data[lo:hi]``, counted from ``lo``."""
    if hi <= lo or data[hi - 1] == 0:
        raise ZstdError("bitstream without its final 1-bit")
    return (hi - lo - 1) * 8 + data[hi - 1].bit_length() - 1


def _bits(data, lo: int, a: int, n: int) -> int:
    """Bits [a, a + n) of the little-endian number ``data[lo:]``, zero below
    bit 0."""
    if a < 0:
        return _bits(data, lo, 0, n + a) << -a if n + a > 0 else 0
    i = lo + (a >> 3)
    return (int.from_bytes(data[i:i + ((a & 7) + n + 7) // 8], "little") >> (a & 7)) & ((1 << n) - 1)


# -- Huffman literals ----------------------------------------------------------
class HuffmanTable:
    def __init__(self, weights: list[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if not total:
            raise ZstdError("Huffman weights all zero")
        bits = total.bit_length()
        rest = (1 << bits) - total
        if rest & (rest - 1):
            raise ZstdError("Huffman weights do not complete a tree")
        weights = weights + [rest.bit_length()]
        if bits > 11 or len(weights) > 256:
            raise ZstdError(f"Huffman table of {bits} bits, {len(weights)} symbols")
        w = np.asarray(weights, np.int64)
        syms = np.flatnonzero(w)
        syms = syms[np.argsort(w[syms], kind="stable")]
        spans = 1 << (w[syms] - 1)
        self.bits = bits
        self.sym = np.repeat(syms.astype(np.uint8), spans)
        self.nb = np.repeat((bits + 1 - w[syms]).astype(np.uint8), spans)


def _read_huffman_table(data, pos: int) -> tuple[HuffmanTable, int]:
    head = data[pos]
    if head >= 128:  # direct: 4 bits a weight
        n = head - 127
        raw = data[pos + 1:pos + 1 + (n + 1) // 2]
        weights = [v for b in raw for v in (b >> 4, b & 15)][:n]
        return HuffmanTable(weights), pos + 1 + (n + 1) // 2
    end = pos + 1 + head
    counts, log, start = read_fse_counts(data[:end], pos + 1, 255, 6)
    t = FSETable(counts, log)
    p = _stream_start(data, start, end)
    s1 = _bits(data, start, p - log, log)
    s2 = _bits(data, start, p - 2 * log, log)
    p -= 2 * log
    weights: list[int] = []
    states = [s1, s2]
    k = 0
    while True:  # alternate the two states until the stream runs out
        s = states[k]
        weights.append(t.sym[s])
        nb = t.nb[s]
        states[k] = t.base[s] + _bits(data, start, p - nb, nb)
        p -= nb
        if p < 0:
            weights.append(t.sym[states[1 - k]])
            break
        k = 1 - k
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return HuffmanTable(weights), end


def _huffman_stream(data, lo: int, hi: int, n: int, table: HuffmanTable) -> np.ndarray:
    """Decode ``n`` symbols of one backward Huffman stream ``data[lo:hi]``."""
    if n == 0:
        return np.zeros(0, np.uint8)
    p = _stream_start(data, lo, hi)
    mb = table.bits
    # the mb bits below each position q = 8 i + k (MSB first, zero below bit
    # 0): bits [q - mb, q), read from a 24-bit window of the bytes behind two
    # zero bytes; for each k the byte and the shift are the same for every i
    raw = np.concatenate([np.zeros(2, np.uint8), np.frombuffer(data, np.uint8, hi - lo, lo),
                          np.zeros(3, np.uint8)]).astype(np.uint32)
    u = raw[:-2] | (raw[1:-1] << 8) | (raw[2:] << 16)
    win = np.empty(((p >> 3) + 1) * 8, np.int32)
    rows = (p >> 3) + 1
    for k in range(8):
        c, s = divmod(k - mb + 16, 8)
        win[k::8] = (u[c:c + rows] >> s) & ((1 << mb) - 1)
    win = win[:p + 1]
    # the chain of read positions: nxt[q] = q less the code length at q,
    # clamped at 0 (a read past the start is caught below)
    nb = np.take(table.nb, win)
    nxt = np.arange(p + 1, dtype=np.int32) - nb
    np.maximum(nxt, 0, out=nxt)
    jump = nxt  # 16 symbols a step
    for _ in range(4):
        jump = np.take(jump, jump)
    steps, pos = n >> 4, p
    chain = np.empty((steps, 16), np.int32)
    if steps:
        heads = [0] * steps
        for i in range(steps):
            heads[i] = pos
            pos = int(jump[pos])
        chain[:, 0] = heads
        for k in range(1, 16):
            chain[:, k] = np.take(nxt, chain[:, k - 1])
    tail = []
    for _ in range(n & 15):
        tail.append(pos)
        pos = int(nxt[pos])
    order = np.concatenate([chain.reshape(-1), np.asarray(tail, np.int32)])
    if pos != 0 or (order < np.take(nb, order)).any() or (order <= 0).any():
        raise ZstdError("Huffman stream not consumed exactly")
    return np.take(table.sym, np.take(win, order))


def _read_literals(data, pos: int, st: "_State") -> tuple[bytes, int]:
    b0 = data[pos]
    kind, sf = b0 & 3, (b0 >> 2) & 3
    if kind < 2:  # raw / RLE
        if sf in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif sf == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), pos + 3
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("raw literals run past the block")
            return bytes(data[pos:pos + size]), pos + size
        return bytes([data[pos]]) * size, pos + 1
    hsize, nbits = ((3, 10), (3, 10), (4, 14), (5, 18))[sf]
    v = int.from_bytes(data[pos:pos + hsize], "little") >> 4
    regen, comp = v & ((1 << nbits) - 1), (v >> nbits) & ((1 << nbits) - 1)
    pos += hsize
    end = pos + comp
    if end > len(data):
        raise ZstdError("compressed literals run past the block")
    if kind == 2:
        st.huffman, pos = _read_huffman_table(data, pos)
    elif st.huffman is None:
        raise ZstdError("treeless literals without a previous Huffman table")
    if sf == 0:
        out = _huffman_stream(data, pos, end, regen, st.huffman)
    else:
        s1, s2, s3 = (int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little")
                      for i in range(3))
        seg = (regen + 3) // 4
        bounds = np.cumsum([pos + 6, s1, s2, s3]).tolist() + [end]
        if bounds[3] > end:
            raise ZstdError("Huffman jump table past the literals")
        out = np.concatenate([_huffman_stream(data, bounds[i], bounds[i + 1],
                                              seg if i < 3 else regen - 3 * seg, st.huffman)
                              for i in range(4)])
    return out.tobytes(), end


# -- sequences -----------------------------------------------------------------
def _seq_table(data, pos: int, mode: int, prev, default, limits, name):
    if mode == 0:
        return FSETable(*default), pos
    if mode == 1:
        if data[pos] > limits[0]:
            raise ZstdError(f"{name} RLE symbol {data[pos]} out of range")
        return FSETable.rle(data[pos]), pos + 1
    if mode == 2:
        counts, log, pos = read_fse_counts(data, pos, *limits)
        return FSETable(counts, log), pos
    if prev is None:
        raise ZstdError(f"{name}: repeat mode without a previous table")
    return prev, pos


def _execute_sequences(data, pos: int, end: int, lits: bytes, out: bytearray, st: "_State"):
    b0 = data[pos]
    if b0 == 0:
        out += lits
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence compression modes")
    st.ll, pos = _seq_table(data, pos, modes >> 6, st.ll, LL_DEFAULT, LL_LIMITS, "literal lengths")
    st.of, pos = _seq_table(data, pos, (modes >> 4) & 3, st.of, OF_DEFAULT, OF_LIMITS, "offsets")
    st.ml, pos = _seq_table(data, pos, (modes >> 2) & 3, st.ml, ML_DEFAULT, ML_LIMITS,
                            "match lengths")
    llt, oft, mlt = st.ll, st.of, st.ml
    ll_sym, ll_nb, ll_base = llt.sym, llt.nb, llt.base
    of_sym, of_nb, of_base = oft.sym, oft.nb, oft.base
    ml_sym, ml_nb, ml_base = mlt.sym, mlt.nb, mlt.base
    p = _stream_start(data, pos, end)
    lo = pos
    sl = _bits(data, lo, p - llt.log, llt.log)
    p -= llt.log
    so = _bits(data, lo, p - oft.log, oft.log)
    p -= oft.log
    sm = _bits(data, lo, p - mlt.log, mlt.log)
    p -= mlt.log
    rep0, rep1, rep2 = st.rep
    lp = 0
    from_bytes = int.from_bytes
    nlit = len(lits)
    for i in range(nseq):
        llc, ofc, mlc = ll_sym[sl], of_sym[so], ml_sym[sm]
        if llc > 35 or mlc > 52 or ofc > 31:
            raise ZstdError("sequence code out of range")
        llb, mlb = LL_BITS[llc], ML_BITS[mlc]
        n = ofc + mlb + llb
        last = i == nseq - 1
        if not last:
            n1, n2, n3 = ll_nb[sl], ml_nb[sm], of_nb[so]
            n += n1 + n2 + n3
        p -= n
        if p < 0:
            raise ZstdError("sequence bitstream overrun")
        j = lo + (p >> 3)
        v = (from_bytes(data[j:j + (((p & 7) + n + 7) >> 3)], "little") >> (p & 7)) & ((1 << n) - 1)
        rest = n - ofc
        ofv = (1 << ofc) + (v >> rest)
        v &= (1 << rest) - 1
        rest -= mlb
        ml = ML_BASE[mlc] + (v >> rest)
        v &= (1 << rest) - 1
        rest -= llb
        ll = LL_BASE[llc] + (v >> rest)
        if not last:
            v &= (1 << rest) - 1
            rest -= n1
            sl = ll_base[sl] + (v >> rest)
            v &= (1 << rest) - 1
            rest -= n2
            sm = ml_base[sm] + (v >> rest)
            so = of_base[so] + (v & ((1 << rest) - 1))
        if ofv > 3:
            off = ofv - 3
            rep0, rep1, rep2 = off, rep0, rep1
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                off = rep0
            elif idx == 1:
                off = rep1
                rep0, rep1 = rep1, rep0
            elif idx == 2:
                off = rep2
                rep0, rep1, rep2 = rep2, rep0, rep1
            else:
                off = rep0 - 1
                rep0, rep1, rep2 = off, rep0, rep1
        if ll:
            if lp + ll > nlit:
                raise ZstdError("sequence takes more literals than the block has")
            out += lits[lp:lp + ll]
            lp += ll
        start = len(out) - off
        if off <= 0 or start < 0:
            raise ZstdError(f"match offset {off} outside the output")
        if off >= ml:
            out += out[start:start + ml]
        else:  # overlapping: the last `off` bytes repeat
            pat = out[start:]
            out += (pat * (ml // off + 1))[:ml]
    if p != 0:
        raise ZstdError("sequence bitstream not consumed exactly")
    st.rep = [rep0, rep1, rep2]
    out += lits[lp:]


# -- frames --------------------------------------------------------------------
class _State:
    """What a frame's blocks carry over: the Huffman table, the sequence
    tables and the repeat offsets."""

    def __init__(self):
        self.huffman = self.ll = self.of = self.ml = None
        self.rep = [1, 4, 8]


def _frame(data, pos: int, out: bytearray) -> int:
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    window = 0
    if not single:
        wd = data[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    dsize = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(data[pos:pos + dsize], "little")
    pos += dsize
    if dict_id:
        raise ZstdError(f"frame needs dictionary ID {dict_id}; dictionaries are not supported")
    fsize = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = int.from_bytes(data[pos:pos + fsize], "little") + (256 if fsize == 2 else 0)
    pos += fsize
    if single:
        window = content
    block_max = min(window, BLOCK_MAX)
    start = len(out)
    st = _State()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, btype, size = h & 1, (h >> 1) & 3, h >> 3
        if btype == 0:
            if size > block_max or pos + size > len(data):
                raise ZstdError("raw block too large or truncated")
            out += data[pos:pos + size]
            pos += size
        elif btype == 1:
            if size > block_max:
                raise ZstdError("RLE block too large")
            out += bytes([data[pos]]) * size
            pos += 1
        elif btype == 2:
            if size > block_max or pos + size > len(data):
                raise ZstdError("compressed block too large or truncated")
            blk = bytes(data[pos:pos + size])
            before = len(out)
            lits, lpos = _read_literals(blk, 0, st)
            _execute_sequences(blk, lpos, size, lits, out, st)
            if len(out) - before > block_max:
                raise ZstdError("block decompresses past its maximum size")
            pos += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if fsize or single:
        if len(out) - start != content:
            raise ZstdError(f"frame content {len(out) - start} bytes, header says {content}")
    if checksum:
        want = int.from_bytes(data[pos:pos + 4], "little")
        got = xxh64(memoryview(out)[start:]) & 0xFFFFFFFF
        if got != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress(data) -> bytes:
    """Every frame of ``data`` (bytes-like) decoded, back to back; skippable
    frames are skipped."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic in SKIPPABLE:
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos > len(data):
                raise ZstdError("truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:08x})")
        try:
            pos = _frame(data, pos + 4, out)
        except (IndexError, KeyError) as e:  # a field read past its input
            raise ZstdError(f"malformed frame at byte {pos}: {e!r}") from e
    return bytes(out)


# -- XXH64 ---------------------------------------------------------------------
_P1, _P2, _P3, _P4, _P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                           0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)
_M = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M, 31) * _P1) & _M


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (the checksum of a zstd frame is its low 32 bits)."""
    data = bytes(data)
    n = len(data)
    i = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed & _M, (seed - _P1) & _M]
        lanes = np.frombuffer(data, "<u8", (n // 32) * 4).reshape(-1, 4).T.tolist()
        for k in range(4):
            acc = v[k]
            for lane in lanes[k]:
                acc = (_rotl((acc + lane * _P2) & _M, 31) * _P1) & _M
            v[k] = acc
        i = (n // 32) * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M
        for acc in v:
            h = ((h ^ _round(0, acc)) * _P1 + _P4) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _P1) & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    return h ^ (h >> 32)
