"""Baseline JPEG decoding and encoding in numpy, without PIL.

`decode_jpeg(buf)` returns what libjpeg-turbo's default decompression
gives (the route of PIL's `Image.open(...).convert("RGB")`), byte for
byte: uint8 (H, W, 3) for YCbCr or RGB streams, (H, W, 1) for gray. It
takes baseline (and extended) sequential, 8-bit, Huffman-coded streams
with one scan over every component: any DQT/DHT tables, restart
intervals, 1 or 3 components, sampling 4:4:4, 4:2:2 and 4:2:0, any width
and height. It raises ValueError on progressive, lossless, hierarchical
and arithmetic-coded streams, on 12-bit samples, on 4-component
(CMYK/YCCK) and multi-scan streams, and on other samplings.

Where the bytes come from, in libjpeg-turbo's terms:
  * Huffman decoding is the only per-symbol loop in Python. Each restart
    interval is unstuffed (FF00 -> FF) into bytes, every bit offset gets
    its 16-bit window (numpy, over a bounded stretch of bytes), and a
    65536-entry table per Huffman table maps a window to the symbol's
    code length, run and, where code and extra bits fit in 16 bits, its
    signed value: one table lookup per coefficient;
  * dequantisation and the integer "islow" IDCT (jidctint.c: CONST_BITS
    13, PASS1_BITS 2, its DESCALE rounding, +128 and the range limit) run
    over all blocks at once in int64;
  * chroma is upsampled with the "fancy" triangle filters of jdsample.c
    (h2v1: 3/4 near + 1/4 far with biases +1/+2; h2v2: 9/16, 3/16, 3/16,
    1/16 with biases +8/+7), edge rows and columns replicated as
    jdmainct.c and jdsample.c do; components 2 samples wide or less are
    replicated (h2v1_upsample / h2v2_upsample), as libjpeg does;
  * YCbCr -> RGB goes through jdcolor.c's fixed-point tables (SCALEBITS
    16) and clamps to 0..255.

`encode_jpeg(arr, quality)` writes baseline JFIF with libjpeg's Annex K
tables scaled by quality (`jpeg_quality_scaling`), 4:2:0 for RGB and one
component for gray, and the standard Huffman tables. It is not byte-equal
to PIL's encoder, but every decoder gives its streams the same pixels.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np


def _zigzag() -> np.ndarray:
    """NATURAL[k]: row-major index of the k-th coefficient in zigzag order."""
    order = []
    for s in range(15):
        rows = range(max(0, s - 7), min(s, 7) + 1)
        if s % 2 == 0:
            rows = reversed(rows)
        order += [r * 8 + (s - r) for r in rows]
    return np.array(order)


NATURAL = _zigzag()

# ---------------------------------------------------------------- tables

# the entry of a 16-bit window in a decoding table (one Python int):
# bits 0-4 the bits to consume, 5-8 the run (AC), 9 end of block, 10 the
# slow path (code + extra bits > 16), 11 an invalid code, 12-15 the extra
# bits' count (slow path), 16 and up the signed value
_EOB, _SLOW, _BAD = 1 << 9, 1 << 10, 1 << 11
_TABLES: Dict[Tuple[int, bytes], List[int]] = {}


def _codes(bits: bytes, vals: bytes):
    """Canonical Huffman codes: [(code, length, symbol)]."""
    out, code, i = [], 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out.append((code, length, vals[i]))
            code += 1
            i += 1
        code <<= 1
    return out


def _decode_table(kind: int, bits: bytes, vals: bytes) -> List[int]:
    """The 65536 entries of a DC (kind 0) or AC (kind 1) table."""
    key = (kind, bits + vals)
    if key in _TABLES:
        return _TABLES[key]
    lens = np.zeros(65536, np.int64)
    syms = np.zeros(65536, np.int64)
    for code, length, sym in _codes(bits, vals):
        if code + 1 > 1 << length:
            raise ValueError("JPEG: bad Huffman table")
        lo = code << (16 - length)
        lens[lo:lo + (1 << (16 - length))] = length
        syms[lo:lo + (1 << (16 - length))] = sym
    w = np.arange(65536, dtype=np.int64)
    size = syms & 15 if kind else syms
    if int(size.max()) > 15:
        raise ValueError("JPEG: bad DC symbol")
    run = syms >> 4 if kind else np.zeros_like(syms)
    fits = lens + size <= 16
    shift = np.where(fits, 16 - lens - size, 0)
    extra = (w >> shift) & ((1 << size) - 1)
    val = np.where(extra < (1 << np.maximum(size - 1, 0)),
                   extra - (1 << size) + 1, extra)
    val = np.where(size > 0, val, 0)
    ent = np.where(fits, lens + size, lens) | (run << 5) | (size << 12)
    ent |= np.where(fits, val << 16, _SLOW)
    if kind:
        ent = np.where((size == 0) & (run != 15), lens | _EOB, ent)
    ent = np.where(lens == 0, _BAD, ent)
    table = ent.tolist()
    if len(_TABLES) > 64:
        _TABLES.clear()
    _TABLES[key] = table
    return table


# ------------------------------------------------------------ bitstream

_SEG = 1 << 14      # bytes windowed at a time
_AHEAD = 1 << 12    # bytes of look-ahead beyond a stretch (> one MCU)


def _windows(data: bytes, start: int) -> List[int]:
    """16-bit windows at every bit offset of data[start:start+_SEG+_AHEAD]
    (zeros past the end, as libjpeg feeds once the data run out)."""
    piece = data[start:start + _SEG + _AHEAD] + b"\0\0\0\0"
    b = np.frombuffer(piece, np.uint8).astype(np.int64)
    triple = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    shifts = 8 - np.arange(8)
    return ((triple[:, None] >> shifts) & 0xFFFF).reshape(-1).tolist()


def _entropy_segments(buf: bytes, pos: int):
    """Unstuffed restart intervals of the scan that starts at `pos`, the
    RST numbers between them, and the position of the marker that ends
    the scan."""
    segs, rst, cur = [], [], bytearray()
    n = len(buf)
    while True:
        j = buf.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            cur += buf[pos:]
            segs.append(bytes(cur))
            return segs, rst, n
        cur += buf[pos:j]
        m = buf[j + 1]
        if m == 0:
            cur.append(0xFF)
            pos = j + 2
        elif m == 0xFF:
            pos = j + 1                   # a fill byte
        elif 0xD0 <= m <= 0xD7:
            segs.append(bytes(cur))
            rst.append(m - 0xD0)
            cur = bytearray()
            pos = j + 2
        else:
            segs.append(bytes(cur))
            return segs, rst, j


def _slow(t: int, win: List[int], p: int):
    """An entry whose code and extra bits exceed 16: -> (value, bits)."""
    if t & _BAD:
        raise ValueError("JPEG: invalid Huffman code")
    length, size = t & 31, (t >> 12) & 15
    extra = win[p + length] >> (16 - size)
    if extra < 1 << (size - 1):
        extra -= (1 << size) - 1
    return extra, length + size


def _decode_interval(data: bytes, slots, dest, first: int, count: int,
                     coefs: List[int], ncomp: int) -> None:
    """Huffman-decode `count` blocks of one restart interval into coefs
    (80 zigzag slots a block; a run past 63 lands in slots 64-79)."""
    preds = [0] * ncomp
    nslots = len(slots)
    start, p = 0, 0
    win = _windows(data, 0)
    limit = 8 * _SEG
    for j in range(first, first + count):
        if p >= limit:                 # move the window stretch along
            start += p >> 3
            p &= 7
            win = _windows(data, start)
        ci, dct, act = slots[j % nslots]
        t = dct[win[p]]
        if t & (_SLOW | _BAD):
            diff, adv = _slow(t, win, p)
        else:
            diff, adv = t >> 16, t & 31
        p += adv
        preds[ci] += diff
        base = dest[j] * 80
        coefs[base] = preds[ci]
        k = 1
        while k < 64:
            t = act[win[p]]
            if t & _EOB:
                p += t & 31
                break
            if t & (_SLOW | _BAD):
                val, adv = _slow(t, win, p)
            else:
                val, adv = t >> 16, t & 31
            p += adv
            k += (t >> 5) & 15
            coefs[base + k] = val
            k += 1
    if (start << 3) + p > 8 * len(data) + 16:
        raise ValueError("JPEG: entropy-coded data ended early")


# ------------------------------------------------------------------ IDCT

_F = {"0298": 2446, "0390": 3196, "0541": 4433, "0765": 6270, "0899": 7373,
      "1175": 9633, "1501": 12299, "1847": 15137, "1961": 16069,
      "2053": 16819, "2562": 20995, "3072": 25172}


def _idct_1d(d):
    """jidctint.c's 8-point butterfly on d[0..7] (arrays); -> 8 sums
    still to be descaled."""
    f = _F
    z1 = (d[2] + d[6]) * f["0541"]
    tmp2 = z1 - d[6] * f["1847"]
    tmp3 = z1 + d[2] * f["0765"]
    tmp0 = (d[0] + d[4]) << 13
    tmp1 = (d[0] - d[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1175"]
    t0, t1 = t0 * f["0298"], t1 * f["2053"]
    t2, t3 = t2 * f["3072"], t3 * f["1501"]
    z1, z2 = z1 * -f["0899"], z2 * -f["2562"]
    z3, z4 = z3 * -f["1961"] + z5, z4 * -f["0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised (N, 8, 8) coefficients (row = vertical frequency) ->
    (N, 8, 8) uint8 samples, as jpeg_idct_islow computes them."""
    c = coef.astype(np.int64)
    out1 = _idct_1d([c[:, k, :] for k in range(8)])        # columns
    ws = np.stack([(o + (1 << 10)) >> 11 for o in out1], axis=1)
    out2 = _idct_1d([ws[:, :, k] for k in range(8)])        # rows
    s = np.stack([(o + (1 << 17)) >> 18 for o in out2], axis=2)
    return np.clip(s + 128, 0, 255).astype(np.uint8)


# ------------------------------------------------- upsampling and colour


def _edge(x: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """x's neighbours before and after along `axis`, edges replicated."""
    n = x.shape[axis]
    before = np.take(x, np.r_[0, np.arange(n - 1)], axis=axis)
    after = np.take(x, np.r_[np.arange(1, n), n - 1], axis=axis)
    return before, after


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(plane: np.ndarray, h2: bool, v2: bool) -> np.ndarray:
    """jdsample.c's fancy upsampling of one component (real samples only)."""
    if not h2 and not v2:
        return plane
    if plane.shape[1] <= 2:            # libjpeg's plain replication
        out = np.repeat(plane, 2, axis=1)
        return np.repeat(out, 2, axis=0) if v2 else out
    s = plane.astype(np.int32)
    if not v2:                          # h2v1
        left, right = _edge(s, 1)
        return _interleave((3 * s + left + 1) >> 2, (3 * s + right + 2) >> 2,
                           1).astype(np.uint8)
    above, below = _edge(s, 0)
    rows = []
    for cs in (3 * s + above, 3 * s + below):
        left, right = _edge(cs, 1)
        rows.append(_interleave((3 * cs + left + 8) >> 4,
                                (3 * cs + right + 7) >> 4, 1))
    return _interleave(rows[0], rows[1], 0).astype(np.uint8)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _X + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _X + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + (1 << 15)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on uint8 planes -> (H, W, 3) uint8."""
    y = y.astype(np.int64)
    rgb = np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
                    y + _CB_B[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# --------------------------------------------------------------- decoder

_REFUSED_SOF = {0xC2: "progressive", 0xC3: "lossless",
                0xC5: "hierarchical", 0xC6: "hierarchical",
                0xC7: "hierarchical", 0xC9: "arithmetic-coded",
                0xCA: "arithmetic-coded", 0xCB: "arithmetic-coded",
                0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded",
                0xCF: "arithmetic-coded", 0xCC: "arithmetic-coded",
                0xC8: "reserved (JPG)"}


def _read_dqt(seg: bytes, qt: dict) -> None:
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        n = 128 if pq else 64
        vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
        if len(vals) != 64:
            raise ValueError("JPEG: truncated DQT")
        table = np.empty(64, np.int64)
        table[NATURAL] = vals
        qt[tq] = table
        i += 1 + n


def _read_dht(seg: bytes, ht: dict) -> None:
    i = 0
    while i < len(seg):
        tc, th = seg[i] >> 4, seg[i] & 15
        bits = seg[i + 1:i + 17]
        n = sum(bits)
        vals = seg[i + 17:i + 17 + n]
        if len(bits) != 16 or len(vals) != n or tc > 1:
            raise ValueError("JPEG: bad DHT")
        ht[(tc, th)] = _decode_table(tc, bits, vals)
        i += 17 + n


def _color_space(comps, jfif: bool, adobe) -> str:
    """libjpeg's guess for a 3-component stream (jdapimin.c)."""
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    ids = tuple(c[0] for c in comps)
    return "rgb" if ids == (82, 71, 66) else "ycc"


def decode_jpeg(buf: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) or, for gray, (H, W, 1)."""
    buf = bytes(buf)
    if buf[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream")
    qt: dict = {}
    ht: dict = {}
    frame = None
    restart = 0
    jfif, adobe = False, None
    coefs = None
    pos, n = 2, len(buf)
    while pos < n:
        if buf[pos] != 0xFF:
            pos = buf.find(b"\xff", pos)   # libjpeg skips stray bytes
            if pos < 0:
                break
        while pos < n and buf[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = buf[pos]
        pos += 1
        if m == 0xD9:
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        if pos + 2 > n:
            raise ValueError("JPEG: truncated marker")
        length, = struct.unpack_from(">H", buf, pos)
        seg = buf[pos + 2:pos + length]
        pos += length
        if m in _REFUSED_SOF:
            raise ValueError(f"JPEG: {_REFUSED_SOF[m]} streams are not "
                             "supported (baseline sequential only)")
        if m == 0xDB:
            _read_dqt(seg, qt)
        elif m == 0xC4:
            _read_dht(seg, ht)
        elif m == 0xDD:
            restart, = struct.unpack(">H", seg[:2])
        elif m == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m in (0xC0, 0xC1):
            if frame is not None:
                raise ValueError("JPEG: more than one frame")
            precision, h, w, nf = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise ValueError(f"JPEG: {precision}-bit samples are not "
                                 "supported (8-bit only)")
            if nf not in (1, 3):
                raise ValueError(f"JPEG: {nf} components are not supported "
                                 "(gray or 3-component colour only)")
            if h == 0 or w == 0:
                raise ValueError("JPEG: empty or DNL-sized frame")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4,
                      seg[7 + 3 * i] & 15, seg[8 + 3 * i]) for i in range(nf)]
            frame = (h, w, comps)
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before frame")
            if coefs is not None:
                raise ValueError("JPEG: multi-scan streams are not supported")
            coefs, layout, pos = _decode_scan(buf, seg, pos, frame, ht,
                                              restart)
    if coefs is None:
        raise ValueError("JPEG: no scan")
    return _reconstruct(coefs, layout, frame, qt, jfif, adobe)


def _decode_scan(buf, seg, pos, frame, ht, restart):
    h, w, comps = frame
    ns = seg[0]
    if ns != len(comps):
        raise ValueError("JPEG: multi-scan streams are not supported "
                         f"(a scan of {ns} of {len(comps)} components)")
    sel = {seg[1 + 2 * i]: (seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15)
           for i in range(ns)}
    ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        raise ValueError("JPEG: not a sequential scan")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    slots, grids, offsets = [], [], []
    total = 0
    if len(comps) == 1:                # non-interleaved: one block an MCU
        cid = comps[0][0]
        bw, bh = -(-w // 8), -(-h // 8)
        grids.append((bh, bw))
        offsets.append(0)
        total = bw * bh
        dest = list(range(total))
        td, ta = sel[cid]
        slots.append((0, ht[(0, td)], ht[(1, ta)]))
        n_mcu = total
    else:
        mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
        n_mcu = mx * my
        dest_cols = []
        for ci, (cid, hc, vc, _) in enumerate(comps):
            if cid not in sel:
                raise ValueError("JPEG: scan misses a component")
            td, ta = sel[cid]
            if (0, td) not in ht or (1, ta) not in ht:
                raise ValueError("JPEG: scan uses an undefined Huffman table")
            gw, gh = mx * hc, my * vc
            grids.append((gh, gw))
            offsets.append(total)
            m = np.arange(n_mcu)
            for v in range(vc):
                for hh in range(hc):
                    slots.append((ci, ht[(0, td)], ht[(1, ta)]))
                    row = (m // mx) * vc + v
                    col = (m % mx) * hc + hh
                    dest_cols.append(total + row * gw + col)
            total += gw * gh
        dest = np.stack(dest_cols, axis=1).reshape(-1).tolist()
    per_mcu = len(slots)
    segs, rst, end = _entropy_segments(buf, pos)
    interval = restart if restart else n_mcu
    want = -(-n_mcu // interval)
    if len(segs) < want:
        raise ValueError("JPEG: entropy-coded data ended early")
    if any(r != i % 8 for i, r in enumerate(rst[:want - 1])):
        raise ValueError("JPEG: restart markers out of sequence")
    coefs = [0] * (total * 80)
    for i in range(want):
        first = i * interval * per_mcu
        count = min(interval, n_mcu - i * interval) * per_mcu
        _decode_interval(segs[i], slots, dest, first, count, coefs,
                         len(comps))
    c = np.array(coefs, np.int64).reshape(total, 80)
    if c[:, 64:].any():
        raise ValueError("JPEG: a coefficient run passed the block's end")
    return c[:, :64], (grids, offsets, hmax, vmax), end


def _reconstruct(zz, layout, frame, qt, jfif, adobe) -> np.ndarray:
    h, w, comps = frame
    grids, offsets, hmax, vmax = layout
    planes = []
    for ci, (cid, hc, vc, tq) in enumerate(comps):
        if tq not in qt:
            raise ValueError("JPEG: component uses an undefined DQT table")
        gh, gw = grids[ci]
        blocks = zz[offsets[ci]:offsets[ci] + gh * gw]
        nat = np.empty_like(blocks)
        nat[:, NATURAL] = blocks
        samples = _idct_islow((nat * qt[tq]).reshape(-1, 8, 8))
        plane = samples.reshape(gh, gw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(gh * 8, gw * 8)
        # the component's real samples (jdmaster.c's downsampled size)
        ch, cw = -(-h * vc // vmax), -(-w * hc // hmax)
        planes.append((plane[:ch, :cw], hc, vc))
    if len(comps) == 1:
        return planes[0][0][:h, :w, None].copy()
    luma = planes[0]
    if (luma[1], luma[2]) != (hmax, vmax) or any(
            (p[1], p[2]) != (1, 1) for p in planes[1:]) or (
            hmax, vmax) not in ((1, 1), (2, 1), (2, 2)):
        raise ValueError("JPEG: sampling "
                         f"{[(p[1], p[2]) for p in planes]} is not supported "
                         "(4:4:4, 4:2:2 and 4:2:0 only)")
    full = [planes[0][0]] + [_upsample(p[0], hmax == 2, vmax == 2)
                             for p in planes[1:]]
    full = [p[:h, :w] for p in full]
    if _color_space(comps, jfif, adobe) == "rgb":
        return np.stack(full, axis=-1)
    return _ycc_to_rgb(*full)


# --------------------------------------------------------------- encoder

# ITU T.81 Annex K tables (libjpeg's std_luminance_quant_tbl and friends),
# in natural order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] +
    [99] * 32)
_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
            bytes(range(12)))
_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
              bytes(range(12)))
_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]), bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa]))
_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa]))


def _quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling + jpeg_add_quant_table (baseline)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _encode_table(spec) -> Tuple[np.ndarray, np.ndarray]:
    """Symbol -> (code, length) arrays of a Huffman table."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    for c, n, sym in _codes(*spec):
        code[sym], length[sym] = c, n
    return code, length


def _fdct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    d = np.cos((2 * x + 1) * u * np.pi / 16) / 2
    d[0] /= np.sqrt(2)
    return d


_FDCT = _fdct_matrix()


def _blocks(plane: np.ndarray, gh: int, gw: int) -> np.ndarray:
    """A plane padded by replication to (8 gh, 8 gw) -> (gh * gw, 8, 8)."""
    ph, pw = 8 * gh - plane.shape[0], 8 * gw - plane.shape[1]
    p = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    return p.reshape(gh, 8, gw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG magnitude category)."""
    a = np.abs(v)
    s = np.zeros_like(a)
    while (a >> s).any():
        s += (a >> s) > 0
    return s


def _extra(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    return np.where(v < 0, v + (1 << s) - 1, v)


def _huffman_bits(zz: np.ndarray, comp: np.ndarray, comp_id: np.ndarray,
                  tables) -> bytes:
    """Entropy-code zigzag blocks in scan order -> stuffed bytes. `comp`
    picks each block's tables, `comp_id` its DC predictor."""
    nb = len(zz)
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp_id):
        idx = np.flatnonzero(comp_id == c)
        diff[idx] = np.diff(dc[idx], prepend=0)
    events = []          # (block, position, sub, code, length)
    s = _size(diff)
    dcode = np.choose(comp, [t[0][0][s] for t in tables])
    dlen = np.choose(comp, [t[0][1][s] for t in tables])
    events.append((np.arange(nb), np.zeros(nb, np.int64),
                   np.zeros(nb, np.int64), (dcode << s) | _extra(diff, s),
                   dlen + s))
    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    val = zz[blk, k]
    prev = np.where(np.r_[True, blk[1:] != blk[:-1]], 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    nzrl = run >> 4
    s = _size(val)
    sym = ((run & 15) << 4) | s
    ac_code = lambda i: np.choose(comp[blk], [t[1][i][sym] for t in tables])
    events.append((blk, k, nzrl, (ac_code(0) << s) | _extra(val, s),
                   ac_code(1) + s))
    if nzrl.any():                      # ZRL symbols before long runs
        zb = np.repeat(blk, nzrl)
        zk = np.repeat(k, nzrl)
        zsub = np.arange(len(zb)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
        zc = comp[zb]
        events.append((zb, zk, zsub,
                       np.choose(zc, [t[1][0][0xF0] for t in tables]),
                       np.choose(zc, [t[1][1][0xF0] for t in tables])))
    last = np.zeros(nb, np.int64)
    last[blk] = k                       # k rises within a block
    eob = np.flatnonzero(last < 63)
    ec = comp[eob]
    events.append((eob, np.full(len(eob), 64), np.zeros(len(eob), np.int64),
                   np.choose(ec, [t[1][0][0] for t in tables]),
                   np.choose(ec, [t[1][1][0] for t in tables])))
    b, p, sub, code, length = (np.concatenate(x) for x in zip(*events))
    order = np.lexsort((sub, p, b))
    code, length = code[order], length[order]
    total = int(length.sum())
    ends = np.cumsum(length)
    owner = np.repeat(np.arange(len(length)), length)
    bit = (code[owner] >> (ends[owner] - 1 - np.arange(total))) & 1
    pad = (-total) % 8
    bits = np.concatenate([bit, np.ones(pad, np.int64)]).astype(np.uint8)
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode_jpeg(arr: np.ndarray, quality: int = 95) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) / (H, W, 1) gray -> baseline JFIF."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError("encode_jpeg takes uint8 images")
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        planes, sampling = [arr.astype(np.float64)], [(1, 1)]
    elif arr.ndim == 3 and arr.shape[2] == 3:
        rgb = arr.astype(np.float64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
                  0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]
        sampling = [(2, 2), (1, 1), (1, 1)]
    else:
        raise ValueError(f"encode_jpeg: shape {arr.shape} is not an image")
    h, w = arr.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError("encode_jpeg: size out of range")
    hmax, vmax = sampling[0]
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qts = [_quality_table(_LUMA_Q, quality), _quality_table(_CHROMA_Q, quality)]
    tables = [(_encode_table(_DC_LUMA), _encode_table(_AC_LUMA)),
              (_encode_table(_DC_CHROMA), _encode_table(_AC_CHROMA))]
    coded, comp_of, dest_of = [], [], []
    total = 0
    for ci, (plane, (hc, vc)) in enumerate(zip(planes, sampling)):
        if (hc, vc) != (hmax, vmax):   # 2x2 box average (4:2:0)
            p = np.pad(plane, ((0, (-h) % 2), (0, (-w) % 2)), mode="edge")
            plane = p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2)
            plane = plane.mean(axis=(1, 3))
        gh, gw = (my * vc, mx * hc) if len(planes) > 1 else (
            -(-h // 8), -(-w // 8))
        blocks = _blocks(plane - 128.0, gh, gw)
        dct = _FDCT @ blocks @ _FDCT.T
        q = qts[min(ci, 1)][NATURAL].reshape(1, 64)
        zz = dct.reshape(-1, 64)[:, NATURAL] / q
        coded.append(np.trunc(zz + np.copysign(0.5, zz)).astype(np.int64))
        if len(planes) == 1:
            dest_of.append(np.arange(gh * gw))
        else:                           # scan order: MCU by MCU
            m = np.arange(mx * my)
            for v in range(vc):
                for hh in range(hc):
                    dest_of.append(total + ((m // mx) * vc + v) * gw
                                   + (m % mx) * hc + hh)
        comp_of += [min(ci, 1)] * (vc * hc)
        total += gh * gw
    allz = np.concatenate(coded)
    order = (np.stack(dest_of, axis=1).reshape(-1) if len(planes) > 1
             else dest_of[0])
    slot_comp = np.array(comp_of)
    comp = np.tile(slot_comp, len(order) // len(slot_comp))
    # the DC prediction runs per component: a colour stream has one luma
    # and two chroma components, each with its own predictor
    comp_id = np.tile(np.repeat(np.arange(len(planes)),
                                [hc * vc for hc, vc in sampling]),
                      len(order) // len(slot_comp))
    zz = allz[order]
    data = _huffman_bits(zz, comp, comp_id, tables)
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, qt in enumerate(qts[:min(len(planes), 2)]):
        out.append(_segment(0xDB, bytes([i]) + bytes(
            qt[NATURAL].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, h, w, len(planes))
    for ci, (hc, vc) in enumerate(sampling):
        sof += bytes([ci + 1, (hc << 4) | vc, min(ci, 1)])
    out.append(_segment(0xC0, sof))
    specs = [(0x00, _DC_LUMA), (0x10, _AC_LUMA)]
    if len(planes) > 1:
        specs += [(0x01, _DC_CHROMA), (0x11, _AC_CHROMA)]
    for tc_th, (bits, vals) in specs:
        out.append(_segment(0xC4, bytes([tc_th]) + bits + vals))
    sos = bytes([len(planes)])
    for ci in range(len(planes)):
        t = min(ci, 1)
        sos += bytes([ci + 1, (t << 4) | t])
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out += [data, b"\xff\xd9"]
    return b"".join(out)
