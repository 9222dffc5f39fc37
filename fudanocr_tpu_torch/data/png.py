"""PNG decoding and encoding in numpy and the standard library, without
PIL.

`decode_png(buf)` takes non-interlaced 8-bit PNGs of every colour type,
and palette images of 1, 2 and 4 bits and gray ones of 2 and 4 bits
(scaled to 0..255, as PIL's "L") as well:
gray (H, W, 1), gray + alpha (H, W, 2), RGB (H, W, 3), RGBA (H, W, 4) and
palette, which comes back as the palette's RGB (H, W, 3) (a tRNS chunk is
ignored, as PIL's convert("RGB") ignores it), or with
`expand_palette=False` as its indices (H, W, 1), as PIL opens it. Chunk
CRCs are checked, the IDAT stream is inflated with zlib, and the five
scanline filters are undone row by row: None, Sub and Up in numpy, Average and Paeth, whose every byte
depends on the one decoded to its left, in a loop over the row's bytes.
Interlaced images and other bit depths raise ValueError.

`encode_png(img)` writes uint8 (H, W) or (H, W, C) as gray, gray +
alpha, RGB or RGBA: every row filter 0 (None), the data deflated by zlib.
PIL reads the file back to the same array.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (palette: one index)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(buf: bytes):
    pos = len(SIGNATURE)
    while pos + 12 <= len(buf):
        n, kind = struct.unpack_from(">I4s", buf, pos)
        data = buf[pos + 8:pos + 8 + n]
        if len(data) != n or pos + 12 + n > len(buf):
            raise ValueError("PNG: truncated chunk")
        crc, = struct.unpack_from(">I", buf, pos + 8 + n)
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f"PNG: bad CRC in {kind!r} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG: no IEND chunk")


def _paeth_row(x: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Paeth filter on one row (bytes of uint8)."""
    b = prev.astype(np.int32)
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    pa = np.abs(b - c).tolist()    # the one term free of the left byte
    out, b, c = x.tolist(), b.tolist(), c.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        up, ci = b[i], c[i]
        pb, pc = abs(a - ci), abs(a + up - 2 * ci)
        if pa[i] <= pb and pa[i] <= pc:
            pred = a
        elif pb <= pc:
            pred = up
        else:
            pred = ci
        out[i] = (out[i] + pred) & 0xFF
    return np.array(out, np.uint8)


def _average_row(x: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = x.tolist()
    b = prev.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + b[i]) >> 1)) & 0xFF
    return np.array(out, np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    kinds = rows[:, 0]
    data = rows[:, 1:]
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        x = data[y]
        kind = kinds[y]
        if kind == 0:
            row = x
        elif kind == 1:       # Sub: a running sum per byte of a pixel
            row = np.cumsum(x.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:       # Up
            row = x + prev
        elif kind == 3:
            row = _average_row(x, prev, bpp)
        elif kind == 4:
            row = _paeth_row(x, prev, bpp)
        else:
            raise ValueError(f"PNG: unknown filter type {kind}")
        out[y] = row
        prev = out[y]
    return out


# colour type -> bit depths below 8 read: palette indices, gray levels
# (1-bit gray is PIL's mode "1", left out)
_PACKED = {3: (1, 2, 4), 0: (2, 4)}


def _unpack(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """(h, stride) bytes of `depth`-bit samples, first sample in the high
    bits -> (h, w) uint8 samples."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return np.ascontiguousarray(samples.reshape(rows.shape[0], -1)[:, :w])


def decode_png(buf: bytes, expand_palette: bool = True) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, C); see the module docstring."""
    buf = bytes(buf)
    if not buf.startswith(SIGNATURE):
        raise ValueError("not a PNG stream")
    header = palette = None
    idat = []
    for kind, data in _chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("PNG: interlaced images are not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG: unknown colour type {ctype}")
    packed = depth in _PACKED.get(ctype, ())
    if depth != 8 and not packed:
        raise ValueError(f"PNG: bit depth {depth} of colour type {ctype} "
                         "is not supported")
    bpp = _CHANNELS[ctype]
    stride = (w * depth + 7) // 8 if packed else w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("PNG: image data too short")
    img = _unfilter(raw[:h * (stride + 1)], h, stride, bpp)
    if packed:
        img = _unpack(img, w, depth)
        if ctype == 0:        # gray scaled to 0..255, as PIL's "L"
            img = img * np.uint8(255 // ((1 << depth) - 1))
    img = img.reshape(h, w, bpp)
    if ctype == 3 and expand_palette:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError("PNG: palette index out of range")
        img = palette[img[..., 0]]
    return np.ascontiguousarray(img)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 image -> PNG bytes; see the module docstring."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("encode_png takes uint8 images")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"encode_png: {c} channels")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)], 1)
    return b"".join([
        SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes())),
        _chunk(b"IEND", b"")])
