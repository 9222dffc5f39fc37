"""Image decoding and PIL's image operations in numpy, without PIL.

`decode_image(buf)` picks the JPEG or PNG decoder by magic bytes and
returns uint8 (H, W, 3) RGB the way PIL's `.convert("RGB")` does: gray is
replicated, alpha dropped, palettes looked up. `decode_raw(buf)` returns
the array `np.asarray(Image.open(...))` gives, unconverted: (H, W) for
gray and palette images (the palette's indices), (H, W, C) otherwise.

Each operation below is byte-equal to PIL's on uint8 images:
* `resize_bicubic` / `resize_bilinear(arr, (w, h))`: `Image.resize(size,
  BICUBIC / BILINEAR)` (Pillow's Resample.c): the a = -0.5 cubic or the
  triangle, its support widened by the scale when shrinking (so shrinking
  antialiases), each output's window normalised by its sequential sum,
  weights in fixed point with 22 fraction bits, the horizontal pass first
  into a uint8 image, then the vertical pass;
* `resize_nearest`: `Image.resize(size, NEAREST)`, which Pillow runs as an
  affine scale: the source coordinate of output x is (x + 0.5) * in / out,
  accumulated one step at a time in doubles, then truncated;
* `gaussian_blur(img, radius)`: `ImageFilter.GaussianBlur(radius)`, three
  extended box blurs per axis (BoxBlur.c): an integer box radius plus a
  fractional weight for the two pixels beyond it, in 24-bit fixed point,
  each pass rounded to uint8, the horizontal passes first; edges repeat
  the border pixel. It is not a true Gaussian;
* `to_gray`: RGB -> "L" (ITU-R 601-2 luma in PIL's fixed point).

`image_size(path)` is what PIL's lazy `Image.open(path).size` tells the
corpus recipes (data/corpus_recipes.py) without decoding: it walks a
JPEG's markers up to the start of scan, or a PNG's chunks up to the first
IDAT, as PIL's plugins do, and reads the size from SOF or IHDR. Where
PIL's open fails (an empty file, no known signature, a header cut off or
malformed before that point) it returns None; a signature that PIL opens
but the port cannot read (GIF, BMP, TIFF, WebP, ...) raises.
"""

from __future__ import annotations

import functools
import math
import re
import struct
import zlib
from typing import BinaryIO, Optional, Tuple

import numpy as np

from fudanocr_tpu_torch.data.jpeg import decode_jpeg
from fudanocr_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
from fudanocr_tpu_torch.data.png import decode_png

PRECISION_BITS = 32 - 8 - 2


def decode_image(buf: bytes) -> np.ndarray:
    """JPEG or PNG bytes -> uint8 (H, W, 3) RGB; anything else raises."""
    if buf is None:
        raise ValueError("no image bytes (missing key)")
    buf = bytes(buf)
    if buf[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(buf)
    elif buf.startswith(PNG_SIGNATURE):
        img = decode_png(buf)
    else:
        raise ValueError(f"unknown image format (magic {buf[:8]!r})")
    c = img.shape[2]
    if c in (1, 2):                       # L / LA -> RGB
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def decode_raw(buf: bytes) -> np.ndarray:
    """JPEG or PNG bytes -> the uint8 array PIL's `np.asarray(Image.open)`
    gives without a conversion: a palette image keeps its indices, one
    channel comes back (H, W); anything else raises."""
    if buf is None:
        raise ValueError("no image bytes (missing key)")
    buf = bytes(buf)
    if buf[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(buf)
    elif buf.startswith(PNG_SIGNATURE):
        img = decode_png(buf, expand_palette=False)
    else:
        raise ValueError(f"unknown image format (magic {buf[:8]!r})")
    return img[..., 0] if img.shape[2] == 1 else img


def read_image(path: str, raw: bool = False) -> np.ndarray:
    """The file at `path` through `decode_image`, or `decode_raw`."""
    with open(path, "rb") as f:
        buf = f.read()
    return decode_raw(buf) if raw else decode_image(buf)


# signatures of formats PIL opens and the port does not read (a prefix,
# or a pattern over the first 16 bytes)
_OTHER_FORMATS = (
    (b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
    (b"II*\0", "TIFF"), (b"MM\0*", "TIFF"), (b"II+\0", "BigTIFF"),
    (b"MM\0+", "BigTIFF"), (re.compile(rb"RIFF....WEBP", re.S), "WebP"),
    (b"\0\0\1\0", "ICO"), (b"\0\0\2\0", "CUR"), (b"8BPS", "PSD"),
    (b"\xff\x4f\xff\x51", "JPEG 2000"),
    (b"\0\0\0\x0cjP  \r\n\x87\n", "JPEG 2000"), (b"DDS ", "DDS"),
    (b"icns", "ICNS"), (b"qoif", "QOI"), (b"\x01\xda", "SGI"),
    (b"\x59\xa6\x6a\x95", "Sun raster"), (b"%!PS", "EPS"),
    (b"\xc5\xd0\xd3\xc6", "EPS"), (re.compile(rb"P[1-7fy]"), "PPM"),
    (re.compile(rb"\x0a[\x00\x02\x03\x05]"), "PCX"),
    (re.compile(rb"....ftyp(avif|avis)", re.S), "AVIF"))
# PIL's JPEG markers with no segment (RST, SOI, EOI, JPG, JPG0-13), those
# it reads as a frame header, and the ones it does not know
_BARE = {0xC8, *range(0xD0, 0xDA), *range(0xF0, 0xFE)}
_FRAMES = {*range(0xC0, 0xC4), *range(0xC5, 0xC8), *range(0xC9, 0xCC),
           *range(0xCD, 0xD0), 0xDE}
# PNG (bit depth, colour type) pairs that PIL gives a mode
_PNG_MODES = {(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2),
              (1, 3), (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6),
              (16, 6)}


def _read(f: BinaryIO, n: int) -> bytes:
    """Exactly n bytes (PIL's `_safe_read`), else the header is cut off."""
    data = f.read(n) if n > 0 else b""
    if len(data) < n:
        raise EOFError("truncated")
    return data


def _jpeg_size(f: BinaryIO) -> Optional[Tuple[int, int]]:
    """JpegImagePlugin's marker walk from just after FF D8 FF, up to the
    start of scan: stray bytes and fill are skipped, every segment's
    length read, the frame header sized, quantisation tables checked."""
    size, byte = None, 0xFF
    while True:
        if byte != 0xFF:                         # junk between markers
            byte = _read(f, 1)[0]
            continue
        m = _read(f, 1)[0]                       # the marker FF m
        if m == 0xFF:                            # fill byte
            continue
        if m == 0x00:                            # an escaped 0xFF
            byte = _read(f, 1)[0]
            continue
        if m < 0xC0:
            return None                          # PIL: no marker found
        if m not in _BARE:
            seg = _read(f, struct.unpack(">H", _read(f, 2))[0] - 2)
            if m in _FRAMES:
                if len(seg) < 6 or seg[0] != 8 or seg[5] not in (1, 3, 4):
                    return None
                h, w = struct.unpack_from(">HH", seg, 1)
                size = (w, h)
            elif m == 0xDB:
                while seg:
                    n = 1 + (64 if seg[0] < 16 else 128)
                    if len(seg) < n:
                        return None
                    seg = seg[n:]
            elif m == 0xDA:                      # start of scan
                return size if size and min(size) > 0 else None
        byte = _read(f, 1)[0]


def _png_size(f: BinaryIO) -> Optional[Tuple[int, int]]:
    """PngImagePlugin's chunk walk after the signature, up to the first
    IDAT (or IEND): each chunk's type must be a name, its CRC right."""
    size = None
    while True:
        head = _read(f, 8)
        length, cid = struct.unpack(">I", head[:4])[0], head[4:]
        if not re.fullmatch(rb"\w{4}", cid):
            return None
        if cid in (b"IDAT", b"IEND", b"fdAT"):
            return size if size and min(size) > 0 else None
        data = _read(f, length)
        if cid == b"IHDR":
            if length < 13 or (data[8], data[9]) not in _PNG_MODES \
                    or data[11]:
                return None
            size = struct.unpack(">II", data[:8])
        if struct.unpack(">I", _read(f, 4))[0] != zlib.crc32(cid + data):
            return None


def image_size(path: str) -> Optional[Tuple[int, int]]:
    """(w, h) of the JPEG or PNG at `path` from its header, without
    decoding; None where PIL's `Image.open` would fail (the corpus recipes
    then skip the file). Raises NotImplementedError, naming the format,
    for a file PIL opens and the port cannot read."""
    try:
        f = open(path, "rb")
    except OSError:            # missing, a directory: PIL's open fails
        return None
    with f:
        prefix = f.read(16)
        if prefix[:3] == b"\xff\xd8\xff":
            read = _jpeg_size
            f.seek(3)
        elif prefix[:8] == PNG_SIGNATURE:
            read = _png_size
            f.seek(8)
        else:
            for sig, name in _OTHER_FORMATS:
                if (sig.match(prefix) if isinstance(sig, re.Pattern)
                        else prefix.startswith(sig)):
                    raise NotImplementedError(
                        f"{path}: a {name} file; the port reads JPEG and "
                        "PNG only")
            return None
        try:
            return read(f)
        except (EOFError, struct.error):
            return None


def to_gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> (H, W) uint8 as PIL's convert("L")."""
    x = rgb.astype(np.int64)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's bicubic_filter (a = -0.5), operation for operation."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1
    far = ((((x - 5) * x + 8) * x) - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _triangle(x: np.ndarray) -> np.ndarray:
    """Resample.c's bilinear_filter."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# Resample.c's filters: (function, support)
_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_triangle, 1.0)}


@functools.lru_cache(maxsize=256)
def _coeffs(in_size: int, out_size: int, kind: str = "bicubic"):
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc for the
    filter `kind` -> (input index (out, ksize), fixed-point weights (out,
    ksize))."""
    fn, filter_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = fn(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                 * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):                # the C loop's summation order
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    scaled = w * (1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return idx, k


def _pass(arr: np.ndarray, out_size: int, axis: int,
          kind: str) -> np.ndarray:
    idx, k = _coeffs(arr.shape[axis], out_size, kind)
    taps = np.take(arr, idx, axis=axis).astype(np.int64)
    # taps: axis -> (out, ksize); weights broadcast over the other axes
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = k.shape
    acc = (taps * k.reshape(shape)).sum(axis=axis + 1)
    acc += 1 << (PRECISION_BITS - 1)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _check(arr: np.ndarray, size, what: str) -> Tuple[int, int]:
    if arr.dtype != np.uint8:
        raise ValueError(f"{what} takes uint8 images")
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"{what}: bad size {size}")
    return w, h


def _resample(arr: np.ndarray, size, kind: str) -> np.ndarray:
    arr = np.asarray(arr)
    w, h = _check(arr, size, f"resize_{kind}")
    out = arr
    if w != arr.shape[1]:
        out = _pass(out, w, 1, kind)
    if h != arr.shape[0]:
        out = _pass(out, h, 0, kind)
    return out.copy() if out is arr else out


def resize_bicubic(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> `size` = (width, height), as PIL's
    Image.resize(size, Image.BICUBIC)."""
    return _resample(arr, size, "bicubic")


def resize_bilinear(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> `size` = (width, height), as PIL's
    Image.resize(size, Image.BILINEAR)."""
    return _resample(arr, size, "bilinear")


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Geometry.c's ImagingScaleAffine: the coordinate starts at half a
    step and grows by one step per output pixel, summed in doubles."""
    step = in_size / out_size
    coord = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1,
                                                            step)]))
    return np.minimum(coord.astype(np.int64), in_size - 1)


def resize_nearest(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> `size` = (width, height), as PIL's
    Image.resize(size, Image.NEAREST)."""
    arr = np.asarray(arr)
    w, h = _check(arr, size, "resize_nearest")
    rows = _nearest_index(arr.shape[0], h)
    cols = _nearest_index(arr.shape[1], w)
    return np.ascontiguousarray(arr[rows][:, cols])


def _box_radius(radius: float, passes: int) -> np.float32:
    """BoxBlur.c's _gaussian_blur_radius: the extended box's radius for
    `passes` boxes of the Gaussian's variance, in C's float arithmetic."""
    f32 = np.float32
    sigma2 = f32(radius) * f32(radius) / f32(passes)
    big_l = f32(np.sqrt(12.0 * np.float64(sigma2) + 1.0))
    small_l = f32(np.floor((np.float64(big_l) - 1.0) / 2.0))
    a = (f32(2) * small_l + f32(1)) * (small_l * (small_l + f32(1))
                                       - f32(3) * sigma2)
    a = a / (f32(6) * (sigma2 - (small_l + f32(1)) * (small_l + f32(1))))
    return f32(small_l + a)


def _box_pass(arr: np.ndarray, radius: np.float32, axis: int) -> np.ndarray:
    """One of BoxBlur.c's line blurs along `axis`: the sum over the box of
    2r + 1 pixels times ww, plus the two pixels just beyond it times fw,
    indices clamped to the line, rounded from 24 fraction bits."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = arr.shape[axis]
    pos = np.arange(n)
    acc = 0
    for d in range(-r, r + 1):
        acc = acc + np.take(arr, np.clip(pos + d, 0, n - 1),
                            axis=axis).astype(np.int64)
    far = (np.take(arr, np.clip(pos - r - 1, 0, n - 1), axis=axis)
           .astype(np.int64)
           + np.take(arr, np.clip(pos + r + 1, 0, n - 1), axis=axis))
    return ((acc * ww + far * fw + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(arr: np.ndarray, radius: float) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> the same shape, as PIL's
    `img.filter(ImageFilter.GaussianBlur(radius))` (three box passes per
    axis)."""
    passes = 3
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError("gaussian_blur takes uint8 images")
    if radius < 0:
        raise ValueError(f"gaussian_blur: negative radius {radius}")
    r = _box_radius(radius, passes)
    out = arr.copy()
    if r == 0:
        return out
    for axis in (1, 0):
        for _ in range(passes):
            out = _box_pass(out, r, axis)
    return out
