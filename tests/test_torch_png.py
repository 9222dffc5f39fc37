"""The port's PNG decoder (fudanocr_tpu_torch/data/png.py) against PIL on
this host: gray, gray + alpha, RGB, RGBA and palette images whose rows use
every filter type, written by a small encoder here (PIL picks its own
filters), decode to PIL's bytes; interlaced and 16-bit images raise."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from fudanocr_tpu_torch.data.image import decode_image
from fudanocr_tpu_torch.data.png import decode_png

CTYPES = {"L": 0, "RGB": 2, "P": 3, "LA": 4, "RGBA": 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(row: np.ndarray, prev: np.ndarray, bpp: int, kind: int):
    x, b = row.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][kind]
    return ((x - pred) & 0xFF).astype(np.uint8)


def _png(img: np.ndarray, mode: str, palette=None, interlace=0,
         depth=8) -> bytes:
    """A PNG whose row y uses filter y % 5."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp)
    raw = b""
    prev = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        raw += bytes([y % 5]) + _filter(rows[y], prev, bpp, y % 5).tobytes()
        prev = rows[y]
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, CTYPES[mode], 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
        out += _chunk(b"tRNS", bytes(range(0, 256, 4)))
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _case(mode: str, h: int, w: int):
    rng = np.random.default_rng(h * 1000 + w + len(mode))
    smooth = np.cumsum(rng.integers(-20, 21, (h, w, 4)), axis=1) + 128
    img = np.clip(smooth, 0, 255).astype(np.uint8)
    if mode == "P":
        pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
        return img[..., 0], pal
    return {"L": img[..., 0], "LA": img[..., :2], "RGB": img[..., :3],
            "RGBA": img}[mode], None


@pytest.mark.parametrize("hw", [(1, 1), (5, 9), (16, 64), (33, 101)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("mode", list(CTYPES))
def test_decode_is_byte_equal_to_pil(mode, hw):
    img, pal = _case(mode, *hw)
    buf = _png(img, mode, pal)
    im = Image.open(io.BytesIO(buf))
    assert im.mode == mode
    want = np.asarray(im.convert("RGB") if mode == "P" else im)
    got = decode_png(buf)
    assert np.array_equal(got, want.reshape(got.shape))
    assert np.array_equal(decode_image(buf), np.asarray(im.convert("RGB")))


def test_pil_written_png_decodes_equal():
    img, _ = _case("RGB", 24, 70)
    out = io.BytesIO()
    Image.fromarray(img).save(out, format="PNG", optimize=True)
    assert np.array_equal(decode_png(out.getvalue()), img)


@pytest.mark.parametrize("kw", [dict(interlace=1), dict(depth=16)],
                         ids=["interlaced", "16-bit"])
def test_unsupported_pngs_raise(kw):
    img, _ = _case("RGB", 4, 4)
    with pytest.raises(ValueError):
        decode_png(_png(img, "RGB", **kw))


def test_bad_crc_and_unknown_format_raise():
    img, _ = _case("RGB", 4, 4)
    buf = bytearray(_png(img, "RGB"))
    buf[20] ^= 1                      # inside IHDR
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(buf))
    with pytest.raises(ValueError, match="unknown image format"):
        decode_image(b"GIF89a" + bytes(20))
