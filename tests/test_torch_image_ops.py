"""PIL's other image operations and OpenCV's colour conversions in numpy
(fudanocr_tpu_torch/data/image.py, data/png.py, data/color.py) against
PIL 12.1 and OpenCV 5.0 on this host. The bar is byte equality
(`np.array_equal`) everywhere: bilinear and nearest resize, GaussianBlur
and PNG on drawn sizes, 1 and 3 channels; cv2's RGB2HSV, HSV2RGB and
RGB2GRAY on every input byte triple, HSV2RGB both inside a row's 32-pixel
vector blocks and in its tail (cv2 rounds the two differently)."""

import io

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageFilter

from fudanocr_tpu_torch.data import color
from fudanocr_tpu_torch.data.image import (decode_image, decode_raw,
                                           gaussian_blur, resize_bilinear,
                                           resize_nearest)
from fudanocr_tpu_torch.data.png import decode_png, encode_png


def _img(h, w, channels, seed):
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if channels == 3 else (h, w)
    return rng.integers(0, 256, shape).astype(np.uint8)


def _smooth(h, w, channels, seed):
    """A smooth image with flat runs: ties and plateaus for the filters."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (max(h // 4, 1), max(w // 4, 1), 3))
    img = np.kron(base, np.ones((4, 4, 1)))[:h, :w].astype(np.uint8)
    img = np.pad(img, ((0, h - img.shape[0]), (0, w - img.shape[1]), (0, 0)),
                 mode="edge")
    return img if channels == 3 else img[..., 0]


RESIZES = {"bilinear": (resize_bilinear, Image.BILINEAR),
           "nearest": (resize_nearest, Image.NEAREST)}


@pytest.mark.parametrize("kind", list(RESIZES))
@settings(max_examples=60, deadline=None)
@given(st.integers(1, 160), st.integers(1, 160), st.integers(1, 320),
       st.integers(1, 320), st.sampled_from([1, 3]), st.booleans(),
       st.integers(0, 2 ** 16))
def test_resize_matches_pil_on_any_size(kind, h, w, oh, ow, channels, smooth,
                                        seed):
    arr = (_smooth if smooth else _img)(h, w, channels, seed)
    ours, mode = RESIZES[kind]
    want = np.asarray(Image.fromarray(arr).resize((ow, oh), mode))
    assert np.array_equal(ours(arr, (ow, oh)), want)


@pytest.mark.parametrize("kind", list(RESIZES))
@pytest.mark.parametrize("hw, size", [((768, 1024), (1365, 1024)),
                                      ((1024, 768), (383, 511)),
                                      ((3, 1000), (2999, 7)),
                                      ((1, 1), (5, 9)),
                                      ((1000, 999), (1, 1))])
def test_resize_matches_pil_at_photo_scales(kind, hw, size):
    """The seg pipeline's scales (a 0.5-2.0 rescale of photo-sized images)
    and extreme ratios, where the nearest coordinate's running sum meets
    the edges."""
    arr = _img(*hw, 3, seed=hw[0])
    ours, mode = RESIZES[kind]
    want = np.asarray(Image.fromarray(arr).resize(size, mode))
    assert np.array_equal(ours(arr, size), want)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 70), st.integers(1, 70),
       st.sampled_from([0.6, 0.05, 0.3, 1.0, 1.5, 2.5, 4.0, 9.0]),
       st.sampled_from([1, 3]), st.integers(0, 2 ** 16))
def test_gaussian_blur_matches_pil(h, w, radius, channels, seed):
    arr = _img(h, w, channels, seed)
    want = np.asarray(Image.fromarray(arr).filter(
        ImageFilter.GaussianBlur(radius)))
    assert np.array_equal(gaussian_blur(arr, radius), want)


def test_gaussian_blur_of_the_synthetic_lr():
    """The synthetic set's call: GaussianBlur(0.6) of a 16x64 LR, and a
    radius of 0 (PIL's copy)."""
    arr = _smooth(16, 64, 3, seed=5)
    want = np.asarray(Image.fromarray(arr).filter(
        ImageFilter.GaussianBlur(0.6)))
    assert np.array_equal(gaussian_blur(arr, 0.6), want)
    out = gaussian_blur(arr, 0)
    assert np.array_equal(out, arr) and not np.shares_memory(out, arr)


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 1), (5, 11, 3),
                                   (4, 6, 4), (3, 3, 2), (1, 1, 3)])
def test_encode_png_round_trips_through_pil_and_decode_png(shape):
    arr = np.random.default_rng(len(shape)).integers(
        0, 256, shape).astype(np.uint8)
    buf = encode_png(arr)
    via_pil = np.asarray(Image.open(io.BytesIO(buf)))
    flat = arr[..., 0] if arr.ndim == 3 and arr.shape[2] == 1 else arr
    assert np.array_equal(via_pil, flat)
    got = decode_png(buf)
    assert np.array_equal(got, arr.reshape(got.shape))
    assert np.array_equal(decode_raw(buf), flat)


@pytest.mark.parametrize("colours", [2, 4, 5, 16, 17, 256])
@pytest.mark.parametrize("w", [1, 7, 10, 33])
def test_palette_png_keeps_its_indices(colours, w):
    """A palette PNG that PIL writes (1, 2, 4 or 8 bits a pixel, by the
    palette's size) reads back as PIL opens it: indices for `decode_raw`
    (annotations), the palette's colours for `decode_image`."""
    rng = np.random.default_rng(colours + w)
    idx = rng.integers(0, colours, (6, w)).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 3 * colours).astype(np.uint8).tolist())
    out = io.BytesIO()
    im.save(out, format="PNG")
    buf = out.getvalue()
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(buf))), idx)
    assert np.array_equal(decode_raw(buf), idx)
    assert np.array_equal(decode_image(buf), np.asarray(im.convert("RGB")))


@pytest.mark.parametrize("mode", ["L;2", "L;4"])
def test_packed_gray_png_reads_as_pil(mode):
    """2- and 4-bit gray PNGs (written here by hand: PIL writes "L" at 8
    bits) read back as PIL opens them, scaled to 0..255."""
    import struct
    import zlib

    from fudanocr_tpu_torch.data.png import SIGNATURE, _chunk

    depth = int(mode[-1])
    h, w = 5, 11
    levels = np.random.default_rng(depth).integers(0, 1 << depth, (h, w))
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = levels
    rows = (padded.reshape(h, -1, per)
            << np.arange(8 - depth, -1, -depth)).sum(-1).astype(np.uint8)
    data = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    buf = b"".join([SIGNATURE, _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, 0, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(data.tobytes())),
        _chunk(b"IEND", b"")])
    im = Image.open(io.BytesIO(buf))
    assert np.array_equal(decode_raw(buf), np.asarray(im))
    assert np.array_equal(decode_image(buf), np.asarray(im.convert("RGB")))


def _every_rgb(stop: int, start: int = 0):
    """Byte triples with R in [start, stop) as (256, 256, 3) images, R
    fixed per image."""
    g, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for r in range(start, stop):
        yield np.stack([np.full_like(g, r), g, b], -1).astype(np.uint8)


@pytest.mark.parametrize("part", range(4))
def test_cv2_colour_conversions_on_every_input(part):
    """Every byte triple (R in quarters of the range per case), as (256,
    256, 3) images: RGB2HSV and RGB2GRAY of it as RGB, HSV2RGB of it as
    HSV, equal to cv2's; HSV2RGB again as (65536, 1, 3) columns, every
    pixel in a row's scalar tail."""
    mismatched = {"hsv": 0, "gray": 0, "rgb": 0, "rgb tail": 0}
    for r in range(64 * part, 64 * part + 64):
        img = next(_every_rgb(r + 1, start=r))
        mismatched["hsv"] += int((color.rgb_to_hsv_cv2(img) != cv2.cvtColor(
            img, cv2.COLOR_RGB2HSV)).any(-1).sum())
        mismatched["gray"] += int((color.rgb_to_gray_cv2(img) != cv2.cvtColor(
            img, cv2.COLOR_RGB2GRAY)).sum())
        mismatched["rgb"] += int((color.hsv_to_rgb_cv2(img) != cv2.cvtColor(
            img, cv2.COLOR_HSV2RGB)).any(-1).sum())
        col = img.reshape(-1, 1, 3)
        mismatched["rgb tail"] += int((color.hsv_to_rgb_cv2(col)
                                       != cv2.cvtColor(col, cv2.COLOR_HSV2RGB)
                                       ).any(-1).sum())
    assert mismatched == {"hsv": 0, "gray": 0, "rgb": 0, "rgb tail": 0}


@pytest.mark.parametrize("w", [1, 31, 47, 64, 100, 512])
def test_cv2_hsv_round_trip_at_any_width(w):
    """A row's first w // 32 * 32 pixels take cv2's vector rounding, the
    rest its scalar rounding: both reproduced at every width."""
    img = _img(9, w, 3, seed=11 + w)
    hsv = color.rgb_to_hsv_cv2(img)
    assert hsv[..., 0].max() < 180
    assert np.array_equal(color.hsv_to_rgb_cv2(hsv),
                          cv2.cvtColor(cv2.cvtColor(img, cv2.COLOR_RGB2HSV),
                                       cv2.COLOR_HSV2RGB))
