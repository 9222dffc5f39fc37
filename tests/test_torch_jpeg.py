"""The port's baseline JPEG decoder (fudanocr_tpu_torch/data/jpeg.py)
against PIL on this host (libjpeg-turbo's default decompression, the JAX
package's decode route): byte-equal on every size, sampling, quality,
optimised table and restart interval below; unsupported streams raise; PIL
decodes the port encoder's streams to the same bytes as the port."""

import io

import numpy as np
import pytest
from PIL import Image

from fudanocr_tpu_torch.data.image import decode_image
from fudanocr_tpu_torch.data.jpeg import NATURAL, decode_jpeg, encode_jpeg

SIZES = [(1, 1), (7, 13), (16, 64), (17, 33), (33, 101), (40, 200)]
MODES = {"444": 0, "422": 1, "420": 2, "gray": None}
VARIANTS = {"q50": dict(quality=50), "q75": dict(quality=75),
            "q95": dict(quality=95), "optimize": dict(quality=95,
                                                       optimize=True),
            "restart": dict(quality=90, restart_marker_blocks=3)}


def _image(h, w, seed=0):
    """Smooth text-like rows with noise: large and small coefficients."""
    rng = np.random.default_rng(seed + 7 * h + w)
    base = np.cumsum(rng.normal(0, 18, (h, w, 3)), axis=1) + 128
    base += rng.normal(0, 12, (h, w, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def _pil_jpeg(arr, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(arr).save(out, format="JPEG", **kw)
    return out.getvalue()


def _pil_decode(buf) -> np.ndarray:
    im = Image.open(io.BytesIO(buf))
    return (np.asarray(im)[..., None] if im.mode == "L"
            else np.asarray(im.convert("RGB")))


def test_zigzag_order_is_the_standard_one():
    assert NATURAL[:10].tolist() == [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]
    assert NATURAL[-6:].tolist() == [61, 54, 47, 55, 62, 63]
    assert sorted(NATURAL.tolist()) == list(range(64))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_decode_is_byte_equal_to_pil(hw, mode, variant):
    arr = _image(*hw)
    kw = dict(VARIANTS[variant])
    if mode == "gray":
        arr = arr[..., 0]
    else:
        kw["subsampling"] = MODES[mode]
    buf = _pil_jpeg(arr, **kw)
    want = _pil_decode(buf)
    got = decode_jpeg(buf)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    # decode_image gives PIL's convert("RGB")
    rgb = np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))
    assert np.array_equal(decode_image(buf), rgb)


def _patched(buf: bytes, marker: int, offset: int, value: int) -> bytes:
    """buf with the byte at `offset` into marker's segment set to value."""
    i = buf.index(bytes([0xFF, marker]))
    out = bytearray(buf)
    out[i + 4 + offset] = value
    return bytes(out)


def _save_cmyk(arr) -> bytes:
    out = io.BytesIO()
    Image.fromarray(arr).convert("CMYK").save(out, format="JPEG")
    return out.getvalue()


def _refused():
    arr = _image(16, 32)
    base = _pil_jpeg(arr, quality=90)
    sof = base.index(b"\xff\xc0")
    return {
        "progressive": _pil_jpeg(arr, quality=90, progressive=True),
        "cmyk": _save_cmyk(arr),
        "12-bit": _patched(base, 0xC0, 0, 12),
        "arithmetic": base[:sof + 1] + b"\xc9" + base[sof + 2:],
        "lossless": base[:sof + 1] + b"\xc3" + base[sof + 2:],
        "multi-scan": _patched(base, 0xDA, 0, 1),
    }


REFUSED = _refused()


@pytest.mark.parametrize("kind", list(REFUSED))
def test_unsupported_streams_raise(kind):
    with pytest.raises(ValueError):
        decode_jpeg(REFUSED[kind])


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_pil_decodes_the_port_encoder_as_the_port_does(hw, gray, quality):
    arr = _image(*hw, seed=1)
    if gray:
        arr = arr[..., 0]
    buf = encode_jpeg(arr, quality)
    got = decode_jpeg(buf)
    assert np.array_equal(got, _pil_decode(buf))
    # as faithful as PIL's own encoder at that quality (4:2:0 for colour)
    src = arr[..., None] if gray else arr
    err = np.abs(got.astype(np.int64) - src).mean()
    ref = np.abs(_pil_decode(_pil_jpeg(arr, quality=quality)).astype(
        np.int64) - src).mean()
    assert err <= 1.1 * ref + 0.5


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_long_scan_is_byte_equal_to_pil(gray):
    """A scan longer than the decoder's windowed stretch of bytes (16 KiB),
    so the stretch moves along the scan several times."""
    arr = np.random.default_rng(11).integers(0, 256, (160, 320, 3),
                                             dtype=np.uint8)
    buf = _pil_jpeg(arr[..., 0] if gray else arr, quality=95)
    assert len(buf) > 2 * (1 << 14)
    assert np.array_equal(decode_jpeg(buf), _pil_decode(buf))


@pytest.mark.parametrize("subsampling", [1, 2], ids=["422", "420"])
@pytest.mark.parametrize("w", [3, 4])
def test_chroma_two_samples_wide_is_replicated_as_pil(w, subsampling):
    """At 2 chroma samples a row libjpeg replicates instead of filtering."""
    buf = _pil_jpeg(_image(9, w), quality=95, subsampling=subsampling)
    assert np.array_equal(decode_jpeg(buf), _pil_decode(buf))
