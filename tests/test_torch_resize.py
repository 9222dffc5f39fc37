"""PIL's bicubic resize in numpy (fudanocr_tpu_torch/data/image.py) and the
host collate built on it (data/collate.py) against PIL and the JAX
package's collate on this host, byte for byte."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from fudanocr_tpu.data import collate as jax_collate
from fudanocr_tpu_torch.data import collate
from fudanocr_tpu_torch.data.image import resize_bicubic, to_gray


def _img(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed + 31 * h + w)
    shape = (h, w, c) if c else (h, w)
    return rng.integers(0, 256, shape).astype(np.uint8)


def _pil(arr, size):
    return np.asarray(Image.fromarray(arr).resize(size, Image.BICUBIC))


CASES = {"shrink": ((40, 200), (64, 16)), "enlarge": ((8, 20), (64, 16)),
         "mixed": ((9, 150), (64, 16)), "width only": ((16, 90), (64, 16)),
         "height only": ((37, 64), (64, 16)), "identity": ((16, 64), (64, 16)),
         "from one pixel": ((1, 1), (64, 16)), "to one pixel": ((33, 101),
                                                                  (1, 1)),
         "large shrink": ((200, 7), (3, 40))}


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("case", list(CASES))
def test_resize_is_byte_equal_to_pil(case, gray):
    (h, w), size = CASES[case]
    arr = _img(h, w, 0 if gray else 3)
    got = resize_bicubic(arr, size)
    assert np.array_equal(got, _pil(arr, size))
    if case == "identity":
        assert not np.shares_memory(got, arr)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 200), st.integers(1, 200), st.integers(1, 200),
       st.integers(1, 200), st.integers(0, 2 ** 16))
def test_resize_matches_pil_on_any_size(h, w, oh, ow, seed):
    arr = _img(h, w, seed=seed)
    assert np.array_equal(resize_bicubic(arr, (ow, oh)), _pil(arr, (ow, oh)))


def test_gray_is_pils_l():
    arr = _img(23, 57)
    assert np.array_equal(to_gray(arr),
                          np.asarray(Image.fromarray(arr).convert("L")))


@pytest.mark.parametrize("mask", [False, True], ids=["rgb", "mask"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float32"])
def test_resize_normalize_matches_jax(dtype, mask):
    for hw in ((40, 200), (8, 21), (16, 64)):
        arr = _img(*hw, seed=3)
        want = jax_collate.resize_normalize(Image.fromarray(arr), (64, 16),
                                            mask=mask, dtype=dtype)
        got = collate.resize_normalize(arr, (64, 16), mask=mask, dtype=dtype)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("synthetic_lr", [False, True],
                         ids=["real", "synthetic"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float32"])
def test_sr_collate_matches_jax(dtype, synthetic_lr):
    rng = np.random.default_rng(5)
    items = []
    for i in range(4):
        hr = _img(int(rng.integers(20, 60)), int(rng.integers(60, 250)),
                  seed=i)
        lr = _img(int(rng.integers(8, 40)), int(rng.integers(20, 200)),
                  seed=10 + i)
        items.append((hr, f"w{i}") if synthetic_lr else (hr, lr, f"w{i}"))
    pil_items = [tuple(Image.fromarray(x) if isinstance(x, np.ndarray) else x
                       for x in it) for it in items]
    kw = dict(img_h=32, img_w=128, down_sample_scale=2, mask=True,
              synthetic_lr=synthetic_lr, dtype=dtype)
    want = jax_collate.sr_collate(pil_items, **kw)
    got = collate.sr_collate(items, **kw)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[2] == want[2]
