"""The port's synthetic sets (fudanocr_tpu_torch/data/synthetic.py
`SyntheticTextZoom`, data/seg_dataset.py `SyntheticTextSeg`) against the
JAX package's. The port draws its glyphs from its own bitmap table and JAX
from PIL's default font, so the images differ inside the text; the bar
everywhere else is byte equality (`np.array_equal`):
* the labels, and every random draw: PIL's `ImageDraw.text` at the port's
  drawn origins, colours and noise rebuilds JAX's images exactly;
* outside the text boxes (PIL's `textbbox` and the port's own, which
  differ in width as the fonts do) the pixels equal JAX's;
* the port's LR is PIL's resize(BICUBIC) then GaussianBlur(0.6) of the
  port's HR."""

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFilter

from fudanocr_tpu_torch.data.glyphs import text_bbox
from fudanocr_tpu_torch.data.seg_dataset import SyntheticTextSeg
from fudanocr_tpu_torch.data.synthetic import SyntheticTextZoom


def _outside(shape, boxes, inclusive=False):
    keep = np.ones(shape, bool)
    for x0, y0, x1, y1 in boxes:
        keep[max(y0, 0):y1 + inclusive, max(x0, 0):x1 + inclusive] = False
    return keep


@pytest.mark.parametrize("seed, hr_size, scale", [(0, (128, 32), 2),
                                                  (7, (64, 16), 2),
                                                  (3, (100, 40), 4)])
def test_synthetic_text_zoom_matches_jax(seed, hr_size, scale):
    from fudanocr_tpu.data.synthetic import SyntheticTextZoom as JaxSet

    n = 12
    j = JaxSet(n, seed=seed, hr_size=hr_size, scale=scale)
    p = SyntheticTextZoom(n, seed=seed, hr_size=hr_size, scale=scale)
    assert p.labels == j.labels and len(p) == len(j)
    draw = ImageDraw.Draw(Image.new("RGB", hr_size))
    for i in range(n):
        jhr, jlr, jlab = j[i]
        hr, lr, lab = p[i]
        jhr = np.asarray(jhr)
        assert lab == jlab and hr.shape == jhr.shape and hr.dtype == np.uint8
        bg, fg, xy, noise = p.draws(i)
        img = Image.new("RGB", hr_size, (bg,) * 3)
        ImageDraw.Draw(img).text(xy, lab, fill=(fg,) * 3)
        rebuilt = np.clip(np.asarray(img, dtype=np.float32) + noise, 0, 255)
        assert np.array_equal(rebuilt.astype(np.uint8), jhr)
        keep = _outside(hr.shape[:2], [draw.textbbox(xy, lab),
                                        text_bbox(xy, lab)])
        assert keep.mean() > 0.5
        assert np.array_equal(hr[keep], jhr[keep])
        want_lr = Image.fromarray(hr).resize(
            (hr_size[0] // scale, hr_size[1] // scale), Image.BICUBIC
        ).filter(ImageFilter.GaussianBlur(0.6))
        assert np.array_equal(lr, np.asarray(want_lr))


def test_synthetic_text_zoom_batches_collate_as_jax():
    """`batches` through the port's sr_collate: the JAX set's batch shapes
    and labels, and the same batch as collating the port's items with the
    JAX collate."""
    from fudanocr_tpu.data.collate import sr_collate
    from fudanocr_tpu.data.synthetic import SyntheticTextZoom as JaxSet

    j, p = JaxSet(10, seed=2), SyntheticTextZoom(10, seed=2)
    jb, pb = list(j.batches(4)), list(p.batches(4))
    assert len(jb) == len(pb) == 2
    for b, (jh, jl, jlab), (ph, pl, plab) in zip(range(2), jb, pb):
        assert (jh.shape, jl.shape, jlab) == (ph.shape, pl.shape, plab)
        items = [tuple(Image.fromarray(a) if k < 2 else a
                       for k, a in enumerate(p[i]))
                 for i in range(4 * b, 4 * b + 4)]
        wh, wl, _ = sr_collate(items)
        assert np.array_equal(ph, wh) and np.array_equal(pl, wl)


@pytest.mark.parametrize("with_det", [False, True])
@pytest.mark.parametrize("seed, size", [(0, (64, 64)), (1, (48, 96))])
def test_synthetic_text_seg_matches_jax(seed, size, with_det):
    from fudanocr_tpu.data.seg_dataset import SyntheticTextSeg as JaxSeg

    n = 8
    j = JaxSeg(n, size, None, seed=seed, with_det=with_det)
    p = SyntheticTextSeg(n, size, None, seed=seed, with_det=with_det)
    h, w = size
    draw = ImageDraw.Draw(Image.new("L", (w, h)))
    for i in range(n):
        js, ps = j[i], p[i]
        assert set(js) == set(ps)
        bg, words, noise = p.draws(i)
        img = Image.new("RGB", (w, h), bg)
        for xy, text, color in words:
            ImageDraw.Draw(img).text(xy, text, fill=color)
        rebuilt = np.clip(np.asarray(img, np.uint8).astype(np.float32)
                          + noise, 0, 255).astype(np.uint8)
        assert np.array_equal(rebuilt, js["img"])
        boxes = [draw.textbbox(xy, text) for xy, text, _ in words]
        ours = [text_bbox(xy, text) for xy, text, _ in words]
        boxes += ours
        # the det rectangles include their right and bottom edges
        keep = _outside((h, w), boxes, inclusive=True)
        assert keep.mean() > 0.3
        for key in ps:
            assert ps[key].dtype == js[key].dtype == np.uint8
            assert np.array_equal(ps[key][keep], js[key][keep]), key
        assert set(np.unique(ps["gt_seg"])) <= {0, 1}
        inside = ~_outside((h, w), ours)
        assert ps["gt_seg"][inside].any()
        if with_det:    # every glyph pixel lies in a det box
            assert (ps["gt_det"][ps["gt_seg"] == 1] == 1).all()


def test_synthetic_text_seg_batches_with_a_pipeline():
    from fudanocr_tpu.data.seg_dataset import SyntheticTextSeg as JaxSeg
    from fudanocr_tpu.data.seg_pipeline import Normalize as JaxNormalize

    from fudanocr_tpu_torch.data.seg_pipeline import Normalize

    j = JaxSeg(5, (32, 32), [JaxNormalize()], seed=4)
    p = SyntheticTextSeg(5, (32, 32), [Normalize()], seed=4)
    for jb, pb in zip(j.batches(2, shuffle=True, seed=9),
                      p.batches(2, shuffle=True, seed=9)):
        assert set(jb) == set(pb) and np.array_equal(jb["valid"], pb["valid"])
        assert pb["img"].dtype == np.float32 and pb["gt_seg"].dtype == np.int32
        assert pb["img"].shape == jb["img"].shape
