"""The port's segmentation data pipeline (fudanocr_tpu_torch/
data/seg_pipeline.py, data/seg_dataset.py `SegDataset`, apps/seg/train.py
`build_data`) against the JAX package's on files written here with PIL
(JPEG images, PNG annotations in L, palette and RGB mode, a det directory
that covers some images). The bar is byte equality (`np.array_equal`):
each transform, and the whole train and test pipelines, give JAX's sample
after the same `random.seed`; `SegDataset.batches(shuffle=True, seed=s)`
gives JAX's batches."""

import random

import numpy as np
import pytest
from PIL import Image

from fudanocr_tpu_torch.data import seg_pipeline as pp
from fudanocr_tpu_torch.data.seg_dataset import SegDataset

SIZES = [(48, 64), (61, 37), (40, 100), (33, 33)]
DATASETS = ["textseg", "bts", "totaltext", "icdar13", "mlt"]


def _annotation(kind, h, w, rng):
    """A raw annotation as each dataset stores it."""
    if kind == "textseg":      # 100 text, 200 background, some 255
        a = np.where(rng.random((h, w)) < 0.3, 100, 200).astype(np.uint8)
        a[rng.random((h, w)) < 0.05] = 255
        return Image.fromarray(a)
    if kind == "bts":          # palette: 0 background, 255 text
        a = np.where(rng.random((h, w)) < 0.3, 255, 0).astype(np.uint8)
        a[rng.random((h, w)) < 0.05] = 7
        im = Image.fromarray(a, "L").convert("P")
        return im
    if kind == "totaltext":    # gray in 0..255
        return Image.fromarray(rng.integers(0, 256, (h, w)).astype(np.uint8))
    if kind == "icdar13":      # RGB: white background, coloured text
        a = np.full((h, w, 3), 255, np.uint8)
        text = rng.random((h, w)) < 0.3
        a[text] = rng.integers(0, 255, (int(text.sum()), 3))
        return Image.fromarray(a)
    # mlt: a 3-colour palette, which PIL writes at 2 bits a pixel
    im = Image.fromarray(rng.integers(0, 3, (h, w)).astype(np.uint8), "P")
    im.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0])
    return im


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Per dataset kind: img/ (JPEG q90 photos, one of them gray), ann/
    (that kind's PNG annotations) and det/ (0/255 PNG masks for every
    other image)."""
    root = tmp_path_factory.mktemp("seg")
    rng = np.random.default_rng(0)
    out = {}
    for kind in DATASETS:
        d = {k: root / kind / k for k in ("img", "ann", "det")}
        for p in d.values():
            p.mkdir(parents=True)
        for i, (h, w) in enumerate(SIZES):
            base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3))
            img = np.kron(base, np.ones((4, 4, 1)))[:h, :w].astype(np.uint8)
            im = Image.fromarray(img)
            if i == 3:
                im = im.convert("L")
            im.save(d["img"] / f"s{i}.jpg", quality=90)
            _annotation(kind, h, w, rng).save(d["ann"] / f"s{i}.png")
            if i % 2 == 0:
                det = np.where(rng.random((h, w)) < 0.2, 255, 0)
                Image.fromarray(det.astype(np.uint8)).save(
                    d["det"] / f"s{i}.png")
        out[kind] = {k: str(v) for k, v in d.items()}
    return out


def _jax_pp():
    from fudanocr_tpu.data import seg_pipeline as jpp
    return jpp


def _sample(tree, kind, i, det=True):
    s = {"img_path": f"{tree[kind]['img']}/s{i}.jpg",
         "seg_path": f"{tree[kind]['ann']}/s{i}.png"}
    if det and i % 2 == 0:
        s["det_path"] = f"{tree[kind]['det']}/s{i}.png"
    return s


def _assert_samples_equal(j, p):
    assert set(j) == set(p)
    for k in j:
        if isinstance(j[k], np.ndarray):
            assert j[k].dtype == p[k].dtype, k
            assert np.array_equal(j[k], p[k]), k
        else:
            assert j[k] == p[k], k


def _both(jax_t, port_t, sample, seed=0):
    """jax_t and port_t of `sample` (a dict, copied for each; or an
    index), each after random.seed(seed); their results equal."""
    arg = (lambda: dict(sample)) if isinstance(sample, dict) else (
        lambda: sample)
    random.seed(seed)
    j = jax_t(arg())
    random.seed(seed)
    p = port_t(arg())
    _assert_samples_equal(j, p)
    return p


@pytest.mark.parametrize("kind", DATASETS)
def test_load_and_remap_match_jax(tree, kind):
    """Loading (RGB and gray JPEG) and every dataset's remap, palette and
    RGB annotations included; the det masks where they exist."""
    jpp = _jax_pp()
    for i in range(len(SIZES)):
        s = _sample(tree, kind, i)
        jt = jpp.Compose([jpp.LoadImageFromFile(),
                          jpp.LoadAnnotations(jpp.REMAPS[kind])])
        pt = pp.Compose([pp.LoadImageFromFile(),
                         pp.LoadAnnotations(pp.REMAPS[kind])])
        got = _both(jt, pt, s)
        assert got["img"].shape == SIZES[i] + (3,)
        assert ("gt_det" in got) == (i % 2 == 0)


@pytest.mark.parametrize("kind", ["bts", "icdar13"])
def test_raw_annotations_as_pil_opens_them(tree, kind):
    """Without a remap: a palette annotation keeps its indices, an RGB
    one stays 3-channel."""
    jpp = _jax_pp()
    got = _both(jpp.LoadAnnotations(), pp.LoadAnnotations(),
                _sample(tree, kind, 0, det=False))
    assert got["gt_seg"].ndim == (3 if kind == "icdar13" else 2)


def _loaded(tree, kind, i):
    jpp = _jax_pp()
    return jpp.Compose([jpp.LoadImageFromFile(),
                        jpp.LoadAnnotations(jpp.REMAPS[kind])])(
        _sample(tree, kind, i))


@pytest.mark.parametrize("keep_ratio", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_resize_matches_jax(tree, keep_ratio, seed):
    jpp = _jax_pp()
    s = _loaded(tree, "textseg", seed % len(SIZES))
    got = _both(jpp.Resize((96, 64), (0.5, 2.0), keep_ratio=keep_ratio),
                pp.Resize((96, 64), (0.5, 2.0), keep_ratio=keep_ratio), s,
                seed)
    assert got["img"].shape[:2] == got["gt_seg"].shape


@pytest.mark.parametrize("seed", range(6))
def test_crop_flip_and_photometric_distortion_match_jax(tree, seed):
    """RandomCrop (with the category-ratio redraws), RandomFlip and every
    branch of PhotoMetricDistortion (six seeds cover the coins), on
    crops as wide as 40 px (cv2's HSV2RGB: a vector block and a tail)."""
    jpp = _jax_pp()
    s = _loaded(tree, "textseg", 2)
    jt = jpp.Compose([jpp.RandomCrop((30, 40)), jpp.RandomFlip(0.5),
                      jpp.PhotoMetricDistortion()])
    pt = pp.Compose([pp.RandomCrop((30, 40)), pp.RandomFlip(0.5),
                     pp.PhotoMetricDistortion()])
    got = _both(jt, pt, s, seed)
    assert got["img"].shape == (30, 40, 3)
    # photometric alone, many draws
    for k in range(20):
        _both(jpp.PhotoMetricDistortion(), pp.PhotoMetricDistortion(),
              {"img": got["img"]}, 100 * seed + k)


def test_transforms_take_their_own_rng(tree):
    """rng= a random.Random: the same draws as JAX's with the same seed,
    and the module `random` untouched."""
    jpp = _jax_pp()
    s = _loaded(tree, "bts", 0)
    state = random.getstate()
    j = jpp.Compose([jpp.Resize((64, 64), rng=random.Random(5)),
                     jpp.RandomCrop((24, 24), rng=random.Random(6)),
                     jpp.RandomFlip(rng=random.Random(7)),
                     jpp.PhotoMetricDistortion(rng=random.Random(8))])(
        dict(s))
    p = pp.Compose([pp.Resize((64, 64), rng=random.Random(5)),
                    pp.RandomCrop((24, 24), rng=random.Random(6)),
                    pp.RandomFlip(rng=random.Random(7)),
                    pp.PhotoMetricDistortion(rng=random.Random(8))])(dict(s))
    _assert_samples_equal(j, p)
    assert random.getstate() == state


def _configs(tree, kind, det):
    from fudanocr_tpu.core.config import load_config as jax_load
    from fudanocr_tpu.core.config import merge_cli_overrides as jax_merge

    from fudanocr_tpu_torch.core.config import (load_config,
                                                merge_cli_overrides)

    path = f"configs/seg/textformer_b0_{kind}{'_det' if det else ''}.yaml"
    opts = [f"data.img_dir={tree[kind]['img']}",
            f"data.ann_dir={tree[kind]['ann']}",
            "data.crop_size=[32, 40]"]
    if det:
        opts.append(f"data.det_dir={tree[kind]['det']}")
    return (jax_merge(jax_load(path), opts),
            merge_cli_overrides(load_config(path), opts))


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("kind, det", [("textseg", False), ("bts", True),
                                       ("icdar13", False),
                                       ("totaltext", True), ("mlt", False)])
def test_build_data_pipelines_match_jax(tree, kind, det, train):
    """apps/seg/train.build_data's datasets, sample by sample after the
    same random.seed, and the train set's first shuffled batch (the test
    pipeline keeps each image's size, and a batch stacks one size only,
    in both packages)."""
    from fudanocr_tpu.apps.seg.train import build_data as jax_build

    from fudanocr_tpu_torch.apps.seg.train import build_data

    jcfg, pcfg = _configs(tree, kind, det)
    j, p = jax_build(jcfg, train), build_data(pcfg, train)
    assert len(j) == len(p) == len(SIZES)
    assert p.samples == j.samples
    for i in range(len(SIZES)):
        _both(j.__getitem__, p.__getitem__, i, seed=31 + i)
    if not train:
        return
    random.seed(3)
    jb = next(iter(j.batches(3, shuffle=True, seed=1)))
    random.seed(3)
    pb = next(iter(p.batches(3, shuffle=True, seed=1)))
    _assert_samples_equal(jb, pb)


def test_seg_dataset_batches_match_jax(tree, tmp_path):
    """Every batch of a shuffled pass (static size, the padded tail), with
    a split file and a partial det directory."""
    from fudanocr_tpu.data.seg_dataset import SegDataset as JaxSegDataset

    jpp = _jax_pp()
    split = tmp_path / "split.txt"
    split.write_text("s0\ns1\ns3\n")
    d = tree["textseg"]

    def pipes(m):
        return [m.LoadImageFromFile(), m.LoadAnnotations(m.REMAPS["textseg"]),
                m.Resize((64, 48), (0.5, 2.0)), m.RandomCrop((24, 32)),
                m.RandomFlip(0.5), m.PhotoMetricDistortion(), m.Normalize(),
                m.Pad((24, 32))]

    for split_file in (None, str(split)):
        j = JaxSegDataset(d["img"], d["ann"], pipes(jpp), det_dir=d["det"],
                          split=split_file)
        p = SegDataset(d["img"], d["ann"], pipes(pp), det_dir=d["det"],
                       split=split_file)
        assert p.samples == j.samples
        random.seed(17)
        jbs = list(j.batches(2, shuffle=True, seed=4))
        random.seed(17)
        pbs = list(p.batches(2, shuffle=True, seed=4))
        assert len(jbs) == len(pbs) == 2
        for jb, pb in zip(jbs, pbs):
            _assert_samples_equal(jb, pb)
