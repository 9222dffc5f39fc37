"""The port's HR-only and mixed LMDB datasets (fudanocr_tpu_torch/
data/lmdb_dataset.py: `LMDBDataset`, `MixLMDBDataset`) against the JAX
package's on stores that JAX writes here with PIL (JPEG q95): the same
items and the same collated batches, byte for byte (`np.array_equal`) and
label for label. The stores hold 11 items, so at batch 4 the last 3 are
left out of `batches`, as JAX leaves them out."""

import numpy as np
import pytest
from PIL import Image

from fudanocr_tpu_torch.data import lmdb_dataset as port_ds

N, BATCH = 11, 4


def _samples(with_lr):
    from fudanocr_tpu.data.synthetic import SyntheticTextZoom

    syn = SyntheticTextZoom(num_samples=N, hr_size=(128, 32), seed=5)
    rng = np.random.default_rng(1)
    out = []
    for i in range(N):
        hr, lr, label = syn[i]
        # HR sizes other than the collate's, so the resizes shrink and grow
        hr = hr.resize((int(rng.integers(40, 200)), int(rng.integers(12, 48))),
                       Image.BICUBIC)
        keep = with_lr(i)
        out.append((hr, lr.resize((int(rng.integers(20, 120)),
                                   int(rng.integers(8, 30))), Image.BICUBIC)
                    if keep else None, label.upper() if i % 3 else label))
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{"paired": every item with its LR, "hr_only": no LR key, "partial":
    every third item without an LR, "plain_key": the HR under 'image-'}."""
    from fudanocr_tpu.data.lmdb_dataset import create_dataset
    from fudanocr_tpu.data.lmdb_store import LMDBReader, LMDBWriter

    root = tmp_path_factory.mktemp("lmdb")
    paths = {}
    for name, with_lr in (("paired", lambda i: True),
                          ("hr_only", lambda i: False),
                          ("partial", lambda i: i % 3 != 0)):
        paths[name] = str(root / name)
        assert create_dataset(paths[name], _samples(with_lr)) == N
    # the reference's HR-only layout: 'image-%09d' keys
    src = LMDBReader(paths["hr_only"])
    paths["plain_key"] = str(root / "plain_key")
    w = LMDBWriter(paths["plain_key"])
    for i in range(1, N + 1):
        w.put(b"image-%09d" % i, src.get(b"image_hr-%09d" % i))
        w.put(b"label-%09d" % i, src.get(b"label-%09d" % i))
    w.put(b"num-samples", str(N).encode())
    w.write()
    return paths


def _assert_items_equal(jax_items, port_items):
    assert len(jax_items) == len(port_items)
    for (jh, jl, jlab), (ph, pl, plab) in zip(jax_items, port_items):
        assert np.array_equal(np.asarray(jh), ph)
        assert np.array_equal(np.asarray(jl), pl)
        assert jlab == plab


def _assert_batches_equal(jax_ds, port_ds_):
    jb, pb = list(jax_ds.batches(BATCH)), list(port_ds_.batches(BATCH))
    assert len(jb) == len(pb) == N // BATCH
    for (jh, jl, jlab), (ph, pl, plab) in zip(jb, pb):
        assert jh.dtype == ph.dtype and jl.dtype == pl.dtype
        assert np.array_equal(jh, ph) and np.array_equal(jl, pl)
        assert jlab == plab


@pytest.mark.parametrize("store", ["hr_only", "paired", "plain_key"])
@pytest.mark.parametrize("voc_type", ["lower", "all"])
def test_lmdb_dataset_matches_jax(stores, store, voc_type):
    """LR = PIL's bicubic HR / 2; the HR from 'image_hr-', else 'image-'."""
    from fudanocr_tpu.data.lmdb_dataset import LMDBDataset

    kw = dict(voc_type=voc_type, batch_hw=(32, 128), scale=2)
    j, p = LMDBDataset(stores[store], **kw), port_ds.LMDBDataset(
        stores[store], **kw)
    assert len(j) == len(p) == N
    _assert_items_equal([j[i] for i in range(N)], p.fetch_items(range(N)))
    _assert_batches_equal(j, p)


@pytest.mark.parametrize("test", [False, True], ids=["train", "test"])
@pytest.mark.parametrize("store", ["partial", "paired", "plain_key"])
def test_mix_lmdb_dataset_matches_jax(stores, store, test):
    """The 0.5 coin from random.Random(seed), drawn only for items with a
    stored LR, in the same order; at test time the stored LR when there is
    one; items and batches of two passes (the coin's stream runs on)."""
    from fudanocr_tpu.data.lmdb_dataset import MixLMDBDataset

    kw = dict(voc_type="lower", batch_hw=(32, 128), scale=2, test=test,
              seed=11)
    j, p = MixLMDBDataset(stores[store], **kw), port_ds.MixLMDBDataset(
        stores[store], **kw)
    _assert_items_equal([j[i] for i in range(N)], p.fetch_items(range(N)))
    for _ in range(2):
        _assert_batches_equal(j, p)


def test_mix_lmdb_dataset_over_two_stores(stores):
    """Several roots read as one dataset, items located across them."""
    from fudanocr_tpu.data.lmdb_dataset import MixLMDBDataset

    roots = [stores["partial"], stores["plain_key"]]
    j = MixLMDBDataset(roots, voc_type="all", seed=3)
    p = port_ds.MixLMDBDataset(roots, voc_type="all", seed=3)
    assert len(j) == len(p) == 2 * N
    _assert_items_equal([j[i] for i in range(2 * N)],
                        p.fetch_items(range(2 * N)))
