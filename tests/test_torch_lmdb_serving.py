"""The port's LMDB serving journey (fudanocr_tpu_torch: data/lmdb_dataset,
data/workers, data/prefetch, serving.LMDBToStrings) against the JAX
package's on a database that JAX's `create_dataset` writes here (PIL JPEG
at quality 95) from `SyntheticTextZoom`, its LR images redrawn at heights
8-40 and widths 20-200 so the collate's resize both shrinks and enlarges.
The database holds 11 images: at batch 4 the last batch has 3, which JAX's
`LMDBToStrings` drops and the port serves."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_threads import one_torch_thread  # noqa: F401

from fudanocr_tpu_torch.data import lmdb_dataset as port_ds
from fudanocr_tpu_torch.data.collate import normalize_uint8
from fudanocr_tpu_torch.data.prefetch import PrefetchIterator
from fudanocr_tpu_torch.data.workers import WorkerBatches
from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter
from fudanocr_tpu_torch.models.rec.crnn import CRNN
from fudanocr_tpu_torch.models.sr import TBSRN
from fudanocr_tpu_torch.serving import LMDBToStrings, PixelsToStrings
from fudanocr_tpu_torch.utils.weights import load_jax_variables

ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"
N_IMAGES, BATCH = 11, 4
HW = (16, 64)            # the small TBSRN's HR geometry; LR 8 x 32
MARGIN = 1e-4            # CTC steps this close to a tie may flip


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    from fudanocr_tpu.data.lmdb_dataset import create_dataset
    from fudanocr_tpu.data.synthetic import SyntheticTextZoom

    syn = SyntheticTextZoom(num_samples=N_IMAGES, hr_size=(128, 32), seed=3)
    rng = np.random.default_rng(0)
    samples = []
    for i in range(N_IMAGES):
        hr, lr, label = syn[i]
        size = (int(rng.integers(20, 201)), int(rng.integers(8, 41)))
        samples.append((hr, lr.resize(size, Image.BICUBIC), label))
    path = str(tmp_path_factory.mktemp("lmdb") / "db")
    assert create_dataset(path, samples) == N_IMAGES
    return path


def _jax_serving(db, **kw):
    from fudanocr_tpu.data.lmdb_dataset import LRServingLMDBDataset

    return LRServingLMDBDataset(db, voc_type="lower", **kw)


@pytest.mark.parametrize("batch_hw", [(32, 128), HW], ids=["32x128",
                                                          "16x64"])
def test_serving_batches_are_byte_equal_to_jax(db, batch_hw):
    jax_ds = _jax_serving(db, batch_hw=batch_hw)
    ds = port_ds.LRServingLMDBDataset(db, batch_hw=batch_hw)
    got = list(ds.batches(BATCH, drop_last=False))
    assert [len(b) for b in got] == [4, 4, 3]
    for k, lr in enumerate(got):
        idx = range(BATCH * k, min(BATCH * (k + 1), N_IMAGES))
        want, _ = jax_ds.collate(jax_ds.fetch_items(idx))
        assert lr.dtype == np.uint8 and np.array_equal(lr, want)
        f32 = ds.collate(ds.fetch_items(idx), dtype=np.float32)
        assert np.array_equal(f32, jax_ds.collate(jax_ds.fetch_items(idx),
                                                  dtype=np.float32)[0])


def test_paired_batches_are_byte_equal_to_jax(db):
    from fudanocr_tpu.data.lmdb_dataset import PairedLMDBDataset

    jax_ds = PairedLMDBDataset(db, voc_type="lower")
    ds = port_ds.PairedLMDBDataset(db, voc_type="lower")
    for got, want in zip(ds.batches(BATCH, dtype=np.uint8),
                         jax_ds.batches(BATCH, dtype=np.uint8)):
        assert all(np.array_equal(g, w) for g, w in zip(got[:2], want[:2]))
        assert got[2] == want[2]


def test_serving_reads_no_label_when_asked_for_none(db):
    ds = port_ds.LRServingLMDBDataset(db)
    keys = []
    get_many = ds.readers[0].get_many
    ds.readers[0].get_many = lambda ks: keys.extend(ks) or get_many(ks)
    lr = ds.collate(ds.fetch_items(range(N_IMAGES)))
    assert lr.shape == (N_IMAGES, 16, 64, 3)
    assert keys and all(k.startswith(b"image_lr-") for k in keys)
    with pytest.raises(TypeError):
        ds.collate(ds.fetch_items([0]), img_h=16)   # only dtype is taken


class _FailingDataset(port_ds.LRServingLMDBDataset):
    def fetch_items(self, indices):
        if 9 in indices:
            raise ValueError("bad record 9")
        return super().fetch_items(indices)


@pytest.mark.parametrize("workers", [0, 2])
def test_worker_batches_keep_order_and_the_tail(db, workers):
    factory = functools.partial(port_ds.LRServingLMDBDataset, db)
    ds = factory()
    want = [ds.collate(ds.fetch_items(range(s, min(s + BATCH, N_IMAGES))))
            for s in range(0, N_IMAGES, BATCH)]
    got = list(WorkerBatches(factory, BATCH, num_workers=workers,
                             drop_last=False))
    assert len(got) == len(want) == 3
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    dropped = list(WorkerBatches(factory, BATCH, num_workers=workers))
    assert [len(b) for b in dropped] == [4, 4]
    with pytest.raises(ValueError, match="bad record 9"):
        list(WorkerBatches(functools.partial(_FailingDataset, db), BATCH,
                           num_workers=workers, drop_last=False))


def test_prefetch_on_the_cpu_stages_tensors_and_raises_errors():
    arrays = [np.full((2, 3), i, np.uint8) for i in range(5)]
    got = list(PrefetchIterator(iter(arrays), device="cpu"))
    assert all(isinstance(t, torch.Tensor) and torch.equal(
        t, torch.from_numpy(a)) for t, a in zip(got, arrays))

    def broken():
        yield arrays[0]
        raise RuntimeError("decode failed")

    stream = PrefetchIterator(broken(), device="cpu")
    assert torch.equal(next(stream), torch.from_numpy(arrays[0]))
    with pytest.raises(RuntimeError, match="decode failed"):
        next(stream)
    closed = []

    def endless():
        try:
            while True:
                yield arrays[1]
        finally:
            closed.append(True)

    stream = PrefetchIterator(endless(), device="cpu", buffer_size=1)
    next(stream)
    stream.close()
    assert closed == [True]


def _models():
    from fudanocr_tpu.models.rec.crnn import CRNN as JaxCRNN
    from fudanocr_tpu.models.sr import TBSRN as JaxTBSRN

    sr_kw = dict(scale_factor=2, width=HW[1], height=HW[0], stn=False,
                 srb_nums=1, hidden_units=32)
    jsr, jcrnn = JaxTBSRN(**sr_kw), JaxCRNN(num_classes=37, hidden=32)
    sr_vars = jsr.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 32, 3)))
    crnn_vars = jcrnn.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 100, 1)))
    sr = load_jax_variables(TBSRN(**sr_kw), "tbsrn", sr_vars, srb_nums=1,
                            stn=False).eval()
    crnn = load_jax_variables(CRNN(37, 32), "crnn", crnn_vars).eval()
    return (jsr, sr_vars, jcrnn, crnn_vars), (sr, crnn)


def test_lmdb_to_strings_matches_jax_and_serves_the_tail(db):
    from fudanocr_tpu.eval.ctc import CTCLabelConverter as JaxConverter
    from fudanocr_tpu.models.rec.crnn import parse_crnn_input
    from fudanocr_tpu.serving import LMDBToStrings as JaxLMDBToStrings
    from fudanocr_tpu.serving import PixelsToStrings as JaxPixelsToStrings

    (jsr, sr_vars, jcrnn, crnn_vars), (sr, crnn) = _models()
    jpipe = JaxPixelsToStrings(lambda x: jsr.apply(sr_vars, x),
                               lambda x: jcrnn.apply(crnn_vars, x),
                               JaxConverter(ALPHABET))
    jax_strings = [t for texts in JaxLMDBToStrings(
        jpipe, db, batch_size=BATCH, batch_hw=HW) for t in texts]
    assert len(jax_strings) == 8                  # JAX drops the tail

    pipe = PixelsToStrings(sr, crnn, CTCLabelConverter(ALPHABET),
                           device="cpu")
    batches = list(LMDBToStrings(pipe, db, batch_size=BATCH, batch_hw=HW,
                                 device="cpu"))
    assert [len(b) for b in batches] == [4, 4, 3]
    got = [t for texts in batches for t in texts]

    # JAX on JAX's own collate of every image, the tail included
    jax_ds = _jax_serving(db, batch_hw=HW)
    lr, _ = jax_ds.collate(jax_ds.fetch_items(range(N_IMAGES)),
                           dtype=np.float32)
    want = jpipe(jnp.asarray(lr))
    assert want[:8] == jax_strings
    logits = np.asarray(jcrnn.apply(crnn_vars, parse_crnn_input(
        jsr.apply(sr_vars, jnp.asarray(lr)), (32, 100))), np.float64)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > MARGIN          # per CTC step
    assert sure.mean() > 0.9
    # the port's ids on its own collate (the same bytes as JAX's), which is
    # what LMDBToStrings runs: equal to JAX's at every sure step, and the
    # strings are those ids joined
    ds = port_ds.LRServingLMDBDataset(db, batch_hw=HW)
    port_lr = ds.collate(ds.fetch_items(range(N_IMAGES)))
    port_ids = pipe.ids_fn(normalize_uint8(torch.from_numpy(port_lr))).numpy()
    jax_ids = logits.argmax(-1)
    assert (port_ids == jax_ids)[sure].all()
    assert got == pipe.decode_ids(np.where(sure, jax_ids, port_ids))
    assert [g for g, s in zip(got, sure.all(axis=1)) if s] == [
        w for w, s in zip(want, sure.all(axis=1)) if s]


def test_lmdb_to_strings_hands_the_pipe_a_device_tensor(db):
    seen = []

    class Spy:
        device = torch.device("cpu")

        def ids_fn(self, x):
            seen.append((x.device, x.dtype, float(x.max())))
            return torch.zeros(len(x), 3, dtype=torch.long)

        def decode_ids(self, ids):
            return ["" for _ in range(len(ids))]

    out = list(LMDBToStrings(Spy(), db, batch_size=BATCH, batch_hw=HW))
    assert [len(b) for b in out] == [4, 4, 3]
    assert all(d == torch.device("cpu") and t == torch.float32 and m <= 1.0
               for d, t, m in seen)
    # and PixelsToStrings runs a tensor already on its device as it is
    given = []
    pipe = PixelsToStrings(lambda x: given.append(x) or x,
                           lambda g: torch.zeros(len(g), 5, 37),
                           CTCLabelConverter(ALPHABET), device="cpu")
    lr = torch.rand(2, 8, 32, 3)
    pipe.ids_fn(lr)
    assert given[0] is lr


def test_lmdb_to_strings_raises_and_rejects_unknown_arguments(db, tmp_path):
    pipe = PixelsToStrings(None, None, None, device="cpu")
    with pytest.raises(TypeError):
        LMDBToStrings(pipe, db, batch_size=BATCH, drop_last=True)
    assert inspect.signature(LMDBToStrings).parameters["device"].default \
        is None
    assert LMDBToStrings(PixelsToStrings(None, None, None), db).device == \
        torch.device("cuda")                      # the pipe's default
    from fudanocr_tpu_torch.data.lmdb_store import LMDBWriter

    w = LMDBWriter(str(tmp_path / "bad"))
    w.update({b"num-samples": b"1", b"image_lr-000000001": b"GIF89a..."})
    w.write()
    with pytest.raises(ValueError, match="unknown image format"):
        list(LMDBToStrings(pipe, str(tmp_path / "bad"), batch_size=BATCH))
