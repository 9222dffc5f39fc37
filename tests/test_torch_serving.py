"""Serving in the PyTorch port (fudanocr_tpu_torch/serving.py): the composed
pixels -> strings path against the JAX package's on the same weights, and
the batching server's semantics (mirroring tests/test_serving.py)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.data.collate import normalize_uint8
from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter
from fudanocr_tpu_torch.models.rec.crnn import CRNN
from fudanocr_tpu_torch.models.sr import TBSRN
from fudanocr_tpu_torch.serving import InferenceServer, PixelsToStrings
from fudanocr_tpu_torch.utils.weights import load_jax_variables

ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"


def _double(x):
    return x * 2.0


def test_pixels_to_strings_matches_jax_and_server():
    """Strings equal the JAX PixelsToStrings on the same weights; the ids
    served through InferenceServer equal the direct call
    (tests/test_serving.py:121-156)."""
    from fudanocr_tpu.eval.ctc import CTCLabelConverter as JaxConverter
    from fudanocr_tpu.models.rec.crnn import CRNN as JaxCRNN
    from fudanocr_tpu.models.sr import TBSRN as JaxTBSRN
    from fudanocr_tpu.serving import PixelsToStrings as JaxPixelsToStrings

    sr_kw = dict(scale_factor=2, width=64, height=16, stn=False, srb_nums=1,
                 hidden_units=32)
    jsr, jcrnn = JaxTBSRN(**sr_kw), JaxCRNN(num_classes=37, hidden=32)
    lr = np.random.default_rng(0).random((3, 8, 32, 3)).astype(np.float32)
    sr_vars = jsr.init(jax.random.PRNGKey(1), jnp.asarray(lr))
    crnn_vars = jcrnn.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 100, 1)))
    want = JaxPixelsToStrings(lambda x: jsr.apply(sr_vars, x),
                              lambda x: jcrnn.apply(crnn_vars, x),
                              JaxConverter(ALPHABET))(jnp.asarray(lr))

    sr = load_jax_variables(TBSRN(**sr_kw), "tbsrn", sr_vars,
                            srb_nums=1, stn=False).eval()
    crnn = load_jax_variables(CRNN(37, 32), "crnn", crnn_vars).eval()
    pipe = PixelsToStrings(sr, crnn, CTCLabelConverter(ALPHABET),
                           device="cpu")
    got, sr_out = pipe(lr, return_sr=True)
    assert got == want
    assert tuple(sr_out.shape) == (3, 16, 64, 3)

    srv = InferenceServer(pipe.ids_fn, buckets=(1, 4),
                          max_wait_ms=2.0, device="cpu")
    futs = [srv.submit(lr[i]) for i in range(3)]
    served = [pipe.decode_ids(f.result(timeout=60)[None])[0] for f in futs]
    srv.close()
    assert served == want


def test_normalize_uint8_matches_host_collate():
    x = np.arange(256, dtype=np.uint8).reshape(4, 8, 8)
    np.testing.assert_array_equal(
        normalize_uint8(torch.from_numpy(x)).numpy(),
        x.astype(np.float32) / 255.0)


def test_results_match_direct_application():
    srv = InferenceServer(_double, buckets=(1, 4),
                          max_wait_ms=2.0, device="cpu")
    rng = np.random.default_rng(0)
    imgs = [rng.random((4, 6, 3), np.float32) for _ in range(11)]
    futs = [srv.submit(im) for im in imgs]
    for im, fut in zip(imgs, futs):
        np.testing.assert_allclose(fut.result(timeout=30), im * 2.0,
                                   rtol=1e-6)
    srv.close()
    assert set(srv.batch_sizes) <= {1, 4}


def test_concurrent_submitters_and_full_batches():
    srv = InferenceServer(_double, buckets=(1, 8),
                          max_wait_ms=50.0, device="cpu")
    results = {}
    lock = threading.Lock()

    def client(i):
        out = srv.submit(np.full((2, 2, 1), float(i), np.float32)).result(
            timeout=30)
        with lock:
            results[i] = out

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    srv.close()
    for i in range(16):
        np.testing.assert_allclose(results[i], np.full((2, 2, 1), 2.0 * i))
    assert 8 in srv.batch_sizes


def test_deadline_flush_pads_whole_backlog_into_one_bucket():
    srv = InferenceServer(_double, buckets=(1, 8),
                          max_wait_ms=100.0, device="cpu")
    imgs = [np.full((2, 2, 1), float(i), np.float32) for i in range(7)]
    futs = [srv.submit(im) for im in imgs]
    outs = [f.result(timeout=30) for f in futs]
    srv.close()
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out, 2.0 * imgs[i])
    assert list(srv.batch_sizes) == [8]


def test_mixed_shapes_served_in_same_shape_runs():
    srv = InferenceServer(_double, buckets=(1, 4),
                          max_wait_ms=5.0, device="cpu")
    a = np.ones((2, 2, 1), np.float32)
    b = np.ones((3, 5, 1), np.float32) * 3.0
    fa, fb, fc = srv.submit(a), srv.submit(b), srv.submit(a * 5.0)
    np.testing.assert_allclose(fa.result(timeout=30), 2.0 * a)
    np.testing.assert_allclose(fb.result(timeout=30), 2.0 * b)
    np.testing.assert_allclose(fc.result(timeout=30), 10.0 * a)
    srv.close()


def test_apply_errors_propagate_and_close_rejects():
    srv = InferenceServer(lambda x: x.view(-1, 9999), buckets=(1,),
                          max_wait_ms=1.0, device="cpu")
    fut = srv.submit(np.ones((2, 2, 1), np.float32))
    with pytest.raises(RuntimeError):
        fut.result(timeout=30)
    srv.close()
    with pytest.raises(RuntimeError):
        srv.submit(np.ones((2, 2, 1), np.float32))


def test_warmup_runs_every_bucket_on_the_batcher_and_stats():
    seen = []

    def apply(x):
        seen.append((threading.current_thread().name, x.shape[0]))
        return x * 2.0

    srv = InferenceServer(apply, buckets=(1, 4),
                          max_wait_ms=2.0, device="cpu")
    srv.warmup(np.ones((2, 2, 1), np.float32))
    assert [b for _, b in seen] == [1, 4]
    assert srv.stats()["requests"] == 0
    futs = [srv.submit(np.full((2, 2, 1), i, np.float32)) for i in range(5)]
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=30), 2.0 * i)
    srv.close()
    assert {name for name, _ in seen} == {srv._thread.name}
    s = srv.stats()
    assert s["requests"] == 5
    assert 0.0 <= s["p50_ms"] <= s["p99_ms"] <= s["max_ms"]
    assert sum(s["batches"]) >= 5
    with pytest.raises(RuntimeError):
        srv.warmup(np.ones((2, 2, 1), np.float32))
