"""The port's SR training feeds and apps (fudanocr_tpu_torch/train/sr.py
feed and demo, core/logging.py, apps/sr_common.py,
apps/scene_text_telescope/main.py, apps/text_gestalt/main.py) on the CPU.

* The training feed gives JAX's `SRTrainer._device_batch` arrays over
  the same LMDB (written here by JAX's `create_dataset`), exactly: hr, lr
  (float32), text_input, text_gt, lengths (equal values; the port's ids
  are int64, JAX's int32); the stroke codec's likewise; in the main
  thread and from two forked workers through the prefetch thread. A
  MixLMDBDataset, whose coins follow the read order, refuses workers.
* Both apps run end to end with `--device cpu --srb 1` at batch 4 on a
  tiny LMDB and on the synthetic fallback; `--test --resume auto`
  reproduces the saved best evaluation exactly; `--demo` writes PNG
  strips; the overwrite guard, an oracle checkpoint that is not there, the
  SR baselines (A6) and a missing card refuse to run.
* `metrics.jsonl` carries JAX's tags: "train/<metric>" every 50 steps,
  "eval/<metric>" per evaluation."""

import json
import os

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from fudanocr_tpu_torch.apps import sr_common
from fudanocr_tpu_torch.apps.scene_text_telescope import main as stt
from fudanocr_tpu_torch.apps.text_gestalt import main as gestalt
from fudanocr_tpu_torch.core.config import dump_yaml
from fudanocr_tpu_torch.data.lmdb_dataset import PairedLMDBDataset
from fudanocr_tpu_torch.data.png import decode_png
from fudanocr_tpu_torch.data.prefetch import PrefetchIterator
from fudanocr_tpu_torch.losses.sr_losses import TextFocusLoss
from fudanocr_tpu_torch.models.sr import TBSRN
from fudanocr_tpu_torch.train.sr import SRTrainer, StrokeSRTrainer

N, BATCH = 10, 4


def _write_lmdb(path, n, seed):
    from fudanocr_tpu.data.lmdb_dataset import create_dataset
    from fudanocr_tpu.data.synthetic import SyntheticTextZoom

    syn = SyntheticTextZoom(num_samples=n, hr_size=(128, 32), seed=seed)
    assert create_dataset(path, [syn[i] for i in range(n)]) == n
    return path


@pytest.fixture(scope="module")
def lmdbs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sr_lmdb")
    return {name: _write_lmdb(str(root / name), n, seed)
            for name, n, seed in (("train", N, 1), ("easy", 4, 2),
                                  ("hard", 5, 3))}


def _tiny_trainer(cls, data, hw=(32, 128), **kw):
    model = sr_common.seeded(lambda: TBSRN(srb_nums=1, stn=False,
                                           height=hw[0], width=hw[1]),
                             0, "cpu")
    return cls(model, TextFocusLoss(None, text_focus=False), data, data,
               batch_size=BATCH, **kw)


@pytest.mark.parametrize("stroke", [False, True], ids=["text", "stroke"])
def test_prefetched_feed_matches_jax_device_batch(lmdbs, stroke):
    from types import SimpleNamespace

    from fudanocr_tpu.data.codecs import english_stroke_codec
    from fudanocr_tpu.data.lmdb_dataset import PairedLMDBDataset as JaxPaired
    from fudanocr_tpu.train.sr import SRTrainer as JaxTrainer

    jax_ds = JaxPaired(lmdbs["train"], voc_type="all")
    port_ds = PairedLMDBDataset(lmdbs["train"], voc_type="all")
    trainer = _tiny_trainer(StrokeSRTrainer if stroke else SRTrainer,
                            port_ds, max_label_len=12)
    ns = SimpleNamespace(max_label_len=12)
    codec = english_stroke_codec(None)
    want = []
    for hr, lr, labels in jax_ds.batches(BATCH):
        if stroke:
            ti, tg, ln = codec.encode(labels, 12)
            want.append({"hr": hr, "lr": lr, "text_input": ti,
                         "text_gt": tg, "lengths": ln})
        else:
            want.append({k: np.asarray(v) for k, v in
                         JaxTrainer._device_batch(ns, hr, lr,
                                                  labels).items()})
    got = list(trainer.feed(port_ds))
    _assert_jax_batches(got, want)


def _assert_jax_batches(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].device.type == "cpu"
            assert g[k].dtype == (torch.float32 if k in ("hr", "lr")
                                  else torch.int64)
            assert np.array_equal(g[k].numpy(), np.asarray(w[k])), k


def test_worker_feed_matches_jax_device_batch(lmdbs):
    from types import SimpleNamespace

    from fudanocr_tpu.data.lmdb_dataset import PairedLMDBDataset as JaxPaired
    from fudanocr_tpu.train.sr import SRTrainer as JaxTrainer

    ns = SimpleNamespace(max_label_len=12)
    want = [{k: np.asarray(v) for k, v in
             JaxTrainer._device_batch(ns, hr, lr, labels).items()}
            for hr, lr, labels in JaxPaired(lmdbs["train"],
                                            voc_type="all").batches(BATCH)]
    port_ds = PairedLMDBDataset(lmdbs["train"], voc_type="all")
    trainer = _tiny_trainer(SRTrainer, port_ds, max_label_len=12,
                            num_workers=2)
    feed = trainer.feed(port_ds)
    assert isinstance(feed, PrefetchIterator)
    _assert_jax_batches(list(feed), want)


def test_worker_feed_of_the_synthetic_set_keeps_its_batches():
    from fudanocr_tpu_torch.data.synthetic import SyntheticTextZoom

    data = SyntheticTextZoom(num_samples=10)
    trainer = _tiny_trainer(SRTrainer, data, num_workers=2)
    got = list(trainer.host_batches(data))
    want = [trainer._host_batch(*b) for b in data.batches(BATCH)]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert all(np.array_equal(g[k], w[k]) for k in w)


def test_mix_dataset_refuses_workers(lmdbs):
    from fudanocr_tpu_torch.data.lmdb_dataset import MixLMDBDataset

    data = MixLMDBDataset(lmdbs["train"], voc_type="all")
    trainer = _tiny_trainer(SRTrainer, data, num_workers=2)
    with pytest.raises(ValueError, match="num_workers=0"):
        next(iter(trainer.host_batches(data)))


def _config(tmp_path, lmdbs=None, val=("easy",), **train):
    cfg = {"TRAIN": {
        "train_data_dir": [lmdbs["train"]] if lmdbs else [],
        "batch_size": BATCH, "width": 128, "height": 32, "epochs": 1,
        "lr": 1e-4, "beta1": 0.5, "manualSeed": 1234, "max_len": 100,
        "down_sample_scale": 2, "ckpt_dir": str(tmp_path / "ckpt"),
        "synthetic_samples": 8, "voc_type": "all", "workers": 2,
        "VAL": {"val_data_dir": [lmdbs[v] for v in val] if lmdbs else [],
                "valInterval": 2, "n_vis": 3,
                "vis_dir": str(tmp_path / "demo")}, **train}}
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "cfg.yaml"
    path.write_text(dump_yaml(cfg))
    return str(path)


COMMON = ["--device", "cpu", "--srb", "1", "--STN", "--text_focus"]


def test_scene_text_telescope_trains_tests_and_demos(tmp_path, lmdbs):
    cfg = _config(tmp_path, lmdbs, val=("easy", "hard"))
    argv = ["--config", cfg, "--arch", "tbsrn", *COMMON]
    res = stt.main(argv)
    # two buckets named after their directories, accuracy summed
    assert {"easy_psnr", "hard_psnr", "easy_acc", "hard_acc",
            "acc"} <= set(res)
    assert np.isfinite([res["easy_psnr"], res["hard_ssim"]]).all()
    best = torch.load(str(tmp_path / "ckpt" / "best.pt"))
    assert best["step"] == N // BATCH
    # the training run logs to its run dir, JAX's tags
    with open(tmp_path / "ckpt" / "metrics.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"eval/easy_psnr", "eval/hard_acc", "eval/acc"} <= tags
    # --test --resume auto: the same weights give the saved evaluation
    again = stt.main(argv + ["--test", "--resume", "auto"])
    assert again == best["metrics"]
    stt.main(argv + ["--demo", "--resume", "auto"])
    strips = sorted(os.listdir(tmp_path / "demo"))
    assert len(strips) == 3 and all(s.endswith(".png") for s in strips)
    with open(tmp_path / "demo" / strips[0], "rb") as f:
        assert decode_png(f.read()).shape == (32, 3 * 128, 3)


def test_apps_run_on_the_synthetic_fallback(tmp_path):
    res = stt.main(["--config", _config(tmp_path / "a"), "--arch", "tbsrn",
                    *COMMON])
    assert {"psnr", "ssim", "acc"} == set(res)
    res = gestalt.main(["--config", _config(tmp_path / "b"), "--arch",
                        "tsrn", *COMMON])
    assert {"psnr", "ssim", "acc"} == set(res)


def test_text_gestalt_trains_and_resumes(tmp_path, lmdbs):
    argv = ["--config", _config(tmp_path, lmdbs), "--arch", "tsrn", *COMMON]
    gestalt.main(argv)
    best = torch.load(str(tmp_path / "ckpt" / "best.pt"))
    assert gestalt.main(argv + ["--test", "--resume", "auto"]) == \
        best["metrics"]


def test_guard_refuses_a_used_run_dir(tmp_path, lmdbs):
    cfg = _config(tmp_path, lmdbs)
    (tmp_path / "ckpt").mkdir()
    (tmp_path / "ckpt" / "notes.txt").write_text("an earlier run")
    argv = ["--config", cfg, "--arch", "tbsrn", "--device", "cpu", "--srb",
            "1"]
    assert stt.main(argv) is None
    assert os.listdir(tmp_path / "ckpt") == ["notes.txt"]


def test_apps_refuse_what_is_not_ported(tmp_path, lmdbs):
    cfg = _config(tmp_path, lmdbs)
    # a configured oracle that is not there: no random oracle instead
    with pytest.raises(FileNotFoundError):
        stt.main(["--config", cfg, "--arch", "tbsrn", *COMMON, "--options",
                  "TRAIN.VAL.oracle_checkpoint=/ckpt/oracle"])
    with pytest.raises(FileNotFoundError):
        gestalt.main(["--config", cfg, "--arch", "tsrn", *COMMON,
                      "--options", "TRAIN.VAL.oracle_checkpoint=/o"])
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        stt.main(["--config", cfg, "--arch", "edsr", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stt.main(["--config", cfg, "--arch", "tbsrn"])


def test_metrics_jsonl_has_jax_tags(tmp_path, lmdbs):
    """50 steps (two batches an epoch) of a TBSRN at HR 16x64."""
    data = PairedLMDBDataset(lmdbs["train"], batch_hw=(16, 64))
    trainer = _tiny_trainer(SRTrainer, data, hw=(16, 64), epochs=25,
                            eval_every=25, log_dir=str(tmp_path / "logs"))
    trainer.train()
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert all(set(r) == {"tag", "value", "step", "time"} for r in lines)
    tags = {(r["tag"], r["step"]) for r in lines}
    assert {("train/loss", 50), ("train/mse", 50), ("eval/psnr", 25),
            ("eval/ssim", 50)} <= tags
    assert {t.split("/")[0] for t, _ in tags} == {"train", "eval"}


def test_entry_points_default_to_the_card():
    for parser in (sr_common.build_argparser("x"),):
        assert parser.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        args = sr_common.build_argparser("x").parse_args([])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sr_common.build_sr_model(args, sr_common.DEFAULTS)
