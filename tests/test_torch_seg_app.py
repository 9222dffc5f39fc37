"""The port's segmentation training app (fudanocr_tpu_torch/apps/seg/
train.py) and SegTrainer's checkpoints (train/seg.py, core/checkpoint.py)
on the CPU, the pattern of JAX's tests/test_seg_resume.py: CascadeMiT-b0
on the synthetic set at 64², batch 2 (two batches an epoch), checkpoints
every 2 iterations.

* A run of 4 iterations killed after iteration 2 and restarted with
  `--auto-resume` ends with the uninterrupted run's parameters, BN
  statistics and Adam state, bit for bit (`torch.equal`).
* `max_keep` keeps the newest periodic checkpoints; `best/` holds the
  best mIoU's evaluation and step.
The app's `build_data` against JAX's on a directory written with PIL is
held in tests/test_torch_seg_pipeline.py."""

import json
import os

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from fudanocr_tpu_torch.apps.seg import train as app
from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
from fudanocr_tpu_torch.train import seg as pseg

CONFIG = "configs/seg/textformer_b0_textseg.yaml"


def _options(ckpt_dir, total_iters=4, eval_every=2):
    return ["--device", "cpu", "--options", "data.batch_size=2",
            "data.synthetic_samples=4", f"schedule.total_iters={total_iters}",
            f"schedule.eval_every={eval_every}", f"ckpt_dir={ckpt_dir}"]


@pytest.fixture
def trainers(monkeypatch):
    """Every SegTrainer the app trains, and a hook to stop its run early
    (a kill: the schedule stays the full recipe's)."""
    seen, stop = [], {}
    train = pseg.SegTrainer.train

    def recording(self, stop_after=None):
        seen.append(self)
        return train(self, stop.get("after", stop_after))

    monkeypatch.setattr(pseg.SegTrainer, "train", recording)
    return seen, stop


def _checkpoints(ckpt_dir):
    """The checkpoint directories in `ckpt_dir` (the run's logs sit beside
    them)."""
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d == "best" or d.startswith("iter_"))


def _state(trainer):
    return (trainer.model.state_dict(),
            trainer.optimizer.adam.state_dict()["state"],
            trainer.optimizer.count)


def test_killed_run_resumes_bit_for_bit(tmp_path, trainers):
    seen, stop = trainers
    app.main([CONFIG, *_options(tmp_path / "full")])
    full = seen.pop()
    stop["after"] = 2
    app.main([CONFIG, *_options(tmp_path / "run")])
    killed = seen.pop()
    assert killed.optimizer.count == 2
    assert _checkpoints(tmp_path / "run") == ["best", "iter_2"]
    assert os.path.exists(tmp_path / "run" / "metrics.jsonl")
    stop.clear()
    app.main([CONFIG, *_options(tmp_path / "run"), "--auto-resume"])
    resumed = seen.pop()
    assert resumed.start_iter == 2
    (sd_f, adam_f, n_f), (sd_r, adam_r, n_r) = _state(full), _state(resumed)
    assert n_f == n_r == 4
    assert sd_f.keys() == sd_r.keys()
    assert all(torch.equal(sd_f[k], sd_r[k]) for k in sd_f)
    assert adam_f.keys() == adam_r.keys()
    for i in adam_f:
        for k in adam_f[i]:
            assert torch.equal(adam_f[i][k], adam_r[i][k]), (i, k)
    meta = ckpt_lib.load_meta(str(tmp_path / "run" / "iter_4"))
    assert meta["step"] == 4 and meta["best"] == resumed.best
    assert ckpt_lib.latest(str(tmp_path / "run"), "iter_").endswith("iter_4")


def test_max_keep_prunes_and_best_follows_miou(tmp_path, trainers,
                                               monkeypatch):
    seen, _ = trainers
    results = []
    evaluate = pseg.SegTrainer.evaluate

    def recording(self, it=0):
        res = evaluate(self, it)
        results.append((self.optimizer.count, res))
        return res

    monkeypatch.setattr(pseg.SegTrainer, "evaluate", recording)
    app.main([CONFIG, *_options(tmp_path, total_iters=10, eval_every=2)])
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("iter_"))
    assert kept == ["iter_10", "iter_6", "iter_8"]     # max_keep 3
    step, best = max(results, key=lambda r: (r[1]["mIoU"], r[0]))
    with open(tmp_path / "best" / "meta.json") as f:
        meta = json.load(f)
    assert meta["best"] == best["mIoU"] == seen[-1].best
    assert {k: meta[k] for k in best} == best
    # the last evaluation that reached the best (>=, as JAX) wrote best/
    last = max(s for s, r in results if r["mIoU"] >= best["mIoU"])
    assert meta["step"] == last
    payload = ckpt_lib.load(str(tmp_path / "best"))
    assert payload["step"] == last and set(payload) == {
        "state_dict", "optimizer", "step"}


def test_seg_trainer_logs_metrics_and_predictions(tmp_path):
    """With `log_dir`: JAX's tags ("eval/<metric>") in metrics.jsonl and a
    prediction table of the first evaluation batch, (image | gt | pred)
    PNG panels."""
    from fudanocr_tpu_torch.core.config import load_config
    from fudanocr_tpu_torch.data.png import decode_png

    cfg = load_config(CONFIG)
    data = app.build_data(cfg, False)          # synthetic, 8 at 64²
    trainer = pseg.SegTrainer(app.build_model(cfg, "cpu"), data, data,
                              batch_size=4, log_dir=str(tmp_path))
    res = trainer.evaluate(7)
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert {(r["tag"], r["step"]) for r in lines} == {
        ("eval/" + k, 7) for k in res} | {("predictions", 7)}
    files = next(r["files"] for r in lines if r["tag"] == "predictions")
    assert len(files) == 4
    with open(tmp_path / "predictions" / files[0], "rb") as f:
        assert decode_png(f.read()).shape == (64, 3 * 64, 3)


def test_checkpoint_writes_are_atomic(tmp_path):
    """A save over an existing checkpoint replaces it whole; no temporary
    directory is left behind."""
    path = str(tmp_path / "c")
    ckpt_lib.save(path, {"a": torch.ones(2)}, {"step": 1})
    ckpt_lib.save(path, {"a": torch.zeros(3)}, {"step": 2})
    assert os.listdir(tmp_path) == ["c"]
    assert ckpt_lib.load_meta(path) == {"step": 2}
    assert torch.equal(ckpt_lib.load(path)["a"], torch.zeros(3))
    assert ckpt_lib.latest(str(tmp_path / "none")) is None


def test_test_only_evaluates_without_training(tmp_path, trainers):
    """`--test-only` evaluates and writes nothing (JAX's app writes
    `best/` from it)."""
    seen, _ = trainers
    res = app.main([CONFIG, *_options(tmp_path), "--test-only"])
    assert set(res) == {"aAcc", "mIoU", "mDice", "mFscore"}
    assert not seen and os.listdir(tmp_path) == []


def test_test_only_leaves_a_trained_best_as_it_is(tmp_path, trainers):
    """`--test-only` over a trained run's dir, without --auto-resume (a
    freshly seeded model), does not overwrite its `best/`."""
    app.main([CONFIG, *_options(tmp_path)])

    def files():
        return {name: (tmp_path / "best" / name).read_bytes()
                for name in sorted(os.listdir(tmp_path / "best"))}

    before = files()
    assert set(before) == {"meta.json", ckpt_lib.PAYLOAD,
                           ckpt_lib.JAX_STATE}
    app.main([CONFIG, *_options(tmp_path), "--test-only"])
    assert files() == before


def test_the_app_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main([CONFIG])


def test_build_model_defaults_to_the_card():
    from fudanocr_tpu_torch.core.config import load_config

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.build_model(load_config(CONFIG))
