"""The plain seg recipe's train step against JAX, and `SegTrainer` on the
CPU (helpers and bars in tests/test_torch_seg_train.py, whose docstring
says what is held)."""

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.train import seg as pseg
from test_torch_seg_train import _Blobs, _port_model, train_step_parity
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("det", [False])
def test_train_step_matches_jax(det):
    train_step_parity(det)


def test_seg_trainer_trains_and_evaluates_on_the_model_device(tmp_path):
    model = _port_model(det=True)
    trainer = pseg.SegTrainer(model, _Blobs(4, 11), _Blobs(3, 12),
                              batch_size=2, total_iters=3, eval_every=10 ** 9,
                              loss_weights={"ce": 1.0, "lovasz": 1.0},
                              crop=(48, 48), stride=(32, 32), seed=3)
    assert trainer.device == torch.device("cpu")
    losses, lrs = [], []
    step = trainer.train_step

    def recording(batch, generator):
        assert all(t.device == trainer.device for t in batch.values())
        out = step(batch, generator)
        losses.append(out["loss"].item())
        lrs.append(trainer.optimizer.last_lr)
        return out

    trainer.train_step = recording
    assert trainer.train() == 3
    sched = pseg.poly_schedule(6e-5, 3)
    assert lrs == [sched(i) for i in range(3)]
    assert np.isfinite(losses).all()
    res = trainer.evaluate(3)
    assert set(res) == {"aAcc", "mIoU", "mDice", "mFscore"}
    assert all(0.0 <= v <= 1.0 for v in res.values())
    # the per-iteration generator depends on (seed, it) alone
    g = lambda it: torch.rand(4, generator=pseg.iteration_generator(3, it,
                                                                    "cpu"))
    assert torch.equal(g(2), g(2)) and not torch.equal(g(1), g(2))
    # a ckpt_dir is taken (checkpoints are ported); by default it is
    # written every eval_every iterations
    t = pseg.SegTrainer(model, _Blobs(2, 1), _Blobs(2, 2), eval_every=5,
                        ckpt_dir=str(tmp_path / "ckpt"))
    assert (t.ckpt_every, t.best, t.start_iter) == (5, -1.0, 0)
