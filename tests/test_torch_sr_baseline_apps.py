"""The five SR baselines through both SR apps of the port on the CPU
(fudanocr_tpu_torch/apps/sr_common.build_sr_model, apps/scene_text_telescope
/main.py, apps/text_gestalt/main.py): `--arch srcnn|srresnet|edsr|rdn|esrgan
--device cpu` trains one step at batch 4 on the synthetic fallback and
evaluates, writes `best.pt` and `best/` (the JAX package's format, through
the arch's porter), and `--test --resume <ckpt_dir>/best` gives the saved
evaluation back. SRResNet trains with `--text_focus` (the frozen oracle,
B2's plain path here). EDSR, RDN and RRDBNet are shrunk to the JAX tests'
sizes (2 blocks x 32, 2 dense layers, 2 blocks) by patching
`build_baseline`, as one CPU step at their published widths takes
minutes; SRCNN and SRResNet run at theirs."""

import os

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.apps import sr_common
from fudanocr_tpu_torch.apps.scene_text_telescope import main as stt
from fudanocr_tpu_torch.apps.text_gestalt import main as gestalt
from fudanocr_tpu_torch.core.config import dump_yaml
from fudanocr_tpu_torch.models.sr import baselines
from torch_threads import one_torch_thread  # noqa: F401

SMALL = {"edsr": lambda s: baselines.EDSR(s, num_blocks=2, features=32),
         "rdn": lambda s: baselines.RDN(s, num_dense=2),
         "esrgan": lambda s: baselines.RRDBNet(s, nb=2)}


@pytest.fixture
def small_baselines(monkeypatch):
    full = baselines.build_baseline

    def build(arch, scale_factor=2, mask=False, **kw):
        if arch in SMALL:
            return SMALL[arch](scale_factor)
        return full(arch, scale_factor, mask, **kw)

    monkeypatch.setattr(baselines, "build_baseline", build)


def _config(tmp_path):
    cfg = {"TRAIN": {
        "train_data_dir": [], "batch_size": 4, "width": 128, "height": 32,
        "epochs": 1, "lr": 1e-4, "beta1": 0.5, "manualSeed": 1234,
        "max_len": 100, "down_sample_scale": 2,
        "ckpt_dir": str(tmp_path / "ckpt"), "synthetic_samples": 4,
        "voc_type": "all", "workers": 0,
        "VAL": {"val_data_dir": [], "valInterval": 1000, "n_vis": 2,
                "vis_dir": str(tmp_path / "demo")}}}
    path = tmp_path / "cfg.yaml"
    path.write_text(dump_yaml(cfg))
    return str(path)


@pytest.mark.parametrize("app", [stt, gestalt],
                         ids=["scene_text_telescope", "text_gestalt"])
@pytest.mark.parametrize("arch", sr_common.BASELINES)
def test_baseline_trains_evaluates_and_resumes(arch, app, tmp_path,
                                               small_baselines):
    argv = ["--config", _config(tmp_path), "--arch", arch, "--device",
            "cpu"]
    if arch == "srresnet":
        argv.append("--text_focus")
    res = app.main(argv)
    assert {"psnr", "ssim", "acc"} == set(res)
    assert np.isfinite([res["psnr"], res["ssim"]]).all()
    ckpt = tmp_path / "ckpt"
    best = torch.load(str(ckpt / "best.pt"))
    assert best["step"] == 1
    assert os.path.exists(ckpt / "best" / "state.msgpack")
    again = app.main(argv + ["--test", "--resume", str(ckpt / "best")])
    assert again == best["metrics"]


def test_build_sr_model_seeds_the_baselines():
    """Two builds from one TRAIN.manualSeed give the same weights; the
    arch's class and `mask` planes are JAX's."""
    args = sr_common.build_argparser("x").parse_args(
        ["--arch", "srcnn", "--mask"])
    a, b = (sr_common.build_sr_model(args, sr_common.DEFAULTS, "cpu")
            for _ in range(2))
    assert isinstance(a, baselines.SRCNN) and a.conv1.in_channels == 4
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
