"""The port's config reader (fudanocr_tpu_torch/core/config.py, no yaml)
against the JAX package's (PyYAML's `safe_load` underneath): every seg
config loads to the same dict, overrides agree, and YAML outside the
reader's subset raises instead of being misread."""

import glob
from pathlib import Path

import pytest
import yaml

from fudanocr_tpu.core import config as jconfig
from fudanocr_tpu_torch.core import config as pconfig

ROOT = Path(__file__).resolve().parents[1]
SEG_CONFIGS = sorted(glob.glob(str(ROOT / "configs/seg/*.yaml")))
ALL_YAML = sorted(glob.glob(str(ROOT / "configs/**/*.yaml"), recursive=True))


def test_every_seg_config_loads_as_in_jax():
    assert len(SEG_CONFIGS) == 60
    for path in SEG_CONFIGS:
        assert pconfig.load_config(path).to_dict() == \
            jconfig.load_config(path).to_dict(), path


def test_every_config_file_parses_as_pyyaml_does():
    assert len(ALL_YAML) > 60
    for path in ALL_YAML:
        text = Path(path).read_text()
        assert pconfig.parse_yaml(text) == yaml.safe_load(text), path


@pytest.mark.parametrize("overrides", [
    ["model.backbone.embed_dims=64", "optimizer.lr=1.0e-04"],
    ["test.crop=[512, 512]", "test.mode=whole", "data.img_dir=\"\""],
    ["new.key.deep=true", "model.backbone.num_layers=[3, 4, 6, 3]",
     "schedule.total_iters=-1", "ckpt_dir=./ckpt/x_y-2"],
])
def test_overrides_match_jax(overrides):
    path = str(ROOT / "configs/seg/textformer_b0_textseg.yaml")
    got = pconfig.merge_cli_overrides(pconfig.load_config(path), overrides)
    want = jconfig.merge_cli_overrides(jconfig.load_config(path), overrides)
    assert got.to_dict() == want.to_dict()
    assert got.model.backbone.sr_ratios == [8, 4, 2, 1]   # attribute access


@pytest.mark.parametrize("text", [
    "a: {b: 1}",                 # flow mapping
    "a: &x 1\nb: *x",            # anchor / alias
    "a: !!int 1",                # tag
    "a: |\n  text",              # block scalar
    "a: 1\n---\nb: 2",           # second document
    "a:\n\tb: 1",                # tab
    "a: yes",                    # YAML 1.1 boolean
    "a: 1e-5",                   # a string to PyYAML
    "a: 012",                    # octal to PyYAML
    "a: x\n  y",                 # multi-line plain scalar
    "a:\n  - b: 1",              # mapping in a list
    "a: 1\na: 2",                # duplicate key
    "a: \"x\\n\"",               # escape
    "- 1\nb: 2",                 # list then mapping at one level
])
def test_reader_refuses_yaml_outside_its_subset(text):
    with pytest.raises(ValueError, match="outside the YAML subset"):
        pconfig.parse_yaml(text)
