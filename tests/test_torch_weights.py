"""The port's weight bridge (fudanocr_tpu_torch/utils/porters.py and
utils/weights.py) against the JAX package's (utils/torch_port.py and
utils/torch_export.py):

* each of the port's porters gives, on a port module's state_dict, the
  tree the JAX package's porter gives, bit for bit;
* JAX variables -> `load_jax_variables` -> `to_jax_variables` returns them
  bit for bit, and the state_dict the port loads equals the JAX exporter's.
"""

import numpy as np
import pytest
import torch

from fudanocr_tpu.utils import torch_export
from fudanocr_tpu.utils import torch_port
from fudanocr_tpu_torch.models.rec.crnn import CRNN
from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
from fudanocr_tpu_torch.models.seg import (CascadeMiT, CascadeMiTDetGuided,
                                           DetGuidedEncoderDecoder,
                                           EncoderDecoder, SegformerHead)
from fudanocr_tpu_torch.models.sr import TBSRN
from fudanocr_tpu_torch.utils import porters
from fudanocr_tpu_torch.utils.weights import (load_jax_variables,
                                              to_jax_variables)

SEG = dict(embed_dims=8, num_layers=(1, 2, 1, 1), num_heads=(1, 2, 5, 8),
           sr_ratios=(8, 4, 2, 1))
OCR = dict(vocab=37, num_in=1, layers=(1, 1, 1, 1), num_heads=4,
           d_embed=32, d_model=64, d_ff=64)
HEAD_IN = [8, 16, 40, 64]


def _segmentor():
    return EncoderDecoder(CascadeMiT(**SEG), SegformerHead(HEAD_IN, 2, 32))


def _segmentor_det():
    return DetGuidedEncoderDecoder(CascadeMiTDetGuided(**SEG),
                                   SegformerHead(HEAD_IN, 2, 32))


# (porter, port module factory, porter kwargs)
CASES = {
    "tbsrn": (lambda: TBSRN(srb_nums=2), dict(srb_nums=2)),
    "crnn": (lambda: CRNN(37, 32), {}),
    "ocr_transformer": (lambda: OCRTransformer(**OCR),
                        dict(layers=OCR["layers"])),
    "cascade_mit": (lambda: CascadeMiT(**SEG), SEG),
    "cascade_mit_v10": (lambda: CascadeMiTDetGuided(**SEG), SEG),
    "segformer_head": (lambda: SegformerHead(HEAD_IN, 2, 32), {}),
    "segmentor": (_segmentor, SEG),
    "segmentor_det": (_segmentor_det, SEG),
}
# the port's whole-segmentor porters: (the JAX package's backbone porter)
SEGMENTORS = {"segmentor": torch_port.port_cascade_mit,
              "segmentor_det": torch_port.port_cascade_mit_v10}


def _leaves(tree, path=()):
    if hasattr(tree, "items"):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _assert_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))


def _module(name):
    torch.manual_seed(len(name))
    make, kw = CASES[name]
    m = make()
    with torch.no_grad():   # BN statistics away from their 0 / 1 inits
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.1)
                mod.running_var.uniform_(0.75, 1.25)
    return m, kw


def _jax_porter(name, sd, kw):
    """The JAX package's porters; a segmentor is its two halves."""
    if name not in SEGMENTORS:
        return torch_port.PORTERS[name](sd, **kw)
    under = lambda p: {k[len(p):]: v for k, v in sd.items()
                       if k.startswith(p)}
    bb = SEGMENTORS[name](under("backbone."), **kw)
    head = torch_port.port_segformer_head(under("decode_head."))
    return {kind: {"backbone": bb[kind], "decode_head": head[kind]}
            for kind in ("params", "batch_stats")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_porter_trees_equal_the_jax_packages(name):
    m, kw = _module(name)
    sd = m.state_dict()
    _assert_bit_equal(porters.PORTERS[name](sd, **kw),
                      _jax_porter(name, sd, kw))


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_variables_round_trip_bit_for_bit(name):
    src, kw = _module(name)
    variables = _jax_porter(name, src.state_dict(), kw)
    fresh, _ = _module(name)
    for p in fresh.parameters():         # other values than src's
        torch.nn.init.uniform_(p.data, -1, 1)
    loaded = load_jax_variables(fresh, name, variables, **kw)
    _assert_bit_equal(to_jax_variables(loaded, name, **kw), variables)
    if name not in SEGMENTORS:   # the JAX exporter does not know those
        template = {k: v.clone() for k, v in fresh.state_dict().items()}
        want = torch_export.export_state_dict(name, variables, template,
                                              **kw)
        for k, v in loaded.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_inverse_refuses_mismatched_variables():
    m, kw = _module("crnn")
    variables = porters.PORTERS["crnn"](m.state_dict())
    del variables["params"]["fc1"]
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables(m, "crnn", variables)
