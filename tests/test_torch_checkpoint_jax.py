"""Checkpoint interchange between the port and the JAX package on the CPU
(fudanocr_tpu_torch/core/serialization.py, core/checkpoint.py and the
loaders that read a JAX checkpoint directory):

* the codec: flax reads the port's bytes, the port reads flax's, and bytes
  flax wrote come back from the port's reader and writer byte for byte,
  for float32, 0-d int32, float64 and bfloat16 leaves, numpy and Python
  scalars, empty maps and chunked leaves (the chunk size patched down to
  64 bytes in both packages, so that small leaves are chunked);
* every porter of the port: JAX `ckpt_lib.save` -> the port's
  `load_model_state` -> the port's `save_jax` -> JAX `ckpt_lib.load` on
  the JAX template gives the variables back bit for bit, and the port
  module loaded from the file matches JAX's forward at atol 2e-4;
* each loader that reads a directory written by JAX's `ckpt_lib.save`:
  `build_oracle` (TRAIN.VAL.oracle_checkpoint), `init_segmentor` and
  `apps.seg.test --checkpoint`, CCR-CLIP stage 2's `radical_model` and
  `SRTrainer.resume` (with `resume_path`'s fallback to best/);
* the converters: `utils.porters` writes the bytes JAX's `torch_port`
  writes, `utils.weights` exports the state_dict JAX's `torch_export`
  does.

Small widths throughout (the existing parity tests' sizes); every leaf is
drawn from a numpy seed.
"""

import functools
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fudanocr_tpu.core import checkpoint as jckpt
from fudanocr_tpu.models.rec import ocr_transformer as jocr
from fudanocr_tpu.models.rec.acpm import ACPM as JaxACPM
from fudanocr_tpu.models.rec.crnn import CRNN as JaxCRNN
from fudanocr_tpu.models.rec.oictr import OICTR as JaxOICTR
from fudanocr_tpu.models.seg import CascadeMiT as JaxCascadeMiT
from fudanocr_tpu.models.seg import CascadeMiTDetGuided as JaxDetGuided
from fudanocr_tpu.models.seg import DetGuidedEncoderDecoder as JaxDetSeg
from fudanocr_tpu.models.seg import EncoderDecoder as JaxSeg
from fudanocr_tpu.models.seg import SegformerHead as JaxSegformerHead
from fudanocr_tpu.models.sr import TBSRN as JaxTBSRN
from fudanocr_tpu.models.sr import TSRN as JaxTSRN
from fudanocr_tpu.utils import torch_export, torch_port
from fudanocr_tpu_torch.core import checkpoint as pckpt
from fudanocr_tpu_torch.core import serialization
from fudanocr_tpu_torch.models.rec.acpm import ACPM
from fudanocr_tpu_torch.models.rec.ccr_clip import CCRCLIP
from fudanocr_tpu_torch.models.rec.crnn import CRNN
from fudanocr_tpu_torch.models.rec.oictr import OICTR
from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
from fudanocr_tpu_torch.models.seg import (CascadeMiT, CascadeMiTDetGuided,
                                           DetGuidedEncoderDecoder,
                                           EncoderDecoder, SegformerHead)
from fudanocr_tpu_torch.models.sr import TBSRN, TSRN
from fudanocr_tpu_torch.utils import porters, weights
from fudanocr_tpu_torch.utils.weights import jax_variables, load_jax_variables
from torch_ctr_cases import (ATOL, CLIP, CLIP_VISION, OICTR as OI, SLD,
                             randomize, small_clip_vision)
from torch_ctr_step_cases import clip_text
from torch_threads import one_torch_thread  # noqa: F401

B, L = 2, 8
SEG = dict(embed_dims=8, num_layers=(1, 1, 1, 1), num_heads=(1, 2, 5, 8),
           sr_ratios=(8, 4, 2, 1))
HEAD_IN = [8, 16, 40, 64]
ACPM_KW = dict(vocab=20, encoder="resnet", stn=False, rn_loss="L1",
               encoder_layers=(1, 1, 1, 1), encoder_width_div=8,
               d_model=128)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_bit_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _variables(jm, *args, seed=0, **kw):
    """Random variables of JAX module `jm` (only an init's shapes are
    traced), numpy leaves."""
    shapes = jax.eval_shape(functools.partial(jm.init, **kw),
                            jax.random.PRNGKey(0),
                            *(jnp.asarray(a) for a in args))
    return randomize(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes),
        np.random.default_rng(seed))


def _uniform(shape, seed, lo=-1.0):
    return np.random.default_rng(seed).uniform(lo, 1, shape).astype(
        np.float32)


def _tokens(vocab, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).astype(
        np.int32)


# -- the codec --------------------------------------------------------------

def _codec_tree(rng):
    return {
        "params": {"w": jnp.asarray(rng.standard_normal((3, 5)),
                                    jnp.float32),
                   "b": rng.standard_normal(5).astype(np.float32),
                   "empty": {}},
        "opt_state": {"count": jnp.asarray(7, jnp.int32), "mu": {},
                      "f64": rng.standard_normal((2, 2)),
                      "bf16": jnp.asarray(rng.standard_normal(9),
                                          jnp.bfloat16)},
        "scalars": {"np_f32": np.float32(1.25), "np_i64": np.int64(-3),
                    "np_bf16": ml_dtypes.bfloat16(-2.5), "py_int": 300,
                    "py_neg": -70000, "py_float": 0.1, "py_bool": True,
                    "none": None, "str": "x" * 40},
        "seq": {"0": np.arange(4, dtype=np.int32), "1": {"k": np.uint8(5)}},
    }


def _check_codec(tree):
    data = fser.to_bytes(tree)
    read = serialization.from_bytes(data)
    assert serialization.to_bytes(read) == data
    assert isinstance(read["opt_state"]["bf16"], torch.Tensor)
    assert read["opt_state"]["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        read["opt_state"]["bf16"].float().numpy(),
        np.asarray(tree["opt_state"]["bf16"], np.float32))
    assert read["scalars"]["np_bf16"] == -2.5
    # flax reads what the port writes, from the port's own tree too
    back = fser.msgpack_restore(serialization.to_bytes(read))
    _assert_bit_equal(back, fser.msgpack_restore(data))
    assert back["params"]["empty"] == {} and back["opt_state"]["mu"] == {}
    assert back["opt_state"]["count"].dtype == np.int32
    assert back["opt_state"]["count"].shape == ()


def test_codec_matches_flax():
    _check_codec(_codec_tree(np.random.default_rng(0)))


def test_codec_chunked_leaves_match_flax(monkeypatch):
    """With the chunk size patched down to 64 bytes in both packages every
    leaf above 64 bytes is a chunked map."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = _codec_tree(rng)
    tree["params"]["big"] = rng.standard_normal((10, 7)).astype(np.float32)
    tree["opt_state"]["bf16"] = jnp.asarray(rng.standard_normal(100),
                                            jnp.bfloat16)
    data = fser.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _check_codec(tree)
    read = serialization.from_bytes(data)
    assert read["params"]["big"].shape == (10, 7)
    np.testing.assert_array_equal(read["params"]["big"],
                                  tree["params"]["big"])


def test_codec_refuses_what_flax_never_writes():
    with pytest.raises(ValueError):
        serialization.from_bytes(fser.to_bytes({"a": 1}) + b"\x00")
    with pytest.raises(TypeError):
        serialization.to_bytes({"a": object()})


# -- every porter: JAX checkpoint -> port -> JAX checkpoint ----------------

def _tame_stn(v):
    """A warp near the identity (the STN head's last layer scaled down)."""
    fc2 = v["params"]["stn_head"]["fc2"]
    fc2["kernel"] = (fc2["kernel"] * 1e-3).astype(np.float32)
    return v


def _sr_case(stn, tbsrn=True):
    if tbsrn:
        jm = JaxTBSRN(scale_factor=2, width=128, height=32, stn=stn,
                      srb_nums=1, hidden_units=32, wide_out_block=0)
        port = lambda: TBSRN(stn=stn, srb_nums=1)
        x = _uniform((B, 16, 64, 3), 1, 0.0)
    else:
        jm = JaxTSRN(scale_factor=2, width=32, height=16, stn=stn,
                     srb_nums=2, hidden_units=8)
        port = lambda: TSRN(scale_factor=2, width=32, height=16, stn=stn,
                            srb_nums=2, hidden_units=8)
        x = _uniform((B, 8, 16, 3), 1, 0.0)
    v = _variables(jm, x)
    if stn:
        v = _tame_stn(v)
    return _forwards(jm, v, port, x)


def _no_grad(m, *args, **kw):
    with torch.no_grad():
        return m.eval()(*args, **kw)


def _forwards(jm, v, port, x, t=None):
    """(variables, port module factory, JAX forward, port forward)."""
    args = (x,) if t is None else (x, t)
    return (v, port, lambda: jax.jit(jm.apply)(v, *map(jnp.asarray, args)),
            lambda m: _no_grad(m, torch.from_numpy(x), *(
                () if t is None else (torch.from_numpy(t).long(),))))


def _rec_case(jm, port, x, t=None):
    return _forwards(jm, _variables(jm, *((x,) if t is None else (x, t))),
                     port, x, t)


def _seg_case(det):
    x = np.random.default_rng(11).standard_normal((B, 64, 64, 3)).astype(
        np.float32)
    if det:
        gt = np.zeros((B, 64, 64), np.float32)
        gt[0, 8:30, 10:60] = gt[1, 16:48, 30:60] = 1
        jm = JaxDetSeg(backbone=JaxDetGuided(**SEG, instance_impl="device"),
                       decode_head=JaxSegformerHead(2, 32))
        port = lambda: DetGuidedEncoderDecoder(CascadeMiTDetGuided(**SEG),
                                               SegformerHead(HEAD_IN, 2, 32))
        v = _variables(jm, x, det_gt=jnp.asarray(gt))
        return (v, port,
                lambda: jax.jit(jm.apply)(v, jnp.asarray(x),
                                          det_gt=jnp.asarray(gt)),
                lambda m: _no_grad(m, torch.from_numpy(x),
                                   torch.from_numpy(gt)))
    jm = JaxSeg(backbone=JaxCascadeMiT(**SEG),
                decode_head=JaxSegformerHead(2, 32))
    port = lambda: EncoderDecoder(CascadeMiT(**SEG),
                                  SegformerHead(HEAD_IN, 2, 32))
    return _rec_case(jm, port, x)


def _clip_case():
    from fudanocr_tpu.models.rec import ccr_clip as jccr

    x, t = _uniform((B, 32, 32, 3), 1), clip_text()
    return _rec_case(jccr.CCRCLIP(**CLIP),
                     lambda: CCRCLIP(vision_layers=CLIP_VISION, **CLIP), x, t)


CASES = {
    "tbsrn": lambda: _sr_case(stn=False),
    "tbsrn_stn": lambda: _sr_case(stn=True),
    "tsrn": lambda: _sr_case(stn=False, tbsrn=False),
    "crnn": lambda: _rec_case(JaxCRNN(num_classes=37, hidden=32),
                              lambda: CRNN(37, 32),
                              _uniform((B, 32, 100, 1), 3, 0.0)),
    "ocr_transformer": lambda: _rec_case(
        jocr.OCRTransformer(**SLD), lambda: OCRTransformer(**SLD),
        _uniform((B, 32, 32, 3), 1), _tokens(SLD["vocab"])),
    "ccr_clip": _clip_case,
    "oictr": lambda: _rec_case(
        JaxOICTR(**OI), lambda: OICTR(image_size=(32, 64), **OI),
        _uniform((B, 32, 64, 3), 1), _tokens(OI["vocab"])),
    "acpm": lambda: _rec_case(JaxACPM(**ACPM_KW), lambda: ACPM(**ACPM_KW),
                              _uniform((B, 32, 32, 3), 1),
                              _tokens(ACPM_KW["vocab"])),
    "segmentor": lambda: _seg_case(det=False),
    "segmentor_det": lambda: _seg_case(det=True),
}


def _outputs(out):
    if isinstance(out, dict):
        return {k: out[k] for k in sorted(out)}
    if isinstance(out, (tuple, list)):
        return {str(i): o for i, o in enumerate(out)}
    return {"out": out}


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_checkpoint_round_trips_through_the_port(name, tmp_path,
                                                     monkeypatch):
    if name == "ccr_clip":      # JAX's image tower at CLIP_VISION blocks
        small_clip_vision(monkeypatch)
    v, port, jax_fwd, port_fwd = CASES[name]()
    src, dst = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(src, v, meta={"step": 3})
    raw = open(os.path.join(src, "state.msgpack"), "rb").read()
    assert serialization.to_bytes(serialization.from_bytes(raw)) == raw

    torch.manual_seed(7)                       # other values than v's
    m = port()
    m.load_state_dict(pckpt.load_model_state(src, module=m))
    pckpt.save_jax(dst, jax_variables(m), meta=pckpt.load_meta(src))
    _assert_bit_equal(jckpt.load(dst, v), v)
    assert jckpt.load_meta(dst) == {"step": 3}

    want, got = _outputs(jax_fwd()), _outputs(port_fwd(m))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=1e-3, atol=ATOL, err_msg=f"{name} {k}")


def test_a_tree_the_porter_does_not_make_is_refused(tmp_path):
    m = CRNN(37, 32)
    v = jax_variables(m)
    v["params"].popitem()
    jckpt.save(str(tmp_path), v)
    with pytest.raises(ValueError, match="missing"):
        pckpt.load_model_state(str(tmp_path), module=m)
    with pytest.raises(ValueError, match="needs the module"):
        pckpt.load_model_state(str(tmp_path))


# -- the loaders ------------------------------------------------------------

SMALL_ORACLE = dict(d_embed=32, d_model=64, d_ff=128, encoder_width_div=8)


def test_build_oracle_reads_a_jax_checkpoint(tmp_path, monkeypatch):
    from fudanocr_tpu_torch.apps import sr_common
    from fudanocr_tpu_torch.core.config import merge_cli_overrides
    from fudanocr_tpu_torch.models.rec import ocr_transformer

    monkeypatch.setattr(ocr_transformer, "OCRTransformer", functools.partial(
        OCRTransformer, **SMALL_ORACLE))
    jm = jocr.OCRTransformer(vocab=37, num_in=1, layers=(1, 2, 5, 3),
                             num_heads=16, **SMALL_ORACLE)
    x, t = _uniform((B, 32, 64, 1), 4), _tokens(37)
    v = _variables(jm, x, t)
    jckpt.save(str(tmp_path / "oracle"), v)
    cfg = merge_cli_overrides(sr_common.DEFAULTS, [
        f"TRAIN.VAL.oracle_checkpoint={tmp_path / 'oracle'}"])
    oracle = sr_common.build_oracle(cfg, 37, "cpu")
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(t))
    got = _no_grad(oracle, torch.from_numpy(x), torch.from_numpy(t).long())
    for k in ("pred", "map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=ATOL, err_msg=k)
    with pytest.raises(FileNotFoundError):
        sr_common.build_oracle(merge_cli_overrides(sr_common.DEFAULTS, [
            f"TRAIN.VAL.oracle_checkpoint={tmp_path / 'none'}"]), 37, "cpu")


SEG_CONFIG = "configs/seg/textformer_b0_textseg.yaml"
SEG_OVERRIDES = ["model.backbone.embed_dims=8",
                 "model.backbone.num_layers=[1, 1, 1, 1]",
                 "model.decode_head.channels=32", "data.batch_size=1",
                 "data.synthetic_samples=2", "data.crop_size=[64, 64]"]


def test_seg_loaders_read_a_jax_checkpoint(tmp_path):
    """`init_segmentor(checkpoint=)` and `apps.seg.test --checkpoint` on a
    directory JAX wrote give the weights and the metrics of the port's
    own checkpoint of the same weights."""
    from fudanocr_tpu_torch.apps.seg import inference as pinf
    from fudanocr_tpu_torch.apps.seg import test as papp

    model, _ = pinf.init_segmentor(SEG_CONFIG, device="cpu",
                                   overrides=SEG_OVERRIDES, seed=3)
    v = randomize(jax_variables(model), np.random.default_rng(5))
    jckpt.save(str(tmp_path / "jax"), v, meta={"step": 2})
    load_jax_variables(model, "segmentor", v, **SEG)
    pckpt.save(str(tmp_path / "port"), {"state_dict": model.state_dict()})
    loaded, _ = pinf.init_segmentor(SEG_CONFIG, device="cpu",
                                    overrides=SEG_OVERRIDES,
                                    checkpoint=str(tmp_path / "jax"))
    want = model.state_dict()
    assert all(torch.equal(t, want[k]) for k, t in
               loaded.state_dict().items())
    opts = ["--device", "cpu", "--options", *SEG_OVERRIDES]
    got = papp.main([SEG_CONFIG, "--checkpoint", str(tmp_path / "jax"),
                     *opts])
    assert got == papp.main([SEG_CONFIG, "--checkpoint",
                             str(tmp_path / "port"), *opts])


def test_stage2_gallery_reads_a_jax_stage1_checkpoint(tmp_path,
                                                      monkeypatch):
    from fudanocr_tpu.models.rec import ccr_clip as jccr
    from fudanocr_tpu_torch.apps.ccr_clip import train as stage2
    from fudanocr_tpu_torch.models.rec import ccr_clip

    small = dict(transformer_layers=1, vision_layers=CLIP_VISION)
    monkeypatch.setattr(ccr_clip, "CCRCLIP",
                        functools.partial(CCRCLIP, **small))
    small_clip_vision(monkeypatch)
    from fudanocr_tpu_torch.data.codecs import radical_codec

    cfg = stage2.merge_cli_overrides(stage2.DEFAULT_CONFIG, [
        f"radical_model={tmp_path / 'best'}"])
    codec = radical_codec(None, None)            # the synthetic system
    charset = sorted(codec.decomposition)
    jm = jccr.CCRCLIP(vocab_size=codec.num_classes,
                      context_length=stage2.GALLERY_CONTEXT,
                      transformer_layers=1)
    v = _variables(jm, np.zeros((1, 32, 32, 3), np.float32),
                   np.zeros((1, stage2.GALLERY_CONTEXT), np.int32))
    jckpt.save(str(tmp_path / "best"), v)
    got = stage2.build_gallery(cfg, charset, codec, "cpu")
    clip = load_jax_variables(
        CCRCLIP(vocab_size=codec.num_classes,
                context_length=stage2.GALLERY_CONTEXT, **small),
        "ccr_clip", v, layers=CLIP_VISION, transformer_layers=1)
    pckpt.save(str(tmp_path / "port"), {"state_dict": clip.state_dict()})
    want = stage2.build_gallery(stage2.merge_cli_overrides(
        stage2.DEFAULT_CONFIG, [f"radical_model={tmp_path / 'port'}"]),
        charset, codec, "cpu")
    assert got.shape == (len(charset) + 2, 2048)
    assert torch.equal(got, want)


def test_sr_trainer_resumes_from_a_jax_checkpoint(tmp_path):
    from fudanocr_tpu_torch.apps import sr_common
    from fudanocr_tpu_torch.losses.sr_losses import TextFocusLoss
    from fudanocr_tpu_torch.train.sr import SRTrainer

    x = _uniform((B, 16, 64, 3), 1, 0.0)
    v = _variables(JaxTBSRN(srb_nums=1, stn=True, wide_out_block=0), x)
    ckpt = tmp_path / "ckpt"
    jckpt.save(str(ckpt / "best"), v, meta={"step": 12})
    trainer = SRTrainer(TBSRN(srb_nums=1), TextFocusLoss(None,
                                                         text_focus=False),
                        None, None, ckpt_dir=str(ckpt))
    args = sr_common.build_argparser("t").parse_args(["--resume", "auto"])
    cfg = sr_common.merge_cli_overrides(sr_common.DEFAULTS,
                                        [f"TRAIN.ckpt_dir={ckpt}"])
    path = sr_common.resume_path(args, cfg)
    assert path == str(ckpt / "best")
    trainer.resume(path)
    assert trainer.step == 12
    want = load_jax_variables(TBSRN(srb_nums=1), "tbsrn", v,
                              srb_nums=1).state_dict()
    got = trainer.model.state_dict()
    assert all(torch.equal(got[k], t) for k, t in want.items())


# -- the converters ---------------------------------------------------------

def test_porter_cli_writes_the_jax_converters_bytes(tmp_path):
    torch.manual_seed(0)
    pth = str(tmp_path / "tbsrn.pth")
    torch.save({"state_dict_G": TBSRN().state_dict()}, pth)
    torch_port.main(["tbsrn", pth, str(tmp_path / "jax")])
    porters.main(["tbsrn", pth, str(tmp_path / "port")])
    for f in ("state.msgpack", "meta.json"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


def test_export_cli_writes_the_jax_exporters_state_dict(tmp_path):
    torch.manual_seed(1)
    template = CRNN(37, 256).state_dict()
    pth = str(tmp_path / "template.pth")
    torch.save(template, pth)
    v = randomize(jax_variables(CRNN(37, 256)), np.random.default_rng(2))
    jckpt.save(str(tmp_path / "ckpt"), v)
    torch_export.main(["crnn", str(tmp_path / "ckpt"), pth,
                       str(tmp_path / "jax.pth")])
    weights.main(["crnn", str(tmp_path / "ckpt"), pth,
                  str(tmp_path / "port.pth")])
    want = torch.load(str(tmp_path / "jax.pth"))
    got = torch.load(str(tmp_path / "port.pth"))
    assert list(got) == list(want)
    for k, t in want.items():
        g = got[k]
        if g.dim() == 0:
            # JAX's exporter writes a 0-d leaf the porter never reads
            # (BatchNorm num_batches_tracked) through np.ascontiguousarray,
            # which makes it (1,); the port keeps the template's shape
            assert g.shape == template[k].shape
            g = g.reshape(t.shape)
        assert g.dtype == t.dtype and torch.equal(g, t), k
    CRNN(37, 256).load_state_dict(got)
