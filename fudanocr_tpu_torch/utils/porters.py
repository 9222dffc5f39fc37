"""Porters: original FudanOCR state_dicts -> JAX-layout variable trees.

The port's own copy of the porters in fudanocr_tpu/utils/torch_port.py
(lines 21-450, 453-608) for the models the port has: TBSRN, TSRN, CRNN,
the OCRTransformer (every encoder preset), CCR-CLIP, OI-CTR, ACPM (with
its STN and the port's VGG and DenseNet encoders, which JAX's porter
leaves out), CascadeMiT,
the det-guided CascadeMiT (V10) and the SegFormer head, plus
`port_segmentor` / `port_segmentor_det` / `port_cascade_segmentor` for a
whole EncoderDecoder / DetGuidedEncoderDecoder / CascadeEncoderDecoder;
and, with no JAX counterpart (the JAX package ports no torch weights into
them), porters from mmseg's key layout into the JAX necks (`port_fpn`,
`port_multilevel_neck`, `port_jpu`, `port_mla_neck`, `port_ic_neck`) and
`Encoding` (`port_encoding`), CCR-CLIP's ViT tower (`port_clip_vit`) and
OI-CTR's reconstructor (in `port_oictr`, under the port's own key
names). Each maps a torch state_dict
(reference key layout, which every port module carries) onto the JAX
package's {"params": ..., "batch_stats": ...} tree: conv OIHW -> HWIO,
linear W -> W^T, LSTM gate blocks transposed, BatchNorm running stats into
batch_stats. Every porter only moves elements (transposes, slices,
concatenations), so `utils/weights.py` inverts them mechanically.

numpy only; the tests hold these trees equal, bit for bit, to the JAX
package's porters on the same state_dict.

As a command (the counterpart of the JAX package's
utils/torch_port.py:624-649), a reference `.pth` to a checkpoint
directory in the JAX package's format (`state.msgpack`, `meta.json`),
with the porter's default arguments:

    python -m fudanocr_tpu_torch.utils.porters <model> <pth> <out_dir>

An SR checkpoint's `state_dict_G` is read from under that key.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np

def _np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop DataParallel's 'module.' prefix (interfaces/base.py:183-187)."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def conv(sd, name):
    out = {"kernel": _np(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def linear(sd, name):
    out = {"kernel": _np(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def bn(sd, name) -> Tuple[Dict, Dict]:
    params = {"scale": _np(sd[f"{name}.weight"]),
              "bias": _np(sd[f"{name}.bias"])}
    stats = {"mean": _np(sd[f"{name}.running_mean"]),
             "var": _np(sd[f"{name}.running_var"])}
    return params, stats


def torch_layernorm(sd, name):
    # the reference LayerNorm params are (a_2, b_2) in the SR projects and
    # (a, b) in stroke-level-decomposition (transformer.py:247-248)
    if f"{name}.a_2" in sd:
        return {"scale": _np(sd[f"{name}.a_2"]),
                "bias": _np(sd[f"{name}.b_2"])}
    return {"scale": _np(sd[f"{name}.a"]), "bias": _np(sd[f"{name}.b"])}


def embedding(sd, name):
    return {"embedding": _np(sd[f"{name}.weight"])}


def birnn(sd, name):
    """torch bidirectional GRU/LSTM -> our BiGRU/BiLSTM param dict."""
    out = {}
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        out[f"wi_{direction}"] = _np(sd[f"{name}.weight_ih_l0{suffix}"]).T
        out[f"wh_{direction}"] = _np(sd[f"{name}.weight_hh_l0{suffix}"]).T
        out[f"bi_{direction}"] = _np(sd[f"{name}.bias_ih_l0{suffix}"])
        out[f"bh_{direction}"] = _np(sd[f"{name}.bias_hh_l0{suffix}"])
    return out


def _mha(sd, prefix, kind: str = "self"):
    """reference MultiHeadedAttention.linears[0..3] -> our fused layout:
    self-attention gets one (D, 3D) 'qkv'; cross-attention keeps 'q' and a
    fused (D, 2D) 'kv' (see nn/attention.py)."""
    lq = linear(sd, f"{prefix}.linears.0")
    lk = linear(sd, f"{prefix}.linears.1")
    lv = linear(sd, f"{prefix}.linears.2")
    out = {"out": linear(sd, f"{prefix}.linears.3")}
    if kind == "self":
        out["qkv"] = {
            "kernel": np.concatenate([lq["kernel"], lk["kernel"],
                                      lv["kernel"]], axis=1),
            "bias": np.concatenate([lq["bias"], lk["bias"], lv["bias"]])}
    else:
        out["q"] = lq
        out["kv"] = {
            "kernel": np.concatenate([lk["kernel"], lv["kernel"]], axis=1),
            "bias": np.concatenate([lk["bias"], lv["bias"]])}
    return out


def _stn_head(sd, prefix="stn_head"):
    """stn_head.py:25-53 -> our STNHead tree."""
    params, stats = {}, {}
    # stn_convnet indices of the conv blocks: 0,2,4,6,8,10 (pools between)
    for i, seq in enumerate((0, 2, 4, 6, 8, 10)):
        cname = f"{prefix}.stn_convnet.{seq}"
        p, s = bn(sd, f"{cname}.1")
        params[f"conv{i}"] = {"Conv_0": conv(sd, f"{cname}.0"),
                              "BatchNorm_0": p}
        stats[f"conv{i}"] = {"BatchNorm_0": s}
    params["fc1"] = linear(sd, f"{prefix}.stn_fc1.0")
    p, s = bn(sd, f"{prefix}.stn_fc1.1")
    params["fc1_bn"] = p
    stats["fc1_bn"] = s
    params["fc2"] = linear(sd, f"{prefix}.stn_fc2")
    return params, stats


def _feature_enhancer(sd, prefix):
    return {
        "mha": _mha(sd, f"{prefix}.multihead"),
        "ln1": torch_layernorm(sd, f"{prefix}.mul_layernorm1"),
        "pff_w1": linear(sd, f"{prefix}.pff.w_1"),
        "pff_w2": linear(sd, f"{prefix}.pff.w_2"),
        "ln2": torch_layernorm(sd, f"{prefix}.mul_layernorm3"),
        "proj": linear(sd, f"{prefix}.linear"),
    }


def _port_sr(sd: Dict, srb_nums: int, scale_factor: int, stn: bool,
             block_extra) -> Dict:
    """The trunk TBSRN and TSRN share; `block_extra(sd, prefix)` gives the
    residual block's entries beside conv1/bn1/conv2/bn2."""
    sd = strip_module_prefix(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    params["stem_conv"] = conv(sd, "block1.0")
    params["stem_prelu"] = {"alpha": _np(sd["block1.1.weight"]).reshape(1)}

    for i in range(srb_nums):
        b = f"block{i + 2}"
        p, s = bn(sd, f"{b}.bn1")
        p2, s2 = bn(sd, f"{b}.bn2")
        params[f"srb{i}"] = {
            "conv1": conv(sd, f"{b}.conv1"), "bn1": p,
            "conv2": conv(sd, f"{b}.conv2"), "bn2": p2,
            **block_extra(sd, b),
        }
        stats[f"srb{i}"] = {"bn1": s, "bn2": s2}

    tail = f"block{srb_nums + 2}"
    p, s = bn(sd, f"{tail}.1")
    params["trunk_tail"] = {"conv": conv(sd, f"{tail}.0"), "bn": p}
    stats["trunk_tail"] = {"bn": s}

    n_up = int(math.log2(scale_factor))
    last = f"block{srb_nums + 3}"
    for u in range(n_up):
        params[f"up{u}"] = {"conv": conv(sd, f"{last}.{u}.conv")}
    params["out_conv"] = conv(sd, f"{last}.{n_up}")

    if stn and "stn_head.stn_fc2.weight" in sd:
        p, s = _stn_head(sd)
        params["stn_head"] = p
        stats["stn_head"] = s
    return {"params": params, "batch_stats": stats}


def port_tbsrn(sd: Dict, srb_nums: int = 5, scale_factor: int = 2,
               stn: bool = True) -> Dict:
    """scene-text-telescope/model/tbsrn.py:166-226 -> TBSRN variables."""
    return _port_sr(sd, srb_nums, scale_factor, stn, lambda sd, b: {
        "enhancer": _feature_enhancer(sd, f"{b}.feature_enhancer")})


def port_tsrn(sd: Dict, srb_nums: int = 5, scale_factor: int = 2,
              stn: bool = False) -> Dict:
    """tsrn.py:18-98 -> TSRN variables (GRU blocks instead of enhancer;
    fudanocr_tpu/utils/torch_port.py:167)."""
    return _port_sr(sd, srb_nums, scale_factor, stn, lambda sd, b: {
        f"gru{g}": {"conv1": conv(sd, f"{b}.gru{g}.conv1"),
                    "gru": birnn(sd, f"{b}.gru{g}.gru")} for g in (1, 2)})


def port_crnn(sd: Dict) -> Dict:
    """model/crnn/crnn.py:25-80 -> CRNN variables."""
    sd = strip_module_prefix(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(7):
        params[f"conv{i}"] = conv(sd, f"cnn.conv{i}")
        if f"cnn.batchnorm{i}.weight" in sd:
            p, s = bn(sd, f"cnn.batchnorm{i}")
            params[f"bn{i}"] = p
            stats[f"bn{i}"] = s
    params["rnn0"] = birnn(sd, "rnn.0.rnn")
    params["fc0"] = linear(sd, "rnn.0.embedding")
    params["rnn1"] = birnn(sd, "rnn.1.rnn")
    params["fc1"] = linear(sd, "rnn.1.embedding")
    return {"params": params, "batch_stats": stats}


def _ocr_resnet(sd: Dict, prefix: str, layers,
                stage_feats=(256, 256, 512, 512),
                stage_convs=(True, True, True, False),
                head_conv: bool = True) -> Tuple[Dict, Dict]:
    """The CTR ResNet family -> OCRResNet tree (both the narrow 4-stage
    and the wide 3-stage variants; see OCRResNet docstring)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def grab_bn(tname, oname):
        p, s = bn(sd, tname)
        params[oname] = p
        stats[oname] = s

    params["stem1_conv"] = conv(sd, f"{prefix}conv1")
    grab_bn(f"{prefix}bn1", "stem1_bn")
    params["stem2_conv"] = conv(sd, f"{prefix}conv2")
    grab_bn(f"{prefix}bn2", "stem2_bn")

    in_feats = 128
    for s_i, n_blocks in enumerate(layers):
        tl = f"{prefix}layer{s_i + 1}"
        for b_i in range(n_blocks):
            blk: Dict[str, Any] = {"conv1": conv(sd, f"{tl}.{b_i}.conv1"),
                                   "conv2": conv(sd, f"{tl}.{b_i}.conv2")}
            bs: Dict[str, Any] = {}
            for which in ("bn1", "bn2"):
                p, st = bn(sd, f"{tl}.{b_i}.{which}")
                blk[which] = p
                bs[which] = st
            if b_i == 0 and in_feats != stage_feats[s_i]:
                blk["down_conv"] = conv(sd, f"{tl}.{b_i}.downsample.0")
                p, st = bn(sd, f"{tl}.{b_i}.downsample.1")
                blk["down_bn"] = p
                bs["down_bn"] = st
            params[f"stage{s_i}_block{b_i}"] = blk
            stats[f"stage{s_i}_block{b_i}"] = bs
        in_feats = stage_feats[s_i]
        if stage_convs[s_i]:
            params[f"stage{s_i}_conv"] = conv(sd, f"{tl}_conv")
            grab_bn(f"{tl}_bn", f"stage{s_i}_bn")
    if head_conv:
        params["head_conv"] = conv(sd, f"{prefix}layer4_conv2")
        grab_bn(f"{prefix}layer4_conv2_bn", "head_bn")
    return params, stats


# the wide 3-stage encoder of OI-CTR and image-ids-CTR
_WIDE_RESNET = dict(layers=(3, 4, 6), stage_feats=(256, 512, 1024),
                    stage_convs=(True, True, True), head_conv=False)
_PRESET_RESNETS = {"oracle": dict(layers=(1, 2, 5, 3)),
                   "sld": dict(layers=(3, 4, 6, 3)),
                   "oictr": _WIDE_RESNET, "image_ids": _WIDE_RESNET}


def _decoder(sd) -> Dict:
    return {
        "self_attn": _mha(sd, "decoder.mask_multihead", "self"),
        "ln1": torch_layernorm(sd, "decoder.mul_layernorm1"),
        "cross_attn": _mha(sd, "decoder.multihead", "cross"),
        "ln2": torch_layernorm(sd, "decoder.mul_layernorm2"),
        "pff_w1": linear(sd, "decoder.pff.w_1"),
        "pff_w2": linear(sd, "decoder.pff.w_2"),
        "ln3": torch_layernorm(sd, "decoder.mul_layernorm3"),
    }


def port_ocr_transformer(sd: Dict, layers=(3, 4, 6, 3),
                         encoder_prefix: str = "encoder.",
                         encoder_preset=None) -> Dict:
    """Shared CTR / loss-oracle transformer -> OCRTransformer variables.

    Handles both the SR loss oracle (encoder.cnn. prefix, layers [1,2,5,3])
    and the CTR projects (encoder. prefix, layers [3,4,6,3]);
    `encoder_preset` (a key of OCR_RESNET_PRESETS, e.g. "image_ids" for
    CCR-CLIP stage 2) replaces `layers`. The generator is whatever width
    the state_dict holds (vocab logits or `out_dim` embeddings)."""
    sd = strip_module_prefix(sd)
    if any(k.startswith("encoder.cnn.") for k in sd):
        encoder_prefix = "encoder.cnn."
    kw = (dict(_PRESET_RESNETS[encoder_preset]) if encoder_preset
          else dict(layers=layers))
    enc_params, enc_stats = _ocr_resnet(sd, encoder_prefix, **kw)
    params = {
        "encoder": enc_params,
        "embed": embedding(sd, "embedding_word.lut"),
        "decoder": _decoder(sd),
        "generator": linear(sd, "generator_word.proj"),
    }
    return {"params": params, "batch_stats": {"encoder": enc_stats}}


def _clip_bottleneck(sd, prefix, downsample: bool):
    blk: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in (1, 2, 3):
        blk[f"conv{i}"] = conv(sd, f"{prefix}.conv{i}")
        p, s = bn(sd, f"{prefix}.bn{i}")
        blk[f"bn{i}"] = p
        stats[f"bn{i}"] = s
    if downsample:
        blk["down_conv"] = conv(sd, f"{prefix}.downsample.0")
        p, s = bn(sd, f"{prefix}.downsample.1")
        blk["down_bn"] = p
        stats["down_bn"] = s
    return blk, stats


def _clip_block(sd, t):
    """transformer.resblocks.{i} -> ResidualAttentionBlock: torch
    nn.MultiheadAttention's fused in_proj is the `attn_in` Dense."""
    return {
        "ln_1": _ln_std(sd, f"{t}.ln_1"),
        "attn_in": {"kernel": _np(sd[f"{t}.attn.in_proj_weight"]).T,
                    "bias": _np(sd[f"{t}.attn.in_proj_bias"])},
        "attn_out": linear(sd, f"{t}.attn.out_proj"),
        "ln_2": _ln_std(sd, f"{t}.ln_2"),
        "mlp_fc": linear(sd, f"{t}.mlp.c_fc"),
        "mlp_proj": linear(sd, f"{t}.mlp.c_proj"),
    }


def port_ccr_clip(sd: Dict, layers=(3, 4, 6, 3),
                  transformer_layers: int = 12) -> Dict:
    """image-ids-CTR/CCR-CLIP model.py:135-221 + resnet50.py -> CCRCLIP
    (the JAX package's torch_port.py:297-360)."""
    sd = strip_module_prefix(sd)
    vis: Dict[str, Any] = {"stem_conv": conv(sd, "visual.conv1")}
    vstats: Dict[str, Any] = {}
    vis["stem_bn"], vstats["stem_bn"] = bn(sd, "visual.bn1")
    in_ch = 64
    for li, (n, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
        for b_i in range(n):
            stride = 2 if (b_i == 0 and li > 0) else 1
            down = b_i == 0 and (stride != 1 or in_ch != planes * 4)
            name = f"layer{li + 1}_{b_i}"
            vis[name], vstats[name] = _clip_bottleneck(
                sd, f"visual.layer{li + 1}.{b_i}", down)
            in_ch = planes * 4
    params: Dict[str, Any] = {
        "visual": vis,
        "token_embedding": embedding(sd, "token_embedding"),
        "positional_embedding": _np(sd["positional_embedding"]),
        "ln_final": _ln_std(sd, "ln_final"),
        "text_projection": _np(sd["text_projection"]),
        "logit_scale": _np(sd["logit_scale"]),
    }
    for i in range(transformer_layers):
        params[f"block{i}"] = _clip_block(sd, f"transformer.resblocks.{i}")
    return {"params": params, "batch_stats": {"visual": vstats}}


def port_clip_vit(sd: Dict, layers: int = 6) -> Dict:
    """CCR-CLIP/model.py:99-132 VisionTransformer -> the JAX
    VisionTransformer (no JAX counterpart: the JAX package ports no
    weights into it)."""
    sd = strip_module_prefix(sd)
    params: Dict[str, Any] = {
        "conv1": conv(sd, "conv1"),
        "class_embedding": _np(sd["class_embedding"]),
        "positional_embedding": _np(sd["positional_embedding"]),
        "ln_pre": _ln_std(sd, "ln_pre"),
        "ln_post": _ln_std(sd, "ln_post"),
        "proj": _np(sd["proj"]),
    }
    for i in range(layers):
        params[f"block{i}"] = _clip_block(sd, f"transformer.resblocks.{i}")
    return {"params": params}


def _deconv(sd, name):
    """torch ConvTranspose2d (in, out, kh, kw) -> flax ConvTranspose
    (kh, kw, in, out) without kernel flip: the taps reversed."""
    out = {"kernel": _np(sd[f"{name}.weight"])[:, :, ::-1, ::-1]
           .transpose(2, 3, 0, 1)}
    out["bias"] = _np(sd[f"{name}.bias"])
    return out


def port_oictr(sd: Dict) -> Dict:
    """orientation-independent-CTR/model/transformer.py:399-424 -> OICTR
    (the JAX package's torch_port.py:362-394), and the port's own
    `reconstructor.deconv{1..5}` keys into JAX's redesigned reconstructor
    (which the JAX porter leaves out: the reference's differs)."""
    sd = strip_module_prefix(sd)
    layers = tuple(_count(sd, f"encoder.layer{s}.{{}}.conv1.weight")
                   for s in (1, 2, 3))
    enc_params, enc_stats = _ocr_resnet(sd, "encoder.", layers,
                                        **{k: v for k, v in
                                           _WIDE_RESNET.items()
                                           if k != "layers"})
    recon = {f"deconv{i}": _deconv(sd, f"reconstructor.deconv{i}")
             for i in range(1, 5)}
    recon["deconv5"] = conv(sd, "reconstructor.deconv5")
    params = {
        "encoder": enc_params,
        "content_extractor": conv(sd, "content_extractor"),
        "dir_conv": conv(sd, "direction_extractor.conv1"),
        "dir_linear": linear(sd, "direction_extractor.linear"),
        "direction_cls": linear(sd, "direction_cls"),
        "embed": embedding(sd, "embedding_word.lut"),
        "decoder": _decoder(sd),
        "generator": linear(sd, "generator_word.proj"),
        # features_compress: torch conv over the token axis (4, T, 1, 1)
        # -> a Dense over that axis (T, 4)
        "features_compress": {
            "kernel": _np(sd["features_compress.weight"])[:, :, 0, 0].T,
            "bias": _np(sd["features_compress.bias"])},
        "reconstructor": recon,
    }
    return {"params": params, "batch_stats": {"encoder": enc_stats}}


def _conv_bn_relu_seq(sd, prefix, idx):
    """ACPM's conv{i}+bn{i}+relu triplets -> our ConvBNReLU tree."""
    p, s = bn(sd, f"{prefix}.bn{idx}")
    return ({"Conv_0": conv(sd, f"{prefix}.conv{idx}"), "BatchNorm_0": p},
            {"BatchNorm_0": s})


def _vgg_encoder(sd, prefix) -> Tuple[Dict, Dict]:
    """The port's VGGEncoder (`block{i}` ConvBNReLU, keys 0 and 1) -> the
    JAX VGGEncoder (no reference layout: the names mirror JAX's)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(_count(sd, prefix + "block{}.0.weight")):
        p, st = bn(sd, f"{prefix}block{i}.1")
        params[f"block{i}"] = {"Conv_0": conv(sd, f"{prefix}block{i}.0"),
                               "BatchNorm_0": p}
        stats[f"block{i}"] = {"BatchNorm_0": st}
    return params, stats


def _densenet_encoder(sd, prefix) -> Tuple[Dict, Dict]:
    """The port's DenseNetEncoder -> the JAX DenseNetEncoder (the same
    names: stem, stem_bn, b{b}l{i}_conv1/bn1/conv2/bn2, trans{b}, head,
    head_bn)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    convs = [n for n in ("stem", "head") if f"{prefix}{n}.weight" in sd]
    bns = [n + "_bn" for n in convs]
    b = 0
    while f"{prefix}b{b}l0_conv1.weight" in sd:
        for i in range(_count(sd, f"{prefix}b{b}l{{}}_conv1.weight")):
            convs += [f"b{b}l{i}_conv1", f"b{b}l{i}_conv2"]
            bns += [f"b{b}l{i}_bn1", f"b{b}l{i}_bn2"]
        if f"{prefix}trans{b}.weight" in sd:
            convs.append(f"trans{b}")
        b += 1
    for n in convs:
        params[n] = conv(sd, prefix + n)
    for n in bns:
        params[n], stats[n] = bn(sd, prefix + n)
    return params, stats


def port_acpm(sd: Dict) -> Dict:
    """character-profile-matching/model/transformer.py:478-567 -> ACPM
    (the JAX package's torch_port.py:403-450: the ResNet encoder, the
    radical decoder and the counting heads), extended to the STN head
    (`stn_head.*`) and to the port's VGG and DenseNet encoders, told apart
    by their keys. The ResNet's blocks per stage are counted."""
    sd = strip_module_prefix(sd)
    if "encoder.block0.0.weight" in sd:
        enc_params, enc_stats = _vgg_encoder(sd, "encoder.")
    elif "encoder.stem.weight" in sd:
        enc_params, enc_stats = _densenet_encoder(sd, "encoder.")
    else:
        # ACPM's ResNet = SLD's (narrow stages, stem pool only in forward)
        layers = tuple(_count(sd, f"encoder.layer{s}.{{}}.conv1.weight")
                       for s in (1, 2, 3, 4))
        enc_params, enc_stats = _ocr_resnet(sd, "encoder.", layers)
    params: Dict[str, Any] = {"encoder": enc_params}
    stats: Dict[str, Any] = {"encoder": enc_stats}
    if "stn_head.stn_fc2.weight" in sd:
        params["stn_head"], stats["stn_head"] = _stn_head(sd)

    params["embed"] = embedding(sd, "embedding_word.lut")
    params["decoder"] = _decoder(sd)
    params["generator"] = linear(sd, "generator_word.proj")

    # radical counter: RSC_R conv1..3 + linear
    rsc_r: Dict[str, Any] = {}
    rsc_r_stats: Dict[str, Any] = {}
    for i in range(3):
        rsc_r[f"conv{i}"], rsc_r_stats[f"conv{i}"] = _conv_bn_relu_seq(
            sd, "RSC_R", i + 1)
    rsc_r["linear"] = linear(sd, "RSC_R.linear")
    params["rsc_r"] = rsc_r
    stats["rsc_r"] = rsc_r_stats

    # stroke counter: shared CNN + N head (linear) + L head (2 convs+linear)
    rsc_s: Dict[str, Any] = {}
    rsc_s_stats: Dict[str, Any] = {}
    for i in range(3):
        rsc_s[f"shared{i}"], rsc_s_stats[f"shared{i}"] = _conv_bn_relu_seq(
            sd, "RSC_S.shared_CNN", i + 1)
    rsc_s["count_n"] = linear(sd, "RSC_S.count_n.linear")
    for i in range(2):
        rsc_s[f"l_conv{i}"], rsc_s_stats[f"l_conv{i}"] = _conv_bn_relu_seq(
            sd, "RSC_S.count_l", i + 1)
    rsc_s["count_l"] = linear(sd, "RSC_S.count_l.linear")
    params["rsc_s"] = rsc_s
    stats["rsc_s"] = rsc_s_stats
    return {"params": params, "batch_stats": stats}


def _ln_std(sd, name):
    """Standard torch nn.LayerNorm (weight, bias) -> flax LayerNorm."""
    return {"scale": _np(sd[f"{name}.weight"]),
            "bias": _np(sd[f"{name}.bias"])}


def _seg_resnet_block(sd, prefix, has_short):
    """cascade_mit.py:306-325 ResNetBlock -> our seg ResNetBlock tree."""
    params = {"conv1": conv(sd, f"{prefix}.conv1"),
              "conv2": conv(sd, f"{prefix}.conv2")}
    stats = {}
    for which in ("bn1", "bn2"):
        p, s = bn(sd, f"{prefix}.{which}")
        params[which] = p
        stats[which] = s
    if has_short:
        params["short_conv"] = conv(sd, f"{prefix}.shortcut.0")
        p, s = bn(sd, f"{prefix}.shortcut.1")
        params["short_bn"] = p
        stats["short_bn"] = s
    return params, stats


def _seg_encoder_layer(sd, prefix, sr_ratio):
    """SegFormer TransformerEncoderLayer (cascade_mit.py:217-298) -> ours.

    torch nn.MultiheadAttention's fused in_proj splits into our separate
    q/k/v Dense kernels."""
    in_w = _np(sd[f"{prefix}.attn.attn.in_proj_weight"])
    in_b = _np(sd[f"{prefix}.attn.attn.in_proj_bias"])
    d = in_w.shape[1]
    attn = {
        "q": {"kernel": in_w[:d].T, "bias": in_b[:d]},
        "k": {"kernel": in_w[d:2 * d].T, "bias": in_b[d:2 * d]},
        "v": {"kernel": in_w[2 * d:].T, "bias": in_b[2 * d:]},
        "proj": linear(sd, f"{prefix}.attn.attn.out_proj"),
    }
    if sr_ratio > 1:
        attn["sr"] = conv(sd, f"{prefix}.attn.sr")
        attn["sr_norm"] = _ln_std(sd, f"{prefix}.attn.norm")
    params = {
        "norm1": _ln_std(sd, f"{prefix}.norm1"),
        "attn": attn,
        "norm2": _ln_std(sd, f"{prefix}.norm2"),
        "ffn": {"fc1": conv(sd, f"{prefix}.ffn.layers.0"),
                "pe_conv": conv(sd, f"{prefix}.ffn.layers.1"),
                "fc2": conv(sd, f"{prefix}.ffn.layers.4")},
    }
    return params


def _seg_stage(sd, i, num_layers, sr_ratio):
    """One cascade level: layers.{i}.[0 patch_embed, 1 blocks, 2 norm]."""
    params = {
        "patch_embed": conv(sd, f"layers.{i}.0.projection"),
        "patch_norm": _ln_std(sd, f"layers.{i}.0.norm"),
        "norm": _ln_std(sd, f"layers.{i}.2"),
    }
    for j in range(num_layers):
        params[f"layer{j}"] = _seg_encoder_layer(sd, f"layers.{i}.1.{j}",
                                                 sr_ratio)
    return params


def _seg_stem_and_pyramid(sd):
    """conv1/bn1 stem + layer1..3 ResNet pairs (cascade_mit.py:454-472)."""
    params: Dict[str, Any] = {"stem_conv": conv(sd, "conv1")}
    stats: Dict[str, Any] = {}
    p, s = bn(sd, "bn1")
    params["stem_bn"] = p
    stats["stem_bn"] = s
    for li in range(3):
        for bi in range(2):
            # block 0 strides 2 -> always has a conv shortcut
            bp, bs = _seg_resnet_block(sd, f"layer{li+1}.{bi}", bi == 0)
            params[f"layer{li+1}_{bi}"] = bp
            stats[f"layer{li+1}_{bi}"] = bs
    return params, stats


def port_cascade_mit(sd: Dict, embed_dims: int = 32,
                     num_layers=(2, 2, 2, 2), num_heads=(1, 2, 5, 8),
                     sr_ratios=(8, 4, 2, 1)) -> Dict:
    """text-focused-Transformers/mmseg/models/backbones/cascade_mit.py:
    329-524 CascadeMixVisionTransformer -> CascadeMiT variables.

    conv2..conv5 are the top-down fusion 1x1 convs for levels 4..1 —
    they map onto our fuse4..fuse1."""
    sd = strip_module_prefix(sd)
    params, stats = _seg_stem_and_pyramid(sd)
    for i in range(4):
        params[f"stage{i}"] = _seg_stage(sd, i, num_layers[i], sr_ratios[i])
    for i in range(4):
        params[f"fuse{4 - i}"] = conv(sd, f"conv{2 + i}")
    return {"params": params, "batch_stats": stats}


def _conv_bn_seq(sd, prefix):
    """Sequential(Conv2d, BatchNorm2d) -> the JAX _DetConvBN {conv, bn}."""
    p, s = bn(sd, f"{prefix}.1")
    return {"conv": conv(sd, f"{prefix}.0"), "bn": p}, {"bn": s}


def port_cascade_mit_v10(sd: Dict, embed_dims: int = 32,
                         num_layers=(2, 2, 2, 2), num_heads=(1, 2, 5, 8),
                         sr_ratios=(8, 4, 2, 1)) -> Dict:
    """cascade_mit.py:4581-5131 CascadeMixVisionTransformer_V10 ->
    CascadeMiTDetGuided variables (det head + dual masked SA + gates +
    BN'd fusion convs)."""
    sd = strip_module_prefix(sd)
    params, stats = _seg_stem_and_pyramid(sd)
    for i in range(4):
        params[f"stage{i}"] = _seg_stage(sd, i, num_layers[i], sr_ratios[i])
    for i in range(4):  # conv2..5 here are Sequential(conv, bn)
        p, s = _conv_bn_seq(sd, f"conv{2 + i}")
        params[f"fuse{4 - i}"] = p
        stats[f"fuse{4 - i}"] = s
    for i in range(4):
        p, s = _conv_bn_seq(sd, f"out_det_{i + 1}")
        params[f"out_det_{i + 1}"] = p
        stats[f"out_det_{i + 1}"] = s
    p, s = _conv_bn_seq(sd, "fusion_conv")
    params["fusion_conv"] = p
    stats["fusion_conv"] = s
    params["det_cls"] = conv(sd, "det_cls.0")
    for i in range(4):
        for ref_kind, our_kind in (("text", "text"), ("instance", "inst")):
            params[f"{our_kind}_sa_{i + 1}"] = _seg_encoder_layer(
                sd, f"{ref_kind}_sa_{i + 1}", sr_ratios[i])
            p, s = bn(sd, f"{ref_kind}_sa_bn_{i + 1}")
            params[f"{our_kind}_sa_bn_{i + 1}"] = p
            stats[f"{our_kind}_sa_bn_{i + 1}"] = s
        p, s = _conv_bn_seq(sd, f"fuse_text_instance_{i + 1}")
        params[f"fuse_text_instance_{i + 1}"] = p
        stats[f"fuse_text_instance_{i + 1}"] = s
    return {"params": params, "batch_stats": stats}


def port_segformer_head(sd: Dict, num_scales: int = 4) -> Dict:
    """mmseg/models/decode_heads/segformer_head.py:92-147 (+ decode_head
    cls_seg/conv_seg) -> SegformerHead variables."""
    sd = strip_module_prefix(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(num_scales):
        params[f"conv{i}"] = conv(sd, f"convs.{i}.conv")
        p, s = bn(sd, f"convs.{i}.bn")
        params[f"bn{i}"] = p
        stats[f"bn{i}"] = s
    params["fusion"] = conv(sd, "fusion_conv.conv")
    p, s = bn(sd, "fusion_conv.bn")
    params["fusion_bn"] = p
    stats["fusion_bn"] = s
    params["cls_seg"] = conv(sd, "conv_seg")
    return {"params": params, "batch_stats": stats}



def _under(sd: Dict, prefix: str) -> Dict:
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def port_segmentor(sd: Dict, embed_dims: int = 32, num_layers=(2, 2, 2, 2),
                   num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1),
                   backbone=port_cascade_mit) -> Dict:
    """EncoderDecoder(CascadeMiT, SegformerHead): the `backbone.` keys
    through `backbone` (`port_cascade_mit`), the `decode_head.` keys
    through `port_segformer_head`, into the JAX EncoderDecoder's tree (its
    submodules are named `backbone` and `decode_head`)."""
    sd = strip_module_prefix(sd)
    bb = backbone(_under(sd, "backbone."), embed_dims, num_layers,
                  num_heads, sr_ratios)
    head = port_segformer_head(_under(sd, "decode_head."))
    return {kind: {"backbone": bb[kind], "decode_head": head[kind]}
            for kind in ("params", "batch_stats")}


def port_segmentor_det(sd: Dict, embed_dims: int = 32,
                       num_layers=(2, 2, 2, 2), num_heads=(1, 2, 5, 8),
                       sr_ratios=(8, 4, 2, 1)) -> Dict:
    """DetGuidedEncoderDecoder(CascadeMiTDetGuided, SegformerHead): as
    `port_segmentor`, the backbone through `port_cascade_mit_v10`."""
    return port_segmentor(sd, embed_dims, num_layers, num_heads, sr_ratios,
                          backbone=port_cascade_mit_v10)


def port_cascade_segmentor(sd: Dict, embed_dims: int = 32,
                          num_layers=(2, 2, 2, 2), num_heads=(1, 2, 5, 8),
                          sr_ratios=(8, 4, 2, 1)) -> Dict:
    """CascadeEncoderDecoder(CascadeMiT, [SegformerHead, ...]): the
    `decode_head.{k}.` keys into the JAX module's `decode_heads_{k}`."""
    sd = strip_module_prefix(sd)
    bb = port_cascade_mit(_under(sd, "backbone."), embed_dims, num_layers,
                          num_heads, sr_ratios)
    out = {kind: {"backbone": bb[kind]} for kind in ("params",
                                                     "batch_stats")}
    for k in range(_count(sd, "decode_head.{}.conv_seg.weight")):
        head = port_segformer_head(_under(sd, f"decode_head.{k}."))
        for kind in out:
            out[kind][f"decode_heads_{k}"] = head[kind]
    return out


def _count(sd: Dict, pattern: str) -> int:
    """How many consecutive i from 0 have `pattern.format(i)` in sd."""
    n = 0
    while pattern.format(n) in sd:
        n += 1
    return n


def _conv_module(sd, prefix) -> Tuple[Dict, Dict]:
    """mmcv ConvModule(conv, bn) -> the JAX necks' `_ConvBNReLU`."""
    p, s = bn(sd, f"{prefix}.bn")
    return {"conv": conv(sd, f"{prefix}.conv"), "bn": p}, {"bn": s}


def _neck_convs(sd: Dict, pairs) -> Dict:
    """{JAX name pattern: mmseg prefix pattern} of bare biased convs, over
    every level present."""
    params: Dict[str, Any] = {}
    for ours, theirs in pairs:
        for i in range(_count(sd, theirs + ".conv.weight")):
            params[ours.format(i)] = conv(sd, theirs.format(i) + ".conv")
    return {"params": params}


def port_fpn(sd: Dict) -> Dict:
    """mmseg necks/fpn.py FPN -> the JAX FPN (lateral{i}, fpn_conv{i})."""
    return _neck_convs(strip_module_prefix(sd),
                       (("lateral{}", "lateral_convs.{}"),
                        ("fpn_conv{}", "fpn_convs.{}")))


def port_multilevel_neck(sd: Dict) -> Dict:
    """mmseg necks/multilevel_neck.py -> the JAX MultiLevelNeck
    (lateral{i}, conv{i})."""
    return _neck_convs(strip_module_prefix(sd),
                       (("lateral{}", "lateral_convs.{}"),
                        ("conv{}", "convs.{}")))


def _conv_modules(sd: Dict, pairs) -> Dict:
    """{JAX name pattern: mmseg ConvModule prefix pattern}, every level."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for ours, theirs in pairs:
        for i in range(_count(sd, theirs + ".conv.weight")):
            params[ours.format(i)], stats[ours.format(i)] = _conv_module(
                sd, theirs.format(i))
    return {"params": params, "batch_stats": stats}


def port_jpu(sd: Dict) -> Dict:
    """mmseg necks/jpu.py JPU -> the JAX JPU (conv{i}, dw{i}, pw{i})."""
    return _conv_modules(strip_module_prefix(sd), (
        ("conv{}", "conv_layers.{}.0"),
        ("dw{}", "dilation_layers.{}.0.depthwise_conv"),
        ("pw{}", "dilation_layers.{}.0.pointwise_conv")))


def port_mla_neck(sd: Dict) -> Dict:
    """mmseg necks/mla_neck.py MLANeck -> the JAX MLANeck (norm{i},
    proj{i}, extract{i})."""
    sd = strip_module_prefix(sd)
    out = _conv_modules(sd, (("proj{}", "mla.channel_proj.{}"),
                             ("extract{}", "mla.feat_extract.{}")))
    for i in range(_count(sd, "norm.{}.weight")):
        out["params"][f"norm{i}"] = _ln_std(sd, f"norm.{i}")
    return out


def port_ic_neck(sd: Dict) -> Dict:
    """mmseg necks/ic_neck.py ICNeck -> the JAX ICNeck (cff_24, cff_12,
    each conv_low and conv_high)."""
    sd = strip_module_prefix(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for cff in ("cff_24", "cff_12"):
        params[cff], stats[cff] = {}, {}
        for part in ("conv_low", "conv_high"):
            params[cff][part], stats[cff][part] = _conv_module(
                sd, f"{cff}.{part}")
    return {"params": params, "batch_stats": stats}


def port_encoding(sd: Dict) -> Dict:
    """mmseg ops/encoding.py Encoding -> the JAX Encoding (the same
    names)."""
    sd = strip_module_prefix(sd)
    return {"params": {"codewords": _np(sd["codewords"]),
                       "scale": _np(sd["scale"])}}


PORTERS = {
    "tbsrn": port_tbsrn,
    "tsrn": port_tsrn,
    "crnn": port_crnn,
    "ocr_transformer": port_ocr_transformer,
    "ccr_clip": port_ccr_clip,
    "clip_vit": port_clip_vit,
    "oictr": port_oictr,
    "acpm": port_acpm,
    "cascade_mit": port_cascade_mit,
    "cascade_mit_v10": port_cascade_mit_v10,
    "segformer_head": port_segformer_head,
    "segmentor": port_segmentor,
    "segmentor_det": port_segmentor_det,
    "cascade_segmentor": port_cascade_segmentor,
    "fpn": port_fpn,
    "multilevel_neck": port_multilevel_neck,
    "jpu": port_jpu,
    "mla_neck": port_mla_neck,
    "ic_neck": port_ic_neck,
    "encoding": port_encoding,
}


def main(argv=None):
    import argparse

    import torch

    from fudanocr_tpu_torch.core import checkpoint as ckpt_lib

    p = argparse.ArgumentParser(
        description="convert a reference torch .pth to a checkpoint "
                    "directory in the JAX package's format")
    p.add_argument("model", choices=sorted(PORTERS))
    p.add_argument("pth")
    p.add_argument("out_dir")
    args = p.parse_args(argv)

    sd = torch.load(args.pth, map_location="cpu")
    if isinstance(sd, dict) and "state_dict_G" in sd:
        sd = sd["state_dict_G"]   # SR checkpoints (interfaces/base.py:260)
    ckpt_lib.save_jax(args.out_dir, PORTERS[args.model](sd),
                      meta={"source": args.pth, "model": args.model})
    print(f"wrote {args.out_dir}")


if __name__ == "__main__":
    main()
