"""The registry-only seg modules of the port (`models/seg/necks.py`,
`models/seg/encoding.py`, `CascadeEncoderDecoder`, `core/registry.py`
through `apps/seg/inference.build_model`) and the layer-wise lr decay
optimizer (`train/seg.layer_id_for_param`, `make_layer_decay_optimizer`)
against the JAX package on the CPU, on the same weights (JAX variables,
randomised, moved in with `load_jax_variables` through the new porters)
and seeded numpy inputs.

Bars: outputs fp32 atol 2e-4 (the module-parity bar), and in bf16 the
bars of tests/test_torch_seg_bf16.py (within 2x JAX's own bf16 distance
from fp32, at least a quarter of it away in mean); layer ids equal to
JAX's on every parameter (CascadeMiT, the det-guided backbone and a whole
segmentor); one layer-decay Adam step's parameter moves rel 1e-5 to
optax's (at lr 1, so that the moves are not lost to the rounding of the
parameters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fudanocr_tpu.models.seg import CascadeMiT as JaxCascadeMiT
from fudanocr_tpu.models.seg import SegformerHead as JaxSegformerHead
from fudanocr_tpu.models.seg import necks as jnecks
from fudanocr_tpu.models.seg.encoder_decoder import (
    CascadeEncoderDecoder as JaxCascadeSeg)
from fudanocr_tpu.models.seg.encoding import Encoding as JaxEncoding
from fudanocr_tpu.train import seg as jseg
from fudanocr_tpu_torch.apps.seg import inference as pinf
from fudanocr_tpu_torch.models.seg import (CascadeEncoderDecoder, CascadeMiT,
                                           CascadeMiTDetGuided, EncoderDecoder,
                                           SegformerHead)
from fudanocr_tpu_torch.models.seg import necks
from fudanocr_tpu_torch.models.seg.encoding import Encoding
from fudanocr_tpu_torch.train import seg as pseg
from fudanocr_tpu_torch.utils.weights import (_walk, load_jax_variables,
                                              to_jax_variables, trace_porter)
from test_torch_seg_model import _randomize
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4
NARROW = dict(embed_dims=8, num_layers=(1, 1, 1, 1), num_heads=(1, 2, 5, 8),
              sr_ratios=(8, 4, 2, 1))
WIDTHS = (8, 16, 32)
# a 3-level pyramid at odd sizes (non-integer nearest and bilinear ratios)
PYRAMID = ((17, 21), (9, 11), (5, 6))
CASES = {
    "fpn": (lambda dt: jnecks.FPN(out_channels=8, dtype=dt),
            lambda dt: necks.FPN(WIDTHS, 8, dtype=dt), PYRAMID),
    "multilevel_neck": (
        lambda dt: jnecks.MultiLevelNeck(out_channels=8, scales=(0.5, 1, 2),
                                         dtype=dt),
        lambda dt: necks.MultiLevelNeck(WIDTHS, 8, scales=(0.5, 1, 2),
                                        dtype=dt), PYRAMID),
    "jpu": (lambda dt: jnecks.JPU(mid_channels=8, dtype=dt),
            lambda dt: necks.JPU(WIDTHS, 8, dtype=dt), PYRAMID),
    "mla_neck": (lambda dt: jnecks.MLANeck(out_channels=8, dtype=dt),
                 lambda dt: necks.MLANeck(WIDTHS, 8, dtype=dt),
                 ((9, 11),) * 3),
    "ic_neck": (lambda dt: jnecks.ICNeck(out_channels=8, dtype=dt),
                lambda dt: necks.ICNeck(WIDTHS, 8, dtype=dt), PYRAMID),
}


def _inputs(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, h, w, c)).astype(np.float32)
            for (h, w), c in zip(sizes, WIDTHS)]


def _port_in(xs):
    return [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous() for x in xs]


def _dist(a, b) -> tuple:
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(d.max()), float(d.mean())


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("train", [False, True])
def test_neck_matches_jax(name, train):
    """Eval (running statistics) and train mode (batch statistics, which
    the port moves as flax does), fp32."""
    jmake, pmake, sizes = CASES[name]
    xs = _inputs(sizes, 1)
    jm = jmake(None)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs]))
    v = _randomize(v, np.random.default_rng(2))
    if train:
        want, mutated = jm.apply(v, [jnp.asarray(x) for x in xs], train=True,
                                 mutable=["batch_stats"])
    else:
        want = jm.apply(v, [jnp.asarray(x) for x in xs])
    m = load_jax_variables(pmake(torch.float32), name, v)
    got = m(_port_in(xs), train=train)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=0, atol=ATOL)
    if train and "batch_stats" in v:
        back = to_jax_variables(m, name)["batch_stats"]
        for path, a in _walk(mutated["batch_stats"]):
            b = back
            for k in path:
                b = b[k]
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_neck_bf16_matches_jax(name):
    jmake, pmake, sizes = CASES[name]
    xs = _inputs(sizes, 3)
    jxs = [jnp.asarray(x) for x in xs]
    v = _randomize(jax.tree_util.tree_map(np.asarray, jmake(None).init(
        jax.random.PRNGKey(0), jxs)), np.random.default_rng(4))
    want32 = jmake(None).apply(v, jxs)
    want16 = jmake(jnp.bfloat16).apply(v, jxs)
    m = load_jax_variables(pmake(torch.bfloat16), name, v)
    with torch.inference_mode():
        got = m(_port_in(xs))
    for i, (g, w32, w16) in enumerate(zip(got, want32, want16)):
        if i < len(xs) - 1 and name == "jpu":
            continue          # JPU passes its first inputs through
        assert g.dtype == torch.bfloat16 and w16.dtype == jnp.bfloat16
        ours = _dist(g.float().permute(0, 2, 3, 1).numpy(), w32)
        jaxs = _dist(np.asarray(w16.astype(jnp.float32)), w32)
        print(f"{name} output {i}: port bf16 from JAX fp32 {ours}, JAX bf16 "
              f"from fp32 {jaxs}")
        assert ours[0] <= 2 * jaxs[0] and ours[1] <= 2 * jaxs[1]
        assert ours[1] >= jaxs[1] / 4


def test_encoding_matches_jax():
    b, h, w, c, k = 2, 4, 5, 8, 6
    x = np.random.default_rng(0).standard_normal((b, h, w, c)).astype(
        np.float32)
    jm = JaxEncoding(channels=c, num_codes=k)
    v = jax.tree_util.tree_map(np.asarray,
                               jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = load_jax_variables(Encoding(c, k), "encoding", v)
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
    assert got.shape == (b, k, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the dtype rounds the input only; the math stays float32, as in JAX
    got16 = Encoding(c, k, dtype=torch.bfloat16)
    got16.load_state_dict(m.state_dict())
    want16 = np.asarray(JaxEncoding(c, k, dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x, jnp.bfloat16)))
    out = got16(torch.from_numpy(x).permute(0, 3, 1, 2)).detach()
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want16, rtol=0, atol=ATOL)


def test_cascade_encoder_decoder_matches_jax():
    """CascadeEncoderDecoder(CascadeMiT, two SegformerHeads), the second
    over the finest level widened by the 2 classes, built directly in both
    packages (neither app builds one, ROADMAP C21)."""
    widths = [8 * n for n in (1, 2, 5, 8)]
    m = CascadeEncoderDecoder(CascadeMiT(**NARROW), [
        SegformerHead(widths, 2, 32),
        SegformerHead([widths[0] + 2] + widths[1:], 2, 32)]).eval()
    jm = JaxCascadeSeg(backbone=JaxCascadeMiT(**NARROW),
                       decode_heads=(JaxSegformerHead(2, 32),
                                     JaxSegformerHead(2, 32)))
    x = np.random.default_rng(5).standard_normal((2, 64, 96, 3)).astype(
        np.float32)
    v = _randomize(jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(x))), np.random.default_rng(6))
    load_jax_variables(m, "cascade_segmentor", v, **NARROW)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 96, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("overrides,want", [
    (("model.type=EncoderDecoder", "model.backbone.type=CascadeMiT",
      "model.decode_head.type=SegformerHead"), EncoderDecoder),
    (("model.type=CascadeEncoderDecoder",), NotImplementedError),
])
def test_build_model_builds_registered_types(overrides, want):
    """`build_model` resolves each `type` through the registries, as the
    JAX app does; a cascade config raises naming ROADMAP C21, as JAX's
    build fails on it (TypeError there)."""
    args = ("configs/seg/textformer_b0_textseg.yaml",)
    kw = dict(device="cpu", overrides=overrides + (
        "model.backbone.embed_dims=8",
        "model.backbone.num_layers=[1, 1, 1, 1]"))
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError, match="C21"):
            pinf.init_segmentor(*args, **kw)
        return
    m, _ = pinf.init_segmentor(*args, **kw)
    assert type(m) is want and isinstance(m.backbone, CascadeMiT)
    assert isinstance(m.decode_head, SegformerHead)


def _port_to_jax_paths(module, porter, **kw) -> dict:
    """{port parameter name: the JAX params path ("a/b/c") it feeds}."""
    sd = module.state_dict()
    tree, meta, _ = trace_porter(porter, {k: tuple(v.shape)
                                          for k, v in sd.items()}, **kw)
    starts = sorted((off, k) for k, (off, _) in meta.items())
    offs = [o for o, _ in starts]
    out = {}
    for path, idx in _walk(tree["params"]):
        first = int(np.asarray(idx).ravel()[0])
        key = starts[np.searchsorted(offs, first, "right") - 1][1]
        out.setdefault(key, "/".join(path))
    params = dict(module.named_parameters())
    assert set(out) == set(params), set(params) ^ set(out)
    return out


@pytest.mark.parametrize("which", ["cascade_mit", "cascade_mit_v10",
                                   "segmentor"])
def test_layer_ids_match_jax(which):
    nl = (1, 2, 1, 2)
    kw = dict(NARROW, num_layers=nl)
    module = {"cascade_mit": lambda: CascadeMiT(**kw),
              "cascade_mit_v10": lambda: CascadeMiTDetGuided(**kw),
              "segmentor": lambda: EncoderDecoder(
                  CascadeMiT(**kw), SegformerHead([8, 16, 40, 64], 2, 16))
              }[which]()
    pairs = _port_to_jax_paths(module, which, **kw)
    ids = {}
    for name, path in pairs.items():
        want = jseg.layer_id_for_param(path, nl)
        assert pseg.layer_id_for_param(name, nl) == want, (name, path)
        ids[want] = ids.get(want, 0) + 1
    print(f"{which}: parameters by layer id {dict(sorted(ids.items()))}")
    if which != "segmentor":
        assert sorted(ids) == list(range(0, 3 + sum(nl))) + [3 + sum(nl) + 1]


def test_layer_decay_step_matches_optax():
    nl = NARROW["num_layers"]
    jm = JaxCascadeMiT(**NARROW)
    v = _randomize(jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))),
        np.random.default_rng(7))
    m = load_jax_variables(CascadeMiT(**NARROW), "cascade_mit", v, **NARROW)
    rng = np.random.default_rng(8)
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        v["params"])
    tx = jseg.make_layer_decay_optimizer(v["params"], base_lr=1.0,
                                         total_iters=160_000, num_layers=nl)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    st = jax.tree_util.tree_map(
        lambda s: s._replace(count=jnp.asarray(1500, jnp.int32))
        if isinstance(s, optax.ScaleByScheduleState) else s,
        tx.init(params),
        is_leaf=lambda s: isinstance(s, optax.ScaleByScheduleState))
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), st,
                       params)
    want = optax.apply_updates(params, upd)

    opt = pseg.make_layer_decay_optimizer(m, base_lr=1.0,
                                          total_iters=160_000, num_layers=nl)
    opt.count = 1500
    mults = sorted({g["lr_mult"] for g in opt.adam.param_groups})
    assert len(mults) == 3 + sum(nl) + 1        # one per layer id
    gsd = load_jax_variables(CascadeMiT(**NARROW), "cascade_mit",
                             {"params": grads,
                              "batch_stats": v["batch_stats"]},
                             **NARROW).state_dict()
    for name, p in m.named_parameters():
        p.grad = gsd[name].clone()
    opt.step()
    got = to_jax_variables(m, "cascade_mit", **NARROW)["params"]
    for path, w in _walk(jax.tree_util.tree_map(np.asarray, want)):
        g, start = got, v["params"]
        for k in path:
            g, start = g[k], start[k]
        moved = np.asarray(w) - start
        assert np.abs(moved).min() > 0.1         # every element moves
        np.testing.assert_allclose(g - start, moved, rtol=1e-5, atol=0,
                                   err_msg="/".join(path))
