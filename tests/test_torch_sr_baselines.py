"""The SR baselines and the SRGAN discriminator of the port
(fudanocr_tpu_torch/models/sr/baselines.py, their porters in
utils/porters.py) against the JAX package on the CPU, at the JAX tests'
small sizes (tests/test_sr_baselines.py: EDSR 2 blocks x 32, RDN 2 dense
layers, RRDBNet 2 blocks; SRCNN and SRResNet at their widths):

* every forward in inference and training mode, JAX's seeded variables
  carried across by the port's porters, at atol 2e-4; after the training
  forward the BatchNorm statistics (SRResNet, the discriminator) equal
  flax's mutated `batch_stats`;
* one SR train step of SRResNet with the text-focus loss (`train/sr.
  make_sr_train_step`, the oracle's B2 on its plain path here): the x100
  loss, its terms and every gradient against JAX's;
* each porter: JAX `ckpt_lib.save` -> the port's `load_model_state` ->
  the port's `save_jax` -> JAX `ckpt_lib.load`, bit for bit (the ASTER
  head's and VGG16's porters too)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.core import checkpoint as jckpt
from fudanocr_tpu.losses import aux_losses as jaux
from fudanocr_tpu.models.rec.aster_head import \
    ASTERAttentionHead as JaxASTERHead
from fudanocr_tpu.models.sr import baselines as jb
from fudanocr_tpu_torch.core import checkpoint as pckpt
from fudanocr_tpu_torch.losses.aux_losses import VGG16Features
from fudanocr_tpu_torch.models.rec.aster_head import ASTERAttentionHead
from fudanocr_tpu_torch.models.sr import baselines as pb
from fudanocr_tpu_torch.utils.weights import (grad_state_dict, jax_variables,
                                              load_jax_variables,
                                              porter_of, to_jax_variables)
from torch_ctr_cases import randomize
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4
B = 2

# name: (JAX module, port module factory, input shape (NHWC))
MODELS = {
    "srcnn": (jb.SRCNN(), pb.SRCNN, (B, 8, 32, 3)),
    "srcnn_mask": (jb.SRCNN(in_planes=4), lambda: pb.SRCNN(in_planes=4),
                   (B, 8, 32, 4)),
    "srresnet": (jb.SRResNet(), pb.SRResNet, (B, 8, 32, 3)),
    "srresnet_mask": (jb.SRResNet(mask=True), lambda: pb.SRResNet(mask=True),
                      (B, 8, 32, 4)),
    "edsr": (jb.EDSR(num_blocks=2, features=32),
             lambda: pb.EDSR(num_blocks=2, features=32), (B, 8, 32, 3)),
    "rdn": (jb.RDN(num_dense=2), lambda: pb.RDN(num_dense=2), (B, 8, 32, 3)),
    "esrgan": (jb.RRDBNet(nb=2), lambda: pb.RRDBNet(nb=2), (B, 8, 32, 3)),
    "discriminator": (jb.SRDiscriminator(), pb.SRDiscriminator,
                      (B, 32, 128, 3)),
}


def _input(shape, seed=1):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_variables(name):
    jm, _, shape = MODELS[name]
    v = jax.jit(functools.partial(jm.init, train=True))(
        jax.random.PRNGKey(0), jnp.zeros(shape))
    return randomize(v, np.random.default_rng(5))


def _port(name):
    _, make, _ = MODELS[name]
    torch.manual_seed(7)                 # other weights than JAX's
    m = make()
    return load_jax_variables(m, porter_of(m)[0], _jax_variables(name))


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(a.shape)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_jax(name, train):
    jm, _, shape = MODELS[name]
    v, x = _jax_variables(name), _input(shape)
    m = _port(name)
    with torch.no_grad():
        got = m(torch.from_numpy(x), train=train)
    if train:
        want, mut = jm.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        want, mut = jm.apply(v, jnp.asarray(x)), {}
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=ATOL)
    if mut.get("batch_stats"):
        stats = _leaves(jax_variables(m)["batch_stats"])
        for k, w in _leaves(mut["batch_stats"]).items():
            np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_build_baseline_takes_jax_defaults():
    """build_baseline's widths are JAX's: the two trees have the same
    leaves and shapes for every arch, `mask` giving SRCNN and SRResNet 4
    planes."""
    for arch in ("srcnn", "srresnet", "edsr", "rdn", "esrgan"):
        for mask in ((False, True) if arch in ("srcnn", "srresnet")
                     else (False,)):
            c = 4 if mask else 3
            x = jnp.zeros((1, 4, 8, c))
            want = jax.eval_shape(functools.partial(
                jb.build_baseline(arch, mask=mask).init, train=True),
                jax.random.PRNGKey(0), x)
            got = jax_variables(pb.build_baseline(arch, mask=mask,
                                                  width=64, height=16))
            assert _shapes(got) == _shapes(want), (arch, mask)
    with pytest.raises(ValueError, match="unknown SR baseline"):
        pb.build_baseline("vdsr")


ORACLE = dict(vocab=37, num_in=1, layers=(1, 1, 1, 1), num_heads=4,
              d_embed=32, d_model=64, d_ff=64)


def test_srresnet_text_focus_step_matches_jax():
    """One step of SRResNet with the text-focus loss over the small oracle
    (its LayerNorms through B2's plain path on the CPU): the x100 loss and
    its terms, the BatchNorm statistics after it and every gradient,
    against jax.value_and_grad of JAX's step body."""
    from fudanocr_tpu.losses.sr_losses import TextFocusLoss as JaxTFL
    from fudanocr_tpu.models.rec.ocr_transformer import \
        OCRTransformer as JaxOCR
    from fudanocr_tpu_torch.losses.sr_losses import (TextFocusLoss,
                                                     encode_text_labels)
    from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
    from fudanocr_tpu_torch.ops.fused_layernorm import \
        fused_residual_layernorm
    from fudanocr_tpu_torch.train.sr import make_sr_train_step
    from fudanocr_tpu_torch.train.state import AdamWithClip

    rng = np.random.default_rng(3)
    lr = rng.random((B, 16, 64, 3)).astype(np.float32)
    hr = rng.random((B, 32, 128, 3)).astype(np.float32)
    ti, tg, ln = encode_text_labels(["srresnet", "Base42"], 32)
    jm = jb.SRResNet()
    v = randomize(jax.jit(functools.partial(jm.init, train=True))(
        jax.random.PRNGKey(1), jnp.asarray(lr)), rng)
    om = JaxOCR(**ORACLE)
    ov = jax.tree_util.tree_map(np.asarray, jax.jit(om.init)(
        jax.random.PRNGKey(2), jnp.zeros((B, 32, 128, 1)),
        jnp.zeros((B, 4), jnp.int32)))
    jfn = JaxTFL(om, ov)

    def loss_of(params):
        sr, mut = jm.apply({"params": params,
                            "batch_stats": v["batch_stats"]},
                           jnp.asarray(lr), train=True,
                           mutable=["batch_stats"])
        loss, aux = jfn(sr, jnp.asarray(hr), jnp.asarray(ti),
                        jnp.asarray(tg), jnp.asarray(ln))
        return loss * 100.0, (aux, mut["batch_stats"])

    (want, (aux, stats)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(v["params"])

    model = load_jax_variables(pb.SRResNet(), "srresnet", v)
    oracle = load_jax_variables(OCRTransformer(**ORACLE), "ocr_transformer",
                                ov, layers=ORACLE["layers"])
    # lr 0: the step leaves the weights where they were and its gradients
    # in .grad (no clip)
    opt = AdamWithClip(model.parameters(), lr=0.0, clip=None)
    step = make_sr_train_step(model, TextFocusLoss(oracle), opt)
    n0 = fused_residual_layernorm.launches
    got = step({"hr": torch.from_numpy(hr), "lr": torch.from_numpy(lr),
                **{k: torch.from_numpy(a).long() for k, a in
                   (("text_input", ti), ("text_gt", tg),
                    ("lengths", ln))}}, torch.Generator().manual_seed(0))
    assert fused_residual_layernorm.launches == n0     # no kernel here
    np.testing.assert_allclose(got["loss"].item(), float(want), rtol=1e-5)
    for k in ("mse", "attention", "recognition"):
        np.testing.assert_allclose(got[k].item(), float(aux[k]), rtol=1e-4,
                                   atol=1e-8, err_msg=k)
    back = to_jax_variables(grad_state_dict(model), "srresnet")
    for k, w in _leaves(stats).items():
        np.testing.assert_allclose(_leaves(back["batch_stats"])[k], w,
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    g, w = _leaves(back["params"]), _leaves(grads)
    assert g.keys() == w.keys()
    scale = max(np.abs(a).max() for a in w.values())
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=k)


ASTER = dict(num_classes=12, in_planes=16, s_dim=16, att_dim=16, max_len=6)

# porter: (JAX variables, port module factory)
ROUND_TRIPS = {
    **{n: (functools.partial(_jax_variables, n),
           functools.partial(lambda n: MODELS[n][1](), n))
       for n in MODELS},
    "aster_head": (lambda: randomize(JaxASTERHead(**ASTER).init(
        jax.random.PRNGKey(0), jnp.zeros((B, 8, 16)),
        jnp.zeros((B, 6), jnp.int32)), np.random.default_rng(6)),
        lambda: ASTERAttentionHead(**ASTER)),
    "vgg16_features": (lambda: randomize(jaux.VGG16Features().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))),
        np.random.default_rng(7)), VGG16Features),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_jax_checkpoint_round_trips_through_the_port(name, tmp_path):
    variables, make = ROUND_TRIPS[name]
    v = variables()
    src, dst = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(src, v, meta={"step": 5})
    torch.manual_seed(11)
    m = make()
    m.load_state_dict(pckpt.load_model_state(src, module=m))
    pckpt.save_jax(dst, jax_variables(m), meta=pckpt.load_meta(src))
    back = jckpt.load(dst, v)
    got, want = _leaves(back), _leaves(v)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
