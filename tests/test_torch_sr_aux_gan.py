"""The auxiliary SR losses and the adversarial SR trainer of the port
(fudanocr_tpu_torch/losses/aux_losses.py, train/gan.py) against the JAX
package on the CPU:

* each auxiliary loss's value and its gradient in its image (or logits)
  input, on the same seeded numpy inputs; the perceptual loss over VGG16
  weights drawn from a seed in JAX and carried across by the port's
  `vgg16_features` porter (no trained VGG16 weights are in the
  repository);
* one GANSRTrainer iteration, the discriminator step and then the
  generator step, against JAX's `d_step` / `g_step` on the same weights
  and batch (RRDBNet nf 8, one block, gc 4, JAX's test size, against the
  full discriminator), in float64: d_loss, pix and g_adv, the
  discriminator's BatchNorm statistics after its step, and both nets'
  parameters after the iteration. Adam runs with lr = eps = 1 on both
  sides (optax.adam patched here, nothing in the JAX package changes), so
  its first update
  is g / (|g| + 1) ~ g and the parameters after it hold the gradients
  (with eps 1e-8 it is lr * sign(g), and the rounding noise of the exactly
  zero gradients of the conv biases in front of a train-mode BatchNorm
  becomes +-lr);
* `train()` on a synthetic set: finite losses, both nets moved, the
  weights a function of the seed (or the generator seeded with it)
  alone."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fudanocr_tpu.losses import aux_losses as jaux
from fudanocr_tpu_torch.data.synthetic import SyntheticTextZoom
from fudanocr_tpu_torch.losses import aux_losses as paux
from fudanocr_tpu_torch.models.sr.baselines import RRDBNet, SRDiscriminator
from fudanocr_tpu_torch.train.gan import GANSRTrainer, init_parameters
from fudanocr_tpu_torch.train.state import AdamWithClip
from fudanocr_tpu_torch.utils.weights import jax_variables, load_jax_variables
from torch_ctr_cases import randomize
from torch_threads import one_torch_thread  # noqa: F401


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _images(seed, shape=(2, 16, 32, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _vgg():
    """JAX's VGG16 with seeded He-scaled kernels (fan-in-scaled ones
    halve the signal at each ReLU: relu5_3 would be ~1e-4 of the input)."""
    v = randomize(jax.jit(jaux.VGG16Features().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 3))),
        np.random.default_rng(4))
    for c in v["params"].values():
        c["kernel"] = (c["kernel"] * np.sqrt(2)).astype(np.float32)
    torch.manual_seed(9)
    return v, load_jax_variables(paux.VGG16Features(), "vgg16_features", v)


def _perceptual():
    v, m = _vgg()
    return (lambda s, h: jaux.perceptual_loss(
                lambda x: jaux.VGG16Features().apply(v, x), s, h),
            lambda s, h: paux.perceptual_loss(m, s, h))


def _logits(seed):
    return (np.random.default_rng(seed).standard_normal(6) * 3).astype(
        np.float32)


# name: (JAX loss, port loss, inputs; the gradient is the first input's)
LOSSES = {
    "gradient_prior": lambda: (jaux.gradient_prior_loss,
                               paux.gradient_prior_loss,
                               (_images(1), _images(2))),
    "total_variation": lambda: (jaux.total_variation_loss,
                                paux.total_variation_loss, (_images(3),)),
    "perceptual": lambda: (*_perceptual(), (_images(5), _images(6))),
    "gan_generator": lambda: (jaux.gan_generator_loss,
                              paux.gan_generator_loss, (_logits(7),)),
    "gan_discriminator": lambda: (jaux.gan_discriminator_loss,
                                  paux.gan_discriminator_loss,
                                  (_logits(8), _logits(9))),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_aux_loss_and_gradient_match_jax(name):
    jfn, pfn, args = LOSSES[name]()
    want, want_g = jax.value_and_grad(jfn)(*map(jnp.asarray, args))
    x = torch.from_numpy(args[0]).requires_grad_()
    got = pfn(x, *map(torch.from_numpy, args[1:]))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-7)
    # every element within 1e-4 of the largest (the perceptual loss's
    # gradient passes back through VGG16's 13 float32 convs)
    g, w = x.grad.numpy(), np.asarray(want_g)
    np.testing.assert_allclose(g, w, rtol=1e-4,
                               atol=1e-4 * np.abs(w).max())


# -- the GAN trainer ----------------------------------------------------------

G_KW = dict(nf=8, nb=1, gc=4)


@pytest.fixture
def jax_gan(monkeypatch):
    """JAX's trainer in float64 (lr 1 for both nets, Adam's eps 1) and one
    batch."""
    from fudanocr_tpu.data.synthetic import SyntheticTextZoom as JaxSTZ
    from fudanocr_tpu.models.sr import RRDBNet as JaxRRDB
    from fudanocr_tpu.models.sr import SRDiscriminator as JaxDisc
    from fudanocr_tpu.train.gan import GANSRTrainer as JaxGAN
    from fudanocr_tpu.train.state import TrainState

    monkeypatch.setattr(optax, "adam",
                        functools.partial(optax.adam, eps=1.0))
    data = JaxSTZ(num_samples=8, hr_size=(32, 16), scale=2)
    with jax.enable_x64(True):
        t = JaxGAN(JaxRRDB(scale_factor=2, **G_KW), JaxDisc(), data,
                   batch_size=4, g_lr=1.0, d_lr=1.0)
        f64 = functools.partial(jax.tree_util.tree_map,
                                lambda a: np.asarray(a, np.float64))
        for name in ("g_state", "d_state"):
            s = getattr(t, name)
            setattr(t, name, TrainState.create(
                f64(s.params), f64(s.batch_stats), optax.adam(1.0, b1=0.9)))
    hr, lr, _ = next(iter(data.batches(4)))
    return t, np.asarray(hr, np.float64), np.asarray(lr, np.float64)


def _variables(state):
    return {"params": state.params, "batch_stats": state.batch_stats}


def test_gan_iteration_matches_jax(jax_gan):
    """In float64 on both sides: in float32 flax's train-mode BatchNorm
    (the variance as E[x^2] - E[x]^2, over the 8 values a channel of the
    discriminator's last levels has at this size) moves the
    discriminator's gradients off float64 by more than the module bar,
    where the port's float32 ones stay near float64; in float64 the two
    packages agree."""
    jt, hr, lr = jax_gan
    g0, d0 = _variables(jt.g_state), _variables(jt.d_state)
    rng = jax.random.PRNGKey(1)
    with jax.enable_x64(True):
        d_state, d_loss = jt.d_step(jt.d_state, jt.g_state,
                                    jnp.asarray(lr), jnp.asarray(hr), rng)
        g_state, aux = jt.g_step(jt.g_state, d_state, jnp.asarray(lr),
                                 jnp.asarray(hr), rng)
        d_loss, aux = float(d_loss), {k: float(v) for k, v in aux.items()}
        d_state, g_state = jax.tree_util.tree_map(np.asarray,
                                                  (d_state, g_state))

    t = GANSRTrainer(RRDBNet(**G_KW).double(), SRDiscriminator().double(),
                     None, batch_size=4)
    load_jax_variables(t.g, "esrgan", g0)
    load_jax_variables(t.d, "sr_discriminator", d0)
    t.g_opt = AdamWithClip(t.g.parameters(), 1.0, beta1=0.9, clip=None,
                           eps=1.0)
    t.d_opt = AdamWithClip(t.d.parameters(), 1.0, beta1=0.9, clip=None,
                           eps=1.0)
    lr_t, hr_t = torch.from_numpy(lr), torch.from_numpy(hr)
    got_d = t.d_step(lr_t, hr_t)
    got = t.g_step(lr_t, hr_t)
    np.testing.assert_allclose(got_d.item(), d_loss, rtol=1e-10)
    for k in ("pix", "g_adv"):
        # pix is a float32 mean on both sides (JAX casts SR and HR to it)
        np.testing.assert_allclose(got[k].item(), aux[k], rtol=1e-6,
                                   err_msg=k)
    for net, state in ((t.d, d_state), (t.g, g_state)):
        mine = _leaves(jax_variables(net))
        want = _leaves(_variables(state))
        assert mine.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(mine[k], w, rtol=1e-6, atol=1e-9,
                                       err_msg=k)


def test_gan_trainer_trains_from_its_seed():
    data = SyntheticTextZoom(num_samples=8, hr_size=(32, 16), scale=2)

    def trainer(seed):
        return GANSRTrainer(RRDBNet(**G_KW), SRDiscriminator(), data,
                            batch_size=4, seed=seed)

    a, c = trainer(3), trainer(4)
    b = GANSRTrainer(RRDBNet(**G_KW), SRDiscriminator(), data, batch_size=4,
                     rng=torch.Generator().manual_seed(3))
    for x, y in ((a.g, b.g), (a.d, b.d)):
        assert all(torch.equal(p, q) for p, q in
                   zip(x.state_dict().values(), y.state_dict().values()))
    assert not torch.equal(a.g.conv_first.weight, c.g.conv_first.weight)
    before = [{k: v.clone() for k, v in n.state_dict().items()}
              for n in (a.g, a.d)]
    out = a.train()
    assert set(out) == {"d_loss", "pix", "g_adv"}
    assert np.isfinite(list(out.values())).all()
    for net, start in zip((a.g, a.d), before):
        assert any(not torch.equal(v, start[k])
                   for k, v in net.state_dict().items())


def test_init_parameters_refuses_what_it_cannot_draw():
    with pytest.raises(TypeError, match="Embedding"):
        init_parameters(torch.nn.Embedding(3, 2), torch.Generator())
