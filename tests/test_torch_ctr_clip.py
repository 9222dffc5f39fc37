"""CCR-CLIP of the port (models/rec/ccr_clip.py, losses/clip_loss.py,
the stage-1 train step of apps/ccr_clip/pretrain.py) against the JAX
package on the CPU: the same seeded numpy inputs, the same random weights
moved by the port's `ccr_clip` porter, at the JAX package's smoke sizes
(tests/torch_ctr_cases.py; the image tower with one bottleneck per
stage). Forwards in float32 within atol 2e-4; the train step in float64
(tests/torch_ctr_step_cases.py; tests/test_torch_ctr_steps_fp32.py holds
it in float32) with its loss within 1e-5 relative, each parameter's
gradient within 1e-3 norm-relative, the BatchNorm statistics within
1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fudanocr_tpu.models.rec import ccr_clip as jccr
from fudanocr_tpu_torch.models.rec import ccr_clip
from fudanocr_tpu_torch.utils.weights import load_jax_variables
from torch_ctr_cases import ATOL, CLIP, CLIP_VISION, init, small_clip_vision
from torch_ctr_step_cases import clip_jax, clip_pretrain_step, clip_text
from torch_threads import one_torch_thread  # noqa: F401

B = 2


def _images(h, w, seed=1):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, h, w, 3)).astype(np.float32)


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-3, atol=ATOL, err_msg=name)


@pytest.fixture(scope="module")
def clip_pair():
    jm, v = clip_jax(B)
    m = load_jax_variables(
        ccr_clip.CCRCLIP(vision_layers=CLIP_VISION, **CLIP), "ccr_clip", v,
        layers=CLIP_VISION, transformer_layers=CLIP["transformer_layers"])
    return jm, v, m


def test_ccr_clip_matches_jax(clip_pair, monkeypatch):
    """Both towers, the unit features and exp(logit_scale); the text tower
    pools at the terminator (ids after it change nothing)."""
    small_clip_vision(monkeypatch)
    jm, v, m = clip_pair
    x, t = _images(32, 32), clip_text()
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t).long())
        raw = m.encode_image(torch.from_numpy(x))
        t2 = t.copy()
        t2[1, 6:] = 1
        after = m.encode_text(torch.from_numpy(t2).long())
        before = m.encode_text(torch.from_numpy(t).long())
    assert raw.shape == (B, 2048)
    want_raw = jm.apply(v, jnp.asarray(x), method=jm.encode_image)
    _close(raw, want_raw, "encode_image")
    for name, g, w in zip(("image", "text", "scale"), got, want):
        _close(g, w, name)
    torch.testing.assert_close(after, before, rtol=1e-5, atol=1e-6)


def test_clip_vit_matches_jax():
    jm = jccr.VisionTransformer(patch_size=16, width=32, layers=1, heads=2,
                                output_dim=16)
    v = init(jm, np.zeros((B, 32, 32, 3), np.float32))
    m = load_jax_variables(ccr_clip.VisionTransformer((32, 32), 16, 32, 1, 2,
                                                      16), "clip_vit", v,
                           layers=1)
    x = _images(32, 32)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    _close(got, jm.apply(v, jnp.asarray(x)), "vit")


def test_clip_loss_matches_jax():
    from fudanocr_tpu.losses import clip_loss as jloss
    from fudanocr_tpu_torch.losses import clip_loss

    labels = ["a", "b", "a", "c", "b", "a"]
    want_t = jloss.first_occurrence_targets(labels)
    got_t = clip_loss.first_occurrence_targets(labels)
    assert got_t.dtype == want_t.dtype and np.array_equal(got_t, want_t)
    rng = np.random.default_rng(5)
    f1, f2 = (rng.standard_normal((6, 16)).astype(np.float32)
              for _ in range(2))
    want = jloss.clip_symmetric_ce(jnp.asarray(f1), jnp.asarray(f2), 14.3,
                                   jnp.asarray(want_t))
    got = clip_loss.clip_symmetric_ce(torch.from_numpy(f1),
                                      torch.from_numpy(f2),
                                      torch.tensor(14.3),
                                      torch.from_numpy(got_t))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_clip_pretrain_step_matches_jax(clip_pair, monkeypatch):
    jm, v, _ = clip_pair
    clip_pretrain_step(monkeypatch, jm, v, x64=True)
