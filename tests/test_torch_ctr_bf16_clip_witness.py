"""CCR-CLIP stage 1's training step in bf16 against the JAX package's
bf16 step on the CPU where the card runs it: at batch 128, the batch of
chip_smoke.py phase 35, on the test sizes (one block a stage, 32x32
images), under the bars of tests/test_torch_ctr_bf16_steps.py; and with
the image tower at its full depth, (3, 4, 6, 3) bottlenecks, at 32x32 and
batch 32. There JAX's own bf16 image-tower gradients lie more than 1 from
its float32 ones, nearly orthogonal to them (scale along them ~0.2), as
the port's do on the card at 128x128 and batch 128 (1.37, scale 0.09):
the test holds the port's image tower, and all gradients together, as
far from float32 as JAX's and shrunk along it as JAX's are."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fudanocr_tpu.train.state import TrainState
from test_torch_ctr_bf16_steps import (JAX_ROUNDING, NOISY_RATIO,
                                       SCALE_DROP, _readings, run_case)
from torch_ctr_cases import CLIP, capture_grads_tx, init, leaves, no_update
from torch_ctr_step_cases import clip_text, images, no_dropout  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

FULL_DEPTH, HW, BATCH = (3, 4, 6, 3), 32, 32


def test_bf16_clip_step_at_batch_128_matches_jax(no_dropout, monkeypatch):
    run_case("clip128", monkeypatch)


def test_bf16_clip_image_tower_at_full_depth_matches_jax(no_dropout):
    from fudanocr_tpu.apps.ccr_clip.pretrain import CLIPPretrainer
    from fudanocr_tpu.models.rec import ccr_clip as jccr
    from fudanocr_tpu_torch.apps.ccr_clip.pretrain import make_clip_train_step
    from fudanocr_tpu_torch.losses.clip_loss import first_occurrence_targets
    from fudanocr_tpu_torch.models.rec.ccr_clip import CCRCLIP
    from fudanocr_tpu_torch.utils.weights import (grad_state_dict,
                                                  load_jax_variables,
                                                  to_jax_variables)

    v = init(jccr.CCRCLIP(**CLIP), np.zeros((2, HW, HW, 3), np.float32),
             np.zeros((2, CLIP["context_length"]), np.int32))
    kw = {"layers": FULL_DEPTH,
          "transformer_layers": CLIP["transformer_layers"]}
    x, t = images(HW, HW, 8, b=BATCH), clip_text(9, b=BATCH)
    rng = np.random.default_rng(3)
    targets = first_occurrence_targets(
        [str(rng.integers(0, BATCH)) for _ in range(BATCH)])
    jax_steps = []
    for dtype in (jnp.bfloat16, None):
        step = CLIPPretrainer._make_train_step(types.SimpleNamespace(
            model=jccr.CCRCLIP(**CLIP, dtype=dtype)))
        state = TrainState.create(v["params"], v["batch_stats"],
                                  capture_grads_tx())
        jax_steps.append(jax.jit(step.__wrapped__,
                                 compiler_options=JAX_ROUNDING)(
            state, jnp.asarray(x), jnp.asarray(t), jnp.asarray(targets)))
    m = load_jax_variables(CCRCLIP(**CLIP, dtype=torch.bfloat16),
                           "ccr_clip", v, **kw)
    loss = make_clip_train_step(m, no_update(m))(
        torch.from_numpy(x), torch.from_numpy(t).long(),
        torch.from_numpy(targets))
    (sbf, lbf), (s32, l32) = jax_steps
    got = leaves(to_jax_variables(grad_state_dict(m), "ccr_clip",
                                  **kw)["params"])
    bf, fp = leaves(sbf.opt_state), leaves(s32.opt_state)
    groups = {"visual": [k for k in fp if k.startswith("['visual']")],
              "all": sorted(fp)}
    read = {g: _readings(got, bf, fp, keys) for g, keys in groups.items()}
    print(f"stage 1 at full image-tower depth: loss {float(loss)} vs JAX "
          f"bf16 {float(lbf)}, fp32 {float(l32)}; (ours, ours vs fp32, "
          f"jaxs, scale, JAX's scale): "
          f"{ {g: tuple(f'{r:.3g}' for r in rs) for g, rs in read.items()} }")
    assert abs(float(loss) - float(lbf)) <= 1e-2 * abs(float(lbf))
    for group, (ours, ours32, jaxs, scale, jax_scale) in read.items():
        assert jaxs > 1, (group, jaxs)   # bf16's own, in JAX
        assert jaxs / 8 <= ours32 <= NOISY_RATIO * jaxs, (group, ours32)
        assert abs(scale - jax_scale) <= SCALE_DROP, (group, scale)
