"""The rounding points of the fp32 fused-enhancer kernels
(fudanocr_tpu_torch/csrc/fused_enhancer.cu `qkv_proj_tf32x3_kernel` and
`attn_epilogue_tf32x3_kernel<DH>`: every product in split TF32 on the
tensor cores) on the CPU, before any card runs them.

`enhancer_tf32x3_model` is their arithmetic in plain torch: each product's
operands split into TF32 hi + lo (cvt.rna), three TF32 products per
m16n8k8 step, each step's sum rounded toward zero as the tensor cores round
it (tests/torch_attention_cases.py `_mm`). The qkv projection, the output
projection, the FFN and the final projection take the small products of
each step before its large one, from zero accumulators, and add their
fp32 bias (or the PE's qkv term) once. The attention is the fp32 seg
forward's arithmetic (`tf32x3_attention_model`) on 64-key tiles: S = Q K^T
small products first, the fp32 scores scaled, an online softmax with a
true row max, each tile's P V from zero added to the rescaled running sum,
o = acc * (1 / l). The two LayerNorms are the plain version's, in fp32
(the kernel's CUDA-core `layer_norm_rows`).

It is held against the JAX package's fp32 Pallas `fused_enhancer`
(fudanocr_tpu/ops/fused_enhancer.py, interpret mode) at the bar the card
holds the kernel to (rtol 2e-4, atol 2e-5: tests/test_torch_fused_enhancer.py
and chip_smoke.py phase 1) at L = 512 (8 x 64, the JAX gate's minimum),
4 heads of 32 and 2 of 64, on normal tokens and on tokens x4 (a peaked
softmax). The same model with one TF32 product per step (`products=1`,
what a plain TF32 kernel computes) misses that bar on every case: its
largest error is 72-95x the bar, where split TF32's is 0.25-0.37 of it.
So one TF32 product misses the fp32 tolerance, and three meet it.
"""

import functools

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.nn.attention import positional_encoding_2d
from fudanocr_tpu_torch.ops.fused_enhancer import enhancer_operands
from fudanocr_tpu_torch.ops.fused_layernorm import torch_layer_norm
from torch_attention_cases import _mm, tf32x3_attention_model
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5        # the card's fp32 bar for the enhancer
B, H, W, C = 2, 8, 64, 64      # L = 512, the JAX kernel's minimum
KEY_TILE = 64                  # keys per K/V tile of the attention kernel
CASES = ("normal", "peaked")


def enhancer_tf32x3_model(tokens, ops, heads: int, products: int = 3,
                          eps: float = 1e-6):
    """The fp32 kernels' output on fp32 (B, L, 64) tokens and the operands
    of `enhancer_operands` (see the module docstring)."""
    mm = lambda a, w: _mm(a, w, products, small_first=False)
    d = ops["wout"].shape[0]
    qkv = mm(tokens, ops["wtop"]) + ops["peqkv"]
    q, k, v = qkv.split(d, dim=-1)
    attn = tf32x3_attention_model(q, k, v, heads, products=products,
                                  tile=KEY_TILE)
    x = torch.cat([tokens, ops["pe"].expand(tokens.shape[0], -1, -1)], -1)
    x1 = torch_layer_norm(x + (mm(attn, ops["wout"]) + ops["bout"]),
                          ops["ln1_scale"], ops["ln1_bias"], eps)
    h = torch.relu(mm(x1, ops["w1"]) + ops["b1"])
    y = mm(h, ops["w2"]) + ops["b2"]
    x2 = torch_layer_norm(x1 + y, ops["ln2_scale"], ops["ln2_bias"], eps)
    return mm(x2, ops["wp"]) + ops["bp"]


@functools.lru_cache(maxsize=None)
def _case(heads: int, case: str):
    """(tokens, the port's operands, JAX's output) for one case, from a
    seed: every weight random, LN scales away from 1."""
    jax = pytest.importorskip("jax")
    from fudanocr_tpu.models.sr.tbsrn import FeatureEnhancer
    from fudanocr_tpu.ops.fused_enhancer import fused_enhancer

    jnp = jax.numpy
    rng = np.random.default_rng(heads)
    init = FeatureEnhancer(height=H, width=W).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H * W, C)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * (0.5 if a.ndim == 1
                                                   else a.shape[0] ** -0.5)
                   + (1.0 if a.ndim == 1 else 0.0)).astype(np.float32), init)
    x = (rng.standard_normal((B, H * W, C))
         * (2.0 if case == "peaked" else 0.5)).astype(np.float32)
    pe = positional_encoding_2d(64, H, W).reshape(64, H * W).T.copy()
    want = np.asarray(fused_enhancer(jnp.asarray(x), jnp.asarray(pe),
                                     params, heads=heads))
    t = lambda a: torch.from_numpy(np.array(a))
    named = {"wqkv": params["mha"]["qkv"]["kernel"],
             "bqkv": params["mha"]["qkv"]["bias"],
             "wout": params["mha"]["out"]["kernel"],
             "bout": params["mha"]["out"]["bias"],
             "ln1_scale": params["ln1"]["scale"],
             "ln1_bias": params["ln1"]["bias"],
             "w1": params["pff_w1"]["kernel"], "b1": params["pff_w1"]["bias"],
             "w2": params["pff_w2"]["kernel"], "b2": params["pff_w2"]["bias"],
             "ln2_scale": params["ln2"]["scale"],
             "ln2_bias": params["ln2"]["bias"],
             "wp": params["proj"]["kernel"], "bp": params["proj"]["bias"]}
    ops = enhancer_operands({k: t(v) for k, v in named.items()}, t(pe),
                            torch.float32)
    return t(x), ops, t(want)


def _ratio(heads: int, case: str, products: int) -> float:
    """The model's largest error against JAX over the bar
    ATOL + RTOL |want|."""
    x, ops, want = _case(heads, case)
    got = enhancer_tf32x3_model(x, ops, heads, products)
    return ((got - want).abs() / (ATOL + RTOL * want.abs())).max().item()


PARAMS = [pytest.param(h, c, id=f"heads{h}-{c}") for h in (4, 2)
          for c in CASES]


@pytest.mark.parametrize("heads,case", PARAMS)
def test_split_tf32_model_matches_jax(heads, case):
    assert _ratio(heads, case, 3) <= 1.0


@pytest.mark.parametrize("heads,case", PARAMS)
def test_one_tf32_product_misses_the_bar(heads, case):
    assert _ratio(heads, case, 1) > 1.0


if __name__ == "__main__":
    for h in (4, 2):
        for c in CASES:
            print(h, c, {p: round(_ratio(h, c, p), 4) for p in (3, 1)})
