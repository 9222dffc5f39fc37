"""The rounding points of the bidirectional GRU kernel (fudanocr_tpu_torch/
csrc/fused_gru.cu `bigru_tf32x3_kernel`: the input projections and the
recurrence on the tensor cores in split TF32) on the CPU, before any card
runs it.

`gru_tf32x3_model` is the kernel's arithmetic in plain torch: every operand
split into TF32 hi + lo (cvt.rna, tests/torch_attention_cases.py `tf32`),
per step each product from a zero accumulator, 8 columns a mma
(m16n8k8), the small products of every k-step first (x_lo W_hi and x_hi
W_lo; a bf16 x is exact in TF32, so only the latter: two products), then
x_hi W_hi, each mma's sum rounded toward zero as the tensor cores round it
(`_mma`), the biases and the gates in fp32 in the kernel's forms,
sigmoid(x) = 1 / (1 + e^-x) and tanh(x) = 1 - 2 / (1 + e^2x). It has
torch's exponential and IEEE division where the kernel has `__expf` and
`__fdividef`, a few ulp apart; the card tests' saturating cases
(tests/test_torch_tsrn.py `test_fused_bigru_x_kernel_saturating`,
chip_smoke.py phase 19c) hold those. It is held against JAX's
`BiGRU(fuse="force")` (fudanocr_tpu/nn/recurrent.py), whose recurrence is
the Pallas kernel `fused_bigru` in interpret mode, at H 32, C 64 (TSRN's
GRU), T 16 and 64, on standard-normal inputs at JAX's init scale and on a
saturating case (W_ih x10: |gate pre-activation| ~ 8 on average, up to
~50), fp32 and bf16 input, under the card's bar for the kernel against
its plain version: 1e-5 max abs in fp32 (chip_smoke.py GRU_ATOL). The
same model with one TF32 product (what a plain TF32 kernel computes)
misses the bar by more than 20x on every case: the tests tell the two
apart. Run as a script, this file prints each case's largest error for
three products, for one, and for products rounded once to fp32 (the
floor that fp32 itself sets at large pre-activations):

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests \\
        python tests/test_torch_gru_tf32x3_rounding.py
"""

import functools

import numpy as np
import pytest
import torch

from torch_attention_cases import _mma, tf32
from torch_threads import one_torch_thread  # noqa: F401

BAR = 1e-5             # chip_smoke.py GRU_ATOL, fp32
ROWS, C, H = 32, 64, 32
CASES = ("normal", "saturating")


def _split_mm(a: torch.Tensor, w: torch.Tensor, products: int) -> torch.Tensor:
    """a (M, K) @ w (N, K)^T from a zero accumulator, 8 columns of a per
    mma, the kernel's order: with `products` 3, a_lo w_hi and a_hi w_lo of
    every step, then a_hi w_hi; with 2 (a exact in TF32) the second and
    the third; with 1, a_hi w_hi alone; with 0, the exact product rounded
    once to fp32."""
    b = w.t()
    if products == 0:
        return (a.double() @ b.double()).float()
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    c = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    steps = range(0, a.shape[1], 8)
    for k0 in steps:
        if products == 3:
            c = _mma(c, al[:, k0:k0 + 8], bh[k0:k0 + 8])
        if products >= 2:
            c = _mma(c, ah[:, k0:k0 + 8], bl[k0:k0 + 8])
    for k0 in steps:
        c = _mma(c, ah[:, k0:k0 + 8], bh[k0:k0 + 8])
    return c


def gru_tf32x3_model(x: torch.Tensor, params: list, hidden: int,
                     products: int = 3) -> torch.Tensor:
    """The kernel's y (B', T, 2H) in fp32 for x (B', T, C) (fp32, or bf16
    values) and torch's parameters of both directions, (W_ih, b_ih, W_hh,
    b_hh) twice. `products` 3 is the kernel (two on a bf16 x); 1 is one
    TF32 product everywhere; 0 every product rounded once to fp32."""
    xf = x.float()
    x_products = 2 if x.dtype == torch.bfloat16 and products == 3 \
        else products
    outs = []
    for d, (wi, bi, wh, bh) in enumerate((params[:4], params[4:])):
        h = torch.zeros(x.shape[0], hidden)
        ys = [None] * x.shape[1]
        steps = range(x.shape[1])
        for t in (reversed(steps) if d else steps):
            p = _split_mm(xf[:, t], wi, x_products) + bi
            g = _split_mm(h, wh, products) + bh
            pr, pz, pn = p.split(hidden, -1)
            gr, gz, gn = g.split(hidden, -1)
            r = 1 / (1 + torch.exp(-(pr + gr)))
            z = 1 / (1 + torch.exp(-(pz + gz)))
            n = 1 - 2 / (1 + torch.exp(2 * (pn + r * gn)))
            h = (1 - z) * n + z * h
            ys[t] = h
        outs.append(torch.stack(ys, 1))
    return torch.cat(outs, -1)


@functools.lru_cache(maxsize=None)
def _case(case: str, t_len: int, dtype: str):
    """x, torch-layout parameters and JAX's fp32 y (its BiGRU with fuse
    "force": the Pallas kernel in interpret mode) from a seed."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from fudanocr_tpu.nn.recurrent import BiGRU as JaxBiGRU

    rng = np.random.default_rng(t_len + len(case))
    x = jnp.asarray(rng.standard_normal((ROWS, t_len, C)).astype(
        np.float32)).astype(dtype)
    jm = JaxBiGRU(H, fuse="force", dtype=jnp.float32)
    p = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(t_len), x)["params"])
    for k in ("bi_fwd", "bh_fwd", "bi_bwd", "bh_bwd"):   # inits are 0
        p[k] = (rng.standard_normal(3 * H) * 0.1).astype(np.float32)
    if case == "saturating":
        for k in ("wi_fwd", "wi_bwd"):
            p[k] = p[k] * 10
    want = np.asarray(jm.apply({"params": p}, x))
    params = []
    for d in ("fwd", "bwd"):
        params += [torch.from_numpy(np.ascontiguousarray(p[f"{n}_{d}"].T))
                   if n.startswith("w") else torch.from_numpy(p[f"{n}_{d}"])
                   for n in ("wi", "bi", "wh", "bh")]
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return xt, params, torch.from_numpy(np.array(want))


PARAMS = [pytest.param(c, t, dt, id=f"{c}-T{t}-{dt}") for c in CASES
          for t in (16, 64) for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("case,t_len,dtype", PARAMS)
def test_split_tf32_model_matches_jax(case, t_len, dtype):
    x, params, want = _case(case, t_len, dtype)
    if case == "saturating":   # the pre-activations are what the case says
        pre = (x.float().reshape(-1, C) @ params[0].t()).abs()
        assert pre.mean() > 5 and pre.max() > 30
    y = gru_tf32x3_model(x, params, H)
    assert y.shape == (ROWS, t_len, 2 * H) and torch.isfinite(y).all()
    assert (y - want).abs().max().item() <= BAR


@pytest.mark.parametrize("case,t_len,dtype", PARAMS)
def test_one_tf32_product_misses_the_bar(case, t_len, dtype):
    x, params, want = _case(case, t_len, dtype)
    y = gru_tf32x3_model(x, params, H, products=1)
    assert (y - want).abs().max().item() > 20 * BAR


if __name__ == "__main__":
    for case, t_len, dtype in ((p.values) for p in PARAMS):
        x, params, want = _case(case, t_len, dtype)
        errs = {n: (gru_tf32x3_model(x, params, H, products=n) - want)
                .abs().max().item() for n in (3, 1, 0)}
        print(f"{case} T {t_len} {dtype}: max abs error against JAX, three "
              f"products {errs[3]:.3e}, one {errs[1]:.3e}, fp32-rounded "
              f"products {errs[0]:.3e} (bar {BAR})")
