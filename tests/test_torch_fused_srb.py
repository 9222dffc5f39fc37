"""The port's whole-SRB route (fudanocr_tpu_torch/ops/fused_srb.py, B9, and
`TBSRN(fused_srb=True)`) against the JAX package on the CPU, on the same
seeded numpy inputs and weights:

* `fold_bn` equals the JAX `fold_bn` (fp32, 1e-6);
* `fused_srb_reference` equals the JAX Pallas kernel `fused_srb`, run in
  interpret mode as tests/test_fused_srb.py runs it (called directly: the
  JAX block's 8x8 parameter stub does not fit a 4-row map), on a small map
  (B 2, 4x16) and the gate's smallest (8x64): fp32 at 1e-5; bf16 at the
  JAX kernel's bars (atol 0.05, mean < 0.01);
* a whole `TBSRN(fused_srb=True)` (2 SRBs, LR 8x64) equals the JAX TBSRN
  with `fused_srb="force"` in fp32 at 1e-5, its blocks on the route;
* training ignores the flag: outputs and BN statistics are bit for bit
  those of `fused_srb=False`;
* the folded-operand cache follows the BN running statistics: after a
  train step, and after a train-mode forward that moves only the
  statistics, inference equals `fused_srb=False` on the same weights;
* the port's gate equals the JAX gate on a grid of (h, w, c, heads).

Tests marked `cuda` hold the kernels against the plain version on the card
and skip where there is none; they import no jax. Each launch is also held
against its plain twin on the same input: in bf16 r1 (`srb_conv_mish`), r
and qkv (`srb_conv_qkv`) each within one bf16 ulp of the fp32 value the
twin computes before it rounds (`bf16_ulp`), and a call runs three kernels
in bf16 and four in fp32 (by the profiler's kernel launches):

    python -m pytest tests/test_torch_fused_srb.py -m cuda --noconftest
"""

import itertools
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fudanocr_tpu_torch.models.sr import tbsrn as port_tbsrn
from fudanocr_tpu_torch.models.sr.tbsrn import TBSRN
from fudanocr_tpu_torch.nn.attention import positional_encoding_2d
from fudanocr_tpu_torch.ops.fused_enhancer import (enhancer_operands,
                                                   fused_enhancer)
from fudanocr_tpu_torch.ops import fused_srb as fs
from fudanocr_tpu_torch.ops.fused_srb import (fold_bn, fused_srb,
                                              fused_srb_reference,
                                              fused_srb_supported,
                                              srb_conv_mish, srb_conv_qkv,
                                              srb_operands)
from fudanocr_tpu_torch.train.sr import make_sr_train_step
from fudanocr_tpu_torch.train.state import adam_with_clip
from torch_threads import one_torch_thread  # noqa: F401

C = 64
FP32_TOL = 1e-5
BF16_ATOL, BF16_MEAN = 0.05, 0.01   # tests/test_fused_srb.py:49-50


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _bn_np(rng):
    return ({"scale": (1 + 0.2 * rng.standard_normal(C)).astype(np.float32),
             "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)},
            {"mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
             "var": (0.75 + 0.5 * rng.random(C)).astype(np.float32)})


def _oihw(hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(hwio).transpose(3, 2, 0, 1)))


def test_fold_bn_matches_jax(jx):
    from fudanocr_tpu.ops.fused_srb import fold_bn as jax_fold_bn

    rng = np.random.default_rng(0)
    kernel = (0.1 * rng.standard_normal((3, 3, C, C))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    bn_p, bn_s = _bn_np(rng)
    wj, bj = jax_fold_bn(kernel, bias, bn_p, bn_s)
    wt, bt = fold_bn(_oihw(kernel), torch.from_numpy(bias),
                     {k: torch.from_numpy(v) for k, v in
                      {**bn_p, **bn_s}.items()})
    np.testing.assert_allclose(wt.numpy(), _oihw(wj).numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6,
                               atol=1e-7)


def _jax_block_variables(jx, x, rng):
    """A JAX block's variables with BN statistics, BN affines and LN scales
    away from their initial values, as numpy arrays (made by the unfused
    block, whose tree is the fused one's, so that init does not run the
    kernel in interpret mode)."""
    jax, jnp = jx
    from fudanocr_tpu.models.sr.tbsrn import TransformerResidualBlock

    v = jax.tree_util.tree_map(np.asarray, TransformerResidualBlock(C).init(
        jax.random.PRNGKey(1), jnp.asarray(x)))
    for name in ("bn1", "bn2"):
        v["params"][name], v["batch_stats"][name] = _bn_np(rng)
    enh = v["params"]["enhancer"]
    for ln in ("ln1", "ln2"):
        enh[ln] = {"scale": (1 + 0.2 * rng.standard_normal(128)).astype(
            np.float32),
            "bias": (0.1 * rng.standard_normal(128)).astype(np.float32)}
    return v


def _port_operands(v, h, w, dtype):
    """`srb_operands` from the JAX block's variables."""
    p, st = v["params"], v["batch_stats"]
    e = p["enhancer"]
    t = lambda a: torch.from_numpy(np.array(a))
    params = {"wqkv": e["mha"]["qkv"]["kernel"],
              "bqkv": e["mha"]["qkv"]["bias"],
              "wout": e["mha"]["out"]["kernel"],
              "bout": e["mha"]["out"]["bias"],
              "ln1_scale": e["ln1"]["scale"], "ln1_bias": e["ln1"]["bias"],
              "w1": e["pff_w1"]["kernel"], "b1": e["pff_w1"]["bias"],
              "w2": e["pff_w2"]["kernel"], "b2": e["pff_w2"]["bias"],
              "ln2_scale": e["ln2"]["scale"], "ln2_bias": e["ln2"]["bias"],
              "wp": e["proj"]["kernel"], "bp": e["proj"]["bias"]}
    pe = torch.from_numpy(
        positional_encoding_2d(64, h, w).reshape(64, h * w).T.copy())
    enh = enhancer_operands({k: t(a) for k, a in params.items()}, pe, dtype)
    conv = lambda n: (_oihw(p[n]["kernel"]), t(p[n]["bias"]))
    bn = lambda n: {k: t(a) for k, a in {**p[n], **st[n]}.items()}
    return srb_operands(conv("conv1"), bn("bn1"), conv("conv2"), bn("bn2"),
                        enh, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(4, 16), (8, 64)])
def test_reference_matches_jax_kernel(jx, h, w, dtype):
    jax, jnp = jx
    from fudanocr_tpu.ops.fused_srb import fused_srb as jax_fused_srb

    rng = np.random.default_rng(h * w)
    x = (0.5 * rng.standard_normal((2, h, w, C))).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    v = _jax_block_variables(jx, x, rng)
    p = v["params"]
    pe = positional_encoding_2d(64, h, w).reshape(64, h * w).T
    xt = torch.from_numpy(x).to(dtype)
    want = np.asarray(jax_fused_srb(
        jnp.asarray(xt.float().numpy(), jdt),
        {k: p[k] for k in ("conv1", "bn1", "conv2", "bn2")},
        v["batch_stats"], p["enhancer"], jnp.asarray(pe, jdt), heads=4),
        np.float32)
    got = fused_srb_reference(xt, _port_operands(v, h, w, dtype))
    assert got.dtype == dtype and got.shape == xt.shape
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        assert float(np.mean(np.abs(got - want))) < BF16_MEAN


def _randomize_bn(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) * 0.5 + 0.75)
                m.weight.copy_(1 + torch.randn(n, generator=g) * 0.1)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)


def test_tbsrn_fused_srb_matches_jax(jx, monkeypatch):
    jax, jnp = jx
    from fudanocr_tpu.models.sr import TBSRN as JaxTBSRN
    from fudanocr_tpu_torch.utils.weights import load_jax_variables

    srb = 2
    rng = np.random.default_rng(7)
    lr = rng.random((1, 8, 64, 3)).astype(np.float32)
    kw = dict(scale_factor=2, width=128, height=16, stn=False,
              srb_nums=srb, hidden_units=32, wide_out_block=0)
    jm = JaxTBSRN(fused_srb="force", **kw)
    v = jax.tree_util.tree_map(np.asarray, JaxTBSRN(**kw).init(
        jax.random.PRNGKey(2), jnp.asarray(lr)))
    for st in v["batch_stats"].values():
        for bn in st.values():
            bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)
                          ).astype(np.float32)
            bn["var"] = (0.75 + 0.5 * rng.random(bn["var"].shape)
                         ).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(lr)))
    seen = []
    real = port_tbsrn.fused_srb
    monkeypatch.setattr(port_tbsrn, "fused_srb",
                        lambda x, *a, **k: seen.append(x.shape)
                        or real(x, *a, **k))
    m = load_jax_variables(TBSRN(width=128, height=16, stn=False,
                                 srb_nums=srb, fused_srb=True), "tbsrn", v,
                           srb_nums=srb, stn=False)
    with torch.inference_mode():
        got = m(torch.from_numpy(lr)).numpy()
    assert seen == [(1, 8, 64, C)] * srb
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def _pair(**kw):
    """(fused_srb=True, fused_srb=False) TBSRNs with one set of weights and
    non-trivial BN statistics: 2 SRBs, LR 8x64 (L = 512)."""
    torch.manual_seed(3)
    kw = dict(width=128, height=16, stn=False, srb_nums=2, **kw)
    a, b = TBSRN(fused_srb=True, **kw), TBSRN(fused_srb=False, **kw)
    _randomize_bn(a, 4)
    b.load_state_dict(a.state_dict())
    return a, b


def _lr(seed, n=2):
    return torch.rand(n, 8, 64, 3, generator=torch.Generator()
                      .manual_seed(seed))


def test_training_ignores_the_flag():
    """train=True takes the module path: the same output and BN statistics
    bit for bit as with the flag off (tests/test_fused_srb.py:53-65)."""
    a, b = _pair()
    x = _lr(5)
    ya = a(x, train=True, generator=torch.Generator().manual_seed(6))
    yb = b(x, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(ya, yb)
    for (name, sa), sb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(sa, sb), name


@pytest.mark.parametrize("update", ["train_step", "statistics_only"])
def test_inference_follows_the_bn_statistics(update):
    """The folded conv weights are cached; the cache must follow the BN
    running statistics, which training moves in place. `statistics_only`
    runs a train-mode forward without an update, so only the buffers
    change (a cache keyed on the parameters alone would miss it)."""
    a, b = _pair()
    x = _lr(8)
    with torch.inference_mode():
        before = a(x)
    stats = a.block2.bn1.running_mean.clone()
    gen = torch.Generator().manual_seed(9)
    if update == "train_step":
        step = make_sr_train_step(
            a, lambda sr, hr, *_: (F.mse_loss(sr, hr), {}),
            adam_with_clip(a.parameters(), 1e-3))
        hr = torch.rand(2, 16, 128, 3, generator=gen) * 2 - 1
        step({"lr": x, "hr": hr, "text_input": None, "text_gt": None,
              "lengths": None}, gen)
    else:
        with torch.no_grad():
            a(x, train=True, generator=gen)
    assert not torch.equal(a.block2.bn1.running_mean, stats)
    b.load_state_dict(a.state_dict())
    with torch.inference_mode():
        after, want = a(x), b(x)
    assert not torch.equal(after, before)
    torch.testing.assert_close(after, want, rtol=FP32_TOL, atol=FP32_TOL)


def test_gate_matches_jax(jx):
    from fudanocr_tpu.ops.fused_srb import \
        fused_srb_supported as jax_supported

    grid = list(itertools.product((1, 4, 8, 16, 32), (16, 32, 64, 100, 128),
                                  (32, 60, 64, 192), (1, 2, 4, 5)))
    for h, w, c, heads in grid:
        assert fused_srb_supported(h, w, c, heads) == \
            jax_supported(h, w, c, heads), (h, w, c, heads)
    assert sum(fused_srb_supported(*g) for g in grid) > 0


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _block_ops(device, dtype, h, w):
    blk = port_tbsrn.TransformerResidualBlock(C, fused_srb=True)
    _randomize_bn(blk, h * w)
    with torch.no_grad():
        for m in (blk.feature_enhancer.mul_layernorm1,
                  blk.feature_enhancer.mul_layernorm3):
            m.a_2.add_(0.2 * torch.randn(128))
    blk = blk.to(device).eval()
    return blk, blk.srb_operands(h, w, dtype, device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", [(2, 8, 64), (3, 16, 64), (2, 32, 32),
                                   (1, 2, 1024)])
def test_kernel_matches_plain_version(cuda, dtype, b, h, w):
    _, ops = _block_ops(cuda, dtype, h, w)
    gen = torch.Generator().manual_seed(b * h)
    x = (0.5 * torch.randn(b, h, w, C, generator=gen)).to(cuda, dtype)
    n0, e0 = fused_srb.launches, fused_enhancer.launches
    got = fused_srb(x, ops).float()
    torch.cuda.synchronize()
    assert fused_srb.launches == n0 + 1
    assert fused_enhancer.launches == e0       # B1's own count only
    want = fused_srb_reference(x, ops).float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    else:
        err = (got - want).abs()
        assert err.max() <= BF16_ATOL and err.mean() < BF16_MEAN


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of |v| (8 significant bits), |v| floored at 2^-8: below
    that the bar stays 2^-15, far above the fp32 reordering of the sums."""
    m = v.abs().clamp(min=2.0 ** -8)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _within_ulp(got: torch.Tensor, want32: torch.Tensor, what: str) -> None:
    err = (got.float() - want32).abs()
    bad = err > bf16_ulp(want32)
    assert not bad.any(), (f"{what}: {int(bad.sum())} elements beyond one "
                           f"bf16 ulp, max err {err.max().item():.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", [(2, 8, 64), (3, 16, 64), (2, 32, 32),
                                   (1, 2, 1024)])
def test_launches_match_their_plain_twins(cuda, dtype, b, h, w):
    _, ops = _block_ops(cuda, dtype, h, w)
    gen = torch.Generator().manual_seed(b * h + 1)
    x = (0.5 * torch.randn(b, h, w, C, generator=gen)).to(cuda, dtype)
    n0 = srb_conv_mish.launches, srb_conv_qkv.launches
    r1 = srb_conv_mish(x, ops)
    r, qkv = srb_conv_qkv(r1, ops)
    torch.cuda.synchronize()
    assert (srb_conv_mish.launches, srb_conv_qkv.launches) == \
        (n0[0] + 1, n0[1] + 1)
    assert r1.dtype == r.dtype == qkv.dtype == dtype
    assert qkv.shape == (b, h * w, 384)
    # the twins' fp32 values before they round, on the launches' inputs
    c1 = fs._conv_reference(x, ops["conv1_w"], ops["conv1_b"])
    r1_32 = c1 * torch.tanh(F.softplus(c1))
    r_32 = fs._conv_reference(r1, ops["conv2_w"], ops["conv2_b"])
    qkv_32 = r.reshape(b, h * w, C).float() @ ops["wtop"].float() \
        + ops["peqkv"]
    for got, want, what in ((r1, r1_32, "r1"), (r, r_32, "r"),
                            (qkv, qkv_32, "qkv")):
        assert torch.isfinite(got).all(), what
        if dtype == torch.bfloat16:
            _within_ulp(got, want, what)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _launches_per_call(fn, want: dict, calls: int = 3) -> dict:
    """Kernel launches per call of `fn` by kernel name (torch.profiler),
    the calls in the active step of a schedule after a warm-up step (as
    chip_smoke.py `profile_kernels` takes them); a trace that differs from
    `want` is taken again, at most twice."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def ready(prof):
        names.clear()
        for e in prof.key_averages():
            if e.device_type.name == "CUDA" and e.device_time_total > 0:
                name = re.split(r"[<(]", re.sub(
                    r"^void |\(anonymous namespace\)::", "", e.key))[0]
                names[name] = names.get(name, 0) + e.count / calls

    names = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=ready) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        if names == want:
            break
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, {"conv3x3_mish_wgmma_kernel": 1,
                      "conv3x3_qkv_wgmma_kernel": 1,
                      "attn_epilogue_kernel": 1}),
    (torch.float32, {"conv3x3_fma_kernel": 2, "qkv_proj_tf32x3_kernel": 1,
                     "attn_epilogue_tf32x3_kernel": 1})])
def test_a_call_runs_its_kernels(cuda, dtype, want):
    _, ops = _block_ops(cuda, dtype, 16, 64)
    x = torch.randn(2, 16, 64, C, device=cuda).to(dtype)
    assert _launches_per_call(lambda: fused_srb(x, ops), want) == want


@pytest.mark.cuda
def test_tbsrn_route_on_the_card(cuda):
    a, _ = _pair()
    plain = TBSRN(width=128, height=16, stn=False, srb_nums=2,
                  fused_srb=True, kernels=False)
    plain.load_state_dict(a.state_dict())
    a, plain = a.to(cuda).eval(), plain.to(cuda).eval()
    x = _lr(10, 4).to(cuda)
    n0 = fused_srb.launches
    with torch.inference_mode():
        got, want = a(x), plain(x)
    torch.cuda.synchronize()
    assert fused_srb.launches == n0 + 2
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    _, ops = _block_ops(cuda, torch.float32, 8, 64)
    x = torch.randn(1, 8, 64, C, device=cuda)
    with pytest.raises(TypeError):
        fused_srb(x.half(), ops)
    with pytest.raises(ValueError):             # NCHW memory, NHWC view
        fused_srb(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                  ops)
    with pytest.raises(ValueError):             # H*W outside the gate
        fused_srb(torch.randn(1, 4, 16, C, device=cuda), ops)
    with pytest.raises(ValueError):             # operands of another dtype
        fused_srb(x.bfloat16(), ops)
