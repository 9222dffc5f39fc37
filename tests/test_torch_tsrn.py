"""TSRN parity: the PyTorch port (models/sr/tsrn.py, nn/recurrent.py,
ops/fused_gru.py) against the JAX package on the CPU, on the same seeded
numpy inputs and the same weights (moved with
fudanocr_tpu_torch.utils.weights.load_jax_variables), fp32.

* TSRN at eval, STN off (LR 8x16) and on (LR 16x64, the TextZoom LR
  size, which the STN head's fc1 width is built for), against JAX `TSRN(fused_gru=False)`, atol 2e-4; the port
  once on cuDNN's route and once on the fused route (the B8 twin on the
  CPU);
* TSRN in train mode (tests/test_torch_tsrn_train.py, a file of its own
  so that the two spread over the workers): the output, the BatchNorm
  statistics after the forward and every gradient against `jax.grad`,
  rel 1e-3;
* the B8 twin against the JAX Pallas kernel `fused_bigru` in interpret
  mode at H 32, T 16 and T 64, rtol 1e-5 / atol 1e-6
  (tests/test_fused_gru.py's bar), and `BiGRU` on both routes against
  the JAX scan (the fused route is the x-level plain version
  `fused_bigru_x_reference`, at C 24 / H 16 and at TSRN's C 64 / H 32,
  also on bf16 input against JAX's bf16 `BiGRU`);
* the `tsrn` porter against the JAX package's, bit for bit, and the round
  trip through `to_jax_variables`.

Tests marked `cuda` hold the kernel (csrc/fused_gru.cu, both entries)
against the twins on the card and skip where there is none; they import
no jax:

    python -m pytest tests/test_torch_tsrn.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch.models.sr import TSRN
from fudanocr_tpu_torch.nn import recurrent
from fudanocr_tpu_torch.nn.recurrent import BiGRU
from fudanocr_tpu_torch.ops import fused_gru as fg
from fudanocr_tpu_torch.utils.weights import (load_jax_variables,
                                              to_jax_variables)
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4   # the module-parity bar (ROADMAP.md, tests/test_torch_port.py)
SRB, HIDDEN = 2, 8
# (stn, LR (h, w), batch): the batch makes gru1's rows (batch * w) a
# multiple of 256, so the fused route runs there
CASES = [(False, (8, 16), 16), (True, (16, 64), 4)]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fudanocr_tpu.models.sr import TSRN as JaxTSRN
    return jax, jnp, JaxTSRN


def _randomize(jax, variables, rng):
    """Non-trivial BN statistics and scales (inits are 0 / 1)."""
    def leaf(path, a):
        key = path[-1].key
        if key == "var":
            return (rng.random(a.shape) * 0.5 + 0.75).astype(np.float32)
        if key in ("mean", "bias") and a.ndim == 1:
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if key == "scale":
            return (1 + rng.standard_normal(a.shape) * 0.2).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _setup(jx, stn, hw, batch, seed):
    jax, jnp, JaxTSRN = jx
    h, w = hw
    jm = JaxTSRN(scale_factor=2, width=2 * w, height=2 * h, stn=stn,
                 srb_nums=SRB, hidden_units=HIDDEN)
    rng = np.random.default_rng(seed)
    x = rng.random((batch, h, w, 3)).astype(np.float32)
    v = _randomize(jax, jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.asarray(x))), rng)
    if stn:   # a warp visibly off the identity
        v["params"]["stn_head"]["fc2"]["kernel"] = (
            rng.standard_normal((512, 40)) * 1e-3).astype(np.float32)
    return jm, v, x


def _port(v, stn, hw, **kw):
    h, w = hw
    m = TSRN(scale_factor=2, width=2 * w, height=2 * h, stn=stn,
             srb_nums=SRB, hidden_units=HIDDEN, **kw)
    return load_jax_variables(m, "tsrn", v, srb_nums=SRB, stn=stn)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("stn,hw,batch", CASES)
def test_tsrn_matches_jax(jx, monkeypatch, stn, hw, batch, fused):
    jm, v, x = _setup(jx, stn, hw, batch, seed=1)
    jnp = jx[1]
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    calls = []
    real = recurrent.fused_bigru_x
    monkeypatch.setattr(recurrent, "fused_bigru_x",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    m = _port(v, stn, hw, fused_gru=fused)
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, 2 * hw[0], 2 * hw[1], 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=ATOL)
    # gru1 of each block passes the rows gate, gru2 (batch * h rows) not;
    # the kernel takes the block's input, 2 * HIDDEN features
    assert calls == ([(batch * hw[1], hw[0], 2 * HIDDEN)] * SRB if fused
                     else [])


def _leaves(jax, tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("t_len", [16, 64])
def test_fused_bigru_twin_matches_jax_kernel(jx, t_len):
    """The JAX Pallas kernel in interpret mode (few rows: interpret mode is
    slow) against the twin, H 32."""
    jax, jnp, _ = jx
    from fudanocr_tpu.ops.fused_gru import fused_bigru as jax_fused_bigru

    rows, h = 8, 32
    rng = np.random.default_rng(t_len)
    xf, xb = (rng.standard_normal((rows, t_len, 3 * h)).astype(np.float32)
              for _ in range(2))
    whf, whb = (rng.standard_normal((h, 3 * h)).astype(np.float32) * 0.2
                for _ in range(2))
    bhf, bhb = (rng.standard_normal(3 * h).astype(np.float32) * 0.1
                for _ in range(2))
    want = np.asarray(jax_fused_bigru(*(jnp.asarray(a) for a in (
        xf, xb, whf, bhf, whb, bhb)), h))
    got = fg.fused_bigru(*(torch.from_numpy(a) for a in (
        xf, xb, whf, bhf, whb, bhb)), h).numpy()
    assert got.shape == (rows, t_len, 2 * h)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def bf16_rounding_of(got: torch.Tensor, want32: torch.Tensor,
                     atol: float) -> None:
    """Assert that the bf16 `got` is fp32 `want32` rounded to nearest even
    after an error of at most `atol`: between the roundings of want32 -
    atol and want32 + atol (rounding is monotone), so equal to
    bf16(want32) wherever those two agree."""
    assert got.dtype == torch.bfloat16
    lo, hi = ((want32 + d).to(torch.bfloat16) for d in (-atol, atol))
    assert ((lo <= got) & (got <= hi)).all()
    firm = lo == hi
    assert firm.float().mean() > 0.9
    assert torch.equal(got[firm], want32.to(torch.bfloat16)[firm])


@pytest.mark.parametrize("route,cin,h,dtype", [
    pytest.param("gru", 24, 16, "float32", id="gru"),
    pytest.param("twin", 24, 16, "float32", id="twin"),
    pytest.param("twin", 64, 32, "float32", id="twin-c64-h32"),
    pytest.param("twin", 64, 32, "bfloat16", id="twin-c64-h32-bf16")])
def test_bigru_matches_jax_scan(jx, route, cin, h, dtype):
    """The port's BiGRU on cuDNN's route (torch's GRU on the CPU) and on
    the fused route (the x-level twin, `fused_bigru_x_reference`) against
    the JAX BiGRU's lax.scan; bf16 input against JAX's bf16 BiGRU (its
    output rounded from fp32 within the fp32 bar)."""
    jax, jnp, _ = jx
    from fudanocr_tpu.nn.recurrent import BiGRU as JaxBiGRU

    rows, t_len = 256, 12
    x = np.random.default_rng(5).standard_normal(
        (rows, t_len, cin)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    jm = JaxBiGRU(h)
    v = jm.init(jax.random.PRNGKey(6), xj)
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    rng = np.random.default_rng(6)
    for k in ("bi_fwd", "bh_fwd", "bi_bwd", "bh_bwd"):   # inits are 0
        p[k] = (rng.standard_normal(3 * h) * 0.1).astype(np.float32)
    want = np.asarray(JaxBiGRU(h, dtype=jnp.float32).apply({"params": p},
                                                           xj))
    m = BiGRU(cin, h, fuse=route == "twin")
    calls = []
    real = recurrent.fused_bigru_x
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(recurrent, "fused_bigru_x",
                   lambda *a: calls.append(a[0].dtype) or real(*a))
        for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
            getattr(m, f"weight_ih_l0{sfx}").copy_(torch.from_numpy(
                p[f"wi_{d}"].T.copy()))
            getattr(m, f"weight_hh_l0{sfx}").copy_(torch.from_numpy(
                p[f"wh_{d}"].T.copy()))
            getattr(m, f"bias_ih_l0{sfx}").copy_(torch.from_numpy(
                p[f"bi_{d}"]))
            getattr(m, f"bias_hh_l0{sfx}").copy_(torch.from_numpy(
                p[f"bh_{d}"]))
        got = m(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert calls == ([getattr(torch, dtype)] if route == "twin" else [])
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        want_bf16 = np.asarray(jm.apply({"params": p}, xj).astype(
            jnp.float32))
        want32 = torch.from_numpy(want)
        bf16_rounding_of(got, want32, 1e-5)
        bf16_rounding_of(torch.from_numpy(want_bf16).to(torch.bfloat16),
                         want32, 0.0)


def test_tsrn_porter_round_trip(jx):
    """The port's `tsrn` porter equals the JAX package's on the port's
    state_dict, and JAX variables -> module -> JAX variables is exact."""
    jax = jx[0]
    from fudanocr_tpu.utils import torch_port

    _, v, _ = _setup(jx, True, (16, 64), 2, seed=7)
    m = _port(v, True, (16, 64))
    sd = {k: t.numpy() for k, t in m.state_dict().items()}
    mine = to_jax_variables(m, "tsrn", srb_nums=SRB, stn=True)
    theirs = torch_port.port_tsrn(sd, srb_nums=SRB, stn=True)
    for got, want in ((mine, theirs), (mine, v)):
        g, w = _leaves(jax, got), _leaves(jax, want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_state_dict_keeps_reference_layout():
    keys = set(TSRN(srb_nums=SRB, stn=True).state_dict())
    for k in ("block1.0.weight", "block1.1.weight", "block2.conv1.weight",
              "block2.bn1.running_var", "block3.gru1.conv1.weight",
              "block3.gru1.gru.weight_ih_l0",
              "block2.gru2.gru.bias_hh_l0_reverse", "block4.0.weight",
              "block4.1.running_mean", "block5.0.conv.weight",
              "block5.1.weight", "stn_head.stn_fc2.bias"):
        assert k in keys, k


@pytest.mark.parametrize("fuse,train,rows,hidden,want", [
    (True, False, 256, 8, 1), (False, False, 256, 8, 0),
    (True, True, 256, 8, 0), (True, False, 128, 8, 0),
    (True, False, 256, 40, 0)])
def test_bigru_route_gate(monkeypatch, fuse, train, rows, hidden, want):
    """The fused route needs fuse on, eval, JAX's gate (rows % 256, 2 <= T
    <= 128) and a hidden size the kernel takes (40 is JAX's, not the
    kernel's)."""
    calls = []
    real = recurrent.fused_bigru_x
    monkeypatch.setattr(recurrent, "fused_bigru_x",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    with torch.no_grad():
        BiGRU(8, hidden, fuse=fuse)(torch.randn(rows, 4, 8), train)
    assert len(calls) == want


@pytest.mark.parametrize("cin,want", [(8, 1), (64, 1), (12, 0), (72, 0)])
def test_bigru_route_gate_input_width(monkeypatch, cin, want):
    """The fused route also needs an input width the kernel's projection
    takes: a multiple of 8 up to 64."""
    calls = []
    real = recurrent.fused_bigru_x
    monkeypatch.setattr(recurrent, "fused_bigru_x",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    with torch.no_grad():
        y = BiGRU(cin, 8, fuse=True)(torch.randn(256, 4, cin))
    assert len(calls) == want and y.shape == (256, 4, 16)


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t_len,hidden", [(4096, 64, 32),
                                               (1000, 16, 32),
                                               (256, 8, 8), (512, 3, 24)])
def test_fused_bigru_kernel_matches_twin(cuda, rows, t_len, hidden):
    gen = torch.Generator().manual_seed(rows + t_len)
    xf, xb = (torch.randn(rows, t_len, 3 * hidden, generator=gen).to(cuda)
              for _ in range(2))
    whf, whb = ((torch.randn(hidden, 3 * hidden, generator=gen) * 0.3)
                .to(cuda) for _ in range(2))
    bhf, bhb = ((torch.randn(3 * hidden, generator=gen) * 0.1).to(cuda)
                for _ in range(2))
    n0 = fg.fused_bigru.launches
    got = fg.fused_bigru(xf, xb, whf, bhf, whb, bhb, hidden)
    torch.cuda.synchronize()
    assert fg.fused_bigru.launches == n0 + 1
    want = fg.fused_bigru_reference(xf, xb, whf, bhf, whb, bhb, hidden)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_fused_bigru_rejects_what_it_cannot_take(cuda):
    x = torch.randn(256, 8, 96, device=cuda)
    w = torch.randn(32, 96, device=cuda)
    b = torch.randn(96, device=cuda)
    with pytest.raises(ValueError):
        fg.fused_bigru(x.double(), x, w, b, w, b, 32)        # dtype
    with pytest.raises(ValueError):
        fg.fused_bigru(x[:, ::2], x[:, ::2], w, b, w, b, 32)  # contiguity
    x40 = torch.randn(256, 8, 120, device=cuda)
    w40 = torch.randn(40, 120, device=cuda)
    b40 = torch.randn(120, device=cuda)
    with pytest.raises(ValueError):
        fg.fused_bigru(x40, x40, w40, b40, w40, b40, 40)    # hidden 40


def _gru_params(gen, c: int, hidden: int, device) -> list:
    """torch's GRU parameters of both directions at torch's init scale,
    U(-1/sqrt(H), 1/sqrt(H)), in `fused_bigru_x`'s order."""
    shapes = ((3 * hidden, c), (3 * hidden,), (3 * hidden, hidden),
              (3 * hidden,)) * 2
    return [((torch.rand(s, generator=gen) * 2 - 1) * hidden ** -0.5)
            .to(device) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,t_len,c,hidden", [
    (4096, 64, 64, 32), (16384, 16, 64, 32), (1000, 16, 64, 32),
    (256, 8, 16, 8), (512, 3, 48, 24)])
def test_fused_bigru_x_kernel_matches_twin(cuda, rows, t_len, c, hidden,
                                           dtype):
    """The x-level kernel (projections and recurrence) against its plain
    version: fp32 output within 1e-5 (the kernel's fp32 arithmetic, also
    on bf16 input), and on bf16 input the bf16 output that fp32 rounds to
    after an error of at most 1e-5."""
    gen = torch.Generator().manual_seed(rows + t_len + c)
    x = torch.randn(rows, t_len, c, generator=gen).to(cuda,
                                                      getattr(torch, dtype))
    _x_kernel_matches_twin(x, _gru_params(gen, c, hidden, cuda), hidden)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,t_len", [(4096, 64), (16384, 16)])
def test_fused_bigru_x_kernel_saturating(cuda, rows, t_len, dtype):
    """As `test_fused_bigru_x_kernel_matches_twin` at TSRN's shapes with
    W_ih x10: |gate pre-activation| ~ 6.5 on average, up to ~50, where the
    kernel's fast exponential and division are furthest from the plain
    version's (tests/test_torch_gru_tf32x3_rounding.py models the rest)."""
    gen = torch.Generator().manual_seed(rows + t_len + 10)
    x = torch.randn(rows, t_len, 64, generator=gen).to(cuda,
                                                       getattr(torch, dtype))
    params = _gru_params(gen, 64, 32, cuda)
    for i in (0, 4):
        params[i] *= 10
    pre = (x.float().reshape(-1, 64) @ params[0].t()).abs()
    assert pre.mean() > 5 and pre.max() > 30
    _x_kernel_matches_twin(x, params, 32)


def _x_kernel_matches_twin(x, params, hidden: int) -> None:
    n0 = fg.fused_bigru.launches
    got = fg.fused_bigru_x(x, *params, hidden, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fg.fused_bigru.launches == n0 + 1
    want = fg.fused_bigru_x_reference(x, *params, hidden,
                                      out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if x.dtype == torch.bfloat16:
        bf16_rounding_of(fg.fused_bigru_x(x, *params, hidden), want, 1e-5)


@pytest.mark.cuda
def test_fused_bigru_x_rejects_what_it_cannot_take(cuda):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(256, 8, 64, device=cuda)
    params = _gru_params(gen, 64, 32, cuda)
    for bad in (x.half(), x.double(), x[:, ::2], x[..., :60],
                x.transpose(0, 1)):
        with pytest.raises(ValueError):
            fg.fused_bigru_x(bad, *params, 32)         # dtype, layout, C
    with pytest.raises(ValueError):                    # C 72
        fg.fused_bigru_x(torch.randn(256, 8, 72, device=cuda),
                         *_gru_params(gen, 72, 32, cuda), 32)
    with pytest.raises(ValueError):                    # hidden 40
        fg.fused_bigru_x(x, *_gru_params(gen, 64, 40, cuda), 40)
    with pytest.raises(ValueError):                    # a transposed W_hh
        fg.fused_bigru_x(x, *params[:2], params[2].t(), *params[3:], 32)
    for out in (torch.float16, torch.bfloat16):         # fp16, bf16 of fp32
        with pytest.raises(ValueError):
            fg.fused_bigru_x(x, *params, 32, out_dtype=out)
