"""Guards for the PyTorch port (fudanocr_tpu_torch): what it may import,
how the smoke script fails without a card, how the kernel wrappers pick
their path, and how the kernel build behaves."""

import ast
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fudanocr_tpu_torch import serving
from fudanocr_tpu_torch.apps.seg import inference as seg_inference
from fudanocr_tpu_torch.ops import _build
from fudanocr_tpu_torch.ops import flash_attention as fa
from fudanocr_tpu_torch.ops import region_attention as ra
from fudanocr_tpu_torch.ops.fused_enhancer import (enhancer_operands,
                                                   fused_enhancer,
                                                   fused_enhancer_reference)
from fudanocr_tpu_torch.ops.fused_layernorm import (
    fused_residual_layernorm, fused_residual_layernorm_reference)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "fudanocr_tpu_torch"
ALLOWED_JAX_PACKAGE = frozenset()   # the port imports nothing of it
FORBIDDEN = ("jax", "jaxlib", "flax", "PIL", "optax", "cv2", "msgpack")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _bad_imports(path: Path, allowed=frozenset()):
    bad = []
    for name in _imports(path):
        top = name.split(".")[0]
        if top in FORBIDDEN or (top == "fudanocr_tpu"
                                and name not in allowed):
            bad.append(name)
    return bad


def test_port_imports_no_jax_flax_pil_or_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): _bad_imports(f, ALLOWED_JAX_PACKAGE)
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_chip_smoke_imports_nothing_of_jax():
    assert not _bad_imports(ROOT / "chip_smoke.py")


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke test would run")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied without the package it cannot pass, on any host."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _ops(dtype=torch.float32, h=4, w=8):
    gen = torch.Generator().manual_seed(0)
    d = 128
    shapes = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wout": (d, d),
              "bout": (d,), "ln1_scale": (d,), "ln1_bias": (d,), "w1": (d, d),
              "b1": (d,), "w2": (d, d), "b2": (d,), "ln2_scale": (d,),
              "ln2_bias": (d,), "wp": (d, 64), "bp": (64,)}
    params = {k: torch.randn(*s, generator=gen) * 0.1
              for k, s in shapes.items()}
    return enhancer_operands(params, torch.randn(h * w, 64, generator=gen),
                             dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    ops = _ops(dtype)
    x = torch.randn(2, 32, 64).to(dtype)
    n0 = fused_enhancer.launches
    got = fused_enhancer(x, ops)
    assert torch.equal(got, fused_enhancer_reference(x, ops))
    assert got.dtype == dtype and got.shape == (2, 32, 64)
    assert fused_enhancer.launches == n0   # no kernel ran


def test_wrapper_refuses_devices_without_a_kernel():
    ops = {k: v.to("meta") for k, v in _ops().items()}
    with pytest.raises(ValueError):
        fused_enhancer(torch.empty(2, 32, 64, device="meta"), ops)


def _launch_counts():
    return (fused_residual_layernorm.launches, fa.qkv_dropout_fwd.launches,
            fa.qkv_dropout_bwd.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_wrappers_on_cpu_are_the_plain_versions(dtype):
    """On CPU tensors the residual-LayerNorm and dropout-attention wrappers
    run their plain versions (forward and backward) and launch nothing."""
    gen = torch.Generator().manual_seed(0)
    n0 = _launch_counts()
    x, r = (torch.randn(6, 128, generator=gen).to(dtype) for _ in range(2))
    s, b = torch.randn(128, generator=gen), torch.randn(128, generator=gen)
    got = fused_residual_layernorm(x, r, s, b)
    assert torch.equal(got, fused_residual_layernorm_reference(x, r, s, b))
    qkv = torch.randn(1, 256, 192, generator=gen).to(dtype).requires_grad_()
    out = fa.flash_mha_qkv_packed_dropout(qkv, 3, 2, 0.1)
    assert torch.equal(out, fa.flash_mha_qkv_packed_dropout_reference(
        qkv, 3, 2, 0.1))
    out.float().sum().backward()
    assert qkv.grad.shape == qkv.shape and out.dtype == dtype
    assert _launch_counts() == n0


def test_training_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError):
        fused_residual_layernorm(x, x, torch.empty(128, device="meta"),
                                 torch.empty(128, device="meta"))
    with pytest.raises(ValueError):
        fa.flash_mha_qkv_packed_dropout(
            torch.empty(1, 512, 384, device="meta"), 1, 4, 0.1)


def _unmasked_counts():
    return (ra.unmasked_packed_fwd.launches, fa.unmasked_bhld_fwd.launches,
            ra.region_packed_fwd.launches, ra.unmasked_packed_bwd.launches,
            ra.region_packed_bwd.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unmasked_attention_wrappers_on_cpu_are_the_plain_versions(dtype):
    """On CPU tensors `packed_flash_mha` and `flash_mha` run their plain
    versions and launch nothing."""
    gen = torch.Generator().manual_seed(1)
    n0 = _unmasked_counts()
    q = torch.randn(2, 256, 64, generator=gen).to(dtype)
    kv = torch.randn(2, 128, 128, generator=gen).to(dtype)
    k, v = kv[..., :64], kv[..., 64:]
    got = ra.packed_flash_mha(q, k, v, 2)
    assert torch.equal(got, ra.packed_flash_mha_reference(q, k, v, 2))
    assert got.dtype == dtype and got.shape == (2, 256, 64)
    qh, kh, vh = (t.unflatten(-1, (2, 32)).transpose(1, 2) for t in (q, k, v))
    got = fa.flash_mha(qh, kh, vh)
    assert torch.equal(got, fa.flash_mha_reference(qh, kh, vh))
    assert got.dtype == dtype and got.shape == (2, 2, 256, 32)
    assert _unmasked_counts() == n0


def test_attention_gradients_on_cpu_run_the_plain_versions():
    """With a gradient to take, CPU tensors still run the plain forwards
    (autograd differentiates them) and launch nothing."""
    gen = torch.Generator().manual_seed(2)
    n0 = _unmasked_counts()
    q = torch.randn(2, 256, 64, generator=gen).requires_grad_()
    kv = torch.randn(2, 128, 128, generator=gen).requires_grad_()
    k, v = kv[..., :64], kv[..., 64:]
    rq, rkv = torch.zeros(2, 256), torch.zeros(2, 128)
    for o in (ra.packed_flash_mha(q, k, v, 2),
              ra.region_flash_mha(q, k, v, rq, rkv, 2),
              fa.flash_mha(*(t.unflatten(-1, (2, 32)).transpose(1, 2)
                             for t in (q, k, v)))):
        o.sum().backward()
    assert q.grad.shape == q.shape and kv.grad.shape == kv.shape
    assert _unmasked_counts() == n0


def test_attention_functions_have_no_cpu_fallback():
    """The autograd Functions behind the CUDA routes launch kernels only:
    handed CPU tensors they raise, they never run the plain versions."""
    q = torch.randn(1, 1024, 64, requires_grad=True)
    k = torch.randn(1, 256, 64, requires_grad=True)
    n0 = _unmasked_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ra._PackedAttention.apply(q, k, k, None, None, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ra._PackedAttention.apply(q, k, k, torch.zeros(1, 1024),
                                  torch.zeros(1, 256), 2)
    qh, kh = (t.unflatten(-1, (2, 32)).transpose(1, 2) for t in (q, k))
    with pytest.raises(ValueError, match="CUDA"):
        fa._FlashMHA.apply(qh, kh, kh)
    assert _unmasked_counts() == n0


def test_qkv_attention_and_gru_wrappers_on_cpu_are_the_plain_versions():
    """`flash_mha_qkv_packed` (B3) and `fused_bigru` (B8) on CPU tensors
    run their plain versions, forward and (B3) backward, and launch
    nothing."""
    from fudanocr_tpu_torch.ops import fused_gru as fg

    gen = torch.Generator().manual_seed(3)
    n0 = (fa.flash_mha_qkv_packed.launches, fg.fused_bigru.launches,
          _unmasked_counts())
    qkv = torch.randn(2, 512, 192, generator=gen).requires_grad_()
    out = fa.flash_mha_qkv_packed(qkv, 2)
    assert torch.equal(out, fa.flash_mha_qkv_packed_reference(qkv, 2))
    out.sum().backward()
    assert qkv.grad.shape == qkv.shape
    args = [torch.randn(*s, generator=gen) for s in (
        (256, 4, 24), (256, 4, 24), (8, 24), (24,), (8, 24), (24,))]
    got = fg.fused_bigru(*args, 8)
    assert torch.equal(got, fg.fused_bigru_reference(*args, 8))
    assert got.shape == (256, 4, 16)
    assert (fa.flash_mha_qkv_packed.launches, fg.fused_bigru.launches,
            _unmasked_counts()) == n0


def test_qkv_attention_and_gru_wrappers_refuse_devices_without_a_kernel():
    from fudanocr_tpu_torch.ops import fused_gru as fg

    with pytest.raises(ValueError):
        fa.flash_mha_qkv_packed(torch.empty(1, 512, 384, device="meta"), 4)
    x = torch.empty(256, 4, 96, device="meta")
    w, b = torch.empty(32, 96, device="meta"), torch.empty(96, device="meta")
    with pytest.raises(ValueError):
        fg.fused_bigru(x, x, w, b, w, b, 32)


def test_x_level_gru_wrapper_on_cpu_is_the_plain_version():
    """`fused_bigru_x` (B8 with its projections) on CPU tensors runs its
    plain version (x's dtype out, or fp32 when asked) and launches
    nothing; on a device without a kernel it raises."""
    from fudanocr_tpu_torch.ops import fused_gru as fg

    gen = torch.Generator().manual_seed(4)
    n0 = fg.fused_bigru.launches
    params = [torch.randn(*s, generator=gen) * 0.3 for s in (
        (24, 16), (24,), (24, 8), (24,)) * 2]
    x = torch.randn(256, 4, 16, generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        got = fg.fused_bigru_x(x.to(dt), *params, 8)
        assert got.dtype == dt and got.shape == (256, 4, 16)
        assert torch.equal(got, fg.fused_bigru_x_reference(x.to(dt), *params,
                                                           8))
    got = fg.fused_bigru_x(x.bfloat16(), *params, 8, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert fg.fused_bigru.launches == n0
    with pytest.raises(ValueError):
        fg.fused_bigru_x(x.to("meta"), *(t.to("meta") for t in params), 8)


def test_seg_trainer_runs_on_the_model_device():
    """SegTrainer takes its device from the model's parameters (the port's
    entry points put models on the card) and moves each batch there."""
    from fudanocr_tpu_torch.train.seg import SegTrainer

    model, _ = seg_inference.init_segmentor(
        "configs/seg/textformer_b0_textseg.yaml", device="meta",
        overrides=("model.backbone.embed_dims=8",
                   "model.backbone.num_layers=[1, 1, 1, 1]",
                   "model.decode_head.channels=32"))
    trainer = SegTrainer(model, None, None)
    assert trainer.device == torch.device("meta")
    batch = trainer._device_batch({"img": np.zeros((1, 4, 4, 3), np.float32),
                                   "gt_seg": np.zeros((1, 4, 4), np.int32)})
    assert all(t.device.type == "meta" for t in batch.values())


def test_unmasked_attention_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty(1, 1024, 64, device="meta")
    k = torch.empty(1, 256, 64, device="meta")
    with pytest.raises(ValueError):
        ra.packed_flash_mha(q, k, k, 2)
    with pytest.raises(ValueError):
        fa.flash_mha(q.view(1, 1024, 2, 32).transpose(1, 2),
                     k.view(1, 256, 2, 32).transpose(1, 2),
                     k.view(1, 256, 2, 32).transpose(1, 2))


@pytest.mark.parametrize("entry", [serving.PixelsToStrings,
                                   serving.InferenceServer,
                                   seg_inference.init_segmentor])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def _fake_nvcc(tmp_path, monkeypatch, script: str):
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")


def test_build_reports_nvcc_errors(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch,
               'echo "fused_enhancer.cu(1): error: boom" >&2\nexit 2\n')
    with pytest.raises(RuntimeError, match="boom"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    # a stand-in compiler: writes its -o argument
    _fake_nvcc(tmp_path, monkeypatch, 'while [ "$1" != "-o" ]; do shift; '
               'done\necho lib > "$2"\n')
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    path, seconds = _build.build()
    assert path.exists() and path.parent == tmp_path / "build"
    assert _build.build() == (path, 0.0)       # built once per source hash
    (csrc / "k.cu").write_text("// v2\n")
    assert _build.library_path() != path
