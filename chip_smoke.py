"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (fudanocr_tpu_torch) once on the card and fails
loudly: it exits non-zero, and prints no result line, when there is no
CUDA device, when a kernel does not build, launch or agree with its plain
PyTorch version, or when any phase's check fails.

Phases:
  0. build the hand-written kernels from fudanocr_tpu_torch/csrc/ (nvcc);
  1. the fused-enhancer kernel against its plain version at the main-path
     shape (L=1024, C=64; B=64 in fp32 and bf16, B=256 in bf16), with
     random weights and non-trivial LayerNorm scales; kernel and plain ms;
  2. the full slice, LR pixels -> TBSRN (full width: x2, 32x128 HR,
     STN built, 5 SRBs, hidden 32) -> bicubic 32x100 gray -> CRNN(37, 256)
     -> greedy CTC -> strings, through `PixelsToStrings`, on a (256, 16, 64,
     3) bf16 batch with weights from a seed and non-trivial BN statistics.
     The kernel's launch counter must show exactly the 5 enhancer calls of
     one TBSRN forward; SR output and CRNN logits must agree with the same
     model run through the plain version; img/s of both paths;
  3. `InferenceServer(pipe.ids_fn, buckets=(1, 8, 32))` answers 40
     concurrent single-image requests; results equal the direct batched
     call; p50 / p99 latency.

Timings use CUDA events after a warm-up; every timing line carries the
card's name and power limit. Float32 comparisons run with TF32 off. The
line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter
from fudanocr_tpu_torch.models.rec.crnn import CRNN, parse_crnn_input
from fudanocr_tpu_torch.models.sr.tbsrn import TBSRN
from fudanocr_tpu_torch.nn.attention import positional_encoding_2d
from fudanocr_tpu_torch.ops import _build
from fudanocr_tpu_torch.ops.fused_enhancer import (enhancer_operands,
                                                   fused_enhancer,
                                                   fused_enhancer_reference)
from fudanocr_tpu_torch.serving import InferenceServer, PixelsToStrings

SEED = 0
ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"
SRB_NUMS = 5
BATCH = 256          # phase-2 batch
LR_HW = (16, 64)     # TextZoom LR geometry -> L = 1024 enhancer tokens
# bf16 bars: the JAX kernel's own (tests/test_fused_enhancer.py:50-51)
BF16_ATOL, BF16_MEAN = 0.05, 0.01
# fp32 bars: tests/test_fused_enhancer.py:37
FP32_RTOL, FP32_ATOL = 2e-4, 2e-5


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of `fn` over `iters` calls, CUDA events, after one
    warm-up call."""
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def in_turns(a, b, iters: int):
    """Time a and b in the order a, b, b, a; mean ms of each."""
    a1, b1, b2, a2 = (cuda_ms(f, iters) for f in (a, b, b, a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def enhancer_params(gen: torch.Generator, dev) -> dict:
    d = 128

    def rn(*shape, s):
        return (torch.randn(*shape, generator=gen) * s).to(dev)

    return {"wqkv": rn(d, 3 * d, s=d ** -0.5), "bqkv": rn(3 * d, s=0.1),
            "wout": rn(d, d, s=d ** -0.5), "bout": rn(d, s=0.1),
            "ln1_scale": 1 + rn(d, s=0.2), "ln1_bias": rn(d, s=0.1),
            "w1": rn(d, d, s=d ** -0.5), "b1": rn(d, s=0.1),
            "w2": rn(d, d, s=d ** -0.5), "b2": rn(d, s=0.1),
            "ln2_scale": 1 + rn(d, s=0.2), "ln2_bias": rn(d, s=0.1),
            "wp": rn(d, 64, s=d ** -0.5), "bp": rn(64, s=0.1)}


def phase1(dev, gpu: str) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    params = enhancer_params(gen, dev)
    h, w = LR_HW
    pe = torch.from_numpy(
        positional_encoding_2d(64, h, w).reshape(64, h * w).T.copy()).to(dev)
    result = {}
    for b, dt in ((64, torch.float32), (64, torch.bfloat16),
                  (BATCH, torch.bfloat16)):
        ops = enhancer_operands(params, pe, dt)
        x = (torch.randn(b, h * w, 64, generator=gen) * 0.5).to(dev, dt)
        got = fused_enhancer(x, ops).float()
        want = fused_enhancer_reference(x, ops).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        print(f"phase 1: B={b} L={h * w} {dt}: max abs err {max_err:.3e}, "
              f"mean abs err {mean_err:.3e}")
        if not torch.isfinite(got).all():
            raise AssertionError("kernel output is not finite")
        if dt == torch.float32:
            torch.testing.assert_close(got, want, rtol=FP32_RTOL,
                                       atol=FP32_ATOL)
        elif max_err > BF16_ATOL or mean_err > BF16_MEAN:
            raise AssertionError(f"bf16 kernel disagrees: max {max_err} > "
                                 f"{BF16_ATOL} or mean {mean_err} > "
                                 f"{BF16_MEAN}")
        if dt == torch.bfloat16:
            k_ms, p_ms = in_turns(lambda: fused_enhancer(x, ops),
                                  lambda: fused_enhancer_reference(x, ops), 10)
            print(f"phase 1: B={b} L={h * w} bf16 enhancer: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms [{gpu}]")
            result[b] = {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}
    return result[BATCH]


def randomize_stats(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Non-trivial BatchNorm statistics and LayerNorm scales, so folded
    identities cannot hide a wrong operand."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) * 0.5 + 0.75)
                m.weight.copy_(1 + torch.randn(n, generator=gen) * 0.1)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
            elif hasattr(m, "a_2"):
                n = m.a_2.numel()
                m.a_2.copy_(1 + torch.randn(n, generator=gen) * 0.2)
                m.b_2.copy_(torch.randn(n, generator=gen) * 0.1)


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def phase2(dev, gpu: str):
    torch.manual_seed(SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    sr = TBSRN(scale_factor=2, width=128, height=32, stn=True,
               srb_nums=SRB_NUMS, hidden_units=32, dtype=bf16)
    randomize_stats(sr, gen)
    sr_plain = TBSRN(scale_factor=2, width=128, height=32, stn=True,
                     srb_nums=SRB_NUMS, hidden_units=32,
                     fused_enhancer=False, dtype=bf16)
    sr_plain.load_state_dict(sr.state_dict())
    crnn = CRNN(num_classes=37, hidden=256, dtype=bf16)
    randomize_stats(crnn, gen)
    sr, sr_plain, crnn = (m.to(dev).eval() for m in (sr, sr_plain, crnn))
    conv = CTCLabelConverter(ALPHABET)
    pipe = PixelsToStrings(sr, crnn, conv, device=dev)
    pipe_plain = PixelsToStrings(sr_plain, crnn, conv, device=dev)
    lr = torch.rand(BATCH, *LR_HW, 3, generator=gen).to(dev)

    pipe_plain.ids_fn(lr)            # warm-up: kernel build, cuDNN plans
    pipe.ids_fn(lr)
    torch.cuda.synchronize()
    fused_enhancer.launches = 0      # the main path's run, counted
    texts, sr_out = pipe(lr, return_sr=True)
    torch.cuda.synchronize()
    launches = fused_enhancer.launches
    print(f"phase 2: one PixelsToStrings call ran {launches} kernel "
          f"launches = {launches // 2} fused-enhancer calls "
          f"(expected {SRB_NUMS})")
    if launches != 2 * SRB_NUMS:
        raise AssertionError(f"expected {2 * SRB_NUMS} kernel launches "
                             f"for one TBSRN forward, got {launches}")

    with torch.inference_mode():
        sr_ref = sr_plain(lr)
        logits = crnn(parse_crnn_input(sr_out))
        logits_ref = crnn(parse_crnn_input(sr_ref))
    texts_ref = pipe_plain(lr)
    hr = (BATCH, 2 * LR_HW[0], 2 * LR_HW[1], 3)
    if tuple(sr_out.shape) != hr or not torch.isfinite(sr_out).all():
        raise AssertionError(f"SR output {tuple(sr_out.shape)} (want {hr}) "
                             "or not finite")
    if len(texts) != BATCH or not torch.isfinite(logits).all():
        raise AssertionError("CRNN logits not finite or strings missing")
    sr_err = (sr_out.float() - sr_ref.float()).abs()
    lg_err = (logits.float() - logits_ref.float()).abs()
    print(f"phase 2: SR {tuple(sr_out.shape)} kernel vs plain: max abs err "
          f"{sr_err.max().item():.3e}, mean {sr_err.mean().item():.3e}; "
          f"logits {tuple(logits.shape)}: max abs err "
          f"{lg_err.max().item():.3e}, mean {lg_err.mean().item():.3e}")
    # SR is a tanh output in [-1, 1]; the bf16 enhancer bars hold end to end
    if sr_err.max() > BF16_ATOL or sr_err.mean() > BF16_MEAN:
        raise AssertionError("SR output: kernel path disagrees with plain")
    scale = logits_ref.float().abs().max().clamp(min=1.0)
    if lg_err.max() > BF16_ATOL * scale or lg_err.mean() > BF16_MEAN * scale:
        raise AssertionError("CRNN logits: kernel path disagrees with plain")
    # ids and strings must agree wherever no CTC step is within the bf16
    # error of a tie (twice the largest logit difference measured above)
    tol = 2 * lg_err.max().item()
    sure_step = (top2_margin(logits_ref) > tol).cpu().numpy()
    same_step = (logits.argmax(-1) == logits_ref.argmax(-1)).cpu().numpy()
    sure = sure_step.all(axis=1)
    bad = [i for i in np.flatnonzero(sure) if texts[i] != texts_ref[i]]
    print(f"phase 2: {int(sure_step.sum())} of {sure_step.size} CTC steps "
          f"have a top-2 margin above {tol:.3e}, ids equal at all of them: "
          f"{bool(same_step[sure_step].all())}; {int(sure.sum())} of "
          f"{BATCH} images are confident at every step, strings equal: "
          f"{not bad}; all {BATCH} strings equal: {texts == texts_ref}")
    if bad or not same_step[sure_step].all():
        raise AssertionError("kernel path decodes other ids than the plain "
                             "path at steps with a clear top-2 margin")

    k_ms, p_ms = in_turns(lambda: pipe.ids_fn(lr),
                          lambda: pipe_plain.ids_fn(lr), 5)
    print(f"phase 2: pixels->strings at batch {BATCH} bf16: kernel path "
          f"{BATCH / k_ms * 1e3:.1f} img/s ({k_ms:.3f} ms), plain path "
          f"{BATCH / p_ms * 1e3:.1f} img/s ({p_ms:.3f} ms) [{gpu}]")
    return pipe, lr, launches


def phase3(pipe: PixelsToStrings, lr: torch.Tensor, gpu: str) -> None:
    n = 40
    imgs = lr[:n].cpu().numpy()
    def run(x):
        with torch.inference_mode():
            return pipe.rec_apply(parse_crnn_input(pipe.sr_apply(x))).float()

    logits = run(lr[:n])
    # the server runs the bucket sizes; measure what the batch size alone
    # moves the logits by
    tol = 2 * max((logits[:b] - run(lr[:b])).abs().max().item()
                  for b in (1, 8, 32))
    direct = logits.argmax(-1).cpu().numpy()
    margin = top2_margin(logits).cpu().numpy()
    srv = InferenceServer(pipe.ids_fn, buckets=(1, 8, 32), max_wait_ms=5.0,
                          device=pipe.device)
    try:
        srv.warmup(imgs[0])
        results = [None] * n
        errors = []

        def client(i):
            try:
                results[i] = srv.submit(imgs[i]).result(timeout=120)
            except Exception as e:  # reported below, fails the phase
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"server requests failed: {errors[:3]}")
    finally:
        srv.close()
    served = np.stack(results)
    # served buckets vs one batch of 40: cuDNN may pick other algorithms per
    # batch size, so a step whose top-2 margin is within that rounding
    # difference may flip; every other step must match exactly
    same = served == direct
    sure = margin > tol
    if not same[sure].all():
        raise AssertionError("served ids differ from the direct call")
    st = srv.stats()
    print(f"phase 3: {n} concurrent requests, buckets run {st['batches']}; "
          f"ids equal to the direct batched call at {int(same.sum())} of "
          f"{same.size} steps, and at all {int(sure.sum())} steps with a "
          f"top-2 margin above {tol:.3e}; latency p50 {st['p50_ms']} ms, "
          f"p99 {st['p99_ms']} ms [{gpu}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a "
              "GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = card()
    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    _build.load_library()
    print(f"phase 0: built {path.name} in {nvcc_s:.2f} s of nvcc "
          f"({time.perf_counter() - t0:.2f} s with loading)")
    enh = phase1(dev, gpu)
    pipe, lr, launches = phase2(dev, gpu)
    phase3(pipe, lr, gpu)
    print(json.dumps({"kernels": [{
        "name": "fused_enhancer", "route": "cuda",
        "source": "fudanocr_tpu_torch/csrc/fused_enhancer.cu",
        "replaces": "fudanocr_tpu/ops/fused_enhancer.py:188",
        "launches": launches, "max_abs_err": enh["max_abs_err"],
        "ms": enh["ms"], "plain_ms": enh["plain_ms"]}]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
