"""Time the port's fused-enhancer kernel (B1, csrc/fused_enhancer.cu) on
one NVIDIA GPU, diagnostic variants of its source, and the paths its fp32
kernels carry in one or more checkouts.

    python3 scripts/time_fused_enhancer.py              # this checkout
    python3 scripts/time_fused_enhancer.py --variants[=a,b]
    python3 scripts/time_fused_enhancer.py --ptxas      # and the registers
    python3 scripts/time_fused_enhancer.py --turns=P,.,.,P   (P: a checkout)
    cd <other checkout> && PYTHONPATH=. python3 <this file>   # that one

For (64, 1024) fp32 and bf16 and (256, 1024) bf16 tokens (chip_smoke.py
phase 1's shapes and weights' scales, from a seed) it prints the ms per
call (CUDA events, three means of 20 calls), the device ms per call by
kernel (torch.profiler) and the error against the plain version, with the
card's name and power limit. The package timed is the one on the import
path, so the same file times a parent checkout beside this one.

The harness is scripts/kernel_timing.py's.
`--variants` copies the package into build/enhancer_variants/<name>/ with
one edit to csrc/fused_enhancer.cu each (all of them, or those named),
builds the copies in parallel, and times B1 in each, in the order listed
and then reversed; bf16 variants at (256, 1024) bf16:
  attention_only   the bf16 kernel returns after the attention (its
                   output is wrong: a timing of the attention part alone);
  no_register_cap  no minimum of 2 blocks an SM in __launch_bounds__, so
                   ptxas takes the registers it wants (1 block an SM);
fp32 variants at (64, 1024) fp32:
  fp32_attention_only  the fp32 kernel returns after the attention;
  fp32_split_at_load   K and V split at each fragment load, not once at
                       staging (raw tiles double-buffered);
  fp32_fast_exp        __expf (ex2.approx) in the softmax, not expf;
  fp32_s_wide          Q K^T of a tile's key n-tiles interleaved;
  fp32_no_part         P V accumulated onto the rescaled running sum;
  fp32_all_three       the last three together.
`--ptxas` first compiles csrc/fused_enhancer.cu once more with the
build's nvcc flags and -Xptxas -v, and prints each kernel's registers,
spills and static shared memory as ptxas reports them.
`--turns=A,B,...` runs this file with `--tree` in each listed checkout (a
directory; `.` is this one), one process each, in the order given (as
scripts/time_seg_paths.py does), and prints the median and range of each
timing per checkout: B1 at (64, 1024) fp32 (ms, device ms of the qkv
projection and of the attention epilogue), one fp32 B9 call at (64, 16,
64, 64) on a TransformerResidualBlock from a seed, and TBSRN's fp32
inference forward on (64, 16, 64, 3) LR crops with and without kernels
(in turns); it fails unless B1's bf16 outputs at (64, 1024) and (256,
1024) are bit-equal in every checkout (their sha256).
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import torch

from kernel_timing import (ROOT, card, cuda_ms, device_ms_by_kernel,
                           ptxas_report, variants)

sys.path.append(str(ROOT))   # after PYTHONPATH: another tree's package wins
SHAPES = ((64, torch.float32), (64, torch.bfloat16), (256, torch.bfloat16))
LR_HW = (16, 64)
ITERS = 20
SOURCE = "fused_enhancer.cu"
VARIANTS = {
    "attention_only": (
        SOURCE,
        "  attention_mma<DH>(qkv, img, q0, L, sm, wout, ws, bufA);\n",
        "  attention_mma<DH>(qkv, img, q0, L, sm, wout, ws, bufA);\n"
        "  if (L > 0) {\n"
        "    cp_async_wait<0>();\n"
        "    __syncthreads();\n"
        "    if (threadIdx.x < kC) out[(img + q0) * kC + threadIdx.x] =\n"
        "        bufA[threadIdx.x];\n"
        "    return;\n"
        "  }\n"),
    "no_register_cap": (
        SOURCE,
        "constexpr int kMinBlocks = 2;",
        "constexpr int kMinBlocks = 1;"),
}
# the fp32 kernels' variants, timed at (64, 1024) fp32
S_LOOP = """#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float c[1][4];
      mma3_abt<KS, 1, kPF>(c, qa, st + n * 8 * kPF + hc,
                           st + kTileF + n * 8 * kPF + hc, g, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = c[0][i];
    }
"""
PV_LOOP = """    float part[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      mma3_xb<NO, kPF>(part, s[kk], st + 2 * kTileF + kk * 8 * kPF + c0,
                       st + 3 * kTileF + kk * 8 * kPF + c0, g, t);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[n][c] = fmaf(acc[n][c], alpha[c >> 1], part[n][c]);
"""
EXPS = [(SOURCE, "alpha[rr] = expf(m[rr] - m_new);",
         "alpha[rr] = __expf(m[rr] - m_new);"),
        (SOURCE, "s[n][c] = expf(s[n][c] - m[c >> 1]);",
         "s[n][c] = __expf(s[n][c] - m[c >> 1]);")]
S_WIDE = [(SOURCE, S_LOOP,
           "    mma3_abt<KS, NS, kPF>(s, qa, st + hc, st + kTileF + hc, g, "
           "t);\n")]
NO_PART = [(SOURCE, PV_LOOP, """#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      mma3_xb<NO, kPF>(acc, s[kk], st + 2 * kTileF + kk * 8 * kPF + c0,
                       st + 3 * kTileF + kk * 8 * kPF + c0, g, t);
""")]
F32_VARIANTS = {
    # the fp32 kernel returns after the attention (a wrong output: a timing
    # of the attention part alone)
    "fp32_attention_only": (
        SOURCE,
        "  attention_tf32x3<DH>(qkv, img, q0, L, smem, wout, ws, bufA);\n",
        "  attention_tf32x3<DH>(qkv, img, q0, L, smem, wout, ws, bufA);\n"
        "  if (L > 0) {\n"
        "    cp_async_wait<0>();\n"
        "    __syncthreads();\n"
        "    if (threadIdx.x < kC) out[(img + q0) * kC + threadIdx.x] =\n"
        "        bufA[threadIdx.x];\n"
        "    return;\n"
        "  }\n"),
    # K and V split into hi and lo at each fragment load, not once at
    # staging: the raw tiles double-buffered in the working stage, one
    # group barrier a tile
    "fp32_split_at_load": [
        (SOURCE, """    stage_head_f32<DH>(land + hc, src + kD, n, gt);
    stage_head_f32<DH>(land + kTileF + hc, src + 2 * kD, n, gt);
""", """    float* raw = smem + (j & 1) * 2 * kTileF;
    stage_head_f32<DH>(raw + hc, src + kD, n, gt);
    stage_head_f32<DH>(raw + kTileF + hc, src + 2 * kD, n, gt);
"""),
        (SOURCE, """    bar_sync(1 + grp, 4 * DH);
    split_head_f32<DH>(land + hc, st + hc, st + kTileF + hc, gt);
    split_head_f32<DH>(land + kTileF + hc, st + 2 * kTileF + hc,
                       st + 3 * kTileF + hc, gt);
    bar_sync(1 + grp, 4 * DH);
""", """    bar_sync(1 + grp, 4 * DH);
    const float* kr = smem + (j & 1) * 2 * kTileF;
"""),
        (SOURCE, S_LOOP, """#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float* kp = kr + (n * 8 + g) * kPF + hc + t;
      uint32_t hb[KS][2];
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t l0, l1;
        split_tf32(kp[kk * 8], hb[kk][0], l0);
        split_tf32(kp[kk * 8 + 4], hb[kk][1], l1);
        mma_tf32(s[n], qa.l[kk], hb[kk][0], hb[kk][1]);
        mma_tf32(s[n], qa.h[kk], l0, l1);
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_tf32(s[n], qa.h[kk], hb[kk][0], hb[kk][1]);
    }
"""),
        (SOURCE, PV_LOOP, """    float part[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t xh[4], xl[4];
      split_tf32(s[kk][0], xh[0], xl[0]);
      split_tf32(s[kk][2], xh[1], xl[1]);
      split_tf32(s[kk][1], xh[2], xl[2]);
      split_tf32(s[kk][3], xh[3], xl[3]);
      const float* vp = kr + kTileF + (kk * 8 + 2 * t) * kPF + c0 + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t h0, l0, h1, l1;
        split_tf32(vp[n * 8], h0, l0);
        split_tf32(vp[kPF + n * 8], h1, l1);
        mma_tf32(part[n], xl, h0, h1);
        mma_tf32(part[n], xh, l0, l1);
        mma_tf32(part[n], xh, h0, h1);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[n][c] = fmaf(acc[n][c], alpha[c >> 1], part[n][c]);
""")],
    # __expf (ex2.approx) in the softmax instead of expf
    "fp32_fast_exp": EXPS,
    # Q K^T of the tile's four key n-tiles interleaved (mma3_abt at NT = 4)
    "fp32_s_wide": S_WIDE,
    # P V accumulated onto the rescaled running sum, no per-tile part
    "fp32_no_part": NO_PART,
    "fp32_all_three": EXPS + S_WIDE + NO_PART,
}


def time_b1(tag: str, shapes) -> None:
    from fudanocr_tpu_torch.nn.attention import positional_encoding_2d
    from fudanocr_tpu_torch.ops.fused_enhancer import (
        enhancer_operands, fused_enhancer, fused_enhancer_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    d = 128

    def rn(*shape, s):
        return (torch.randn(*shape, generator=gen) * s).to(dev)

    params = {"wqkv": rn(d, 3 * d, s=d ** -0.5), "bqkv": rn(3 * d, s=0.1),
              "wout": rn(d, d, s=d ** -0.5), "bout": rn(d, s=0.1),
              "ln1_scale": 1 + rn(d, s=0.2), "ln1_bias": rn(d, s=0.1),
              "w1": rn(d, d, s=d ** -0.5), "b1": rn(d, s=0.1),
              "w2": rn(d, d, s=d ** -0.5), "b2": rn(d, s=0.1),
              "ln2_scale": 1 + rn(d, s=0.2), "ln2_bias": rn(d, s=0.1),
              "wp": rn(d, 64, s=d ** -0.5), "bp": rn(64, s=0.1)}
    h, w = LR_HW
    pe = torch.from_numpy(positional_encoding_2d(64, h, w).reshape(
        64, h * w).T.copy()).to(dev)
    gpu = card()
    for b, dt in shapes:
        ops = enhancer_operands(params, pe, dt)
        x = (torch.randn(b, h * w, 64, generator=gen) * 0.5).to(dev, dt)
        err = (fused_enhancer(x, ops).float()
               - fused_enhancer_reference(x, ops).float()).abs()
        ms = [round(cuda_ms(lambda: fused_enhancer(x, ops), ITERS), 4)
              for _ in range(3)]
        split = device_ms_by_kernel(lambda: fused_enhancer(x, ops), ITERS)
        print(f"{tag}: B1 ({b}, {h * w}) {dt}: ms {ms}, device ms by kernel "
              f"{split}, max abs err {err.max().item():.3e}, mean "
              f"{err.mean().item():.3e} [{gpu}]", flush=True)


def run_tree() -> None:
    """The paths that B1's fp32 kernels carry and B1's bf16 outputs, timed
    in the checkout of the current directory (its package and its
    chip_smoke.py), as `--turns` runs it in each listed checkout."""
    import hashlib
    import os

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from fudanocr_tpu_torch.models.sr.tbsrn import (TBSRN,
                                                    TransformerResidualBlock)
    from fudanocr_tpu_torch.nn.attention import positional_encoding_2d
    from fudanocr_tpu_torch.ops import _build
    from fudanocr_tpu_torch.ops.fused_enhancer import (
        enhancer_operands, fused_enhancer, fused_enhancer_reference)
    from fudanocr_tpu_torch.ops.fused_srb import (fused_srb,
                                                  fused_srb_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = card()
    _build.build()
    gen = torch.Generator().manual_seed(0)
    params = cs.enhancer_params(gen, dev)
    h, w = LR_HW
    pe = torch.from_numpy(positional_encoding_2d(64, h, w).reshape(
        64, h * w).T.copy()).to(dev)
    for b, dt in SHAPES:
        ops = enhancer_operands(params, pe, dt)
        x = (torch.randn(b, h * w, 64, generator=gen) * 0.5).to(dev, dt)
        got = fused_enhancer(x, ops)
        if dt == torch.bfloat16:
            digest = hashlib.sha256(got.view(torch.int16).cpu().numpy()
                                    .tobytes()).hexdigest()[:16]
            print(f"B1 ({b}, {h * w}) bf16 output sha256 {digest}")
            continue
        err = (got - fused_enhancer_reference(x, ops)).abs().max().item()
        ms = cuda_ms(lambda: fused_enhancer(x, ops), ITERS)
        split = device_ms_by_kernel(lambda: fused_enhancer(x, ops), ITERS)
        qkv = sum(v for k, v in split.items() if k.startswith("qkv_proj"))
        epi = sum(v for k, v in split.items() if k.startswith("attn_epi"))
        print(f"B1 ({b}, {h * w}) fp32: {ms:.4f} ms, device ms qkv "
              f"{qkv:.4f}, attention epilogue {epi:.4f}, max abs err "
              f"{err:.3e} [{gpu}]", flush=True)

    torch.manual_seed(22)
    blk = TransformerResidualBlock(64, fused_srb=True)
    cs.randomize_stats(blk, gen)
    blk = blk.to(dev).eval()
    ops = blk.srb_operands(h, w, torch.float32, dev)
    x = (torch.randn(64, h, w, 64, generator=gen) * 0.5).to(dev)
    err = (fused_srb(x, ops) - fused_srb_reference(x, ops)).abs().max()
    ms = cuda_ms(lambda: fused_srb(x, ops), ITERS)
    print(f"B9 (64, {h}, {w}, 64) fp32: {ms:.4f} ms, max abs err "
          f"{err.item():.3e} [{gpu}]", flush=True)

    torch.manual_seed(1)
    sr = TBSRN(scale_factor=2, width=128, height=32, stn=True, srb_nums=5,
               hidden_units=32)
    cs.randomize_stats(sr, gen)
    plain = TBSRN(scale_factor=2, width=128, height=32, stn=True,
                  srb_nums=5, hidden_units=32, kernels=False)
    plain.load_state_dict(sr.state_dict())
    sr, plain = sr.to(dev).eval(), plain.to(dev).eval()
    lr = torch.rand(64, h, w, 3, generator=gen).to(dev)
    with torch.inference_mode():
        err = (sr(lr) - plain(lr)).abs().max().item()
        k1, p1, p2, k2 = (cuda_ms(f, 5) for f in (lambda: sr(lr),
                                                   lambda: plain(lr),
                                                   lambda: plain(lr),
                                                   lambda: sr(lr)))
    print(f"TBSRN fp32 forward (64, {h}, {w}, 3): kernels "
          f"{(k1 + k2) / 2:.4f} ms, kernels=False {(p1 + p2) / 2:.4f} ms, "
          f"max abs err {err:.3e} [{gpu}]", flush=True)


def kernel_name(mangled: str) -> str:
    """`kernel<dh>` (or the bare name) of a mangled name; the bf16
    attention epilogue as `attn_epilogue_kernel<bf16, dh>`."""
    name = re.search(r"(qkv_proj_mma_kernel|qkv_proj_tf32x3_kernel|"
                     r"attn_epilogue_tf32x3_kernel|attn_epilogue_kernel)"
                     r"(I\w*?Li(\d+)E)?", mangled)
    bf16 = "bf16, " if "bfloat16" in (name.group(2) or "") else ""
    return name.group(1) + (f"<{bf16}{name.group(3)}>" if name.group(2)
                            else "")


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("time_fused_enhancer: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--tree"]:   # one turn, in its own checkout
        run_tree()
        return 0
    if argv[:1] and argv[0].startswith("--turns="):
        from time_seg_paths import turns

        return turns(argv[0].split("=", 1)[1].split(","), __file__,
                     re.compile(r"B1 \(64, 1024\) fp32|B9 \(|TBSRN fp32"),
                     re.compile(r"bf16 output sha256"), ("--tree",))
    if argv[:1] == ["--as"]:     # one variant, from its own copy
        time_b1(argv[1], SHAPES[:1] if argv[1] in F32_VARIANTS
                else SHAPES[2:])
        return 0
    from fudanocr_tpu_torch.ops import _build

    _build.build()
    if "--ptxas" in argv:
        ptxas_report((SOURCE,), kernel_name)
    tree = Path(_build.__file__).resolve().parents[2]
    time_b1(f"tree {tree.name or tree}", SHAPES)
    every = {**VARIANTS, **F32_VARIANTS}
    names = [n for a in argv if a.startswith("--variants")
             for n in (a.split("=", 1)[1].split(",") if "=" in a
                       else every)]
    return variants(__file__, "enhancer_variants", every,
                    names) if names else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
