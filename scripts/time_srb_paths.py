"""Time the whole-SRB kernel (B9) and TBSRN(fused_srb=True) pixels ->
strings (chip_smoke.py phase 23) in one or more checkouts, one process
each, so a parent and a change can be run in turns on one card.

    python3 scripts/time_srb_paths.py                  # this checkout
    python3 scripts/time_srb_paths.py --turns P,.,.,P
    python3 scripts/time_srb_paths.py --ptxas          # registers
    python3 scripts/time_srb_paths.py --variants[=a,b]

A run imports the package and the chip_smoke.py of the checkout in the
current directory. It times one `fused_srb` call at (256, 16, 64, 64) in
bf16 (phase 22's main shape, on a TransformerResidualBlock from a seed
with non-trivial BN statistics): CUDA-event ms, device ms, and on a line
of its own the device ms and launches by kernel; beside it cuDNN's two
convs with their biases (channels-last bf16, no mish). Then it runs the
checkout's phase 23 on a TBSRN, CRNN(37, 256) and LR batch made here as
phase 2 makes them (phase 23 is not standalone): pixels -> strings at
batch 256 bf16 through B9 with its checks, img/s of the B9, fused-enhancer
and plain paths, the server and the train step; then the unfused
enhancer's path (`fused_enhancer=False`, phase 18's) on the same weights.
`--turns` runs this file in each listed checkout (a directory; `.` is
this one) in the order given, as scripts/time_seg_paths.py does, and
prints every timing line's median and range per checkout. `--ptxas`
compiles csrc/fused_srb.cu once more with -Xptxas -v and prints each
kernel's registers and spills. `--variants` times the B9 call (ms, device
ms by kernel, largest error from the plain version) in copies of the
package built with one edit each (VARIANTS; scripts/kernel_timing.py
`variants`): the ring depth, the tile rows and the taps in flight of the
bf16 convs, conv1's mish in other forms, and diagnostics that each leave
a piece out or put another activation in mish's place. Needs a
CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from kernel_timing import (card, cuda_ms, device_ms_by_kernel,  # noqa: E402
                           ptxas_report, variants)
from time_seg_paths import turns  # noqa: E402

TIMING = re.compile(r"B9 call .*: |cuDNN's two convs|pixels->strings")
SHAPE, ITERS = (256, 16, 64, 64), 20
_STAGES = "constexpr int kStagesMish = 2, kStagesQkv = 2;"
# conv1's epilogue as the kernel has it, and with the fp32 pre-activations
# staged and mish applied in a rolled loop (small code)
_EPILOGUE = """\
    uint32_t ra[4][4];   // conv2: r as the A operand of the qkv product
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // b' of this thread's columns 8j + 2t, 8j + 2t + 1
      const float2 bv =
          *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
      float v[4] = {acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y,
                    acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y};
      if (!QKV) {
#pragma unroll
        for (int h = 0; h < 4; ++h) v[h] = mish(v[h]);
      }
      const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
      *reinterpret_cast<uint32_t*>(st + g * kSR + 8 * j + 2 * t) = lo;
      *reinterpret_cast<uint32_t*>(st + (g + 8) * kSR + 8 * j + 2 * t) = hi;
      ra[j / 2][(j & 1) * 2] = lo;
      ra[j / 2][(j & 1) * 2 + 1] = hi;
    }
    __syncwarp();
    store_rows<kSR, kC>(out + row0 * kC, kC, st, lane);
"""
_EPILOGUE_ROLLED = """\
    uint32_t ra[4][4];   // conv2: r as the A operand of the qkv product
    float* sf = reinterpret_cast<float*>(st);   // conv1: fp32, pitch 68
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // b' of this thread's columns 8j + 2t, 8j + 2t + 1
      const float2 bv =
          *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
      float v[4] = {acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y,
                    acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y};
      if (!QKV) {
        *reinterpret_cast<float2*>(sf + g * 68 + 8 * j + 2 * t) =
            make_float2(v[0], v[1]);
        *reinterpret_cast<float2*>(sf + (g + 8) * 68 + 8 * j + 2 * t) =
            make_float2(v[2], v[3]);
        continue;
      }
      const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
      *reinterpret_cast<uint32_t*>(st + g * kSR + 8 * j + 2 * t) = lo;
      *reinterpret_cast<uint32_t*>(st + (g + 8) * kSR + 8 * j + 2 * t) = hi;
      ra[j / 2][(j & 1) * 2] = lo;
      ra[j / 2][(j & 1) * 2 + 1] = hi;
    }
    __syncwarp();
    if (!QKV) {
      __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(
          bands + (kThreads / 32) * kWarpStage) + warp * 16 * 64;
#pragma unroll 1
      for (int e = lane; e < 16 * 32; e += 32) {
        const int r = e / 32, c = (e % 32) * 2;
        const float2 p = *reinterpret_cast<const float2*>(sf + r * 68 + c);
        *reinterpret_cast<uint32_t*>(sb + r * 64 + c) =
            pack_bf16(mish(p.x), mish(p.y));
      }
      __syncwarp();
#pragma unroll
      for (int e = lane; e < 16 * 8; e += 32) {
        const int r = e / 8, c = e % 8;
        *reinterpret_cast<uint4*>(out + (row0 + r) * kC + c * 8) =
            *reinterpret_cast<const uint4*>(sb + r * 64 + c * 8);
      }
    } else {
      store_rows<kSR, kC>(out + row0 * kC, kC, st, lane);
    }
"""
_WGMMA = ("      wgmma_n64(acc, at[ks], desc_sw128(w_addr + tap * kC * 128 + "
          "ks * 32));")
# name: (source, its text, the variant's text), or a list of such edits:
# conv1's ring three stages deep (conv2 has no room for a third), both
# convs with one stage (no overlap of a tile's loads with the tile before),
# and tiles of 64 rows (one consumer warpgroup a block in place of two)
VARIANTS = {
    "ring3_conv1": ("fused_srb.cu", _STAGES,
                    "constexpr int kStagesMish = 3, kStagesQkv = 2;"),
    "ring1": ("fused_srb.cu", _STAGES,
              "constexpr int kStagesMish = 1, kStagesQkv = 1;"),
    "rows64": ("fused_srb.cu", "constexpr int kWarpgroups = 2;",
               "constexpr int kWarpgroups = 1;"),
    # three taps' A fragments in flight in place of two
    "a_ring3": [("fused_srb.cu", "uint32_t a[2][4][4];",
                 "uint32_t a[3][4][4];"),
                ("fused_srb.cu", "= a[tap & 1];", "= a[tap % 3];"),
                ("fused_srb.cu", "wg_wait<1>();   // tap - 1 is done",
                 "wg_wait<2>();   // tap - 1 is done")],
    # diagnostics that change the function, each leaving one piece out:
    # the conv's products (its loads kept), the A fragments' ldmatrix (the
    # products run on the row addresses), conv1's mish, and the stores of
    # r1 / r (qkv still stored)
    "no_conv_mma": ("fused_srb.cu", _WGMMA,
                    "      acc[ks] += __uint_as_float(at[ks][0]);"),
    "no_ldmatrix": ("fused_srb.cu", "      ldmatrix_x4(at[ks], row + ((((2 * "
                    "ks + lc) ^ br) & 7) << 4));",
                    "      at[ks][0] = at[ks][1] = at[ks][2] = at[ks][3] = "
                    "row + ks;"),
    "no_mish": ("fused_srb.cu", "v[h] = mish(v[h]);", "v[h] = v[h];"),
    # conv1's mish replaced by one multiply, by one fast exponent, and by
    # one fast division: which of them costs what the mish costs
    "act_mul": ("fused_srb.cu", "v[h] = mish(v[h]);",
                "v[h] = 0.5f * v[h];"),
    "act_ex2": ("fused_srb.cu", "v[h] = mish(v[h]);",
                "v[h] = v[h] * __expf(-fabsf(v[h]));"),
    "act_div": ("fused_srb.cu", "v[h] = mish(v[h]);",
                "v[h] = __fdividef(v[h], 1.f + fabsf(v[h]));"),
    # conv1's mish out of line, and in a rolled loop over the staged fp32
    # values: whether the unrolled epilogue's code size is what costs
    "mish_noinline": ("fused_srb.cu",
                      "__device__ __forceinline__ float mish(float v) {",
                      "__device__ __noinline__ float mish(float v) {"),
    "mish_rolled": ("fused_srb.cu", _EPILOGUE, _EPILOGUE_ROLLED),
    # conv1's mish as v * n / (n + 2), n = e^v (e^v + 2), with __expf and
    # __fdividef: one fast exponent in place of three transcendentals
    "fast_mish": [("fused_srb.cu", "v[h] = mish(v[h]);",
                   "v[h] = mish_fast(v[h]);"),
                  ("fused_srb.cu", "// ---- fp32: CUDA-core FMAs",
                   "__device__ __forceinline__ float mish_fast(float v) {\n"
                   "  const float e = __expf(v), n = e * (e + 2.f);\n"
                   "  return v > 20.f ? v : v * __fdividef(n, n + 2.f);\n"
                   "}\n\n// ---- fp32: CUDA-core FMAs")],
    "no_r_store": ("fused_srb.cu",
                   "    store_rows<kSR, kC>(out + row0 * kC, kC, st, lane);",
                   ""),
}


def srb_case(dev, dt=torch.bfloat16):
    """A seeded TransformerResidualBlock's operands and a map x at SHAPE
    (chip_smoke.phase22's construction)."""
    import chip_smoke as cs
    from fudanocr_tpu_torch.models.sr.tbsrn import TransformerResidualBlock

    gen = torch.Generator().manual_seed(cs.SEED + 22)
    torch.manual_seed(cs.SEED + 22)
    blk = TransformerResidualBlock(64, fused_srb=True)
    cs.randomize_stats(blk, gen)
    blk = blk.to(dev).eval()
    b, h, w, c = SHAPE
    x = (torch.randn(b, h, w, c, generator=gen) * 0.5).to(dev, dt)
    return x, blk.srb_operands(h, w, dt, dev)


def time_call(tag: str, dev, gpu: str) -> tuple:
    from fudanocr_tpu_torch.ops.fused_srb import (fused_srb,
                                                  fused_srb_reference)

    x, ops = srb_case(dev)
    err = (fused_srb(x, ops).float()
           - fused_srb_reference(x, ops).float()).abs().max().item()
    fn = lambda: fused_srb(x, ops)  # noqa: E731
    ms = cuda_ms(fn, ITERS)
    split = device_ms_by_kernel(fn, ITERS)
    print(f"{tag}B9 call {SHAPE} bf16: {ms:.4f} ms, device "
          f"{sum(split.values()):.4f} ms, max abs err {err:.3e} [{gpu}]",
          flush=True)
    print(f"{tag}B9 device ms by kernel: {split}", flush=True)
    return x, ops


def run_tree() -> None:
    import chip_smoke as cs
    import torch.nn.functional as F
    from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter
    from fudanocr_tpu_torch.models.rec.crnn import CRNN
    from fudanocr_tpu_torch.models.sr.tbsrn import TBSRN
    from fudanocr_tpu_torch.ops import _build
    from fudanocr_tpu_torch.serving import PixelsToStrings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = card()
    _build.build()
    _build.load_library()
    x, ops = time_call("", dev, gpu)
    xc = x.permute(0, 3, 1, 2)
    ws = [ops[f"conv{i}_w"].reshape(3, 3, 64, 64).permute(3, 2, 0, 1)
          .contiguous(memory_format=torch.channels_last) for i in (1, 2)]
    bs = [ops[f"conv{i}_b"].to(x.dtype) for i in (1, 2)]
    lib = lambda: F.conv2d(F.conv2d(xc, ws[0], bs[0], padding=1),  # noqa
                           ws[1], bs[1], padding=1)
    print(f"cuDNN's two convs {SHAPE} bf16: {cuda_ms(lib, ITERS):.4f} ms, "
          f"device {sum(device_ms_by_kernel(lib, ITERS).values()):.4f} ms "
          f"[{gpu}]", flush=True)
    del x, ops, xc, ws
    torch.cuda.empty_cache()
    # phase 2's TBSRN (fused enhancer), CRNN and LR batch, from its seeds
    torch.manual_seed(cs.SEED)
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    bf16 = torch.bfloat16
    sr = TBSRN(scale_factor=2, width=128, height=32, stn=True,
               srb_nums=cs.SRB_NUMS, hidden_units=32, dtype=bf16)
    cs.randomize_stats(sr, gen)
    crnn = CRNN(num_classes=37, hidden=256, dtype=bf16)
    cs.randomize_stats(crnn, gen)
    pipe = PixelsToStrings(sr.to(dev).eval(), crnn.to(dev).eval(),
                           CTCLabelConverter(cs.ALPHABET), device=dev)
    lr = torch.rand(cs.BATCH, *cs.LR_HW, 3, generator=gen).to(dev)
    cs.phase23(dev, gpu, pipe, lr)
    # the unfused enhancer's path (phase 18's) on the same weights
    unfused = TBSRN(scale_factor=2, width=128, height=32, stn=True,
                    srb_nums=cs.SRB_NUMS, hidden_units=32, dtype=bf16,
                    fused_enhancer=False)
    unfused.load_state_dict(sr.state_dict())
    path = PixelsToStrings(unfused.to(dev).eval(), pipe.rec_apply,
                           pipe.converter, device=dev)
    ms = cuda_ms(lambda: path.ids_fn(lr), 5)
    print(f"pixels->strings at batch {cs.BATCH} bf16: unfused enhancer "
          f"path {ms:.3f} ms [{gpu}]", flush=True)


def kernel_name(mangled: str):
    """The kernel's name in a mangled ptxas entry of csrc/fused_srb.cu."""
    m = re.search(r"(conv3x3_\w+?_kernel)", mangled)
    return m.group(1) if m else None


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("time_srb_paths: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--as"]:     # one variant, from its own copy
        sys.path.append(ROOT)    # chip_smoke.py, behind the variant's package
        time_call(f"{argv[1]}: ", torch.device("cuda", 0), card())
        return 0
    sys.path.insert(0, os.getcwd())   # the checkout to time
    if argv[:1] == ["--turns"]:
        return turns(argv[1].split(","), __file__, TIMING)
    if not argv:
        run_tree()
        return 0
    from fudanocr_tpu_torch.ops import _build

    _build.build()
    if "--ptxas" in argv:
        ptxas_report(("fused_srb.cu",), kernel_name)
    chosen = [a.split("=", 1)[1].split(",") if "=" in a else list(VARIANTS)
              for a in argv if a.startswith("--variants")]
    return (variants(__file__, "srb_variants", VARIANTS, chosen[0])
            if chosen else 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
