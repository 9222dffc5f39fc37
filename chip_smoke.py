"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 5,6,24   (only phases that need no
                                            earlier one; no result line)

Drives the port's main paths (fudanocr_tpu_torch) once on the card and
fails loudly: it exits non-zero, and prints no result line, when there is
no CUDA device, when a kernel does not build, launch or agree with its
plain PyTorch version, or when any phase's check fails.

Phases:
  0. build the hand-written kernels from fudanocr_tpu_torch/csrc/ (one
     nvcc per source, in parallel);
  1. the fused-enhancer kernel against its plain version at the main-path
     shape (L=1024, C=64; B=64 in fp32 and bf16, B=256 in bf16), with
     random weights and non-trivial LayerNorm scales; kernel and plain ms,
     the kernel's device ms by kernel (`qkv_proj_mma_kernel`,
     `attn_epilogue_kernel`) from a profiler trace (bf16), the fp32 call's
     ms and bound (the SR apps' evaluation runs it), and, at B=256 bf16,
     SDPA on B1's attention part alone, (256, 4, 1024, 32), as the
     yardstick (timed only; the port never calls it);
  2. the full slice, LR pixels -> TBSRN (full width: x2, 32x128 HR,
     STN built, 5 SRBs, hidden 32) -> bicubic 32x100 gray -> CRNN(37, 256)
     -> greedy CTC -> strings, through `PixelsToStrings`, on a (256, 16, 64,
     3) bf16 batch with weights from a seed and non-trivial BN statistics.
     The kernel's launch counter must show exactly the 5 enhancer calls of
     one TBSRN forward; SR output and CRNN logits must agree with the same
     model run through the plain version; img/s of both paths;
  3. `InferenceServer(pipe.ids_fn, buckets=(1, 8, 32))` answers 40
     concurrent single-image requests; results equal the direct batched
     call; p50 / p99 latency;
  4. the fused residual-LayerNorm kernel against its plain version at the
     training slices' shapes ((64*1024, 128) for TBSRN, (64*32, 1024) for
     the oracle) in fp32 and bf16, and at the bf16 step's ((128*1024, 128),
     (128*32, 1024)) in bf16: forward, and the gradients through its
     autograd Function against plain autograd; kernel and plain ms;
  5. the hash-dropout attention kernels (forward and backward) against
     the plain version at (64, 1024, 384), 4 heads, rate 0.1, fp32 and
     bf16, and at the bf16 step's (128, 1024, 384): the keep mask bit for
     bit, seed determinism, the output and dqkv; kernel, plain and SDPA
     (timed only) ms of the forward and the backward beside the bound
     (products and the keep hash's integer operations; in fp32 the
     products as three TF32 products, the CUDA-core floor beside it); a
     profiler trace names the kernels, all on the tensor cores: bf16
     `attn_dropout_fwd_mma_kernel`, and `attn_dropout_dsum_mma_kernel`
     with `attn_dropout_bwd_mma_kernel` for the backward; fp32 the split-
     TF32 `attn_dropout_fwd_tf32x3_kernel`, and
     `attn_dropout_bwd_dq_tf32x3_kernel` with
     `attn_dropout_bwd_dkv_tf32x3_kernel`;
  6. the training slice at full width: `SRTrainer` over TBSRN x2 (32x128
     HR, STN + TPS, 5 SRBs, hidden 32, fp32) with the text-focus loss of
     the frozen OCRTransformer(37, 1 channel, (1, 2, 5, 3), 16 heads,
     512/1024/2048) at batch 64, label length 32, Adam(1e-4, 0.5, 0.999)
     after a 0.25 global-norm clip, on seeded smooth random HR images, their
     bicubic LR, and random labels: (a) one step of the kernel path agrees
     with the same step of the plain path (`kernels=False`); (b) the launch
     counters show 5 attention forwards, 5 backwards and 10 + 3 per oracle
     forward LayerNorms per step; (c) 32 steps over 4 repeated batches,
     the HR-map cache hit from epoch 1, losses finite and falling;
     (d) `evaluate()` through the inference path (10 fused-enhancer
     launches per forward) and a CRNN; (e) step ms and img/s of both
     paths, split into TBSRN and oracle forward + backward;
  7. the unmasked-attention kernel (csrc/unmasked_attention.cu) against its
     plain version in fp32 and bf16: the packed route (B7) at the four
     stage shapes of CascadeMiT-b0 on 1024² crops at batch 3, the
     (B, H, L, dh) route (B5) at (1, 8, 512, 32) and at the 2048² whole-
     image stage 0 (1, 1, 262144, 32) over 4096 keys; kernel, plain and
     `F.scaled_dot_product_attention` ms (timed only; the port never calls
     it) beside the bound (in fp32 two floors: three TF32 products at the
     495 TFLOP/s TF32 peak, and fp32 FMA at 67; calls under 0.3 ms in fp32
     also print the kernel's and SDPA's device ms). For each route and
     type a torch.profiler trace names the kernel: bf16 must run the
     tensor-core forward (`attn_fwd_mma_kernel`), fp32 the split-TF32 one
     (`attn_fwd_tf32x3_kernel`);
  8. segmentation at full width: `init_segmentor` on
     configs/seg/textformer_b0_textseg.yaml (CascadeMiT-b0 + SegformerHead,
     weights from a seed, non-trivial BN and LN statistics), then
     `inference_segmentor` in the configs' slide mode (crop 1024², stride
     768²) on a seeded 1024x2048 image, fp32: exactly 8 packed launches
     and 0 (B, H, L, dh) launches, logits equal to `kernels=False` within
     1e-4, class maps equal wherever the top-2 margin exceeds twice the
     measured error; ms per canvas, canvases/s and peak memory of both
     paths;
  9. the same model in whole-image mode: a 512x1024 image (6 packed and
     2 (B, H, L, dh) launches) and a 2048x2048 image (8 (B, H, L, dh)
     launches), with the checks of phase 8;
 10. the region-masked attention kernel (B6, the MASKED variant of
     csrc/unmasked_attention.cu) against its plain version in fp32 and
     bf16 at the four level shapes of CascadeMiT-b0-det on 1024² crops at
     batch 3, with seeded blob ids (0, 1 and 0.5 ids, instance ids, an
     all-background image): max error, fully suppressed rows equal to the
     mean of v; kernel, plain and masked-SDPA ms (timed only) beside the
     bound, as in phase 7; the kernel's name: fp32 the split-TF32 forward,
     bf16 the tensor-core one (`attn_fwd_mma_kernel`, MASKED);
 11. det-guided segmentation at full width: `init_segmentor` on
     configs/seg/textformer_b0_textseg_det.yaml (CascadeMiTDetGuided-b0 +
     SegformerHead, weights from a seed, non-trivial BN and LN statistics;
     `det_cls` redrawn from a seed if the text maps come out trivial), then
     `inference_segmentor` slide on a seeded 1024x2048 image: every crop's
     text map neither all 0 nor all 1 with at least 2 instances, exactly
     (B6, B7, B5) = (8, 8, 0) launches, the checks of phase 8; labelling
     rounds and ms, its ids equal to the same labelling on the CPU; a
     profiler breakdown of one canvas;
 12. the same model in whole mode on 512x1024: (6, 6, 2) launches (level
     3's branches run plain with the materialised mask), the same checks;
 13. the backward kernels of the packed (B7) and region-masked (B6)
     attention (csrc/unmasked_attention.cu, with their training forward)
     against the plain backwards in fp32 and bf16, at the det recipe's four
     level shapes at batch 2 and the plain recipe's stage 0 (B7 only; B6
     with the phase-10 ids of an instance map and an all-background image,
     fully suppressed rows checked on their own): dq/dk/dv relative error,
     kernel, plain and SDPA-backward ms (timed only) beside the bound, as
     in phase 7; at level 0 the kernels by name: fp32 the split-TF32
     training forward and `attn_bwd_dq_tf32x3_kernel`,
     `attn_bwd_dkv_tf32x3_kernel` and the reduce, bf16 the tensor-core
     STATS forward (`attn_fwd_mma_kernel`) and `attn_bwd_dq_mma_kernel`,
     `attn_bwd_dkv_mma_kernel` and the reduce;
 14. one train step of each seg recipe at full b0 width and depth, fp32:
     configs/seg/textformer_b0_textseg.yaml (512², batch 8, CE) and
     textformer_b0_textseg_det.yaml (1024², batch 2, CE + Lovász + 0.1 det
     loss), weights from a seed with non-trivial BN/LN statistics, seeded
     blob batches: the kernel path against `kernels=False` on the same
     generator (loss rel 1e-5, every gradient rel 1e-3, BN statistics
     atol 1e-5), and launches per step of (B7 fwd, B7 bwd, B6 fwd, B6 bwd)
     exactly (6, 6, 0, 0) and (8, 8, 8, 8);
 15. `SegTrainer.train()` for 8 iterations of each recipe with the kwargs
     the JAX app builds from the config (losses finite, every lr the poly
     schedule's) and `evaluate()`; then 16 steps from optimizer count 1500
     (the end of the warmup) on 2 repeated batches, the loss falling;
 16. per recipe and path: step ms, img/s and peak memory, and a
     torch.profiler split of one kernel-path step;
 17. the packed-qkv attention (B3: `flash_mha_qkv_packed`, the unmasked
     kernel of csrc/unmasked_attention.cu on column slices of one
     (B, L, 384) buffer, 4 heads) against its plain version at L 1024
     (B 64 and 256), L 512 and 2048 (B 64), fp32 and bf16; kernel, plain
     and SDPA ms (timed only) beside the bound; the kernel's name checked
     as in phase 7;
 18. phase 2's TBSRN with `fused_enhancer=False` at batch 256 bf16:
     exactly 5 B3, 0 fused-enhancer and 10 residual-LayerNorm launches
     per forward; SR and CRNN logits at phase 2's bars against the fused
     path and against `kernels=False`; img/s of the three paths;
 19. the bidirectional GRU kernel (B8, csrc/fused_gru.cu, every product on
     the tensor cores in split TF32) against its plain versions at TSRN's
     shapes, rows x T = (16384, 16) and (4096, 64), H 32: (a) the
     projection-off entry (`fused_bigru`, JAX's kernel) over fp32
     projections (rows, T, 96); (b) the x-level entry (`fused_bigru_x`,
     TSRN's route: projections and recurrence in one launch) on x (rows,
     T, 64) in fp32 and bf16, its fp32 output within 1e-5 and, on bf16
     input, its bf16 output the rounding of that; kernel, plain, the
     BiGRU module call and cuDNN's GRU (timed only, fp32) ms beside both
     bounds (the tensor cores': 3xTF32, a bf16 x's projection as three
     bf16 products; the CUDA cores'); (c) the x-level entry at (4096, 64)
     with saturating gates (W_ih x10, |pre-activation| up to ~50), fp32
     and bf16 x, at the same bars;
 20. TSRN at full width (x2, 32x128 HR, STN built, 5 SRBs, hidden 32,
     bf16, `fused_gru=True`, non-trivial BN statistics) through
     `PixelsToStrings` with phase 2's CRNN at batch 256: exactly 10 B8
     launches per forward; SR and logits at phase 2's bars against
     `fused_gru=False` (cuDNN) and `kernels=False` (the plain version);
     img/s of the three paths; `InferenceServer(buckets=(1, 8, 32))` as
     in phase 3, and which buckets pass the GRU's rows % 256 gate (with
     --phases, on a CRNN and LR batch made from phase 2's seeds);
 21. Text Gestalt's stroke-focus training: `StrokeSRTrainer` over TSRN
     (STN + TPS, 5 SRBs, hidden 32, fp32) with `StrokeFocusLoss`
     (stroke_lambda 50) of the frozen stroke oracle OCRTransformer(10,
     1 channel, (1, 2, 5, 3), 16 heads) at batch 64, random labels
     through the fallback stroke codec: (a) one step against
     `kernels=False` (loss rel 1e-5, gradients rel 1e-3) and its B2 and
     B8 launches; (b) 32 steps over 4 repeated batches, the loss
     falling; (c) `evaluate()` through the fused-GRU inference path (10
     B8 launches per forward); (d) step ms and img/s of both paths;
 22. the whole-SRB kernel (B9) against its plain version at (64, 16, 64,
     64) in fp32 and bf16 and (256, 16, 64, 64) in bf16, on a
     TransformerResidualBlock with weights from a seed and non-trivial BN
     statistics and LN scales, at phase 1's bars. In bf16 a call is three
     launches (csrc/fused_srb.cu's two wgmma convolutions, the second with
     the enhancer's qkv projection in its epilogue, then B1's attention
     epilogue with the block residual), in fp32 four (two CUDA-core
     convolutions, B1's two kernels): the kernels are read from a profiler
     trace (the launches a call it holds are printed; the card test
     `test_a_call_runs_its_kernels` holds their count), and each conv
     launch is held against its plain twin on the same input (bf16 r1, r
     and qkv within one bf16 ulp).
     Kernel, plain and module-path ms (cuDNN convs, BN, mish, B1, add;
     timed only) beside the bound, the device ms of each launch beside its
     own bound, and cuDNN's two convs with their biases (channels-last,
     mish left out) as the yardstick (`library_ms`);
 23. phase 2's TBSRN with `fused_srb=True` through `PixelsToStrings` at
     batch 256 bf16: exactly 5 B9 calls and 0 standalone B1 launches per
     forward; SR and logits at phase 2's bars against the fused-enhancer
     path and against `kernels=False`; img/s of the three paths;
     `InferenceServer(buckets=(1, 8, 32))` as in phase 3; after one train
     step on the model (its BN running statistics move), inference agrees
     with `fused_srb=False` on the same weights;
 24. the split-operand attention kernels at (64, 1024, 128), 4 heads, fp32
     and bf16: B10 (`flash_mha_packed`, B7's forward on separate q, k, v)
     and B11 (`flash_mha_packed_dropout`, B4's kernels at per-operand row
     strides, rate 0.1: the keep mask bit for bit, seed determinism, the
     output, dq, dk and dv); kernel, plain and SDPA ms (timed only) beside
     the bound, also at (128, 1024, 128) in bf16; B10's kernel names
     checked as in phase 7, B11's as in phase 5. No path of the system
     reaches B10 or B11, as in JAX: their launches are those of this
     phase's checks;
 25. the JAX package's benched training configuration (bench_train.py):
     TBSRN x2 + STN (5 SRBs, hidden 32) and the frozen OCRTransformer(37,
     1, (1, 2, 5, 3), 16 heads), both in bf16, at batch 128, label length
     16, text-focus loss, Adam after the 0.25 clip: (a) one step of the
     kernel path against `kernels=False` and the plain fp32 step on the
     same weights (bars BF16_STEP_LOSS_REL, BF16_STEP_GRAD_REL); (b) 5 B4
     forwards and 5 backwards per step; (c) ms per step and img/s of both
     paths, and B4's device time in a profiled step;
 26. LMDB -> strings: the port's `create_dataset` writes 1343 seeded crops
     (TextZoom's hard test split's count; HR 32x128, LR redrawn at heights
     8-40 and widths 20-200) as a JPEG q95 LMDB in a temporary directory;
     `LMDBToStrings` serves it with phase 2's bf16 pipe at batch 256 (the
     last batch 63 images): 10 B1 launches per batch, every string equal
     to the pipe on the same collated uint8 batches and to the plain path
     under phase 2's top-2-margin rule; img/s with 0 and min(cpu count,
     16) workers, the host's decode + resize ms per image on one worker,
     the device's busy share (CUDA-event time of the `ids_fn` calls over
     the wall), and whether the toolkit has libnvjpeg (not used);
 27. the SR training journey through the apps, from LMDBs the port's
     `create_dataset` writes (512 phase-26 crops, three 128-crop val
     buckets): (a) `apps.scene_text_telescope.main --arch tbsrn --STN
     --text_focus` from a YAML config, batch 64 fp32, 2 epochs (16
     steps), evaluation at 16: launches (13, 5, 5, 0) per step (LayerNorm,
     B4 fwd, B4 bwd, B1) as phase 6b's and 60 B1 launches per evaluation
     as phase 6d's; `best.pt`, `--test --resume auto` giving the same
     evaluation, `--demo` writing 10 PNG strips; the app's step ms on the
     device timeline against phase 6e's, the host's ms per batch and the
     device busy share of 4 fed steps (profiler kernel + copy time over
     the wall); the app's feed (TRAIN.workers = 8 forked processes into
     the prefetch thread) against the same host work in the main thread
     and on the prefetch thread, in turns; (b) `SRTrainer` over
     `LMDBDataset` (an HR-only LMDB) and `MixLMDBDataset`, 2 steps each;
     (c) `apps.text_gestalt.main --arch tsrn --STN --text_focus`, 2 steps
     and one evaluation: B2 3 per step in the stroke oracle, B8 0;
 28. the seg training journey: `apps.seg.train` on
     configs/seg/textformer_b0_textseg.yaml over 16 JPEG photos (1024x768
     and 768x1024, `encode_jpeg`) with TextSeg PNG annotations and 2 val
     photos: the full train pipeline, crop 512², batch 8, (6, 6, 0, 0)
     launches per step, slide evaluation, `iter_4/` and `best/` written;
     then `--auto-resume` to 6 iterations starts at 4 and takes 2 steps;
     the iteration's ms against phase 16's, the host pipeline's ms per
     sample and the device busy share of the resumed run;
 29. the seg models in bf16 (`dtype=torch.bfloat16` in backbone and head,
     as the JAX package's bench_seg.py builds them): (a) B7 and B6 at the
     bf16 steps' shapes (the det recipe's four levels at batch 2, the
     plain recipe's three kernel stages at batch 8): the inference
     forward, the STATS (training) forward and the backward, all on the
     tensor cores, against their plain twins (2e-2 forward, 1e-2
     norm-relative gradients) and against the CPU rounding model of
     tests/torch_attention_cases.py `bf16_attention_model` run on the card
     (o within one bf16 ulp or 1e-2, o32 1e-3, gradients 2e-3); the STATS
     o equal to the inference forward's bit for bit (bf16(p) V, as the
     plain twin rounds it), fully suppressed rows the mean of v; beside
     SDPA in bf16 (B6 with the float mask), with the bf16 bound and the
     fp32 kernel's split-TF32 bound beside it; (b) one
     bf16 train step per recipe (phase 14's, as they are) against the
     bf16 plain step (loss rel 1e-2; gradients 5e-2 norm-relative and
     within the plain bf16 step's distance from the fp32 plain step),
     launches per step by counter and, from a profiled step, by kernel
     name and template (`attn_fwd_mma_kernel<DH, VEC16, MASKED, STATS>`
     with STATS, unmasked and MASKED, and the backward's
     `attn_bwd_dq_mma_kernel`, `attn_bwd_dkv_mma_kernel` and reduce; any
     other attention kernel, a CUDA-core one included, fails), the busy
     share, and ms / img/s beside the fp32 kernel-path step in turns;
 30. bf16 seg inference against the bf16 plain path (logits max 1e-2,
     mean 1e-3 and within twice the plain path's distance from the fp32
     path; class maps equal where the margin exceeds twice the measured
     error): slide over phase 8's canvas, whole 512x1024 and 2048² (B5),
     det-guided slide over phase 11's canvas, whose attention kernels a
     profiler trace names (only `attn_fwd_mma_kernel`); `apps.seg.test`
     with and
     without `--tta` on seeded photos and a checkpoint of the weights with
     the classifier's bias set so that both classes are predicted (fp32:
     the app has no dtype), its metrics against kernels=False's within
     1e-4, and TTA moving them by more; bf16 `tta_inference` over slide on
     the first photo (probabilities max 5e-4);
 31. the CTR pillar (phases 31-33, synthetic characters, random weights
     from seed 0, fp32, batch 32, the JAX apps' default widths):
     `apps.sld.train` in stroke mode (ResNet (3, 4, 6, 3) with the stem
     pool only, d_embed 512, d_model 1024, d_ff 2048, 32x32, max_len 30,
     Adadelta lr 1.0; 4 steps, then the confusable-matched evaluation):
     B2 launched 3 times a step and a decoder pass (102 in the run), one
     step against `kernels=False` (the training bar), the greedy decode's
     ids against the plain path's (equal up to a top-2 margin within twice
     the measured step-output error), step and decode ms of both paths in
     turns, each one's device time and largest kernels, B2 by kernel name
     in a profiled step and decode, B2 against its plain version at
     (32 * 30, 1024); one JSON line;
 32. `apps.ccr_clip.pretrain` (ResNet-50 on 128x128, 12 text layers of
     width 512, 8 heads, embed 2048, context 30; 4 steps, zero-shot
     retrieval; no kernel) and its step and retrieval ms, then
     `apps.ccr_clip.train` over its `best/` (the image_ids encoder,
     out_dim 2048, 32x32, max_len 48, gallery decode; 156 B2 launches) as
     phase 31, B2 at (32 * 48, 1024);
 33. `apps.oictr.train` (the oictr encoder (3, 4, 6), d_model 512,
     d_embed 256, 32x128, max_len 16) for 11 epochs of 4 updates, across
     the SGDR restart at update 40 (180 B2 launches), as phase 31, B2 at
     (32 * 16, 512);
 34. `apps.acpm.train` (the ResNet (3, 4, 6, 3) with the stem pool only,
     d_model 1024, 32x32, max_len 12, the L1 radical counter; 4 steps,
     then the profile-matching evaluation of one test batch: 51 B2
     launches, 3 a step and 39 a test batch, 12 decoder passes and one
     forward for the profile heads) as phase 31, then one step each of
     the VGG and DenseNet encoders and of the STN with the CE counter
     against `kernels=False`; B2 at (32 * 12, 1024);
 35. the CTR models in bf16, JAX's benched configurations: SLD (phase
     31's model and batch, `dtype=torch.bfloat16`): one step against the
     bf16 `kernels=False` step and the fp32 plain step (the bf16 training
     bar), one greedy decode against the bf16 plain path's (step outputs
     within twice the bf16 plain path's distance from fp32, ids by the
     margin rule), step and decode ms beside fp32's in turns, device ms,
     launches and busy share of a profiled call; CCR-CLIP stage 1 at batch
     128 in bf16 beside fp32 in turns (its towers reach no kernel: the
     loss within 1e-2 of the fp32 step's; the gradients' distance from
     fp32 by top-level module, at random init and after 30 fp32 steps);
     bf16 B2 against its plain version at every CTR row of phases 31-34.

Phases 8 and 11 end with a torch.profiler breakdown of one more canvas
(device time by name, the device's busy time against the wall time).

Timings use CUDA events after a warm-up; every timing line carries the
card's name and power limit. Float32 comparisons run with TF32 off. A
kernel's bound is the larger of its operations over the card's peak for
their type (H100 SXM data sheet: fp32 67 TFLOP/s on CUDA cores, bf16
989 TFLOP/s on tensor cores) and its bytes (each input read once, each
output written once) over 3.35 TB/s. The last line is {"ok": true,
"device": {...}}; the line before it is the card's name and power limit as
nvidia-smi gives them, and the line before that the kernel table as JSON
(`fused_residual_layernorm_ctr`: B2's launches in the four CTR entry
points' runs, its numbers at (32 * 30, 1024) fp32;
`fused_residual_layernorm_ctr_bf16`: the bf16 SLD step's and decode's
launches, its numbers at (32 * 30, 1024) bf16; each CTR phase's line
also holds B2 at its training rows and at its decoder passes' rows).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import glob
import itertools
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from fudanocr_tpu_torch.core import checkpoint as ckpt_lib
from fudanocr_tpu_torch.core import serialization
from fudanocr_tpu_torch.data.collate import normalize_uint8
from fudanocr_tpu_torch.data.image import resize_bicubic
from fudanocr_tpu_torch.core.config import dump_yaml
from fudanocr_tpu_torch.data.jpeg import encode_jpeg
from fudanocr_tpu_torch.data.lmdb_dataset import (LMDBDataset,
                                                  LRServingLMDBDataset,
                                                  MixLMDBDataset,
                                                  create_dataset)
from fudanocr_tpu_torch.data.png import decode_png, encode_png
from fudanocr_tpu_torch.data.prefetch import PrefetchIterator
from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter
from fudanocr_tpu_torch.losses.sr_losses import (LOSS_VOCAB, TextFocusLoss,
                                                 encode_text_labels)
from fudanocr_tpu_torch.losses.stroke_focus import StrokeFocusLoss
from fudanocr_tpu_torch.models.rec.crnn import CRNN, parse_crnn_input
from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
from fudanocr_tpu_torch.models.sr.tbsrn import (TBSRN,
                                                TransformerResidualBlock)
from fudanocr_tpu_torch.models.sr.tsrn import TSRN
from fudanocr_tpu_torch.nn.attention import positional_encoding_2d
from fudanocr_tpu_torch.nn.recurrent import BiGRU
from fudanocr_tpu_torch.ops import _build
from fudanocr_tpu_torch.ops import flash_attention as fa
from fudanocr_tpu_torch.ops import fused_gru as fgru
from fudanocr_tpu_torch.ops.fused_enhancer import (enhancer_operands,
                                                   fused_enhancer,
                                                   fused_enhancer_reference)
from fudanocr_tpu_torch.ops.fused_layernorm import (
    fused_residual_layernorm, fused_residual_layernorm_reference)
from fudanocr_tpu_torch.ops import fused_srb as fsrb
from fudanocr_tpu_torch.ops.fused_srb import (fused_srb, fused_srb_reference,
                                              srb_conv_mish, srb_conv_qkv)
from fudanocr_tpu_torch.ops import region_attention as ra
from fudanocr_tpu_torch.apps.seg.inference import (inference_segmentor,
                                                   init_segmentor)
from fudanocr_tpu_torch.data.seg_pipeline import Normalize
from fudanocr_tpu_torch.models.seg.det_guided import (instance_labels,
                                                      region_vectors,
                                                      soft_argmax)
from fudanocr_tpu_torch.models.seg.encoder_decoder import crop_grid
from fudanocr_tpu_torch.data.seg_dataset import batches_from
from fudanocr_tpu_torch.serving import (InferenceServer, LMDBToStrings,
                                        PixelsToStrings)
from fudanocr_tpu_torch.train import seg as train_seg
from fudanocr_tpu_torch.train import sr as train_sr
from fudanocr_tpu_torch.train.seg import (SegTrainer, make_seg_optimizer,
                                          make_seg_train_step, poly_schedule)
from fudanocr_tpu_torch.train.sr import (SRTrainer, StrokeSRTrainer,
                                        make_sr_train_step)
from fudanocr_tpu_torch.train.state import adam_with_clip
from fudanocr_tpu_torch.utils.weights import jax_variables

SEED = 0
ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"
SRB_NUMS = 5
BATCH = 256          # phase-2 batch
LR_HW = (16, 64)     # TextZoom LR geometry -> L = 1024 enhancer tokens
# bf16 bars: the JAX kernel's own (tests/test_fused_enhancer.py:50-51)
BF16_ATOL, BF16_MEAN = 0.05, 0.01
# fp32 bars: tests/test_fused_enhancer.py:37
FP32_RTOL, FP32_ATOL = 2e-4, 2e-5
# phases 4-5, kernel vs plain on the same inputs. fp32: the same math in
# another summation order (measured max errors 1e-6 .. 3e-6); bf16: the
# outputs are rounded to bf16 (8 mantissa bits), and the plain attention
# rounds its probabilities to bf16 for the value product. The bf16 kernels
# of csrc/unmasked_attention.cu (phases 7, 10, 13, 17, 24, 29) and the bf16
# dropout kernels (phases 5, 24) round them there too; their backwards also
# round P and dS for dV and dK (tests/test_torch_seg_bf16_rounding.py,
# test_torch_dropout_rounding.py)
LN_ATOL = {torch.float32: 1e-5, torch.bfloat16: 0.04}
ATTN_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# phase 6: the full train step, kernel path vs plain path
STEP_LOSS_REL, STEP_GRAD_REL = 1e-5, 1e-3
TRAIN_B, LABEL_LEN, HEADS, RATE = 64, 32, 4, 0.1
# phases 5 and 24: the dropout kernels' cases (dtype, batch) at L = 1024;
# batch 128 is the bf16 train step's (phase 25)
DROPOUT_CASES = ((torch.float32, TRAIN_B), (torch.bfloat16, TRAIN_B),
                 (torch.bfloat16, 128))
# the keep hash per score and pass, from the kernels' code: a counter add, 2
# multiplies, 3 shift-xors (the seed xor folded in) and the compare; the
# H100 SXM's int32 rate: 64 int32 lanes per SM x 132 SMs x 1.98 GHz (the
# Hopper architecture white paper)
HASH_OPS, INT32_OPS_PER_S = 10, 64 * 132 * 1.98e9
TRAIN_BATCHES, EPOCHS, EVAL_BATCHES = 4, 8, 2
# phases 7-9: the segmentation slice
SEG_CONFIG = "configs/seg/textformer_b0_textseg.yaml"
SEG_CROP, SEG_STRIDE = (1024, 1024), (768, 768)
SEG_ATOL = 1e-4   # logits, kernel path vs kernels=False, fp32
# phase 30, bf16 kernel path vs the bf16 plain path, about 2.5-4x the
# largest reading of PR 18's sound runs (NVIDIA H100 80GB HBM3, 700 W):
# logits max 1.465e-3 .. 3.662e-3 and mean 1.780e-4 .. 3.953e-4 over the
# slide, whole and det slide canvases (|logits| up to 0.209), TTA
# probabilities max 1.219e-4; each path also within twice the bf16 plain
# path's own distance from the fp32 path, as the CPU tests hold the port
# to JAX (that distance is a few bf16 ulps of the logits too: max
# 1.79e-3 .. 1.87e-3, mean 2.95e-4 .. 3.98e-4 in the same runs)
SEG_BF16_ATOL, SEG_BF16_MEAN, SEG_TTA_ATOL = 1e-2, 1e-3, 5e-4
# phase 30, apps.seg.test's metrics, fp32 kernel path vs kernels=False: a
# class flipped at a near-tie pixel moves a metric by ~1 / 1.5e6 over the
# two photos; the bar admits ~150 such flips, and TTA itself must move
# the metrics by more than the bar
SEG_METRIC_ATOL = 1e-4
# B7 on the slide recipe's 1024² crops at batch 3: (B, Lq, Lkv, D, heads)
B7_SHAPES = ((3, 65536, 1024, 32, 1), (3, 16384, 1024, 64, 2),
             (3, 4096, 1024, 160, 5), (3, 1024, 1024, 256, 8))
# B5: stage 3 of a 512x1024 whole image (the JAX full-K variant) and stage 0
# of a 2048² whole image (online softmax): (B, H, Lq, Lkv, dh)
B5_SHAPES = ((1, 8, 512, 512, 32), (1, 1, 262144, 4096, 32))
# phases 10-12: the det-guided slice; B6 at the four levels of 1024² crops at
# batch 3: (B, Lq, Lkv, D, heads, level side, sr)
DET_CONFIG = "configs/seg/textformer_b0_textseg_det.yaml"
B6_SHAPES = ((3, 65536, 1024, 32, 1, 256, 8), (3, 16384, 1024, 64, 2, 128, 4),
             (3, 4096, 1024, 160, 5, 64, 2), (3, 1024, 1024, 256, 8, 32, 1))
# the det-guided canvases and their (B6, B7, B5) launches: a slide canvas
# (3 crops, every level's branches on B6, every stage on B7) and a whole
# 512x1024 image (level 3: Lq = 512, branches plain, stage on B5)
DET_SLIDE_HW, DET_SLIDE_LAUNCHES = (1024, 2048), (8, 8, 0)
DET_WHOLE_HW, DET_WHOLE_LAUNCHES = (512, 1024), (6, 6, 2)
# phases 13-16: the seg training slice. Backward shapes (B, Lq, Lkv, D,
# heads, level side, sr): the det recipe's four levels at batch 2, then the
# plain recipe's stage 0 at batch 8 (B7 only)
BWD_SHAPES = ((2, 65536, 1024, 32, 1, 256, 8), (2, 16384, 1024, 64, 2, 128, 4),
              (2, 4096, 1024, 160, 5, 64, 2), (2, 1024, 1024, 256, 8, 32, 1),
              (8, 16384, 256, 32, 1, 128, 8))
# the two recipes: (config, launches per step of (B7 fwd, B7 bwd, B6 fwd,
# B6 bwd)); crop and batch come from the configs (512², 8; 1024², 2)
TRAIN_RECIPES = ((SEG_CONFIG, (6, 6, 0, 0)), (DET_CONFIG, (8, 8, 8, 8)))
TRAIN_ITERS, TRAJ_STEPS, TRAJ_START = 8, 16, 1500
# published H100 SXM peaks (dense fp32 / bf16 tensor core, HBM3), 700 W
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
# the dense TF32 tensor-core peak; the fp32 attention kernels (csrc/
# unmasked_attention.cu, csrc/flash_attention_dropout.cu) run each product
# as three TF32 products
TF32_FLOPS, TF32X3_PRODUCTS = 495e12, 3


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


def bound(flops: float, nbytes: float, dtype) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak for `dtype` and the bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def seg_attn_bound(flops: float, nbytes: float, dtype) -> dict:
    """The bound of a csrc/unmasked_attention.cu kernel: in fp32 the split-
    TF32 floor, three TF32 products per product at the tensor cores' TF32
    peak (`bound_ms`), beside the CUDA cores' fp32 floor
    (`cuda_core_bound_ms`); in bf16 `bound`."""
    if dtype != torch.float32:
        return bound(flops, nbytes, dtype)
    t_ops = TF32X3_PRODUCTS * flops / TF32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "cuda_core_bound_ms": bound(flops, nbytes, dtype)["bound_ms"]}


def attn_bound(b: int, h: int, lq: int, lk: int, dh: int, dtype,
               extra_bytes: int = 0) -> dict:
    """Softmax attention forward: two products of 2*Lq*Lkv*dh flops per
    head; q, k, v read and o written once."""
    es = torch.finfo(dtype).bits // 8
    return seg_attn_bound(4 * b * h * lq * lk * dh,
                          es * b * h * dh * (2 * lq + 2 * lk) + extra_bytes,
                          dtype)


def bound_note(bd: dict) -> str:
    """The bound as the phases print it: both floors in fp32."""
    note = f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}"
    if "cuda_core_bound_ms" in bd:
        note += (f", {bd.get('floor', '3xTF32')}; CUDA-core fp32 floor "
                 f"{bd['cuda_core_bound_ms']:.4f} ms")
    return note + ")"


# fp32 calls faster than this also print device time: their CUDA-event time
# reads the host's launch rate
SHORT_MS = 0.3


def short_note(fn, lib, ms: float, dt, iters: int = 20) -> str:
    """Device ms of `fn` and of the library call `lib` (torch.profiler),
    for fp32 calls under SHORT_MS."""
    if dt != torch.float32 or ms >= SHORT_MS:
        return ""
    return (f", device ms: kernel {device_ms(fn, iters):.4f}, library "
            f"{device_ms(lib, iters):.4f}")


def device_ms(fn, iters: int) -> float:
    """Mean device time per call of `fn` over `iters` calls: the card's
    kernel and copy time in torch.profiler, without the host's launch
    time between calls that `cuda_ms` sees when a call is short."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / iters


def kernel_names(phase: str, what: str, fn, dt, prefix: str,
                 want: list) -> None:
    """Print the kernels named `prefix`... that ten calls of `fn` (after a
    warm-up call) launch, by name in a torch.profiler trace of host and
    device, as `profile_step` takes it; fail unless they are `want`. The
    profiler on the card's machine now and then delivers no device event
    at all for a short trace (seen right after another trace); such a
    trace is taken again, at most twice."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        kernels = {re.split(r"[<(]", re.sub(
            r"^void |\(anonymous namespace\)::", "", e.key))[0]
            for e in prof.key_averages() if e.device_time_total > 0}
        if kernels:
            break
        print(f"phase {phase}: {what} {dt}: the profiler trace held no "
              "device event; taking it again")
    names = sorted(n for n in kernels if n.startswith(prefix))
    print(f"phase {phase}: {what} {dt} ran {names}")
    if names != want:
        raise AssertionError(f"phase {phase}: {what} {dt} ran {names} of "
                             f"{sorted(kernels)}, want {want}")


def attn_kernel_name(phase: str, what: str, fn, dt) -> None:
    """Fail unless the attention forward that `fn` runs is the split-TF32
    kernel in fp32 and the tensor-core one in bf16 (csrc/
    unmasked_attention.cu `attn_fwd_mma_kernel`: unmasked, MASKED and
    STATS), by name in a profiler trace."""
    kernel_names(phase, what, fn, dt, "attn_fwd",
                 ["attn_fwd_mma_kernel" if dt == torch.bfloat16
                  else "attn_fwd_tf32x3_kernel"])


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
        # per token: qkv 2*64*384, attention 4*L*128, out 2*128*128, FFN
        # 2*2*128*128, proj 2*128*64; tokens in and out, the PE terms
        es = torch.finfo(dt).bits // 8
        flops = b * h * w * (2 * 64 * 384 + 4 * h * w * 128
                             + 6 * 128 * 128 + 2 * 128 * 64)
        nbytes = 2 * b * h * w * 64 * es + h * w * (64 * es + 384 * 4)
        if dt == torch.float32:
            # fp32 as every fp32 kernel of the port: the 3xTF32 floor, the
            # CUDA-core floor (where this kernel runs today) beside it
            k_ms, p_ms = in_turns(lambda: fused_enhancer(x, ops),
                                  lambda: fused_enhancer_reference(x, ops),
                                  10)
            print(f"phase 1: B={b} L={h * w} fp32 enhancer (the SR apps' "
                  f"evaluation): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
                  f"{bound_note(seg_attn_bound(flops, nbytes, dt))} "
                  f"[{gpu}]")
        if dt == torch.bfloat16:
            k_ms, p_ms = in_turns(lambda: fused_enhancer(x, ops),
                                  lambda: fused_enhancer_reference(x, ops), 10)
            split = kernel_split(lambda: fused_enhancer(x, ops), 10)
            # the yardstick covers the attention part only: no one PyTorch
            # call computes the whole enhancer
            q, k, v = (torch.randn(b, HEADS, h * w, 32, generator=gen)
                       .to(dev, dt) for _ in range(3))
            lib_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v), 10)
            del q, k, v
            print(f"phase 1: B={b} L={h * w} bf16 enhancer: kernel "
                  f"{k_ms:.4f} ms (device ms by kernel {split}), plain "
                  f"{p_ms:.4f} ms; SDPA on its attention part alone "
                  f"({b}, {HEADS}, {h * w}, 32) {lib_ms:.4f} ms [{gpu}]")
            result[b] = {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
                         **bound(flops, nbytes, dt), "library_ms": lib_ms,
                         "library": "SDPA on the attention part only"}
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
            elif isinstance(m, torch.nn.LayerNorm):
                n = m.weight.numel()
                m.weight.copy_(1 + torch.randn(n, generator=gen) * 0.2)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def ocr_models(dev) -> tuple:
    """Phase 2's bf16 TBSRN, its `kernels=False` twin and CRNN(37, 256),
    weights and BN statistics from the seeds -> (sr, sr_plain, crnn, gen)."""
    torch.manual_seed(SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    sr = TBSRN(scale_factor=2, width=128, height=32, stn=True,
               srb_nums=SRB_NUMS, hidden_units=32, dtype=bf16)
    randomize_stats(sr, gen)
    sr_plain = TBSRN(scale_factor=2, width=128, height=32, stn=True,
                     srb_nums=SRB_NUMS, hidden_units=32, kernels=False,
                     dtype=bf16)
    sr_plain.load_state_dict(sr.state_dict())
    crnn = CRNN(num_classes=37, hidden=256, dtype=bf16)
    randomize_stats(crnn, gen)
    sr, sr_plain, crnn = (m.to(dev).eval() for m in (sr, sr_plain, crnn))
    return sr, sr_plain, crnn, gen


def phase2(dev, gpu: str):
    sr, sr_plain, crnn, gen = ocr_models(dev)
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


def phase3(pipe: PixelsToStrings, lr: torch.Tensor, gpu: str,
           phase: str = "3") -> None:
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
    print(f"phase {phase}: {n} concurrent requests, buckets run "
          f"{st['batches']}; "
          f"ids equal to the direct batched call at {int(same.sum())} of "
          f"{same.size} steps, and at all {int(sure.sum())} steps with a "
          f"top-2 margin above {tol:.3e}; latency p50 {st['p50_ms']} ms, "
          f"p99 {st['p99_ms']} ms [{gpu}]")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def ln_case(phase: str, rows: int, d: int, dt, gen: torch.Generator, dev,
            gpu: str) -> dict:
    """B2 at (rows, d) in `dt` against its plain version (forward, and the
    gradients through its autograd Function against plain autograd), its
    ms in turns with the plain version's, device ms and bound: the kernel
    row's numbers."""
    x, r = (torch.randn(rows, d, generator=gen).to(dev, dt)
            for _ in range(2))
    s = (1 + 0.2 * torch.randn(d, generator=gen)).to(dev)
    b = (0.1 * torch.randn(d, generator=gen)).to(dev)
    g = torch.randn(rows, d, generator=gen).to(dev, dt)
    lk = [t.clone().requires_grad_() for t in (x, r, s, b)]
    lp = [t.clone().requires_grad_() for t in (x, r, s, b)]
    got = fused_residual_layernorm(*lk)
    want = fused_residual_layernorm_reference(*lp)
    gk = torch.autograd.grad(got, lk, g)
    gp = torch.autograd.grad(want, lp, g)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("LayerNorm kernel output not finite")
    err = (got.float() - want.float()).abs().max().item()
    grel = max(rel_err(a, c) for a, c in zip(gk, gp))
    if err > LN_ATOL[dt] or grel > GRAD_REL[dt]:
        raise AssertionError(
            f"LayerNorm kernel disagrees at ({rows}, {d}) {dt}: "
            f"max abs {err} (bar {LN_ATOL[dt]}), grads rel {grel} "
            f"(bar {GRAD_REL[dt]})")
    k_ms, p_ms = in_turns(
        lambda: fused_residual_layernorm(x, r, s, b),
        lambda: fused_residual_layernorm_reference(x, r, s, b), 20)
    kb_ms, pb_ms = in_turns(
        lambda: torch.autograd.grad(fused_residual_layernorm(*lk), lk, g),
        lambda: torch.autograd.grad(
            fused_residual_layernorm_reference(*lp), lp, g), 10)
    kd_ms = device_ms(lambda: fused_residual_layernorm(x, r, s, b), 20)
    print(f"phase {phase}: residual LN ({rows}, {d}) {dt}: max abs err "
          f"{err:.3e}, grads max rel {grel:.3e}; forward kernel "
          f"{k_ms:.4f} ms ({kd_ms:.4f} ms of device time in the "
          f"profiler), plain {p_ms:.4f} ms; forward+backward "
          f"{kb_ms:.4f} ms, plain {pb_ms:.4f} ms [{gpu}]")
    es = torch.finfo(dt).bits // 8
    # F.layer_norm is another function (biased variance, eps under the
    # root): no library call
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            **bound(8 * rows * d, 3 * rows * d * es + 8 * d, dt),
            "library_ms": None}


def phase4(dev, gpu: str) -> dict:
    gen = torch.Generator().manual_seed(SEED + 4)
    result = {}
    both = (torch.float32, torch.bfloat16)
    for rows, d, dts in ((TRAIN_B * 1024, 128, both),
                         (TRAIN_B * 32, 1024, both),
                         (STEP_B * 1024, 128, (torch.bfloat16,)),
                         (STEP_B * 32, 1024, (torch.bfloat16,))):
        for dt in dts:
            result[(rows, d, dt)] = ln_case("4", rows, d, dt, gen, dev, gpu)
    return (result[(TRAIN_B * 1024, 128, torch.float32)],
            result[(STEP_B * 1024, 128, torch.bfloat16)])


def dropout_bound(b: int, heads: int, l: int, dt, products: int,
                  passes: int, nbytes: int) -> tuple:
    """The least time of the dropout kernels: `products` matrix products
    of 2*L*L*dh flops per image and head (bf16 at its peak; fp32 as three
    TF32 products each at the TF32 peak, the kernels' split TF32, with the
    CUDA cores' fp32 floor beside it as `cuda_core_bound_ms`), `passes`
    evaluations of the keep hash per score (HASH_OPS int32 operations each)
    at the int32 rate, and `nbytes` over the memory rate; the largest, with
    (products ms, hash ms) beside it."""
    scores = b * heads * l * l
    flops = products * 2 * scores * 32
    t_fma = flops / PEAK_FLOPS[dt] * 1e3
    t_mm = (TF32X3_PRODUCTS * flops / TF32_FLOPS * 1e3
            if dt == torch.float32 else t_fma)
    t_hash = passes * scores * HASH_OPS / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bd = {"bound_ms": max(t_mm, t_hash, t_bytes),
          "bound_by": "bytes" if t_bytes > max(t_mm, t_hash)
          else "operations"}
    if dt == torch.float32:
        bd["cuda_core_bound_ms"] = max(t_fma, t_hash, t_bytes)
    return bd, t_mm, t_hash


def dropout_note(bd: dict, t_mm: float, t_hash: float) -> str:
    """A dropout kernel's bound as phases 5 and 24 print it."""
    note = (f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; products "
            f"{t_mm:.4f}, hash {t_hash:.4f}")
    if "cuda_core_bound_ms" in bd:
        note += (f"; 3xTF32; CUDA-core fp32 floor "
                 f"{bd['cuda_core_bound_ms']:.4f} ms")
    return note + ")"


# the dropout kernels of each type, by name (csrc/flash_attention_dropout.cu
# in bf16: forward, the row terms D', the gradients; csrc/
# flash_attention_dropout_tf32x3.cu in fp32: forward, dQ and D, dK and dV)
DROPOUT_KERNELS = {
    torch.bfloat16: ["attn_dropout_bwd_mma_kernel",
                     "attn_dropout_dsum_mma_kernel",
                     "attn_dropout_fwd_mma_kernel"],
    torch.float32: ["attn_dropout_bwd_dkv_tf32x3_kernel",
                    "attn_dropout_bwd_dq_tf32x3_kernel",
                    "attn_dropout_fwd_tf32x3_kernel"]}


def dropout_kernel_names(phase: str, what: str, fn, dt) -> None:
    """Fail unless `fn` (a forward and backward through the dropout
    wrappers) runs the tensor-core kernels of `dt` (DROPOUT_KERNELS), by
    name in a profiler trace."""
    kernel_names(phase, what, fn, dt, "attn_dropout_", DROPOUT_KERNELS[dt])


def phase5(dev, gpu: str) -> dict:
    l = 1024
    gen = torch.Generator().manual_seed(SEED + 5)
    seed = torch.tensor(20261016, device=dev)
    keep = fa.dropout_keep_mask_cuda(seed, TRAIN_B, HEADS, l, RATE, dev)
    same = torch.equal(keep, fa.dropout_keep_oracle(TRAIN_B, HEADS, l, seed,
                                                    RATE, device=dev))
    frac = keep.float().mean().item()
    print(f"phase 5: keep mask ({TRAIN_B}, {HEADS}, {l}, {l}) from the "
          f"kernels' hash equals the plain hash bit for bit: {same}; kept "
          f"{frac:.5f} (rate {RATE}) [{gpu}]")
    if not same or abs(frac - (1 - RATE)) > 1e-3:
        raise AssertionError("keep mask differs from the plain hash")
    del keep
    rows = {}
    for dt, b in DROPOUT_CASES:
        qkv = torch.randn(b, l, 3 * HEADS * 32, generator=gen).to(dev, dt)
        do = torch.randn(b, l, HEADS * 32, generator=gen).to(dev, dt)
        xk, xp = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
        out_k = fa.flash_mha_qkv_packed_dropout(xk, seed, HEADS, RATE)
        (dk,) = torch.autograd.grad(out_k, xk, do)
        out_p = fa.flash_mha_qkv_packed_dropout_reference(xp, seed, HEADS,
                                                          RATE)
        (dp,) = torch.autograd.grad(out_p, xp, do)
        torch.cuda.synchronize()
        ferr = (out_k.float() - out_p.float()).abs().max().item()
        berr = (dk.float() - dp.float()).abs().max().item()
        brel = rel_err(dk, dp)
        again = fa.flash_mha_qkv_packed_dropout(qkv, seed, HEADS, RATE)
        other = fa.flash_mha_qkv_packed_dropout(qkv, seed + 1, HEADS, RATE)
        print(f"phase 5: dropout attention ({b}, {l}, {3 * HEADS * 32}) "
              f"{dt}: forward max abs err {ferr:.3e}; dqkv max abs err "
              f"{berr:.3e}, rel {brel:.3e}; same seed bit-identical: "
              f"{torch.equal(again, out_k)}, another seed differs: "
              f"{not torch.equal(other, again)} [{gpu}]")
        if not (torch.isfinite(out_k).all() and torch.isfinite(dk).all()):
            raise AssertionError("attention kernels' output not finite")
        if ferr > ATTN_ATOL[dt] or brel > GRAD_REL[dt]:
            raise AssertionError(f"attention kernels disagree ({dt})")
        if not torch.equal(again, out_k) or torch.equal(other, again):
            raise AssertionError("the seed does not decide the output")
        del out_k, out_p, dk, dp, again, other
        o, lse = fa.qkv_dropout_fwd(qkv, seed, HEADS, RATE)
        og = fa.flash_mha_qkv_packed_dropout_reference(xp, seed, HEADS, RATE)
        f_ms, fp_ms = in_turns(
            lambda: fa.flash_mha_qkv_packed_dropout(qkv, seed, HEADS, RATE),
            lambda: fa.flash_mha_qkv_packed_dropout_reference(
                qkv, seed, HEADS, RATE), 5)
        b_ms, bp_ms = in_turns(
            lambda: fa.qkv_dropout_bwd(qkv, o, do, lse, seed, HEADS, RATE),
            lambda: torch.autograd.grad(og, xp, do, retain_graph=True), 5)
        # the yardstick: SDPA with dropout 0.1 on the same (B, H, L, dh)
        # views (it draws another mask; timed only)
        xs = qkv.clone().requires_grad_()
        qh, kh, vh = (xs[..., i * HEADS * 32:(i + 1) * HEADS * 32]
                      .unflatten(-1, (HEADS, 32)).transpose(1, 2)
                      for i in range(3))
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      dropout_p=RATE)
        lib_f = cuda_ms(sdpa, 5)
        so = sdpa().transpose(1, 2).reshape(b, l, HEADS * 32)
        lib_b = cuda_ms(lambda: torch.autograd.grad(so, xs, do,
                                                    retain_graph=True), 5)
        es = torch.finfo(dt).bits // 8
        n_qkv, n_o = b * l * 3 * HEADS * 32, b * l * HEADS * 32
        # forward: 2 products, one hash pass; qkv read, o and lse written.
        # backward: 5 products (s again, dV, dP, dQ, dK) and one keep bit
        # per score, what the function needs (the kernels recompute s, dP
        # and the bit in each of their three roles); qkv, o, dO, lse read,
        # dqkv written
        fb, f_mm, f_hash = dropout_bound(b, HEADS, l, dt, 2, 1,
                                         (n_qkv + n_o) * es
                                         + b * HEADS * l * 4)
        bb, b_mm, b_hash = dropout_bound(b, HEADS, l, dt, 5, 1,
                                         (2 * n_qkv + 2 * n_o) * es
                                         + b * HEADS * l * 4)
        print(f"phase 5: ({b}, {l}, {3 * HEADS * 32}) {dt}: forward kernel "
              f"{f_ms:.4f} ms, plain {fp_ms:.4f} ms, SDPA {lib_f:.4f} ms, "
              f"{dropout_note(fb, f_mm, f_hash)}; backward kernel "
              f"{b_ms:.4f} ms, plain {bp_ms:.4f} ms, SDPA {lib_b:.4f} ms, "
              f"{dropout_note(bb, b_mm, b_hash)} [{gpu}]")
        rows[(dt, b)] = (
            {"max_abs_err": ferr, "ms": f_ms, "plain_ms": fp_ms, **fb,
             "library_ms": lib_f},
            {"max_abs_err": berr, "ms": b_ms, "plain_ms": bp_ms, **bb,
             "library_ms": lib_b})
        del qkv, do, xk, xp, og, o, lse, so, xs, qh, kh, vh
        torch.cuda.empty_cache()
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(TRAIN_B, l, 3 * HEADS * 32,
                          generator=gen).to(dev, dt).requires_grad_()
        do = torch.randn(TRAIN_B, l, HEADS * 32, generator=gen).to(dev, dt)
        dropout_kernel_names(
            "5", "B4", lambda: torch.autograd.grad(
                fa.flash_mha_qkv_packed_dropout(qkv, seed, HEADS, RATE), qkv,
                do), dt)
    return rows


class SeededTextZoom:
    """Paired SR batches made from a seed, with `.batches(batch_size)` as
    SRTrainer takes them: smooth random HR images (bicubic upsampled 8x32
    noise, 32x128x3 in [0, 1]), their bicubic 16x64 LR, and random
    lowercase/digit labels of 3-12 characters."""

    def __init__(self, n: int, seed: int):
        gen = torch.Generator().manual_seed(seed)
        hr = F.interpolate(torch.rand(n, 3, 8, 32, generator=gen), (32, 128),
                           mode="bicubic", align_corners=False).clamp(0, 1)
        lr = F.interpolate(hr, LR_HW, mode="bicubic",
                           align_corners=False).clamp(0, 1)
        self.hr = hr.permute(0, 2, 3, 1).contiguous().numpy()
        self.lr = lr.permute(0, 2, 3, 1).contiguous().numpy()
        rng = np.random.default_rng(seed)
        self.labels = ["".join(rng.choice(list(ALPHABET),
                                          rng.integers(3, 13)))
                       for _ in range(n)]

    def batches(self, batch_size: int):
        for i in range(0, len(self.labels) - batch_size + 1, batch_size):
            yield (self.hr[i:i + batch_size], self.lr[i:i + batch_size],
                   self.labels[i:i + batch_size])


def train_counts() -> tuple:
    return (fused_residual_layernorm.launches, fa.qkv_dropout_fwd.launches,
            fa.qkv_dropout_bwd.launches, fused_enhancer.launches)


def reset_counts() -> None:
    fused_residual_layernorm.launches = 0
    fa.qkv_dropout_fwd.launches = fa.qkv_dropout_bwd.launches = 0
    fused_enhancer.launches = 0


def split_ms(model, loss_fn, batch, gen) -> tuple:
    """(TBSRN forward+backward ms, oracle loss forward+backward ms) of one
    train step, from CUDA events around the model's forward, the loss's
    forward and backward down to the SR image, and the model's backward."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    sr = model(batch["lr"], train=True, generator=gen)
    ev[1].record()
    sr_d = sr.detach().requires_grad_()
    loss, _ = loss_fn(sr_d, batch["hr"], batch["text_input"],
                      batch["text_gt"], batch["lengths"],
                      hr_map=batch["hr_map"])
    (loss * 100.0).backward()
    ev[2].record()
    sr.backward(sr_d.grad)
    ev[3].record()
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    return (ev[0].elapsed_time(ev[1]) + ev[2].elapsed_time(ev[3]),
            ev[1].elapsed_time(ev[2]))


def phase6(dev, gpu: str) -> tuple:
    torch.manual_seed(SEED + 6)
    sr_kw = dict(scale_factor=2, width=128, height=32, stn=True,
                 srb_nums=SRB_NUMS, hidden_units=32)
    oracle_kw = dict(vocab=LOSS_VOCAB, num_in=1, layers=(1, 2, 5, 3),
                     num_heads=16, d_embed=512, d_model=1024, d_ff=2048)
    model = TBSRN(**sr_kw).to(dev)
    plain = TBSRN(**sr_kw, kernels=False).to(dev)
    oracle = OCRTransformer(**oracle_kw).to(dev)
    oracle_plain = OCRTransformer(**oracle_kw, kernels=False).to(dev)
    oracle_plain.load_state_dict(oracle.state_dict())
    crnn = CRNN(num_classes=37, hidden=256).to(dev).eval()
    loss_k, loss_p = TextFocusLoss(oracle), TextFocusLoss(oracle_plain)
    data = SeededTextZoom(TRAIN_BATCHES * TRAIN_B, SEED + 60)
    eval_data = SeededTextZoom(EVAL_BATCHES * TRAIN_B, SEED + 61)
    trainer = SRTrainer(model, loss_k, data, eval_data, batch_size=TRAIN_B,
                        lr=1e-4, epochs=EPOCHS, eval_every=10 ** 9,
                        max_label_len=LABEL_LEN, recognizer=crnn,
                        converter=CTCLabelConverter(ALPHABET), seed=SEED)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = trainer._device_batch(*next(data.batches(TRAIN_B)))

    # (a) one step, kernel path vs plain path, same state and generator
    plain.load_state_dict(init)
    step_k = make_sr_train_step(model, loss_k,
                                adam_with_clip(model.parameters(), 1e-4))
    step_p = make_sr_train_step(plain, loss_p,
                                adam_with_clip(plain.parameters(), 1e-4))
    torch.cuda.synchronize()
    reset_counts()
    mk = step_k(batch, torch.Generator(dev).manual_seed(7))
    torch.cuda.synchronize()
    live = train_counts()
    mp = step_p(batch, torch.Generator(dev).manual_seed(7))
    torch.cuda.synchronize()
    lk, lp = mk["loss"].item(), mp["loss"].item()
    loss_rel = abs(lk - lp) / abs(lp)
    pairs = [(n, pk.grad, pp.grad) for (n, pk), pp in
             zip(model.named_parameters(), plain.parameters())]
    top = max(gp.norm().item() for _, _, gp in pairs)
    worst, worst_name, zero = 0.0, "", 0
    for name, gk, gp in pairs:
        if gp.norm().item() <= 1e-6 * top:
            # exactly-zero gradients up to rounding (conv biases in front
            # of a train-mode BatchNorm): held to 1e-6 of the largest
            zero += 1
            if (gk - gp).norm().item() > 1e-6 * top:
                raise AssertionError(f"{name}: zero gradient differs")
            continue
        err = rel_err(gk, gp)
        if err > worst:
            worst, worst_name = err, name
    print(f"phase 6a: one train step at batch {TRAIN_B}, kernel path loss "
          f"{lk:.6f}, plain path {lp:.6f} (rel {loss_rel:.3e}, bar "
          f"{STEP_LOSS_REL}); per-tensor gradient rel err max {worst:.3e} "
          f"({worst_name}; bar {STEP_GRAD_REL}) over {len(pairs) - zero} "
          f"tensors, {zero} zero-gradient tensors equal; grad norm "
          f"{mk['grad_norm'].item():.4f} vs {mp['grad_norm'].item():.4f} "
          f"[{gpu}]")
    if not all(np.isfinite(v.item()) for v in mk.values()):
        raise AssertionError("train step metrics are not finite")
    if loss_rel > STEP_LOSS_REL or worst > STEP_GRAD_REL:
        raise AssertionError("kernel path train step disagrees with plain")

    # (b) launches per step: live HR map (two oracle forwards), cached (one)
    batch["hr_map"] = loss_k.hr_oracle_map(batch["hr"], batch["text_input"])
    torch.cuda.synchronize()
    reset_counts()
    step_k(batch, torch.Generator(dev).manual_seed(8))
    torch.cuda.synchronize()
    cached = train_counts()
    want_live = (2 * SRB_NUMS + 2 * 3, SRB_NUMS, SRB_NUMS, 0)
    want_cached = (2 * SRB_NUMS + 3, SRB_NUMS, SRB_NUMS, 0)
    print(f"phase 6b: launches per step (LayerNorm, attention forward, "
          f"attention backward, fused enhancer): live HR map {live} "
          f"(expected {want_live}), cached HR map {cached} (expected "
          f"{want_cached}) [{gpu}]")
    if live != want_live or cached != want_cached:
        raise AssertionError("the train step did not run the expected "
                             "kernel launches")

    # (c) the trainer: 4 batches x 8 epochs, HR maps cached from epoch 1
    model.load_state_dict(init)
    losses, maps = [], []
    step = trainer.train_step

    def recording_step(b, generator):
        maps.append(b["hr_map"])
        out = step(b, generator)
        losses.append(out["loss"])
        return out

    trainer.train_step = recording_step
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = train_counts()
    n = len(losses)
    losses = [v.item() for v in losses]
    hits = all(maps[i] is maps[i % TRAIN_BATCHES] for i in range(n))
    want = (n * 2 * SRB_NUMS + 3 * (n + TRAIN_BATCHES), n * SRB_NUMS,
            n * SRB_NUMS, 0)
    print(f"phase 6c: SRTrainer.train() ran {n} steps in {seconds:.3f} s; "
          f"HR-map cache {len(trainer._hr_map_cache)} maps, hit from epoch "
          f"1 on: {hits}; launches {counts} (expected {want}); loss first "
          f"{losses[0]:.4f}, last four {[round(v, 4) for v in losses[-4:]]} "
          f"[{gpu}]")
    if (n != TRAIN_BATCHES * EPOCHS or not hits or counts != want
            or len(trainer._hr_map_cache) != TRAIN_BATCHES):
        raise AssertionError("the trainer did not run the expected path")
    if not np.isfinite(losses).all() or np.mean(losses[-4:]) >= losses[0]:
        raise AssertionError("training losses are not finite or not falling")

    # (d) evaluation through the inference path
    reset_counts()
    res = trainer.evaluate(trainer.step)
    torch.cuda.synchronize()
    enh = fused_enhancer.launches
    print(f"phase 6d: evaluate() over {EVAL_BATCHES} batches: {res}; "
          f"fused-enhancer launches {enh} (expected "
          f"{EVAL_BATCHES * 2 * SRB_NUMS}) [{gpu}]")
    if (enh != EVAL_BATCHES * 2 * SRB_NUMS or not np.isfinite(res["psnr"])
            or not 0.0 < res["ssim"] <= 1.0 or not 0.0 <= res["acc"] <= 1.0):
        raise AssertionError("evaluation failed")

    # (e) steady-state step time (cached HR map), kernel vs plain path
    plain.load_state_dict(model.state_dict())
    gk, gp = (torch.Generator(dev).manual_seed(9) for _ in range(2))
    k_ms, p_ms = in_turns(lambda: step_k(batch, gk), lambda: step_p(batch,
                                                                   gp), 3)
    sk = [split_ms(model, loss_k, batch, gk) for _ in range(3)]
    sp = [split_ms(plain, loss_p, batch, gp) for _ in range(3)]
    for name, ms, parts in (("kernel", k_ms, sk), ("plain", p_ms, sp)):
        tb = float(np.mean([p[0] for p in parts]))
        orc = float(np.mean([p[1] for p in parts]))
        print(f"phase 6e: {name} path train step at batch {TRAIN_B} fp32: "
              f"{ms:.3f} ms, {1e3 / ms:.3f} steps/s, {TRAIN_B * 1e3 / ms:.1f}"
              f" img/s; TBSRN forward+backward {tb:.3f} ms, oracle loss "
              f"forward+backward {orc:.3f} ms [{gpu}]")
    print(f"phase 6: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{gpu}]")
    return counts, k_ms


def _attn_operands(gen, dev, dt, b, lq, lk, d):
    """q, k, v as CascadeMiT's projections give them: with spatial
    reduction (Lkv < Lq) q alone and k, v column slices of one (B, Lkv, 2D)
    projection; without it, all three slices of one (B, L, 3D) qkv."""
    if lq == lk:
        qkv = torch.randn(b, lq, 3 * d, generator=gen).to(dev, dt)
        return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    q = torch.randn(b, lq, d, generator=gen).to(dev, dt)
    kv = torch.randn(b, lk, 2 * d, generator=gen).to(dev, dt)
    return q, kv[..., :d], kv[..., d:]


def _attn_check(name, got, want, dt):
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (got.float() - want.float()).abs().max().item()
    if err > ATTN_ATOL[dt]:
        raise AssertionError(f"{name} {dt}: kernel disagrees with the plain "
                             f"version, max abs err {err} > {ATTN_ATOL[dt]}")
    return err


def phase7(dev, gpu: str) -> tuple:
    gen = torch.Generator().manual_seed(SEED + 7)
    b7, b5 = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        for b, lq, lk, d, heads in B7_SHAPES:
            q, k, v = _attn_operands(gen, dev, dt, b, lq, lk, d)
            err = _attn_check("packed_flash_mha",
                              ra.packed_flash_mha(q, k, v, heads),
                              ra.packed_flash_mha_reference(q, k, v, heads),
                              dt)
            if lq == B7_SHAPES[0][1]:
                attn_kernel_name("7", "packed (B7)",
                                 lambda: ra.packed_flash_mha(q, k, v, heads),
                                 dt)
            k_ms, p_ms = in_turns(lambda: ra.packed_flash_mha(q, k, v, heads),
                                  lambda: ra.packed_flash_mha_reference(
                                      q, k, v, heads), 5)
            qh, kh, vh = (t.unflatten(-1, (heads, d // heads)).transpose(1, 2)
                          for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)
            lib_ms = cuda_ms(sdpa, 5)
            bd = attn_bound(b, heads, lq, lk, d // heads, dt)
            short = short_note(lambda: ra.packed_flash_mha(q, k, v, heads),
                               sdpa, k_ms, dt)
            print(f"phase 7: packed (B7) q ({b}, {lq}, {d}), k/v ({b}, {lk}, "
                  f"{d}), {heads} heads, {dt}: max abs err {err:.3e}; kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
                  f"{bound_note(bd)}{short}; "
                  f"{4 * b * lq * lk * d / k_ms / 1e9:.1f} TFLOP/s [{gpu}]")
            b7[(lq, dt)] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                            **bd, "library_ms": lib_ms}
            del q, k, v, qh, kh, vh
        for b, h, lq, lk, dh in B5_SHAPES:
            q, k, v = (t.unflatten(-1, (h, dh)).transpose(1, 2) for t in
                       _attn_operands(gen, dev, dt, b, lq, lk, h * dh))
            err = _attn_check("flash_mha", fa.flash_mha(q, k, v),
                              fa.flash_mha_reference(q, k, v), dt)
            if lq == B5_SHAPES[0][2]:
                attn_kernel_name("7", "head-major (B5)",
                                 lambda: fa.flash_mha(q, k, v), dt)
            k_ms, p_ms = in_turns(lambda: fa.flash_mha(q, k, v),
                                  lambda: fa.flash_mha_reference(q, k, v), 3)
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v)
            lib_ms = cuda_ms(sdpa, 3)
            bd = attn_bound(b, h, lq, lk, dh, dt)
            short = short_note(lambda: fa.flash_mha(q, k, v), sdpa, k_ms, dt)
            print(f"phase 7: head-major (B5) q ({b}, {h}, {lq}, {dh}), "
                  f"{lk} keys, {dt}: max abs err {err:.3e}; kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
                  f"{bound_note(bd)}{short}; "
                  f"{4 * b * h * lq * lk * dh / k_ms / 1e9:.1f} TFLOP/s "
                  f"[{gpu}]")
            b5[(lq, dt)] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                            **bd, "library_ms": lib_ms}
            del q, k, v
        torch.cuda.empty_cache()
    # the JSON rows: the largest call of each route, fp32 and bf16
    return (b7[(65536, torch.float32)], b5[(262144, torch.float32)],
            b7[(65536, torch.bfloat16)], b5[(262144, torch.bfloat16)])


def seg_counts() -> tuple:
    return (ra.region_packed_fwd.launches, ra.unmasked_packed_fwd.launches,
            fa.unmasked_bhld_fwd.launches)


def reset_seg_counts() -> None:
    ra.region_packed_fwd.launches = 0
    ra.unmasked_packed_fwd.launches = fa.unmasked_bhld_fwd.launches = 0


def seg_models(dev):
    """CascadeMiT-b0 + SegformerHead from the TextSeg config, weights from
    a seed, non-trivial BN statistics and LN scales; and the same weights
    on the plain path."""
    gen = torch.Generator().manual_seed(SEED + 8)
    model, cfg = init_segmentor(SEG_CONFIG, device="cpu", seed=SEED + 8)
    randomize_stats(model, gen)
    plain, _ = init_segmentor(SEG_CONFIG, device="cpu", kernels=False)
    plain.load_state_dict(model.state_dict())
    return model.to(dev), plain.to(dev), cfg


def seg_run(phase: str, model, plain, img: np.ndarray, crop, stride,
            want_counts: tuple, gpu: str, atol: float = SEG_ATOL,
            mean_bar=None, what: str = "fp32", ref32=None) -> tuple:
    """One `inference_segmentor` call per path, checked (logits within
    `atol`, and in mean within `mean_bar` where given; with an fp32
    `ref32` model, also within twice the plain path's distance from it, in
    max and mean); returns the launch counts of the kernel path's call."""
    run = lambda m: inference_segmentor(m, img, crop, stride,
                                        return_logits=True)
    run(plain)                       # warm-up: kernel build, cuDNN plans
    run(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_seg_counts()
    seg, logits = run(model)         # the main path's run, counted
    torch.cuda.synchronize()
    counts = seg_counts()
    peak_k = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    seg_p, logits_p = run(plain)
    torch.cuda.synchronize()
    peak_p = torch.cuda.max_memory_allocated() / 2 ** 30
    h, w = img.shape[:2]
    mode = (f"slide crop {crop[0]}x{crop[1]} stride {stride[0]}x{stride[1]}"
            if crop else "whole image")
    if tuple(logits.shape) != (1, h, w, 2) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"{phase}: logits {tuple(logits.shape)} or not "
                             "finite")
    diff = (logits - logits_p).abs()
    err, mean_err = diff.max().item(), diff.mean().item()
    far = (float("inf"), float("inf"))
    if ref32 is not None:
        d32 = (logits_p - run(ref32)[1]).abs()
        far = (2 * d32.max().item(), 2 * d32.mean().item())
        del d32
        print(f"phase {phase}: {h}x{w} {mode} {what}: the plain path's "
              f"distance from the fp32 path max {far[0] / 2:.3e}, mean "
              f"{far[1] / 2:.3e}; the kernel path's from the plain path must "
              "stay within twice it")
    tol = max(2 * err, 1e-6)
    sure = (top2_margin(logits_p[0]) > tol).cpu().numpy()
    same = seg == seg_p
    print(f"phase {phase}: {h}x{w} {mode} {what}: launches (region B6, "
          f"packed B7, head-major B5) {counts} (expected {want_counts}); "
          f"logits vs kernels=False max abs err {err:.3e} (bar {atol}), "
          f"mean {mean_err:.3e} (bar {mean_bar}), |logits| max "
          f"{logits_p.abs().max().item():.3f}; class maps equal at "
          f"{int(same.sum())} of {same.size} pixels and at all "
          f"{int(sure.sum())} whose top-2 margin exceeds {tol:.3e}: "
          f"{bool(same[sure].all())}; text share {seg.mean():.4f}")
    if counts != want_counts:
        raise AssertionError(f"{phase}: the run did not launch the expected "
                             "attention kernels")
    if (err > atol or not same[sure].all() or err > far[0]
            or mean_err > far[1]
            or (mean_bar is not None and mean_err > mean_bar)):
        raise AssertionError(f"{phase}: kernel path disagrees with "
                             "kernels=False")
    k_ms, p_ms = in_turns(lambda: run(model), lambda: run(plain), 3)
    print(f"phase {phase}: {h}x{w} {mode} {what}, per canvas: kernel path "
          f"{k_ms:.3f} ms ({1e3 / k_ms:.3f} canvases/s, peak "
          f"{peak_k:.2f} GiB), plain path {p_ms:.3f} ms "
          f"({1e3 / p_ms:.3f} canvases/s, peak {peak_p:.2f} GiB) [{gpu}]")
    return counts


def profile_canvas(model, img: np.ndarray, gpu: str,
                   what: str = "") -> None:
    """torch.profiler over one slide canvas: device kernel time by name
    and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference_segmentor(model, img, SEG_CROP, SEG_STRIDE)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted((e for e in prof.key_averages()
                   if e.device_time_total > 0),
                  key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in rows if e.device_type.name
               == "CUDA") / 1e3
    print(f"profile:{what} one {SEG_CROP} slide canvas, wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms (kernels and copies) [{gpu}]")
    for e in rows[:15]:
        print(f"profile: {e.device_time_total / 1e3:9.3f} ms "
              f"{e.count:5d}x {e.key[:90]}")


def phase8(dev, gpu: str, models) -> int:
    model, plain, cfg = models
    test = cfg.test
    if (test.mode, tuple(test.crop), tuple(test.stride)) != (
            "slide", SEG_CROP, SEG_STRIDE):
        raise AssertionError(f"{SEG_CONFIG}: test recipe {test}")
    img = np.random.default_rng(SEED + 80).integers(0, 256, (1024, 2048, 3),
                                                    dtype=np.uint8)
    counts = seg_run("8", model, plain, img, SEG_CROP, SEG_STRIDE, (0, 8, 0),
                     gpu)
    profile_canvas(model, img, gpu)
    return counts[1]


def phase9(dev, gpu: str, models) -> int:
    model, plain, _ = models
    launches = 0
    for (h, w), want in (((512, 1024), (0, 6, 2)), ((2048, 2048), (0, 0, 8))):
        img = np.random.default_rng(SEED + 90 + h).integers(
            0, 256, (h, w, 3), dtype=np.uint8)
        launches += seg_run("9", model, plain, img, None, None, want, gpu)[2]
        torch.cuda.empty_cache()
    return launches


def blob_regions(dev, side: int = 256) -> torch.Tensor:
    """(3, side, side) float32 region maps made from a seed, at the 1/4
    scale of a 1024² crop: image 0 a text map of rectangles (ids 1 and some
    0.5 on 0), image 1 the instance ids of its own rectangles, image 2 all
    background (every row of its attention is fully suppressed)."""
    rng = np.random.default_rng(SEED + 10)
    maps = np.zeros((3, side, side), np.float32)
    for b in range(2):
        for _ in range(12):
            y, x = rng.integers(0, side - 40, 2)
            hh, ww = rng.integers(8, 40, 2)
            maps[b, y:y + hh, x:x + ww] = rng.choice([1.0, 0.5], p=[0.8, 0.2])
    regions = torch.from_numpy(maps).to(dev)
    regions[1] = instance_labels(regions[1:2])[0]
    return regions


def phase10(dev, gpu: str) -> dict:
    gen = torch.Generator().manual_seed(SEED + 10)
    regions = blob_regions(dev)
    b6 = {}
    for dt in (torch.float32, torch.bfloat16):
        for b, lq, lk, d, heads, side, sr in B6_SHAPES:
            q, k, v = _attn_operands(gen, dev, dt, b, lq, lk, d)
            rq, rkv = (r.contiguous() for r in
                       region_vectors(regions, (side, side), sr))
            got = ra.region_flash_mha(q, k, v, rq, rkv, heads)
            err = _attn_check("region_flash_mha", got,
                              ra.region_flash_mha_reference(q, k, v, rq, rkv,
                                                            heads), dt)
            if lq == B6_SHAPES[0][1]:
                attn_kernel_name(
                    "10", "region (B6)",
                    lambda: ra.region_flash_mha(q, k, v, rq, rkv, heads), dt)
            # rows whose every pair is suppressed are the mean of v
            full = (rq[:, :, None] == rkv[:, None, :]).all(-1)
            free = ~(rq[:, :, None] == rkv[:, None, :]).any(-1)
            mean_v = v.float().mean(1, keepdim=True).expand(-1, lq, -1)
            full_err = (got.float() - mean_v)[full].abs().max().item()
            n_full, n_free = int(full.sum()), int(free.sum())
            if (full_err > ATTN_ATOL[dt] or n_full == 0
                    or n_full + n_free == b * lq):
                raise AssertionError(
                    f"region_flash_mha {dt} Lq={lq}: fully suppressed rows "
                    f"{n_full} (max err to the mean of v {full_err}), "
                    f"partly suppressed {b * lq - n_full - n_free}")
            k_ms, p_ms = in_turns(
                lambda: ra.region_flash_mha(q, k, v, rq, rkv, heads),
                lambda: ra.region_flash_mha_reference(q, k, v, rq, rkv,
                                                      heads), 5)
            qh, kh, vh = (t.unflatten(-1, (heads, d // heads)).transpose(1, 2)
                          for t in (q, k, v))
            mask = ra.region_mask(rq, rkv)[:, None].to(dt)
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                          attn_mask=mask)
            lib_ms = cuda_ms(sdpa, 5)
            bd = attn_bound(b, heads, lq, lk, d // heads, dt,
                            extra_bytes=4 * b * (lq + lk))
            short = short_note(
                lambda: ra.region_flash_mha(q, k, v, rq, rkv, heads), sdpa,
                k_ms, dt)
            print(f"phase 10: region (B6) q ({b}, {lq}, {d}), k/v ({b}, {lk}, "
                  f"{d}), {heads} heads, {dt}: max abs err {err:.3e}; "
                  f"{n_full} fully suppressed rows (max err to the mean of v "
                  f"{full_err:.3e}), {n_free} rows with no suppressed pair; "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA with the "
                  f"float mask {lib_ms:.4f} ms, {bound_note(bd)}{short}; "
                  f"{4 * b * lq * lk * d / k_ms / 1e9:.1f}"
                  f" TFLOP/s [{gpu}]")
            b6[(lq, dt)] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                            **bd, "library_ms": lib_ms}
            del q, k, v, qh, kh, vh, mask, got, full, free, mean_v
        torch.cuda.empty_cache()
    # level 0, fp32 and bf16
    return (b6[(B6_SHAPES[0][1], torch.float32)],
            b6[(B6_SHAPES[0][1], torch.bfloat16)])


def det_models(dev):
    """CascadeMiTDetGuided-b0 + SegformerHead from the TextSeg det config,
    weights from a seed, non-trivial BN statistics and LN scales; and the
    same weights on the plain path."""
    gen = torch.Generator().manual_seed(SEED + 11)
    model, cfg = init_segmentor(DET_CONFIG, device="cpu", seed=SEED + 11)
    randomize_stats(model, gen)
    plain, _ = init_segmentor(DET_CONFIG, device="cpu", kernels=False)
    plain.load_state_dict(model.state_dict())
    return model.to(dev), plain.to(dev), cfg


def normalized(img: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(Normalize()({"img": img})["img"][None]).to(dev)


def det_maps(model, x: torch.Tensor) -> tuple:
    """The text and instance maps of the model's det head for images x."""
    with torch.inference_mode():
        _, det = model(x)
        text = soft_argmax(det)
        return text, instance_labels(text)


def maps_ok(text: torch.Tensor, inst: torch.Tensor) -> list:
    """Per image (text share, instances); None where the map is all 0, all
    text, or has fewer than 2 instances."""
    out = []
    for t, i in zip(text, inst):
        share = (t > 0).float().mean().item()
        n = torch.unique(i[i > 0]).numel()
        out.append((share, n) if 0 < share < 1 and n >= 2 else None)
    return out


def nontrivial_text_maps(model, plain, inputs: list,
                         phase: str = "11") -> list:
    """Make every image's text map neither all 0 nor all 1, with at least
    2 instances: keep the seeded weights if they do, else redraw `det_cls`
    from the next seed (at most 8)."""
    conv = model.backbone.det_cls[0]
    for attempt in range(8):
        stats = [maps_ok(*det_maps(model, x)) for x in inputs]
        if all(s is not None for st in stats for s in st):
            print(f"phase {phase}: text maps non-trivial with "
                  + ("the seeded weights" if attempt == 0 else
                     f"det_cls redrawn from seed {SEED + 110 + attempt - 1}")
                  + f": (text share, instances) per image {stats}")
            return stats
        g = torch.Generator().manual_seed(SEED + 110 + attempt)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                              * 4 / conv.in_channels ** 0.5)
            conv.bias.zero_()
        plain.backbone.det_cls.load_state_dict(
            model.backbone.det_cls.state_dict())
    raise AssertionError(f"no det_cls seed gives non-trivial text maps: "
                         f"{stats}")


def phase11_12(dev, gpu: str) -> int:
    model, plain, cfg = det_models(dev)
    test = cfg.test
    if (test.mode, tuple(test.crop), tuple(test.stride)) != (
            "slide", SEG_CROP, SEG_STRIDE):
        raise AssertionError(f"{DET_CONFIG}: test recipe {test}")
    img = np.random.default_rng(SEED + 110).integers(
        0, 256, (*DET_SLIDE_HW, 3), dtype=np.uint8)
    whole = np.random.default_rng(SEED + 120).integers(
        0, 256, (*DET_WHOLE_HW, 3), dtype=np.uint8)
    x = normalized(img, dev)
    ch, cw, pos = crop_grid(*DET_SLIDE_HW, SEG_CROP, SEG_STRIDE)
    crops = torch.cat([x[:, y:y + ch, c:c + cw] for y, c in pos])
    nontrivial_text_maps(model, plain, [crops, normalized(whole, dev)])
    text, inst = det_maps(model, crops)
    if not torch.equal(inst, det_maps(plain, crops)[1]):
        raise AssertionError("phase 11: the instance maps of the kernel and "
                             "plain paths differ")
    if not torch.equal(inst.cpu(), instance_labels(text.cpu())):
        raise AssertionError("phase 11: the labelling on the card differs "
                             "from the same labelling on the CPU")
    ccl = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        instance_labels(text)
        torch.cuda.synchronize()
        ccl.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 11: labelling the 3 crops' text maps {tuple(text.shape)}: "
          f"{instance_labels.rounds} rounds, {float(np.median(ccl)):.3f} ms "
          f"(median of 5, host clock), equal to the CPU's and to the plain "
          f"path's [{gpu}]")
    del x, crops, text, inst
    counts = seg_run("11", model, plain, img, SEG_CROP, SEG_STRIDE,
                     DET_SLIDE_LAUNCHES, gpu)
    profile_canvas(model, img, gpu, " det-guided")
    torch.cuda.empty_cache()
    seg_run("12", model, plain, whole, None, None, DET_WHOLE_LAUNCHES, gpu)
    return counts[0]


# -- phases 13-16: the segmentation training slice ---------------------------

BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the backward's launches by name: fp32 the split-TF32 passes, bf16 the
# bf16 tensor-core ones, then the reduce
BWD_KERNELS = {
    torch.float32: ["attn_bwd_dkv_tf32x3_kernel", "attn_bwd_dq_tf32x3_kernel",
                    "attn_bwd_reduce_kernel"],
    torch.bfloat16: ["attn_bwd_dkv_mma_kernel", "attn_bwd_dq_mma_kernel",
                     "attn_bwd_reduce_kernel"]}


def train_seg_counts() -> tuple:
    """(B7 fwd, B7 bwd, B6 fwd, B6 bwd) launches."""
    return (ra.unmasked_packed_fwd.launches, ra.unmasked_packed_bwd.launches,
            ra.region_packed_fwd.launches, ra.region_packed_bwd.launches)


def reset_train_seg_counts() -> None:
    reset_seg_counts()
    ra.unmasked_packed_bwd.launches = ra.region_packed_bwd.launches = 0


def bwd_bound(b: int, h: int, lq: int, lk: int, dh: int, dt) -> dict:
    """The attention backward: 5 products of 2*Lq*Lkv*dh flops per head
    (the JAX CostEstimate); q, k, v, dO, the fp32 o and the row statistics
    read once, dq, dk, dv written once."""
    es = torch.finfo(dt).bits // 8
    d = h * dh
    nbytes = es * b * (3 * lq * d + 4 * lk * d) + 4 * b * (lq * d + 2 * h * lq)
    return seg_attn_bound(10 * b * h * lq * lk * dh, nbytes, dt)


def bwd_check(q, k, v, do, ids, heads: int, dt, gpu: str,
              names: bool = False, phase: str = "13") -> dict:
    """The training forward and the backward kernel on strided packed
    operands (as the model gives them) against the plain backward; the
    fully suppressed rows' dq on their own; kernel, plain and SDPA-backward
    ms; with `names`, the kernels both launch, by name."""
    b, lq, d = q.shape
    lk, dh = k.shape[1], d // heads
    if ids is None:
        name = "packed (B7)"
        fwd = lambda: ra.unmasked_packed_fwd(q, k, v, heads, stats=True)
        o, o32, m, inv = fwd()
        bwd = lambda: ra.unmasked_packed_bwd(q, k, v, o32, do, m, inv, heads)
        plain = lambda: ra.packed_flash_mha_bwd_reference(q, k, v, do, heads)
    else:
        name = "region (B6)"
        fwd = lambda: ra.region_packed_fwd(q, k, v, *ids, heads, stats=True)
        o, o32, m, inv = fwd()
        bwd = lambda: ra.region_packed_bwd(q, k, v, *ids, o32, do, m, inv,
                                           heads)
        plain = lambda: ra.region_flash_mha_bwd_reference(q, k, v, *ids, do,
                                                          heads)
    if names:
        attn_kernel_name(phase, f"{name} training forward", fwd, dt)
        kernel_names(phase, f"{name} backward", bwd, dt, "attn_bwd",
                     BWD_KERNELS[dt])
    got, want = bwd(), plain()
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"{name} backward not finite")
    rels = [rel_err(g, w) for g, w in zip(got, want)]
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    full_note = ""
    if ids is not None:
        full = (ids[0][:, :, None] == ids[1][:, None, :]).all(-1)
        n_full = int(full.sum())
        full_rel = rel_err(got[0][full], want[0][full]) if n_full else 1.0
        full_note = (f"; {n_full} fully suppressed rows, their dq rel "
                     f"{full_rel:.3e}")
        if n_full == 0 or full_rel > BWD_REL[dt]:
            raise AssertionError(f"{name} {dt} Lq={lq}: fully suppressed "
                                 f"rows {n_full}, dq rel {full_rel}")
        del full
    if max(rels) > BWD_REL[dt]:
        raise AssertionError(f"{name} backward {dt} at ({b}, {lq}, {d}) x "
                             f"{lk}: dq/dk/dv rel {rels} > {BWD_REL[dt]}")
    del got, want
    k_ms, p_ms = in_turns(bwd, plain, 3)
    f_ms = cuda_ms(fwd, 3)
    # the yardstick: SDPA's backward on the same (B, H, L, dh) views
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    qh, kh, vh = (t.unflatten(-1, (heads, dh)).transpose(1, 2)
                  for t in leaves)
    mask = None if ids is None else ra.region_mask(*ids)[:, None].to(dt)
    so = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    doh = do.unflatten(-1, (heads, dh)).transpose(1, 2)
    sdpa = lambda: torch.autograd.grad(so, leaves, doh, retain_graph=True)
    lib_ms = cuda_ms(sdpa, 3)
    bd = bwd_bound(b, heads, lq, lk, dh, dt)
    short = short_note(bwd, sdpa, k_ms, dt)
    print(f"phase {phase}: {name} backward q ({b}, {lq}, {d}), k/v ({b}, "
          f"{lk}, {d}), {heads} heads, {dt}: dq/dk/dv rel err "
          f"{rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e}, max abs {err:.3e}"
          f"{full_note}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA "
          f"backward {lib_ms:.4f} ms, {bound_note(bd)}{short}; training "
          f"forward {f_ms:.4f} ms; "
          f"{10 * b * lq * lk * d / k_ms / 1e9:.1f} TFLOP/s [{gpu}]")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **bd,
            "library_ms": lib_ms}


def phase13(dev, gpu: str) -> tuple:
    gen = torch.Generator().manual_seed(SEED + 13)
    # an instance map and an all-background image (every row of its
    # attention fully suppressed), at the 1/4 scale of a 1024² crop
    regions = blob_regions(dev)[1:]
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        for b, lq, lk, d, heads, side, sr in BWD_SHAPES:
            q, k, v = _attn_operands(gen, dev, dt, b, lq, lk, d)
            do = torch.randn(b, lq, d, generator=gen).to(dev, dt)
            first = lq == BWD_SHAPES[0][1]
            rows[(False, lq, b, dt)] = bwd_check(q, k, v, do, None, heads,
                                                 dt, gpu, first)
            if b == len(regions):
                ids = tuple(r.contiguous() for r in
                            region_vectors(regions, (side, side), sr))
                rows[(True, lq, b, dt)] = bwd_check(q, k, v, do, ids, heads,
                                                    dt, gpu, first)
            del q, k, v, do
            torch.cuda.empty_cache()
    # the JSON rows: the det recipe's level 0, fp32
    return (rows[(False, 65536, 2, torch.float32)],
            rows[(True, 65536, 2, torch.float32)])


class SeededTextSeg:
    """Segmentation samples made from a seed, with `.batches(batch_size,
    shuffle, seed)` as SegTrainer takes them: smooth blob text masks
    (gt_seg), a uint8 image whose text pixels are darker, normalised
    (`Normalize`), and with `with_det` the mask dilated by 8 px (gt_det)."""

    def __init__(self, n: int, side: int, seed: int, with_det: bool):
        rng = np.random.default_rng(seed)
        gt = np.zeros((n, side, side), np.int32)
        for i in range(n):
            for _ in range(8):
                y, x = rng.integers(0, side * 7 // 8, 2)
                h, w = rng.integers(side // 64, side // 8, 2)
                gt[i, y:y + h, x:x + w] = 1
        img = (rng.integers(90, 230, (n, 1, 1, 3))
               + rng.integers(-25, 26, (n, side, side, 3)) - 70 * gt[..., None])
        img = Normalize()({"img": np.clip(img, 0, 255).astype(np.uint8)})[
            "img"]
        self.samples = [{"img": img[i], "gt_seg": gt[i]} for i in range(n)]
        if with_det:
            det = F.max_pool2d(torch.from_numpy(gt[:, None]).float(), 17, 1,
                               8)[:, 0].numpy().astype(np.int32)
            for i, sample in enumerate(self.samples):
                sample["gt_det"] = det[i]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        return batches_from(self.samples.__getitem__, len(self.samples),
                            batch_size, shuffle, seed, False)


def trainer_kwargs(cfg) -> dict:
    """SegTrainer's kwargs as fudanocr_tpu/apps/seg/train.py:118-134 builds
    them from the config, for data that is not a directory of images
    (whole-image evaluation) and without `ckpt_dir` (phase 28 drives the
    checkpoints through the app)."""
    tc = cfg.get("train_cfg", {})
    return dict(num_classes=cfg.model.decode_head.num_classes,
                batch_size=cfg.data.batch_size, lr=cfg.optimizer.lr,
                total_iters=cfg.schedule.total_iters,
                eval_every=cfg.schedule.eval_every,
                loss_weights=cfg.loss.to_dict(), crop=None, stride=None,
                det_loss_ratio=tc.get("det_loss_ratio", 0.1),
                gt_guided_masks=tc.get("gt_guided_masks", False))


def recipe_step(model, cfg, count: int = 0):
    """(optimizer at update `count`, train step) of the config's recipe."""
    kw = trainer_kwargs(cfg)
    opt = make_seg_optimizer(model, kw["lr"], total_iters=kw["total_iters"])
    opt.count = count
    return opt, make_seg_train_step(model, opt, kw["loss_weights"],
                                    kw["det_loss_ratio"],
                                    kw["gt_guided_masks"])


def grads_agree(model, plain, what: str) -> tuple:
    """(worst per-tensor gradient rel err, its name, zero-gradient count),
    kernel path against plain; raises where an exactly-zero gradient (a
    conv bias in front of a train-mode BatchNorm) differs beyond 1e-6 of
    the largest."""
    pairs = [(n, pk.grad, pp.grad) for (n, pk), pp in
             zip(model.named_parameters(), plain.parameters())]
    top = max(gp.norm().item() for _, _, gp in pairs)
    worst, worst_name, zero = 0.0, "", 0
    for name, gk, gp in pairs:
        if gp.norm().item() <= 1e-6 * top:
            zero += 1
            if (gk - gp).norm().item() > 1e-6 * top:
                raise AssertionError(f"{what} {name}: zero gradient differs")
            continue
        err = rel_err(gk, gp)
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name, zero


def device_batch(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def profile_step(step, batch, gen, gpu: str, what: str) -> tuple:
    """torch.profiler over one train step: device time by name and the
    device's busy share of the wall time; returns (the kernel and copy
    events, busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernels and copies only: a user annotation (the optimizer's step)
    # spans kernels already counted
    rows = sorted((e for e in prof.key_averages()
                   if e.device_time_total > 0 and e.device_type.name
                   == "CUDA" and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in rows) / 1e3
    print(f"profile: {what} one train step, wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f} %) [{gpu}]")
    for e in rows[:12]:
        print(f"profile: {e.device_time_total / 1e3:9.3f} ms "
              f"{e.count:5d}x {e.key[:90]}")
    return rows, busy


def train_recipe(config: str, want: tuple, dev, gpu: str) -> tuple:
    """Phases 14-16 for one recipe; returns phase 14's launches per step
    and phase 16's kernel path ms per step."""
    gen = torch.Generator().manual_seed(SEED + 14)
    model, cfg = init_segmentor(config, device=dev, seed=SEED + 14)
    randomize_stats(model, gen)
    plain, _ = init_segmentor(config, device=dev, kernels=False)
    plain.load_state_dict(model.state_dict())
    init = {k: v.clone() for k, v in model.state_dict().items()}
    side, bs = cfg.data.crop_size[0], cfg.data.batch_size
    det = bool(cfg.model.get("det_guided", False))
    tag = f"{config.split('/')[-1]} ({side}², batch {bs})"
    data = SeededTextSeg(2 * bs, side, SEED + 140, det)
    batches = [device_batch(b, dev) for b in data.batches(bs)]
    batch = batches[0]

    # 14: one step, kernel path against plain path on the same generator;
    # cuDNN in its deterministic algorithms (its default weight gradient
    # sums with atomics, noise of its own between any two runs)
    _, step_k = recipe_step(model, cfg)
    _, step_p = recipe_step(plain, cfg)
    torch.backends.cudnn.deterministic = True
    torch.cuda.synchronize()
    reset_train_seg_counts()
    mk = step_k(batch, torch.Generator(dev).manual_seed(7))
    torch.cuda.synchronize()
    counts = train_seg_counts()
    mp = step_p(batch, torch.Generator(dev).manual_seed(7))
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    loss_rel = abs(mk["loss"].item() - mp["loss"].item()) / abs(
        mp["loss"].item())
    worst, worst_name, zero = grads_agree(model, plain, tag)
    stats_err = max((a.float() - c.float()).abs().max().item()
                    for (n, a), c in zip(model.named_buffers(),
                                         plain.buffers())
                    if n.endswith(("running_mean", "running_var")))
    print(f"phase 14: {tag}: one train step, kernel path "
          f"{ {k: round(v.item(), 6) for k, v in mk.items()} }, plain loss "
          f"{mp['loss'].item():.6f} (rel {loss_rel:.3e}, bar {STEP_LOSS_REL})"
          f"; per-tensor gradient rel err max {worst:.3e} ({worst_name}; bar "
          f"{STEP_GRAD_REL}), {zero} zero-gradient tensors equal; BN "
          f"statistics max abs err {stats_err:.3e} (bar 1e-5); launches (B7 "
          f"fwd, B7 bwd, B6 fwd, B6 bwd) {counts} (expected {want}) [{gpu}]")
    if not all(np.isfinite(v.item()) for v in mk.values()):
        raise AssertionError(f"{tag}: train step metrics are not finite")
    if loss_rel > STEP_LOSS_REL or worst > STEP_GRAD_REL or stats_err > 1e-5:
        raise AssertionError(f"{tag}: kernel path train step disagrees with "
                             "kernels=False")
    if counts != want:
        raise AssertionError(f"{tag}: the train step did not launch the "
                             "expected attention kernels")

    # 15: the trainer, then the post-warmup trajectory
    model.load_state_dict(init)
    trainer = SegTrainer(model, data, SeededTextSeg(bs, side, SEED + 150,
                                                    det),
                         **trainer_kwargs(cfg))
    losses, lrs = [], []
    inner = trainer.train_step

    def recording(b, generator):
        out = inner(b, generator)
        losses.append(out["loss"])
        lrs.append(trainer.optimizer.last_lr)
        return out

    trainer.train_step = recording
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reached = trainer.train(stop_after=TRAIN_ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [v.item() for v in losses]
    sched = poly_schedule(cfg.optimizer.lr, cfg.schedule.total_iters)
    res = trainer.evaluate(reached)
    print(f"phase 15: {tag}: SegTrainer.train() ran {reached} iterations in "
          f"{seconds:.3f} s, losses {[round(v, 4) for v in losses]}, lr "
          f"{lrs[0]:.3e} .. {lrs[-1]:.3e} (the poly schedule's: "
          f"{lrs == [sched(i) for i in range(len(lrs))]}); evaluate(): "
          f"{res} [{gpu}]")
    if (reached != TRAIN_ITERS or len(losses) != TRAIN_ITERS
            or not np.isfinite(losses).all()
            or lrs != [sched(i) for i in range(TRAIN_ITERS)]):
        raise AssertionError(f"{tag}: the trainer did not run as configured")
    if (set(res) != {"aAcc", "mIoU", "mDice", "mFscore"}
            or not all(0.0 <= v <= 1.0 for v in res.values())):
        raise AssertionError(f"{tag}: evaluate() returned {res}")
    model.load_state_dict(init)
    opt, step_t = recipe_step(model, cfg, count=TRAJ_START)
    traj = [step_t(batches[i % 2], torch.Generator(dev).manual_seed(100 + i))
            ["loss"].item() for i in range(TRAJ_STEPS)]
    first, last = np.mean(traj[:4]), np.mean(traj[-4:])
    print(f"phase 15: {tag}: {TRAJ_STEPS} steps from count {TRAJ_START} (lr "
          f"{sched(TRAJ_START):.3e}, head x10) on 2 repeated batches: losses "
          f"{[round(v, 4) for v in traj]}; mean of the first 4 {first:.5f}, "
          f"of the last 4 {last:.5f} [{gpu}]")
    if not np.isfinite(traj).all() or not last < first:
        raise AssertionError(f"{tag}: the post-warmup loss does not fall")

    # 16: step time, img/s and peak memory of both paths; a profile
    model.load_state_dict(init)
    plain.load_state_dict(init)
    _, step_k = recipe_step(model, cfg)
    _, step_p = recipe_step(plain, cfg)
    gk, gp = (torch.Generator(dev).manual_seed(9) for _ in range(2))
    peaks = []
    for step, g in ((step_k, gk), (step_p, gp)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(batch, g)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    k_ms, p_ms = in_turns(lambda: step_k(batch, gk),
                          lambda: step_p(batch, gp), 2)
    for name, ms, peak in (("kernel", k_ms, peaks[0]),
                           ("plain", p_ms, peaks[1])):
        print(f"phase 16: {tag}: {name} path train step fp32 {ms:.3f} ms, "
              f"{bs * 1e3 / ms:.2f} img/s, peak {peak:.2f} GiB [{gpu}]")
    profile_step(step_k, batch, gk, gpu, tag)
    del model, plain, trainer, batches, batch, data
    torch.cuda.empty_cache()
    return counts, k_ms


# -- phases 17-21: TBSRN's packed-qkv route and the TSRN / Text Gestalt slice

# B3 at TBSRN's enhancer shapes: (B, L), D = 128 over 4 heads of 32
B3_SHAPES = ((64, 1024), (BATCH, 1024), (64, 512), (64, 2048))
# B8 at TSRN's two GRUs over 16x64 LR at batch 256: (rows, T, hidden)
B8_SHAPES = ((BATCH * LR_HW[1], LR_HW[0], 32), (BATCH * LR_HW[0], LR_HW[1],
                                                 32))
GRU_ATOL = 1e-5   # fp32, the same recurrence in another summation order
STROKE_VOCAB = 10


def phase17(dev, gpu: str) -> dict:
    gen = torch.Generator().manual_seed(SEED + 17)
    result = {}
    for dt in (torch.float32, torch.bfloat16):
        for b, l in B3_SHAPES:
            qkv = torch.randn(b, l, 3 * HEADS * 32, generator=gen).to(dev, dt)
            err = _attn_check("flash_mha_qkv_packed",
                              fa.flash_mha_qkv_packed(qkv, HEADS),
                              fa.flash_mha_qkv_packed_reference(qkv, HEADS),
                              dt)
            if (b, l) == B3_SHAPES[0]:
                attn_kernel_name("17", "packed qkv (B3)",
                                 lambda: fa.flash_mha_qkv_packed(qkv, HEADS),
                                 dt)
            k_ms, p_ms = in_turns(
                lambda: fa.flash_mha_qkv_packed(qkv, HEADS),
                lambda: fa.flash_mha_qkv_packed_reference(qkv, HEADS), 5)
            qh, kh, vh = (qkv[..., i * HEADS * 32:(i + 1) * HEADS * 32]
                          .unflatten(-1, (HEADS, 32)).transpose(1, 2)
                          for i in range(3))
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)
            lib_ms = cuda_ms(sdpa, 5)
            bd = attn_bound(b, HEADS, l, l, 32, dt)
            short = short_note(lambda: fa.flash_mha_qkv_packed(qkv, HEADS),
                               sdpa, k_ms, dt)
            print(f"phase 17: packed qkv (B3) ({b}, {l}, {3 * HEADS * 32}), "
                  f"{HEADS} heads, {dt}: max abs err {err:.3e}; kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
                  f"{bound_note(bd)}{short}; "
                  f"{4 * b * l * l * HEADS * 32 / k_ms / 1e9:.1f} TFLOP/s "
                  f"[{gpu}]")
            result[(b, l, dt)] = {"max_abs_err": err, "ms": k_ms,
                                  "plain_ms": p_ms, **bd,
                                  "library_ms": lib_ms}
            del qkv, qh, kh, vh
        torch.cuda.empty_cache()
    # the JSON row: phase 18's shape and type
    return result[(BATCH, 1024, torch.bfloat16)]


def compare_paths(phase: str, what: str, sr_out, sr_ref, crnn) -> None:
    """Phase 2's bars between two SR outputs and the CRNN logits on them:
    the bf16 enhancer bars on the SR image (tanh, in [-1, 1]) and, scaled
    by the largest logit, on the logits."""
    hr = (sr_ref.shape[0], 2 * LR_HW[0], 2 * LR_HW[1], 3)
    if tuple(sr_out.shape) != hr or not torch.isfinite(sr_out).all():
        raise AssertionError(f"phase {phase}: SR output "
                             f"{tuple(sr_out.shape)} (want {hr}) or not "
                             "finite")
    with torch.inference_mode():
        logits = crnn(parse_crnn_input(sr_out)).float()
        logits_ref = crnn(parse_crnn_input(sr_ref)).float()
    if not torch.isfinite(logits).all():
        raise AssertionError(f"phase {phase}: CRNN logits not finite")
    sr_err = (sr_out.float() - sr_ref.float()).abs()
    lg_err = (logits - logits_ref).abs()
    scale = logits_ref.abs().max().clamp(min=1.0)
    print(f"phase {phase}: SR against {what}: max abs err "
          f"{sr_err.max().item():.3e}, mean {sr_err.mean().item():.3e}; "
          f"logits max abs err {lg_err.max().item():.3e}, mean "
          f"{lg_err.mean().item():.3e} (scale {scale.item():.3f})")
    if (sr_err.max() > BF16_ATOL or sr_err.mean() > BF16_MEAN
            or lg_err.max() > BF16_ATOL * scale
            or lg_err.mean() > BF16_MEAN * scale):
        raise AssertionError(f"phase {phase}: disagrees with {what}")


def phase18(dev, gpu: str, pipe: PixelsToStrings,
            lr: torch.Tensor) -> int:
    """Phase 2's TBSRN run unfused (`fused_enhancer=False`)."""
    bf16 = torch.bfloat16
    kw = dict(scale_factor=2, width=128, height=32, stn=True,
              srb_nums=SRB_NUMS, hidden_units=32, dtype=bf16,
              fused_enhancer=False)
    unfused, plain = TBSRN(**kw), TBSRN(**kw, kernels=False)
    for m in (unfused, plain):
        m.load_state_dict(pipe.sr_apply.state_dict())
    unfused, plain = unfused.to(dev).eval(), plain.to(dev).eval()
    conv = pipe.converter
    paths = {"unfused kernel": PixelsToStrings(unfused, pipe.rec_apply, conv,
                                               device=dev),
             "fused kernel": pipe,
             "unfused plain": PixelsToStrings(plain, pipe.rec_apply, conv,
                                              device=dev)}
    for p in paths.values():
        p.ids_fn(lr)                 # warm-up
    torch.cuda.synchronize()
    counts = lambda: (fa.flash_mha_qkv_packed.launches,
                      fused_enhancer.launches,
                      fused_residual_layernorm.launches)
    fa.flash_mha_qkv_packed.launches = fused_enhancer.launches = 0
    fused_residual_layernorm.launches = 0
    _, sr_out = paths["unfused kernel"](lr, return_sr=True)
    torch.cuda.synchronize()
    got = counts()
    want = (SRB_NUMS, 0, 2 * SRB_NUMS)
    print(f"phase 18: one PixelsToStrings call through TBSRN with "
          f"fused_enhancer=False ran (B3, fused enhancer, B2) launches "
          f"{got} (expected {want})")
    if got != want:
        raise AssertionError("phase 18: the unfused TBSRN did not run the "
                             "expected kernel launches")
    with torch.inference_mode():
        for what in ("fused kernel", "unfused plain"):
            compare_paths("18", f"the {what} path", sr_out,
                          paths[what].sr_apply(lr), pipe.rec_apply)
    names = list(paths)
    ms = dict(zip(names[:2], in_turns(lambda: paths[names[0]].ids_fn(lr),
                                      lambda: paths[names[1]].ids_fn(lr), 5)))
    ms[names[2]] = cuda_ms(lambda: paths[names[2]].ids_fn(lr), 3)
    print("phase 18: pixels->strings at batch " + str(BATCH) + " bf16: "
          + ", ".join(f"{k} path {BATCH / v * 1e3:.1f} img/s ({v:.3f} ms)"
                      for k, v in ms.items()) + f" [{gpu}]")
    return got[0]


def gru_bound(rows: int, t: int, h: int, c: int = 0,
              dt=torch.float32) -> dict:
    """B8, both directions over rows x t row-steps: per row-step the
    projection (6HC flops; none for the projection-off entry, c = 0) and
    the recurrence (6H^2) at the tensor cores' peak (`bound_ms`, beside
    the bytes: x in `dt`, or the two fp32 projections, the weights and y
    in `dt` moved once). The recurrence and an fp32 x's projection take
    three TF32 products; a bf16 x's projection the cheaper of two TF32
    products (x exact in TF32) and three bf16 ones (W_i split three ways
    into bf16, 24 significant bits). `cuda_core_bound_ms` adds ~30H gate
    operations and takes all at the CUDA cores' fp32 peak."""
    n, es = rows * t, torch.finfo(dt).bits // 8
    proj, rec, gates = 2 * n * 6 * h * c, 2 * n * 6 * h * h, 2 * n * 30 * h
    t_proj = (min(2 * proj / TF32_FLOPS, 3 * proj / PEAK_FLOPS[dt])
              if dt == torch.bfloat16 else TF32X3_PRODUCTS * proj / TF32_FLOPS)
    t_ops = (t_proj + TF32X3_PRODUCTS * rec / TF32_FLOPS) * 1e3
    weights = 2 * 4 * (3 * h * (c + h + 2) if c else 3 * h * (h + 1))
    nbytes = (n * c * es if c else 2 * n * 3 * h * 4) + weights \
        + n * 2 * h * es
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "floor": ("3xTF32, the projection 3 bf16 products"
                      if dt == torch.bfloat16 and c else "3xTF32"),
            "cuda_core_bound_ms": (proj + rec + gates)
            / PEAK_FLOPS[torch.float32] * 1e3}


def gru_params(gen: torch.Generator, c: int, h: int, dev) -> list:
    """torch's GRU parameters of both directions at torch's init scale,
    U(-1/sqrt(H), 1/sqrt(H)), in `fused_bigru_x`'s order."""
    shapes = ((3 * h, c), (3 * h,), (3 * h, h), (3 * h,)) * 2
    return [((torch.rand(s, generator=gen) * 2 - 1) * h ** -0.5).to(dev)
            for s in shapes]


def bf16_rounding_err(got: torch.Tensor, want32: torch.Tensor,
                      atol: float) -> float:
    """The share of bf16 `got` outside the roundings of [want32 - atol,
    want32 + atol] (0: got is want32 rounded to nearest even after an fp32
    error of at most atol)."""
    lo, hi = ((want32 + d).to(torch.bfloat16) for d in (-atol, atol))
    return 1.0 - ((lo <= got) & (got <= hi)).float().mean().item()


def check_gru_x(args: tuple, what: str) -> float:
    """The x-level B8 entry on `args` against its plain version: the fp32
    output's max abs error, which must be within GRU_ATOL, and on bf16 x
    the bf16 output the rounding of that."""
    got = fgru.fused_bigru_x(*args, out_dtype=torch.float32)
    want = fgru.fused_bigru_x_reference(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("B8 x-level kernel output not finite")
    err = (got - want).abs().max().item()
    off = (bf16_rounding_err(fgru.fused_bigru_x(*args), want, GRU_ATOL)
           if args[0].dtype == torch.bfloat16 else 0.0)
    if err > GRU_ATOL or off:
        raise AssertionError(f"B8 x-level kernel disagrees with the plain "
                             f"version at {what}: max abs err {err} (bar "
                             f"{GRU_ATOL}), bf16 output off its rounding "
                             f"at a share {off}")
    return err


def phase19(dev, gpu: str) -> dict:
    gen = torch.Generator().manual_seed(SEED + 19)
    # (a) the projection-off entry (JAX's fused_bigru) over fp32 projections
    for rows, t, h in B8_SHAPES:
        xf, xb = (torch.randn(rows, t, 3 * h, generator=gen).to(dev)
                  for _ in range(2))
        whf, whb = ((torch.randn(h, 3 * h, generator=gen) * h ** -0.5)
                    .to(dev) for _ in range(2))
        bhf, bhb = ((torch.randn(3 * h, generator=gen) * 0.1).to(dev)
                    for _ in range(2))
        args = (xf, xb, whf, bhf, whb, bhb, h)
        got = fgru.fused_bigru(*args)
        want = fgru.fused_bigru_reference(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("B8 kernel output not finite")
        err = (got - want).abs().max().item()
        if err > GRU_ATOL:
            raise AssertionError(f"B8 kernel disagrees with the plain version "
                                 f"at ({rows}, {t}, {3 * h}): max abs err "
                                 f"{err} > {GRU_ATOL}")
        k_ms, p_ms = in_turns(lambda: fgru.fused_bigru(*args),
                              lambda: fgru.fused_bigru_reference(*args), 5)
        bd = gru_bound(rows, t, h)
        print(f"phase 19a: fused_bigru (B8, projections in) ({rows}, {t}, "
              f"{3 * h}) fp32: max abs err {err:.3e}; kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, {bound_note(bd)} [{gpu}]")
        del xf, xb, got, want
    # (b) the x-level entry, TSRN's route: the projections in the kernel
    result = {}
    for (rows, t, h), dt in itertools.product(
            B8_SHAPES, (torch.float32, torch.bfloat16)):
        c = 2 * h
        x = torch.randn(rows, t, c, generator=gen).to(dev, dt)
        params = gru_params(gen, c, h, dev)
        args = (x, *params, h)
        what = f"({rows}, {t}, C {c}, H {h}) {dt}"
        err = check_gru_x(args, what)
        k_ms, p_ms = in_turns(lambda: fgru.fused_bigru_x(*args),
                              lambda: fgru.fused_bigru_x_reference(*args), 5)
        # the module call (the route TSRN takes) and the yardstick, cuDNN's
        # bidirectional GRU on the same input and parameters in fp32
        gru = BiGRU(c, h, fuse=True).to(dev)
        with torch.no_grad():
            for dst, src in zip(
                    (gru.weight_ih_l0, gru.bias_ih_l0, gru.weight_hh_l0,
                     gru.bias_hh_l0, gru.weight_ih_l0_reverse,
                     gru.bias_ih_l0_reverse, gru.weight_hh_l0_reverse,
                     gru.bias_hh_l0_reverse), params):
                dst.copy_(src)
            xf = x.float()
            lib_ms = cuda_ms(lambda: torch.nn.GRU.forward(gru, xf), 5)
            mod_ms = cuda_ms(lambda: gru(x), 5)
        bd = gru_bound(rows, t, h, c, dt)
        print(f"phase 19b: BiGRU (B8, x-level) {what}: max abs err {err:.3e} "
              f"(fp32 output; bar {GRU_ATOL}); kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, the module call {mod_ms:.4f} ms, cuDNN GRU "
              f"{lib_ms:.4f} ms, {bound_note(bd)} [{gpu}]")
        result[(rows, t, dt)] = {"max_abs_err": err, "ms": k_ms,
                                 "plain_ms": p_ms, **bd,
                                 "library_ms": lib_ms}
        del x, xf, gru
    # (c) saturating gates, where the fast exponential's error is largest:
    # W_ih x10 puts |pre-activation| ~ 8 on average, up to ~50
    rows, t, h = B8_SHAPES[1]
    for dt in (torch.float32, torch.bfloat16):
        params = gru_params(gen, 2 * h, h, dev)
        for i in (0, 4):
            params[i] *= 10
        x = torch.randn(rows, t, 2 * h, generator=gen).to(dev, dt)
        what = f"({rows}, {t}, C {2 * h}, H {h}) {dt}, W_ih x10"
        err = check_gru_x((x, *params, h), what)
        print(f"phase 19c: BiGRU (B8, x-level) {what}: max abs err "
              f"{err:.3e} (fp32 output; bar {GRU_ATOL})")
    torch.cuda.empty_cache()
    return result[(*B8_SHAPES[0][:2], torch.bfloat16)]


def tsrn(dev, **kw) -> TSRN:
    return TSRN(scale_factor=2, width=128, height=32, stn=True,
                srb_nums=SRB_NUMS, hidden_units=32, **kw).to(dev)


def phase20(dev, gpu: str, crnn, lr: torch.Tensor) -> int:
    torch.manual_seed(SEED + 20)
    gen = torch.Generator().manual_seed(SEED + 20)
    bf16 = torch.bfloat16
    fused = tsrn("cpu", fused_gru=True, dtype=bf16)
    randomize_stats(fused, gen)
    models = {"kernel": fused,
              "cuDNN GRU": tsrn("cpu", fused_gru=False, dtype=bf16),
              "plain": tsrn("cpu", fused_gru=True, kernels=False,
                            dtype=bf16)}
    for m in models.values():
        m.load_state_dict(fused.state_dict())
    conv = CTCLabelConverter(ALPHABET)
    pipes = {k: PixelsToStrings(m.to(dev).eval(), crnn, conv, device=dev)
             for k, m in models.items()}
    for p in pipes.values():
        p.ids_fn(lr)                 # warm-up: kernel build, cuDNN plans
    torch.cuda.synchronize()
    fgru.fused_bigru.launches = 0
    _, sr_out = pipes["kernel"](lr, return_sr=True)
    torch.cuda.synchronize()
    launches = fgru.fused_bigru.launches
    print(f"phase 20: one PixelsToStrings call through TSRN (fused_gru) ran "
          f"{launches} B8 launches (expected {2 * SRB_NUMS})")
    if launches != 2 * SRB_NUMS:
        raise AssertionError("phase 20: TSRN did not run the expected B8 "
                             "launches")
    with torch.inference_mode():
        for what in ("cuDNN GRU", "plain"):
            compare_paths("20", f"the {what} path", sr_out,
                          pipes[what].sr_apply(lr), crnn)
    names = list(pipes)
    ms = dict(zip(names[:2], in_turns(lambda: pipes[names[0]].ids_fn(lr),
                                      lambda: pipes[names[1]].ids_fn(lr), 5)))
    ms[names[2]] = cuda_ms(lambda: pipes[names[2]].ids_fn(lr), 2)
    print("phase 20: TSRN pixels->strings at batch " + str(BATCH) + " bf16: "
          + ", ".join(f"{k} path {BATCH / v * 1e3:.1f} img/s ({v:.3f} ms)"
                      for k, v in ms.items()) + f" [{gpu}]")
    h, w = LR_HW
    gate = {b: (fgru.fused_gru_supported(b * w, h, 32),
                fgru.fused_gru_supported(b * h, w, 32)) for b in (1, 8, 32)}
    print(f"phase 20: server buckets whose (gru1, gru2) rows pass the "
          f"rows % 256 gate: {gate}")
    phase3(pipes["kernel"], lr, gpu, phase="20")
    return launches


def phase20_alone(dev, gpu: str) -> int:
    """Phase 20 without phase 2: a CRNN(37, 256) in bf16 with non-trivial
    BN statistics and an LR batch from phase 2's seeds."""
    torch.manual_seed(SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    crnn = CRNN(num_classes=37, hidden=256, dtype=torch.bfloat16)
    randomize_stats(crnn, gen)
    lr = torch.rand(BATCH, *LR_HW, 3, generator=gen).to(dev)
    return phase20(dev, gpu, crnn.to(dev).eval(), lr)


def phase21(dev, gpu: str) -> int:
    torch.manual_seed(SEED + 21)
    oracle_kw = dict(vocab=STROKE_VOCAB, num_in=1, layers=(1, 2, 5, 3),
                     num_heads=16, d_embed=512, d_model=1024, d_ff=2048)
    model = tsrn(dev, fused_gru=True)
    plain = tsrn(dev, fused_gru=True, kernels=False)
    oracle = OCRTransformer(**oracle_kw).to(dev)
    oracle_plain = OCRTransformer(**oracle_kw, kernels=False).to(dev)
    oracle_plain.load_state_dict(oracle.state_dict())
    crnn = CRNN(num_classes=37, hidden=256).to(dev).eval()
    loss_k = StrokeFocusLoss(oracle, stroke_lambda=50.0)
    loss_p = StrokeFocusLoss(oracle_plain, stroke_lambda=50.0)
    data = SeededTextZoom(TRAIN_BATCHES * TRAIN_B, SEED + 210)
    eval_data = SeededTextZoom(EVAL_BATCHES * TRAIN_B, SEED + 211)
    trainer = StrokeSRTrainer(model, loss_k, data, eval_data,
                              batch_size=TRAIN_B, lr=1e-4, epochs=EPOCHS,
                              eval_every=10 ** 9, max_label_len=LABEL_LEN,
                              recognizer=crnn,
                              converter=CTCLabelConverter(ALPHABET),
                              seed=SEED)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = trainer._device_batch(*next(data.batches(TRAIN_B)))
    if int(batch["text_gt"].max()) >= STROKE_VOCAB:
        raise AssertionError("phase 21: labels are not stroke ids")

    # (a) one step, kernel path vs plain path, same state
    plain.load_state_dict(init)
    step_k = make_sr_train_step(model, loss_k,
                                adam_with_clip(model.parameters(), 1e-4))
    step_p = make_sr_train_step(plain, loss_p,
                                adam_with_clip(plain.parameters(), 1e-4))
    torch.cuda.synchronize()
    reset_counts()
    fgru.fused_bigru.launches = 0
    mk = step_k(batch)
    torch.cuda.synchronize()
    ln_live, gru_train = fused_residual_layernorm.launches, \
        fgru.fused_bigru.launches
    mp = step_p(batch)
    torch.cuda.synchronize()
    lk, lp = mk["loss"].item(), mp["loss"].item()
    loss_rel = abs(lk - lp) / abs(lp)
    pairs = [(n, pk.grad, pp.grad) for (n, pk), pp in
             zip(model.named_parameters(), plain.parameters())]
    top = max(gp.norm().item() for _, _, gp in pairs)
    worst, worst_name, zero = 0.0, "", 0
    for name, gk, gp in pairs:
        if gp.norm().item() <= 1e-6 * top:
            zero += 1        # conv biases in front of a train-mode BatchNorm
            if (gk - gp).norm().item() > 1e-6 * top:
                raise AssertionError(f"{name}: zero gradient differs")
            continue
        err = rel_err(gk, gp)
        if err > worst:
            worst, worst_name = err, name
    print(f"phase 21a: one stroke-focus step of TSRN at batch {TRAIN_B}, "
          f"kernel path loss {lk:.6f} (mse {mk['mse'].item():.6e}, stroke "
          f"attention {mk['attention'].item():.6e}), plain path {lp:.6f} "
          f"(rel {loss_rel:.3e}, bar {STEP_LOSS_REL}); per-tensor gradient "
          f"rel err max {worst:.3e} ({worst_name}; bar {STEP_GRAD_REL}) over "
          f"{len(pairs) - zero} tensors, {zero} zero-gradient tensors equal; "
          f"B2 launches {ln_live} (expected 6: two oracle forwards), B8 "
          f"launches {gru_train} (expected 0: training keeps cuDNN's GRU) "
          f"[{gpu}]")
    if not all(np.isfinite(v.item()) for v in mk.values()):
        raise AssertionError("phase 21: train step metrics are not finite")
    if loss_rel > STEP_LOSS_REL or worst > STEP_GRAD_REL:
        raise AssertionError("phase 21: kernel path train step disagrees "
                             "with plain")
    if ln_live != 6 or gru_train != 0:
        raise AssertionError("phase 21: the train step did not run the "
                             "expected kernel launches")

    # (b) the trainer: 4 batches x 8 epochs, HR maps cached from epoch 1
    model.load_state_dict(init)
    losses = []
    step = trainer.train_step

    def recording_step(b, generator):
        out = step(b, generator)
        losses.append(out["loss"])
        return out

    trainer.train_step = recording_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [v.item() for v in losses]
    print(f"phase 21b: StrokeSRTrainer.train() ran {len(losses)} steps in "
          f"{seconds:.3f} s; HR-map cache {len(trainer._hr_map_cache)} maps; "
          f"loss first {losses[0]:.4f}, last four "
          f"{[round(v, 4) for v in losses[-4:]]} [{gpu}]")
    if (len(losses) != TRAIN_BATCHES * EPOCHS
            or len(trainer._hr_map_cache) != TRAIN_BATCHES):
        raise AssertionError("phase 21: the trainer did not run the "
                             "expected path")
    if not np.isfinite(losses).all() or np.mean(losses[-4:]) >= losses[0]:
        raise AssertionError("phase 21: losses not finite or not falling")

    # (c) evaluation through the fused-GRU inference path
    fgru.fused_bigru.launches = 0
    res = trainer.evaluate(trainer.step)
    torch.cuda.synchronize()
    evals = fgru.fused_bigru.launches
    print(f"phase 21c: evaluate() over {EVAL_BATCHES} batches: {res}; B8 "
          f"launches {evals} (expected {EVAL_BATCHES * 2 * SRB_NUMS}) "
          f"[{gpu}]")
    if (evals != EVAL_BATCHES * 2 * SRB_NUMS or not np.isfinite(res["psnr"])
            or not 0.0 < res["ssim"] <= 1.0 or not 0.0 <= res["acc"] <= 1.0):
        raise AssertionError("phase 21: evaluation failed")

    # (d) steady-state step time (cached HR map), kernel vs plain path
    batch["hr_map"] = loss_k.hr_oracle_map(batch["hr"], batch["text_input"])
    plain.load_state_dict(model.state_dict())
    k_ms, p_ms = in_turns(lambda: step_k(batch), lambda: step_p(batch), 3)
    for name, ms in (("kernel", k_ms), ("plain", p_ms)):
        print(f"phase 21d: {name} path stroke-focus step at batch {TRAIN_B} "
              f"fp32 (cached HR map): {ms:.3f} ms, {TRAIN_B * 1e3 / ms:.1f} "
              f"img/s [{gpu}]")
    print(f"phase 21: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{gpu}]")
    return ln_live


# phases 22-24: the whole-SRB kernel (B9) and the split-operand attention
# kernels (B10, B11). B9 shapes: (B, H, W, dtype), the last the JSON row's
B9_SHAPES = ((64, *LR_HW, torch.float32), (64, *LR_HW, torch.bfloat16),
             (BATCH, *LR_HW, torch.bfloat16))
B10_B, B10_L = TRAIN_B, 1024   # (64, 1024, 128), 4 heads: JAX's test shape x32


def srb_bound(b: int, h: int, w: int, dt) -> dict:
    """Two 3x3 convs (2*B*L*9*C^2 flops each) and the enhancer (JAX's
    count, fused_srb.py:149-152); the map read and the output written
    once."""
    l, c, d = h * w, 64, 128
    conv = 2 * (2 * b * l * 9 * c * c)
    enh = 2 * b * l * (c * 3 * d + 4 * 2 * l * (d // 4) + 3 * d * d + d * c)
    return bound(conv + enh, 2 * b * l * c * torch.finfo(dt).bits // 8, dt)


def srb_launch_bounds(b: int, h: int, w: int, dt) -> dict:
    """The bound of each of B9's bf16 launches, each launch's inputs read
    and outputs written once: conv1 (+ mish) reads x and writes r1; conv2
    (+ qkv) reads r1 and writes r and the (B, L, 384) qkv; the attention
    epilogue reads qkv, r and x and writes out."""
    l, c, d = h * w, 64, 128
    es = torch.finfo(dt).bits // 8
    conv = 2 * b * l * 9 * c * c
    attn = 2 * b * l * (4 * 2 * l * (d // 4) + 3 * d * d + d * c)
    return {"conv1": bound(conv, es * b * l * 2 * c, dt)["bound_ms"],
            "conv2+qkv": bound(conv + 2 * b * l * c * 3 * d,
                               es * b * l * (2 * c + 3 * d), dt)["bound_ms"],
            "epilogue": bound(attn, es * b * l * (3 * d + 3 * c),
                              dt)["bound_ms"]}


def profile_kernels(fn, iters: int) -> dict:
    """{kernel name: (device ms, launches)} per call of `fn`, from
    torch.profiler over `iters` calls after a warm-up call. The calls run
    in the active step of a profiler schedule whose warm-up step runs one
    more call: on the card's machine a trace begun straight away has
    missed the first few kernels after many earlier traces."""
    from torch.profiler import ProfilerActivity, profile, schedule

    split = {}

    def ready(prof):
        for e in prof.key_averages():
            if e.device_type.name == "CUDA" and e.device_time_total > 0:
                name = re.sub(r"^void |\(anonymous namespace\)::", "",
                              e.key)
                name = re.split(r"[<(]", name)[0][:40]
                ms, n = split.get(name, (0.0, 0.0))
                split[name] = (ms + e.device_time_total / 1e3 / iters,
                               n + e.count / iters)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return split


def kernel_split(fn, iters: int) -> dict:
    """Device ms per call of `fn` by kernel name, from torch.profiler."""
    return {k: round(ms, 4) for k, (ms, _) in profile_kernels(fn,
                                                              iters).items()}


# the kernels of one B9 call and their launches, by dtype: bf16 on the
# tensor cores (csrc/fused_srb.cu's two wgmma convs, the second with the
# enhancer's qkv projection; then B1's attention epilogue), fp32 on the
# CUDA cores (two convs, B1's qkv projection and epilogue)
B9_KERNELS = {torch.bfloat16: {"conv3x3_mish_wgmma_kernel": 1,
                               "conv3x3_qkv_wgmma_kernel": 1,
                               "attn_epilogue_kernel": 1},
              torch.float32: {"conv3x3_fma_kernel": 2, "qkv_proj_kernel": 1,
                              "attn_epilogue_kernel": 1}}


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of |v| (8 significant bits), |v| floored at 2^-8."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -8)))
                      - 7)


def check_srb_launches(x: torch.Tensor, ops: dict, what: str) -> str:
    """B9's conv launches alone against their plain twins on the same
    inputs: r1 (`srb_conv_mish`), r and qkv (`srb_conv_qkv`) within one
    bf16 ulp of the twin's fp32 value before it rounds (fp32: 1e-5)."""
    b, h, w, c = x.shape
    r1 = srb_conv_mish(x, ops)
    r, qkv = srb_conv_qkv(r1, ops)
    c1 = fsrb._conv_reference(x, ops["conv1_w"], ops["conv1_b"])
    wants = {"r1": (r1, c1 * torch.tanh(F.softplus(c1))),
             "r": (r, fsrb._conv_reference(r1, ops["conv2_w"],
                                           ops["conv2_b"])),
             "qkv": (qkv, r.reshape(b, h * w, c).float()
                     @ ops["wtop"].float() + ops["peqkv"])}
    notes = []
    for name, (got, want) in wants.items():
        err = (got.float() - want).abs()
        bar = (bf16_ulp(want) if x.dtype == torch.bfloat16
               else torch.full_like(want, 1e-5) + 1e-5 * want.abs())
        worst = (err / bar).max().item()
        notes.append(f"{name} max err {err.max().item():.3e} "
                     f"({worst:.3f} of its bar)")
        if not torch.isfinite(got).all() or worst > 1:
            raise AssertionError(f"phase 22: {what}: the {name} launch "
                                 f"disagrees with its plain twin: "
                                 f"{notes[-1]}")
    return ", ".join(notes)


def cudnn_convs(x: torch.Tensor, ops: dict):
    """cuDNN's two 3x3 convs with their biases on x's channels-last memory
    at x's dtype, mish left out: the yardstick of B9's front half (timed
    only)."""
    xc = x.permute(0, 3, 1, 2)
    ws = [ops[f"conv{i}_w"].reshape(3, 3, 64, 64).permute(3, 2, 0, 1)
          .contiguous(memory_format=torch.channels_last) for i in (1, 2)]
    bs = [ops[f"conv{i}_b"].to(x.dtype) for i in (1, 2)]
    return lambda: F.conv2d(F.conv2d(xc, ws[0], bs[0], padding=1), ws[1],
                            bs[1], padding=1)


def phase22(dev, gpu: str) -> dict:
    gen = torch.Generator().manual_seed(SEED + 22)
    torch.manual_seed(SEED + 22)
    blk = TransformerResidualBlock(64, fused_srb=True)
    randomize_stats(blk, gen)
    blk = blk.to(dev).eval()
    result = {}
    for b, h, w, dt in B9_SHAPES:
        ops = blk.srb_operands(h, w, dt, dev)
        x = (torch.randn(b, h, w, 64, generator=gen) * 0.5).to(dev, dt)
        got = fused_srb(x, ops).float()
        want = fused_srb_reference(x, ops).float()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("B9 kernel output is not finite")
        err = (got - want).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        if dt == torch.float32:
            torch.testing.assert_close(got, want, rtol=FP32_RTOL,
                                       atol=FP32_ATOL)
        elif max_err > BF16_ATOL or mean_err > BF16_MEAN:
            raise AssertionError(f"bf16 B9 kernel disagrees: max {max_err} > "
                                 f"{BF16_ATOL} or mean {mean_err} > "
                                 f"{BF16_MEAN}")
        del got, want
        shape = f"({b}, {h}, {w}, 64) {dt}"
        launches = check_srb_launches(x, ops, shape)
        k_ms, p_ms = in_turns(lambda: fused_srb(x, ops),
                              lambda: fused_srb_reference(x, ops), 5)
        # the module path on the same block and map: cuDNN convs, BN, mish,
        # the fused enhancer (B1), the residual add (timed only)
        xm = x.permute(0, 3, 1, 2)
        blk.fused_srb = False
        with torch.inference_mode():
            m_ms = cuda_ms(lambda: blk(xm), 5)
        blk.fused_srb = True
        lib = cudnn_convs(x, ops)
        lib_ms = cuda_ms(lib, 10)
        lib_dev = device_ms(lib, 10)
        # the kernels a call runs, by name; in this long process the
        # profiler drops some of a trace's device events (an fp32 trace of
        # 5 calls held 7 or 9 of its 10 conv launches), so the launches a
        # call are printed, and tests/test_torch_fused_srb.py
        # `test_a_call_runs_its_kernels` holds them in a fresh process
        prof = profiled(lambda: fused_srb(x, ops), 5)
        ran = {k: n for k, (_, n) in prof.items()}
        if sorted(ran) != sorted(B9_KERNELS[dt]):
            raise AssertionError(f"phase 22: a B9 call {shape} ran {ran}, "
                                 f"want {B9_KERNELS[dt]}")
        # device ms a launch, which the dropped events do not bias
        split = {k: round(v / n, 4) for k, (v, n) in prof.items()}
        bd = srb_bound(b, h, w, dt)
        lb = {k: round(v, 4) for k, v in srb_launch_bounds(b, h, w,
                                                           dt).items()}
        front = sum(v * B9_KERNELS[dt][k] for k, v in split.items()
                    if k.startswith("conv3x3") or k == "qkv_proj_kernel")
        print(f"phase 22: whole SRB (B9) {shape}: max abs err {max_err:.3e}, "
              f"mean {mean_err:.3e}; launches against their twins: "
              f"{launches}")
        print(f"phase 22: B9 {shape}: kernel {k_ms:.4f} ms "
              f"(launches a call in the trace {ran}, device ms a launch "
              f"by kernel {split}; front half (convs and qkv) {front:.4f} "
              f"ms), "
              f"bounds by launch {lb}, plain {p_ms:.4f} ms, module path "
              f"{m_ms:.4f} ms, cuDNN's two convs {lib_ms:.4f} ms (device "
              f"{lib_dev:.4f}), bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}) [{gpu}]")
        result[(b, dt)] = {"max_abs_err": max_err, "ms": k_ms,
                           "plain_ms": p_ms, **bd, "library_ms": lib_ms}
        del x
    torch.cuda.empty_cache()
    return result[(BATCH, torch.bfloat16)]


def phase23(dev, gpu: str, pipe: PixelsToStrings,
            lr: torch.Tensor) -> int:
    """Phase 2's TBSRN with `fused_srb=True`: every SRB through B9."""
    bf16 = torch.bfloat16
    kw = dict(scale_factor=2, width=128, height=32, stn=True,
              srb_nums=SRB_NUMS, hidden_units=32, dtype=bf16, fused_srb=True)
    models = {"B9": TBSRN(**kw), "plain": TBSRN(**kw, kernels=False)}
    for m in models.values():
        m.load_state_dict(pipe.sr_apply.state_dict())
    conv = pipe.converter
    paths = {"B9": PixelsToStrings(models["B9"].to(dev).eval(),
                                   pipe.rec_apply, conv, device=dev),
             "fused enhancer": pipe,
             "plain": PixelsToStrings(models["plain"].to(dev).eval(),
                                      pipe.rec_apply, conv, device=dev)}
    for p in paths.values():
        p.ids_fn(lr)                 # warm-up
    torch.cuda.synchronize()
    fused_srb.launches = fused_enhancer.launches = 0
    _, sr_out = paths["B9"](lr, return_sr=True)
    torch.cuda.synchronize()
    got = (fused_srb.launches, fused_enhancer.launches)
    print(f"phase 23: one PixelsToStrings call through TBSRN with "
          f"fused_srb=True ran (B9 calls, standalone B1 launches) {got} "
          f"(expected ({SRB_NUMS}, 0))")
    if got != (SRB_NUMS, 0):
        raise AssertionError("phase 23: the TBSRN did not run the expected "
                             "kernel launches")
    with torch.inference_mode():
        for what in ("fused enhancer", "plain"):
            compare_paths("23", f"the {what} path", sr_out,
                          paths[what].sr_apply(lr), pipe.rec_apply)
    names = list(paths)
    ms = dict(zip(names[:2], in_turns(lambda: paths[names[0]].ids_fn(lr),
                                      lambda: paths[names[1]].ids_fn(lr), 5)))
    ms[names[2]] = cuda_ms(lambda: paths[names[2]].ids_fn(lr), 3)
    print("phase 23: pixels->strings at batch " + str(BATCH) + " bf16: "
          + ", ".join(f"{k} path {BATCH / v * 1e3:.1f} img/s ({v:.3f} ms)"
                      for k, v in ms.items()) + f" [{gpu}]")
    phase3(paths["B9"], lr, gpu, phase="23")

    # a train step moves the BN running statistics in place: the next
    # inference must fold the new ones (the operand cache follows them)
    model = models["B9"]
    stats = model.block2.bn1.running_mean.clone()
    step = make_sr_train_step(
        model, lambda sr, hr, *_: (F.mse_loss(sr.float(), hr), {}),
        adam_with_clip(model.parameters(), 1e-4))
    gen = torch.Generator().manual_seed(SEED + 23)
    hr = (torch.rand(TRAIN_B, 2 * LR_HW[0], 2 * LR_HW[1], 3, generator=gen)
          * 2 - 1).to(dev)
    loss = step({"lr": lr[:TRAIN_B], "hr": hr, "text_input": None,
                 "text_gt": None, "lengths": None},
                torch.Generator(dev).manual_seed(SEED + 23))["loss"].item()
    moved = (model.block2.bn1.running_mean - stats).abs().max().item()
    unfused = TBSRN(**{**kw, "fused_srb": False})
    unfused.load_state_dict(model.state_dict())
    unfused = unfused.to(dev).eval()
    with torch.inference_mode():
        sr_after = model(lr)
        compare_paths("23", "fused_srb=False after a train step", sr_after,
                      unfused(lr), pipe.rec_apply)
    print(f"phase 23: one train step (loss {loss:.4f}) moved the BN running "
          f"means by up to {moved:.3e}; inference after it agrees with "
          f"fused_srb=False on the same weights [{gpu}]")
    if not moved > 0 or not np.isfinite(loss):
        raise AssertionError("phase 23: the train step did not move the BN "
                             "statistics")
    return got[0]


def phase24(dev, gpu: str) -> tuple:
    l, heads, dh = B10_L, HEADS, 32
    gen = torch.Generator().manual_seed(SEED + 24)
    seed = torch.tensor(20261017, device=dev)
    keep = fa.dropout_keep_mask_cuda(seed, B10_B, heads, l, RATE, dev)
    same = torch.equal(keep, fa.dropout_keep_oracle(B10_B, heads, l, seed,
                                                    RATE, device=dev))
    print(f"phase 24: keep mask ({B10_B}, {heads}, {l}, {l}) from the "
          f"kernels' hash equals the plain hash bit for bit: {same} [{gpu}]")
    if not same:
        raise AssertionError("keep mask differs from the plain hash")
    del keep
    rows, counted = {}, {}
    for dt, b in DROPOUT_CASES:
        q, k, v, do = (torch.randn(b, l, heads * dh, generator=gen)
                       .to(dev, dt) for _ in range(4))
        fa.flash_mha_packed.launches = 0     # the checking run, counted
        fa.packed_dropout_fwd.launches = fa.packed_dropout_bwd.launches = 0
        ten = _attn_check("flash_mha_packed", fa.flash_mha_packed(q, k, v,
                                                                   heads),
                          fa.flash_mha_packed_reference(q, k, v, heads), dt)
        xk = [t.clone().requires_grad_() for t in (q, k, v)]
        xp = [t.clone().requires_grad_() for t in (q, k, v)]
        out_k = fa.flash_mha_packed_dropout(*xk, seed, heads, RATE)
        gk = torch.autograd.grad(out_k, xk, do)
        out_p = fa.flash_mha_packed_dropout_reference(*xp, seed, heads, RATE)
        gp = torch.autograd.grad(out_p, xp, do)
        torch.cuda.synchronize()
        counted[(dt, b)] = (fa.flash_mha_packed.launches,
                            fa.packed_dropout_fwd.launches,
                            fa.packed_dropout_bwd.launches)
        if counted[(dt, b)] != (1, 1, 1):
            raise AssertionError(f"phase 24: launches (B10, B11 forward, "
                                 f"B11 backward) {counted[(dt, b)]}, want "
                                 f"one each")
        attn_kernel_name("24", "B10",
                         lambda: fa.flash_mha_packed(q, k, v, heads), dt)
        ferr = (out_k.float() - out_p.float()).abs().max().item()
        grel = max(rel_err(a, c) for a, c in zip(gk, gp))
        berr = max((a.float() - c.float()).abs().max().item()
                   for a, c in zip(gk, gp))
        again = fa.flash_mha_packed_dropout(q, k, v, seed, heads, RATE)
        other = fa.flash_mha_packed_dropout(q, k, v, seed + 1, heads, RATE)
        print(f"phase 24: ({b}, {l}, {heads * dh}) {dt}: B10 max abs err "
              f"{ten:.3e}; B11 forward max abs err {ferr:.3e}, dq/dk/dv max "
              f"rel {grel:.3e} (max abs {berr:.3e}); same seed "
              f"bit-identical: {torch.equal(again, out_k)}, another seed "
              f"differs: {not torch.equal(other, again)} [{gpu}]")
        if not (torch.isfinite(out_k).all()
                and all(torch.isfinite(g).all() for g in gk)):
            raise AssertionError("B11 kernels' output not finite")
        if ferr > ATTN_ATOL[dt] or grel > GRAD_REL[dt]:
            raise AssertionError(f"B11 kernels disagree ({dt})")
        if not torch.equal(again, out_k) or torch.equal(other, again):
            raise AssertionError("the seed does not decide B11's output")
        del out_k, out_p, gk, gp, again, other

        p10_ms, p10p_ms = in_turns(
            lambda: fa.flash_mha_packed(q, k, v, heads),
            lambda: fa.flash_mha_packed_reference(q, k, v, heads), 5)
        qh, kh, vh = (t.unflatten(-1, (heads, dh)).transpose(1, 2)
                      for t in (q, k, v))
        sdpa10 = lambda: F.scaled_dot_product_attention(qh, kh, vh)
        lib10 = cuda_ms(sdpa10, 5)
        o, lse = fa.packed_dropout_fwd(q, k, v, seed, heads, RATE)
        og = fa.flash_mha_packed_dropout_reference(*xp, seed, heads, RATE)
        f_ms, fp_ms = in_turns(
            lambda: fa.flash_mha_packed_dropout(q, k, v, seed, heads, RATE),
            lambda: fa.flash_mha_packed_dropout_reference(q, k, v, seed,
                                                          heads, RATE), 5)
        b_ms, bp_ms = in_turns(
            lambda: fa.packed_dropout_bwd(q, k, v, o, do, lse, seed, heads,
                                          RATE),
            lambda: torch.autograd.grad(og, xp, do, retain_graph=True), 5)
        # the yardstick: SDPA with dropout 0.1 on the (B, H, L, dh) views (it
        # draws another mask; timed only)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        sh = [t.unflatten(-1, (heads, dh)).transpose(1, 2) for t in xs]
        sdpa = lambda: F.scaled_dot_product_attention(*sh, dropout_p=RATE)
        lib_f = cuda_ms(sdpa, 5)
        so = sdpa().transpose(1, 2).reshape(b, l, heads * dh)
        lib_b = cuda_ms(lambda: torch.autograd.grad(so, xs, do,
                                                    retain_graph=True), 5)
        es = torch.finfo(dt).bits // 8
        n = b * l * heads * dh
        # forward: q, k, v read, o and lse written; backward: q, k, v, o,
        # dO, lse read, dq, dk, dv written (products and hash passes as in
        # phase 5)
        fb, f_mm, f_hash = dropout_bound(b, heads, l, dt, 2, 1,
                                         4 * n * es + b * heads * l * 4)
        bb, b_mm, b_hash = dropout_bound(b, heads, l, dt, 5, 1,
                                         8 * n * es + b * heads * l * 4)
        tb = attn_bound(b, heads, l, l, dh, dt)
        short10 = short_note(lambda: fa.flash_mha_packed(q, k, v, heads),
                             sdpa10, p10_ms, dt)
        print(f"phase 24: ({b}, {l}, {heads * dh}) {dt}: B10 kernel "
              f"{p10_ms:.4f} ms, plain {p10p_ms:.4f} ms, SDPA {lib10:.4f} "
              f"ms, {bound_note(tb)}{short10}, "
              f"{4 * b * l * l * heads * dh / p10_ms / 1e9:.1f} TFLOP/s; B11 "
              f"forward kernel {f_ms:.4f} ms, plain {fp_ms:.4f} ms, SDPA "
              f"{lib_f:.4f} ms, {dropout_note(fb, f_mm, f_hash)}; backward "
              f"kernel {b_ms:.4f} ms, plain {bp_ms:.4f} ms, SDPA "
              f"{lib_b:.4f} ms, {dropout_note(bb, b_mm, b_hash)} [{gpu}]")
        rows[(dt, b)] = (
            {"max_abs_err": ten, "ms": p10_ms, "plain_ms": p10p_ms, **tb,
             "library_ms": lib10},
            {"max_abs_err": ferr, "ms": f_ms, "plain_ms": fp_ms, **fb,
             "library_ms": lib_f},
            {"max_abs_err": berr, "ms": b_ms, "plain_ms": bp_ms, **bb,
             "library_ms": lib_b})
        del q, k, v, do, xk, xp, o, lse, og, xs, sh, so
        torch.cuda.empty_cache()
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(B10_B, l, heads * dh, generator=gen)
                   .to(dev, dt).requires_grad_() for _ in range(3))
        do = torch.randn(B10_B, l, heads * dh, generator=gen).to(dev, dt)
        dropout_kernel_names(
            "24", "B11", lambda: torch.autograd.grad(
                fa.flash_mha_packed_dropout(q, k, v, seed, heads, RATE),
                (q, k, v), do), dt)
    return rows, counted


# phase 25: the JAX package's benched train step (bench_train.py:20-50):
# TBSRN x2 + STN, 5 SRBs, hidden 32, and the OCRTransformer oracle, both in
# bf16, at batch 128, label length 16
STEP_B, STEP_LABEL_LEN = 128, 16
# kernel path against plain path in bf16 (the same weights, seeds and keep
# masks): the two round at other places (B4 rounds P and dS to bf16 for its
# products; B2 and the plain LayerNorm round their outputs once each), and
# every such difference is then carried through bf16 activations (8
# significant bits, 3.9e-3 relative) of 5 SRBs and the oracle. Bars: the
# loss to 1e-2 relative, all gradients together to 5e-2 norm-relative and
# within the distance of the plain bf16 step's gradients from the plain
# fp32 step's on the same weights (what bf16 itself moves them by).
BF16_STEP_LOSS_REL, BF16_STEP_GRAD_REL = 1e-2, 5e-2


def grad_distance(model, other) -> tuple:
    """(norm-relative distance of all gradients together, the largest
    per-tensor relative distance among tensors holding 1e-3 or more of the
    largest gradient norm, that tensor's name), `model` against `other`."""
    pairs = [(n, pk.grad.float(), pp.grad.float()) for (n, pk), pp in
             zip(model.named_parameters(), other.parameters())]
    top = max(gp.norm().item() for _, _, gp in pairs)
    diff = sum(((gk - gp) ** 2).sum().item() for _, gk, gp in pairs)
    norm = sum((gp ** 2).sum().item() for _, _, gp in pairs)
    worst, worst_name = 0.0, ""
    for name, gk, gp in pairs:
        if gp.norm().item() >= 1e-3 * top:
            err = rel_err(gk, gp)
            if err > worst:
                worst, worst_name = err, name
    return (diff / norm) ** 0.5, worst, worst_name


def bf16_step_bar(what: str, losses: tuple, models: tuple) -> dict:
    """The bf16 training bar on one step of (the bf16 kernel path, the bf16
    plain path, the fp32 plain path) from the same weights and generator
    seed, `losses` their losses: the loss within BF16_STEP_LOSS_REL of the
    plain step's, the gradients, all together, within BF16_STEP_GRAD_REL
    and within the plain bf16 step's own distance from the fp32 step.
    Returns the readings; raises past the bar."""
    lk, lp, l32 = losses
    grel, worst, worst_name = grad_distance(models[0], models[1])
    grel16, worst16, _ = grad_distance(models[1], models[2])
    r = {"loss_rel": abs(lk - lp) / abs(lp),
         "loss_bf16": abs(lp - l32) / abs(l32), "grel": grel,
         "worst": worst, "worst_name": worst_name, "grel16": grel16,
         "worst16": worst16}
    if (not np.isfinite(lk) or r["loss_rel"] > BF16_STEP_LOSS_REL
            or grel > min(BF16_STEP_GRAD_REL, grel16)):
        raise AssertionError(f"{what}: the bf16 kernel path's step "
                             f"disagrees with the bf16 plain step: {r}")
    return r


def phase25(dev, gpu: str) -> tuple:
    torch.manual_seed(SEED + 25)
    sr_kw = dict(scale_factor=2, width=128, height=32, stn=True,
                 srb_nums=SRB_NUMS, hidden_units=32)
    oracle_kw = dict(vocab=LOSS_VOCAB, num_in=1, layers=(1, 2, 5, 3),
                     num_heads=16, d_embed=512, d_model=1024, d_ff=2048)
    bf = torch.bfloat16
    model = TBSRN(**sr_kw, dtype=bf).to(dev)
    plain = TBSRN(**sr_kw, dtype=bf, kernels=False).to(dev)
    ref = TBSRN(**sr_kw, kernels=False).to(dev)   # fp32, plain
    oracle = OCRTransformer(**oracle_kw, dtype=bf).to(dev)
    oracle_plain = OCRTransformer(**oracle_kw, dtype=bf, kernels=False)
    oracle_ref = OCRTransformer(**oracle_kw, kernels=False)
    for m in (oracle_plain, oracle_ref):
        m.to(dev).load_state_dict(oracle.state_dict())
    init = {k: v.clone() for k, v in model.state_dict().items()}
    for m in (plain, ref):
        m.load_state_dict(init)
    hr, lr, labels = next(SeededTextZoom(STEP_B, SEED + 250).batches(STEP_B))
    ti, tg, ln = encode_text_labels(labels, STEP_LABEL_LEN)
    batch = {"hr": torch.from_numpy(hr).to(dev),
             "lr": torch.from_numpy(lr).to(dev),
             **{k: torch.from_numpy(a).to(dev, torch.int64) for k, a in
                (("text_input", ti), ("text_gt", tg), ("lengths", ln))}}
    losses = [TextFocusLoss(o) for o in (oracle, oracle_plain, oracle_ref)]
    steps = [make_sr_train_step(m, f, adam_with_clip(m.parameters(), 1e-4))
             for m, f in zip((model, plain, ref), losses)]

    # (a) one step of each path from the same weights and generator seed,
    # so the three draw the same keep masks; live HR maps
    torch.cuda.synchronize()
    reset_counts()
    out = [steps[0](batch, torch.Generator(dev).manual_seed(7))]
    torch.cuda.synchronize()
    live = train_counts()
    out += [st(batch, torch.Generator(dev).manual_seed(7))
            for st in steps[1:]]
    torch.cuda.synchronize()
    if not all(np.isfinite(v.item()) for v in out[0].values()):
        raise AssertionError("bf16 train step metrics are not finite")
    lk, lp, lr32 = (o["loss"].item() for o in out)
    r = bf16_step_bar("phase 25a", (lk, lp, lr32), (model, plain, ref))
    print(f"phase 25a: one bf16 train step at batch {STEP_B}: loss kernel "
          f"path {lk:.6f}, plain path {lp:.6f} (rel {r['loss_rel']:.3e}, "
          f"bar {BF16_STEP_LOSS_REL}), fp32 plain path {lr32:.6f} (bf16 vs "
          f"fp32 rel {r['loss_bf16']:.3e}); gradients kernel vs plain "
          f"{r['grel']:.3e} norm-relative (bar {BF16_STEP_GRAD_REL}), worst "
          f"tensor {r['worst']:.3e} ({r['worst_name']}); plain bf16 vs fp32 "
          f"{r['grel16']:.3e}, worst tensor {r['worst16']:.3e}; grad norm "
          f"{out[0]['grad_norm'].item():.4f} vs "
          f"{out[1]['grad_norm'].item():.4f} [{gpu}]")
    del ref, oracle_ref, steps[2], losses[2]
    torch.cuda.empty_cache()

    # (b) launches per step, cached HR map as SRTrainer runs from epoch 1
    batch["hr_map"] = losses[0].hr_oracle_map(batch["hr"],
                                              batch["text_input"])
    torch.cuda.synchronize()
    reset_counts()
    steps[0](batch, torch.Generator(dev).manual_seed(8))
    torch.cuda.synchronize()
    cached = train_counts()
    want_live = (2 * SRB_NUMS + 2 * 3, SRB_NUMS, SRB_NUMS, 0)
    want_cached = (2 * SRB_NUMS + 3, SRB_NUMS, SRB_NUMS, 0)
    print(f"phase 25b: launches per bf16 step (LayerNorm, B4 forward, B4 "
          f"backward, fused enhancer): live HR map {live} (expected "
          f"{want_live}), cached {cached} (expected {want_cached}) [{gpu}]")
    if live != want_live or cached != want_cached:
        raise AssertionError("the bf16 train step did not run the expected "
                             "kernel launches")

    # (c) steady-state step time of both paths, and B4's share of a step
    gk, gp = (torch.Generator(dev).manual_seed(9) for _ in range(2))
    k_ms, p_ms = in_turns(lambda: steps[0](batch, gk),
                          lambda: steps[1](batch, gp), 3)
    for name, ms, st, g in (("kernel", k_ms, steps[0], gk),
                            ("plain", p_ms, steps[1], gp)):
        rows, busy = profile_step(st, batch, g, gpu,
                                  f"phase 25c: {name} path bf16")
        b4 = sum(e.device_time_total for e in rows
                 if re.sub(r"^void |\(anonymous namespace\)::", "",
                           e.key).startswith("attn_dropout_")) / 1e3
        print(f"phase 25c: {name} path bf16 train step at batch {STEP_B}: "
              f"{ms:.3f} ms, {STEP_B * 1e3 / ms:.1f} img/s; dropout "
              f"attention (B4, 5 forwards + 5 backwards) {b4:.3f} ms of "
              f"{busy:.3f} ms of device time in the profiled step [{gpu}]")
    print(f"phase 25: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{gpu}]")
    return live


# the phases that need nothing of an earlier one, for `--phases`
# phase 26: as many crops as TextZoom's hard test split; 1343 % 256 = 63
# images in the last batch
LMDB_IMAGES = 1343
LMDB_WORKERS = min(os.cpu_count() or 1, 16)


def lmdb_crops(n: int, seed: int, noise: float = 6.0):
    """n (hr, lr, label) crops from a seed: a light background, dark
    vertical strokes, Gaussian noise of sigma `noise`; HR 32x128, the LR
    redrawn from it at heights 8-40 and widths 20-200, so the collate both
    shrinks and enlarges. A synthetic mix with no published source: the
    noise fills the high frequencies, so the decoder meets more nonzero
    coefficients than in a blurry crop."""
    rng = np.random.default_rng(seed)
    h, w = 2 * LR_HW[0], 2 * LR_HW[1]
    for _ in range(n):
        img = np.empty((h, w, 3))
        img[:] = rng.integers(120, 256, 3)
        fg = rng.integers(0, 100, 3)
        for _ in range(int(rng.integers(3, 10))):
            x0, y0 = int(rng.integers(2, w - 8)), int(rng.integers(2, 10))
            img[y0:int(rng.integers(20, 30)),
                x0:x0 + int(rng.integers(2, 6))] = fg
        img += rng.normal(0, noise, img.shape) if noise else 0.0
        hr = np.clip(img, 0, 255).astype(np.uint8)
        lr = resize_bicubic(hr, (int(rng.integers(20, 201)),
                                 int(rng.integers(8, 41))))
        label = "".join(rng.choice(list(ALPHABET), int(rng.integers(3, 9))))
        yield hr, lr, label


def host_pass(ds: LRServingLMDBDataset, n: int) -> tuple:
    """The host's work on one worker, read + decode + resize + collate of
    the first n images -> (uint8 batches, ms per image)."""
    t0 = time.perf_counter()
    batches = [ds.collate(ds.fetch_items(range(s, min(s + BATCH, n))))
               for s in range(0, n, BATCH)]
    return batches, (time.perf_counter() - t0) * 1e3 / n


def host_probe_ms() -> float:
    """ms of a fixed pure-Python loop that allocates no tracked object:
    it follows the host core's speed and the GIL's contention, and not the
    process's heap or its garbage collector."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(3_000_000):
        acc ^= i
    return (time.perf_counter() - t0) * 1e3


def host_state() -> str:
    """The process state that can slow the host's Python: OS threads and
    the Python threads among them, objects the garbage collector tracks,
    resident memory."""
    status = dict(line.split(":", 1) for line in
                  open("/proc/self/status").read().splitlines()
                  if ":" in line)
    names = sorted(t.name for t in threading.enumerate())
    return (f"{status['Threads'].strip()} OS threads, Python threads "
            f"{names}, "
            f"{len(gc.get_objects())} gc-tracked objects, "
            f"{status['VmRSS'].strip()} resident")


class EventTimedPipe:
    """A pipe whose `ids_fn` calls are bracketed by CUDA events. Their
    summed time is the `ids_fn` device span: it also holds the time the
    device waits while the launching thread waits for the GIL, so it
    overstates the device's work (that comes from `served_device_ms`)."""

    def __init__(self, pipe: PixelsToStrings):
        self.pipe, self.device, self.spans = pipe, pipe.device, []

    def ids_fn(self, x):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        ids = self.pipe.ids_fn(x)
        e1.record()
        self.spans.append((e0, e1))
        return ids

    def decode_ids(self, ids):
        return self.pipe.decode_ids(ids)

    def span_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans)


def serve_lmdb(pipe: PixelsToStrings, path: str, workers: int) -> tuple:
    """One LMDBToStrings pass -> (strings, wall s, `ids_fn` span ms)."""
    timed = EventTimedPipe(pipe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = [t for batch in LMDBToStrings(timed, path, batch_size=BATCH,
                                          num_workers=workers)
             for t in batch]
    torch.cuda.synchronize()
    return texts, time.perf_counter() - t0, timed.span_ms()


def served_device_ms(pipe: PixelsToStrings, path: str) -> dict:
    """The device's work in one LMDBToStrings pass at 0 workers, from a
    scheduled torch.profiler trace (a warm-up step of one batch first, as
    in `profile_kernels`): summed kernel ms, summed copy ms, B1's
    kernels seen in the trace and B1's launches counted. The
    workers are left out: their forks would copy a process that is
    tracing the card; the device's work is the same batches either way."""
    from torch.profiler import ProfilerActivity, profile, schedule

    got = {"kernel_ms": 0.0, "copy_ms": 0.0, "b1_traced": 0}

    def ready(prof):
        for e in prof.key_averages():
            if e.device_type.name != "CUDA" or e.device_time_total <= 0:
                continue
            copy = e.key.startswith(("Memcpy", "Memset"))
            got["copy_ms" if copy else "kernel_ms"] += \
                e.device_time_total / 1e3
            if re.search(r"qkv_proj(_mma)?_kernel|attn_epilogue_kernel",
                         e.key):
                got["b1_traced"] += e.count

    warm = torch.zeros(BATCH, *LR_HW, 3, dtype=torch.uint8,
                       device=pipe.device)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        pipe.ids_fn(normalize_uint8(warm))
        torch.cuda.synchronize()
        prof.step()
        before = fused_enhancer.launches
        serve_lmdb(pipe, path, 0)
        got["b1_counted"] = fused_enhancer.launches - before
        prof.step()
    return got


def phase26(dev, gpu: str, pipe: PixelsToStrings) -> int:
    """LMDB -> strings through `LMDBToStrings` with phase 2's bf16 pipe."""
    n, batches_n = LMDB_IMAGES, -(-LMDB_IMAGES // BATCH)
    sub = 2 * BATCH          # the host's diagnostics run on 512 images
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lmdb_") as tmp:
        path, smooth = os.path.join(tmp, "db"), os.path.join(tmp, "smooth")
        t0 = time.perf_counter()
        create_dataset(path, lmdb_crops(n, SEED + 26))
        mb = os.path.getsize(os.path.join(path, "data.mdb")) / 2 ** 20
        print(f"phase 26: wrote {n} seeded crops (HR 32x128, LR heights "
              f"8-40, widths 20-200; a synthetic mix, noise sigma 6) as "
              f"JPEG q95 with the port's create_dataset: {mb:.1f} MiB in "
              f"{time.perf_counter() - t0:.2f} s [{gpu}]")
        create_dataset(smooth, lmdb_crops(sub, SEED + 26, noise=0.0))
        # the host alone on one worker: read, decode, resize, collate
        ds = LRServingLMDBDataset(path)
        probe = [host_probe_ms()]
        host, host_ms = host_pass(ds, n)
        probe.append(host_probe_ms())
        _, again_ms = host_pass(ds, sub)
        gc.disable()
        try:
            _, no_gc_ms = host_pass(ds, sub)
        finally:
            gc.enable()
        _, smooth_ms = host_pass(LRServingLMDBDataset(smooth), sub)
        probe.append(host_probe_ms())
        print(f"phase 26: host decode + resize + collate on one worker: "
              f"{host_ms:.4f} ms per image over {n}; the first {sub} again "
              f"{again_ms:.4f}, with the garbage collector off "
              f"{no_gc_ms:.4f}; {sub} noise-free crops {smooth_ms:.4f}; "
              f"host probe (a fixed Python loop) "
              f"{', '.join(f'{p:.2f}' for p in probe)} ms; "
              f"{host_state()} [{gpu}]")

        fused_enhancer.launches = 0      # the main path's run, counted
        texts, _, _ = serve_lmdb(pipe, path, LMDB_WORKERS)
        launches = fused_enhancer.launches
        print(f"phase 26: LMDBToStrings over {n} images at batch {BATCH} "
              f"({batches_n} batches, the last of {n % BATCH}) with "
              f"{LMDB_WORKERS} workers ran {launches} B1 launches (expected "
              f"{2 * SRB_NUMS * batches_n}) and returned {len(texts)} "
              "strings")
        if launches != 2 * SRB_NUMS * batches_n or len(texts) != n:
            raise AssertionError("phase 26: LMDBToStrings did not serve "
                                 "every image through B1")
        runs = {w: serve_lmdb(pipe, path, w) for w in (0, LMDB_WORKERS)}
        device = served_device_ms(pipe, path)

    # the same collated uint8 batches through the pipe, and the plain pipe
    sr_plain = TBSRN(scale_factor=2, width=128, height=32, stn=True,
                     srb_nums=SRB_NUMS, hidden_units=32, kernels=False,
                     dtype=torch.bfloat16)
    sr_plain.load_state_dict(pipe.sr_apply.state_dict())
    sr_plain = sr_plain.to(dev).eval()
    want, ids, ids_ref, margin, err = [], [], [], [], 0.0
    with torch.inference_mode():
        for b in host:
            x = normalize_uint8(torch.from_numpy(b).to(dev))
            want += pipe(x)
            logits = pipe.rec_apply(parse_crnn_input(pipe.sr_apply(x)))
            ref = pipe.rec_apply(parse_crnn_input(sr_plain(x)))
            err = max(err, (logits.float() - ref.float()).abs().max().item())
            ids.append(logits.argmax(-1).cpu().numpy())
            ids_ref.append(ref.argmax(-1).cpu().numpy())
            margin.append(top2_margin(ref).cpu().numpy())
    texts_ref = pipe.decode_ids(np.concatenate(ids_ref))
    ids, ids_ref = np.concatenate(ids), np.concatenate(ids_ref)
    sure_step = np.concatenate(margin) > 2 * err
    sure = sure_step.all(axis=1)
    bad = [i for i in np.flatnonzero(sure) if texts[i] != texts_ref[i]]
    same = [t == texts for t, _, _ in runs.values()]
    print(f"phase 26: all {n} strings equal to the pipe on the same collated "
          f"uint8 batches: {texts == want} (both timed runs: {all(same)}); "
          f"against the plain path (logits max abs err {err:.3e}): ids equal "
          f"at all {int(sure_step.sum())} of {sure_step.size} CTC steps with "
          f"a top-2 margin above {2 * err:.3e}: "
          f"{bool((ids == ids_ref)[sure_step].all())}; strings equal at "
          f"all {int(sure.sum())} images confident at every step (random "
          f"weights: few or none are): {not bad}")
    if texts != want or not all(same):
        raise AssertionError("phase 26: LMDBToStrings disagrees with the "
                             "pipe on the same batches")
    if bad or not (ids == ids_ref)[sure_step].all():
        raise AssertionError("phase 26: the kernel path decodes other ids "
                             "than the plain path at steps with a clear "
                             "top-2 margin")
    busy = device["kernel_ms"] + device["copy_ms"]
    print(f"phase 26: device work of one served pass (torch.profiler, 0 "
          f"workers): kernels {device['kernel_ms']:.3f} ms, copies "
          f"{device['copy_ms']:.3f} ms (summed over both streams, so at "
          f"most {busy:.3f} ms busy); B1 kernels in the trace "
          f"{device['b1_traced']} of {device['b1_counted']} launched "
          f"[{gpu}]")
    for w, (_, wall, span) in runs.items():
        print(f"phase 26: LMDB->strings at batch {BATCH} bf16, {w} "
              f"workers: {n / wall:.1f} img/s ({wall:.3f} s for {n} "
              f"images); device busy at most {busy:.3f} ms = "
              f"{100 * busy / (wall * 1e3):.2f} % of the wall; ids_fn "
              f"device span (CUDA events, GIL waits included) {span:.3f} "
              f"ms = {100 * span / (wall * 1e3):.2f} %; host "
              f"decode + resize {host_ms:.4f} ms per image on one worker; "
              f"os.cpu_count() {os.cpu_count()} [{gpu}]")
    lib = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                       "lib64")
    found = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(lib, "libnvjpeg.so*")))
    print(f"phase 26: libnvjpeg.so* in {lib}: {found or 'none'}")
    return launches


def phase26_alone(dev, gpu: str) -> int:
    """Phase 26 without phase 2: its pipe from phase 2's seeds."""
    sr, _, crnn, _ = ocr_models(dev)
    return phase26(dev, gpu, PixelsToStrings(
        sr, crnn, CTCLabelConverter(ALPHABET), device=dev))


# -- phases 27-28: the training journeys through the apps, fed from files

SR_APP_CROPS, SR_APP_VAL = 512, 128    # train crops; crops per val bucket
SR_APP_EPOCHS = 2                      # 512 / 64 x 2 = 16 steps
# phase 28: photos (w, h), 8 of each orientation, and 2 val images of one
# size (an evaluation batch stacks images of one size)
SEG_APP_SHAPES = ((1024, 768),) * 8 + ((768, 1024),) * 8
SEG_APP_VAL_SHAPES = ((1024, 768),) * 2
# 4 + 2 iterations: at 6 + 2 phases 27-28 took 139 s (PERF.md §6, PR 17)
SEG_APP_ITERS, SEG_APP_MORE = 4, 2
SR_HOST_BATCHES, SEG_HOST_SAMPLES = 4, 2   # the host's timed share


@contextlib.contextmanager
def recording(module, maker: str, cls, counts):
    """While open, every train step that `module.<maker>` builds records
    its metrics, its own launches by `counts()` and a CUDA event at its
    start; `cls.train` records its trainer (and, in `rec["profile"]`,
    the kernel and copy ms of a torch.profiler trace over it and its wall
    ms, when `rec["profile"]` is set to {}); `cls.evaluate` records its
    result and its launches."""
    from torch.profiler import ProfilerActivity, profile

    rec = {"steps": [], "trainers": [], "evals": [], "profile": None}
    make, train, evaluate = getattr(module, maker), cls.train, cls.evaluate

    def delta(before):
        return tuple(b - a for a, b in zip(before, counts()))

    def make_recorded(*args, **kw):
        step = make(*args, **kw)

        def recorded(batch, generator=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            before = counts()
            out = step(batch, generator)
            rec["steps"].append((out, delta(before), ev))
            return out
        return recorded

    def train_recorded(self, *args, **kw):
        rec["trainers"].append(self)
        if rec["profile"] is None:
            return train(self, *args, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = train(self, *args, **kw)
            torch.cuda.synchronize()
            rec["profile"]["wall_ms"] = (time.perf_counter() - t0) * 1e3
        rec["profile"]["busy_ms"] = device_busy_ms(prof)
        return out

    def evaluate_recorded(self, *args, **kw):
        before = counts()
        res = evaluate(self, *args, **kw)
        torch.cuda.synchronize()
        rec["evals"].append((res, delta(before)))
        return res

    setattr(module, maker, make_recorded)
    cls.train, cls.evaluate = train_recorded, evaluate_recorded
    try:
        yield rec
    finally:
        setattr(module, maker, make)
        cls.train, cls.evaluate = train, evaluate


def device_busy_ms(prof) -> float:
    """Kernel and copy ms of a torch.profiler trace, summed over streams
    (user annotations left out: they span kernels already counted)."""
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_time_total > 0 and e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)) / 1e3


def finite_losses(rec) -> list:
    losses = [out["loss"].item() for out, _, _ in rec["steps"]]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses} are not finite")
    return losses


def sr_app_config(tmp: str, name: str, train: list, val: list,
                  epochs: int, val_every: int) -> tuple:
    """A YAML config of the SR apps (phase 6's recipe, batch 64) -> (its
    path, the checkpoint dir, the demo dir)."""
    ckpt, demo = (os.path.join(tmp, name, d) for d in ("ckpt", "demo"))
    cfg = {"TRAIN": {
        "train_data_dir": train, "batch_size": TRAIN_B, "width": 128,
        "height": 32, "epochs": epochs, "lr": 1e-4, "beta1": 0.5,
        "manualSeed": SEED + 27, "max_len": 100, "down_sample_scale": 2,
        "ckpt_dir": ckpt, "synthetic_samples": 512, "voc_type": "all",
        "VAL": {"val_data_dir": val, "valInterval": val_every, "n_vis": 10,
                "vis_dir": demo}}}
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
    return path, ckpt, demo


SR_FEED_STEPS, SR_FEED_WARM = 8, 2   # steps a feed turn (an epoch), warm-up


def sr_feed_turns(trainer) -> dict:
    """Wall ms per step of `trainer`'s steps (HR maps cached) fed three
    ways over its train set: "workers", its own feed (`num_workers`
    forked processes, the prefetch thread stages each batch); "main", the
    feed with no workers (the host work and copy in the main thread before
    each step); "thread", the host work of no workers and the copy on the
    prefetch thread (JAX's feed). In turns workers, main, thread, thread,
    main, workers; per turn (ms per step over all SR_FEED_STEPS steps, ms
    per step after SR_FEED_WARM)."""
    data, workers = trainer.train_data, trainer.num_workers

    def feed(n: int, thread: bool = False):
        trainer.num_workers = n
        if thread:
            return PrefetchIterator(trainer.host_batches(data),
                                    trainer.device, buffer_size=1)
        return trainer.feed(data)

    feeds = {"workers": lambda: feed(workers), "main": lambda: feed(0),
             "thread": lambda: feed(0, thread=True)}
    walls = {k: [] for k in feeds}
    try:
        for name in ("workers", "main", "thread", "thread", "main",
                     "workers"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batches = feeds[name]()
            for bi, batch in zip(range(SR_FEED_STEPS), batches):
                batch["hr_map"] = trainer._hr_map(bi, batch)
                trainer.train_step(batch, trainer.generator)
                if bi + 1 == SR_FEED_WARM:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            batches.close()
            walls[name].append(
                (round((t2 - t0) * 1e3 / SR_FEED_STEPS, 1),
                 round((t2 - t1) * 1e3 / (SR_FEED_STEPS - SR_FEED_WARM),
                       1)))
    finally:
        trainer.num_workers = workers
    return walls


def phase27(dev, gpu: str, step6_ms=None) -> None:
    """The SR training journey through the apps, fed from LMDBs on disk."""
    from fudanocr_tpu_torch.apps.scene_text_telescope import main as stt
    from fudanocr_tpu_torch.apps.text_gestalt import main as gestalt

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sr_app_") as tmp:
        t0 = time.perf_counter()
        train = os.path.join(tmp, "train")
        create_dataset(train, lmdb_crops(SR_APP_CROPS, SEED + 27))
        vals = []
        for k, name in enumerate(("easy", "medium", "hard")):
            vals.append(os.path.join(tmp, name))
            create_dataset(vals[-1], lmdb_crops(SR_APP_VAL, SEED + 270 + k))
        crops = list(lmdb_crops(2 * TRAIN_B, SEED + 274))
        stores = {k: os.path.join(tmp, k) for k in ("hr_only", "mix",
                                                    "small")}
        create_dataset(stores["hr_only"], [(hr, None, t) for hr, _, t in
                                           crops])
        create_dataset(stores["mix"], [(hr, lr if i % 2 else None, t)
                                       for i, (hr, lr, t) in
                                       enumerate(crops)])
        create_dataset(stores["small"], crops)
        print(f"phase 27: wrote a train LMDB of {SR_APP_CROPS} crops, three "
              f"val LMDBs of {SR_APP_VAL} (easy/medium/hard) and three of "
              f"{2 * TRAIN_B} (HR only, mixed, paired) with the port's "
              f"create_dataset in {time.perf_counter() - t0:.2f} s [{gpu}]")

        # (a) scene_text_telescope.main: 2 epochs, 16 steps, eval at 16
        cfg, ckpt, demo = sr_app_config(tmp, "stt", [train], vals,
                                        SR_APP_EPOCHS, 16)
        argv = ["--config", cfg, "--arch", "tbsrn", "--STN", "--text_focus"]
        torch.cuda.synchronize()
        reset_counts()                  # the journey's run, counted
        with recording(train_sr, "make_sr_train_step", SRTrainer,
                       train_counts) as rec:
            t0 = time.perf_counter()
            res = stt.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        total = train_counts()
        steps = SR_APP_CROPS // TRAIN_B * SR_APP_EPOCHS
        losses = finite_losses(rec)
        per_step = {d for _, d, _ in rec["steps"]}
        want_step = (2 * SRB_NUMS + 3, SRB_NUMS, SRB_NUMS, 0)
        eval_b1 = [d[3] for _, d in rec["evals"]]
        want_eval = 3 * SR_APP_VAL // TRAIN_B * 2 * SRB_NUMS
        want_total = (steps * want_step[0] + 3 * SR_APP_CROPS // TRAIN_B,
                      steps * SRB_NUMS, steps * SRB_NUMS,
                      len(eval_b1) * want_eval)
        print(f"phase 27a: scene_text_telescope.main --arch tbsrn --STN "
              f"--text_focus, batch {TRAIN_B} fp32: {len(losses)} steps in "
              f"{wall:.3f} s (the whole app), losses first {losses[0]:.4f}, "
              f"last {losses[-1]:.4f}; launches per step (LayerNorm, "
              f"attention forward, attention backward, fused enhancer) "
              f"{sorted(per_step)} (expected [{want_step}], phase 6b's "
              f"cached-map step), B1 launches per evaluation {eval_b1} "
              f"(expected {want_eval} each: 6 batches, phase 6d's 10 a "
              f"batch), app total {total} (expected {want_total}, the "
              f"epoch-0 HR maps' 3 LayerNorms each outside the steps); "
              f"final evaluation {res} [{gpu}]")
        if (len(losses) != steps or per_step != {want_step}
                or eval_b1 != [want_eval] * 2 or total != want_total):
            raise AssertionError("phase 27: the app did not run the "
                                 "expected kernel launches")
        best = torch.load(os.path.join(ckpt, "best.pt"), map_location="cpu")
        again = stt.main(argv + ["--test", "--resume", "auto"])
        rel = max(abs(again[k] - res[k]) / max(abs(res[k]), 1e-12)
                  for k in res)
        accs = [k for k in res if k.endswith("acc")]
        print(f"phase 27a: best.pt at step {best['step']}; --test --resume "
              f"auto: {again}; equal to the training run's final evaluation "
              f"and best.pt's: {again == res == best['metrics']} (largest "
              f"relative difference {rel:.3e}) [{gpu}]")
        if (best["metrics"] != res or set(again) != set(res) or rel > 1e-6
                or any(again[k] != res[k] for k in accs)):
            raise AssertionError("phase 27: --test --resume auto does not "
                                 "reproduce the saved evaluation")
        stt.main(argv + ["--demo", "--resume", "auto"])
        strips = sorted(os.listdir(demo))
        shapes = set()
        for name in strips:
            with open(os.path.join(demo, name), "rb") as f:
                shapes.add(decode_png(f.read()).shape)
        print(f"phase 27a: --demo wrote {len(strips)} PNG strips, decoded "
              f"at {sorted(shapes)} [{gpu}]")
        if len(strips) != 10 or shapes != {(32, 3 * 128, 3)}:
            raise AssertionError("phase 27: --demo strips missing or "
                                 "misshapen")

        # steady state: epoch 1's steps on the device's timeline (HR maps
        # cached), the host's share and the device's busy share
        ev = [e for _, _, e in rec["steps"]]
        half = steps // 2
        app_ms = ev[half].elapsed_time(ev[-1]) / (steps - 1 - half)
        trainer = rec["trainers"][0]
        t0 = time.perf_counter()
        for hr, lr, labels in itertools.islice(
                trainer.train_data.batches(TRAIN_B), SR_HOST_BATCHES):
            trainer._host_batch(hr, lr, labels)
        host_ms = (time.perf_counter() - t0) * 1e3 / SR_HOST_BATCHES
        from torch.profiler import ProfilerActivity, profile
        feed = trainer.feed(trainer.train_data)
        fed = enumerate(feed)

        def steps(k: int) -> None:
            for bi, batch in itertools.islice(fed, k):
                batch["hr_map"] = trainer._hr_map(bi, batch)
                trainer.train_step(batch, trainer.generator)

        steps(2)                        # the workers start up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps(4)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        feed.close()
        busy = device_busy_ms(prof)
        ref = (f"; phase 6e's step on resident batches {step6_ms:.3f} ms, "
               f"the app's {app_ms / step6_ms:.2f}x" if step6_ms else "")
        print(f"phase 27a: app step (epoch 1, device timeline between step "
              f"starts) {app_ms:.3f} ms, {TRAIN_B * 1e3 / app_ms:.1f} img/s"
              f"{ref}; host read + decode + resize + collate + label "
              f"encode {host_ms:.3f} ms per batch of {TRAIN_B} "
              f"({SR_HOST_BATCHES} batches, one process); the app's "
              f"feed's steps 3-6 under the profiler: wall "
              f"{prof_wall:.3f} ms, kernels + copies {busy:.3f} ms, "
              f"device busy {100 * busy / prof_wall:.1f} % [{gpu}]")

        # the feed: the app's workers against the same host work in the
        # main thread and on a thread, in turns on the same trainer
        walls = sr_feed_turns(trainer)
        steady = {k: float(np.median([w[1] for w in v]))
                  for k, v in walls.items()}
        print(f"phase 27a: feed turns of {SR_FEED_STEPS} steps, wall ms "
              f"per step (all steps, after {SR_FEED_WARM}), each feed "
              f"twice: {trainer.num_workers} forked workers into the "
              f"prefetch thread (the app's) {walls['workers']}, main "
              f"thread {walls['main']}, one process's host work on the "
              f"prefetch thread {walls['thread']}; medians after "
              f"{SR_FEED_WARM} {steady}: the workers' "
              f"{steady['main'] / steady['workers']:.2f}x and the "
              f"thread's {steady['main'] / steady['thread']:.2f}x the main "
              f"thread's rate [{gpu}]")

        # (b) the same model and loss over LMDBDataset and MixLMDBDataset
        for name, ds in (("LMDBDataset (HR only)", LMDBDataset(
                             stores["hr_only"], voc_type="all")),
                         ("MixLMDBDataset (every other item HR only)",
                          MixLMDBDataset(stores["mix"], voc_type="all",
                                         seed=SEED))):
            sub = SRTrainer(trainer.model, trainer.loss_fn, ds, None,
                            batch_size=TRAIN_B, epochs=1,
                            eval_every=10 ** 9, seed=SEED)
            with recording(train_sr, "make_sr_train_step", SRTrainer,
                           train_counts) as r:
                sub.train_step = train_sr.make_sr_train_step(
                    sub.model, sub.loss_fn, sub.optimizer)
                sub.train()
                torch.cuda.synchronize()
            losses = finite_losses(r)
            print(f"phase 27b: SRTrainer over {name}: {len(losses)} steps, "
                  f"losses {[round(v, 4) for v in losses]}, launches per "
                  f"step {sorted({d for _, d, _ in r['steps']})} [{gpu}]")
            if len(losses) != 2 or {d for _, d, _ in r["steps"]} != {
                    want_step}:
                raise AssertionError(f"phase 27: {name} did not train")

        # (c) text_gestalt.main: TSRN + STN, stroke focus, 2 steps + eval
        cfg, _, _ = sr_app_config(tmp, "gestalt", [stores["small"]],
                                  [vals[0]], 1, 10 ** 9)
        gru = lambda: (fused_residual_layernorm.launches,
                       fgru.fused_bigru.launches)
        fused_residual_layernorm.launches = fgru.fused_bigru.launches = 0
        with recording(train_sr, "make_sr_train_step", SRTrainer,
                       gru) as rec:
            t0 = time.perf_counter()
            res = gestalt.main(["--config", cfg, "--arch", "tsrn", "--STN",
                                "--text_focus"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        total = gru()
        losses = finite_losses(rec)
        per_step = {d for _, d, _ in rec["steps"]}
        print(f"phase 27c: text_gestalt.main --arch tsrn --STN "
              f"--text_focus: {len(losses)} steps and "
              f"{len(rec['evals'])} evaluation in "
              f"{wall:.3f} s, losses {[round(v, 4) for v in losses]}; "
              f"launches (B2 in the stroke oracle, B8) per step "
              f"{sorted(per_step)} (expected [(3, 0)]: one oracle forward "
              f"on the SR image, cuDNN's GRU), app total {total} (expected "
              f"(12, 0): phase 21a's 6 of a live-map step, twice; B8 stays "
              f"off, as JAX's app leaves fused_gru off); evaluation {res} "
              f"[{gpu}]")
        if (len(losses) != 2 or per_step != {(3, 0)} or total != (12, 0)
                or len(rec["evals"]) != 1
                or not np.isfinite(res["psnr"])):
            raise AssertionError("phase 27: text_gestalt did not run the "
                                 "expected path")


def seg_app_photos(root: str, shapes, seed: int) -> None:
    """Seeded photo-sized images and TextSeg-coded annotations under
    root/img (JPEG q90, the port's `encode_jpeg`) and root/ann (PNG,
    `encode_png`): a background of 64-px tiles with noise sigma 8, dark
    bars as text (100 in the annotation), background 200, a 2-px ring of
    255 (ignore) around each bar. Unsourced: a photo's order of size."""
    rng = np.random.default_rng(seed)
    for d in ("img", "ann"):
        os.makedirs(os.path.join(root, d))
    for i, (w, h) in enumerate(shapes):
        tiles = rng.integers(70, 220, (h // 64 + 1, w // 64 + 1, 3))
        img = np.kron(tiles, np.ones((64, 64, 1)))[:h, :w]
        ann = np.full((h, w), 200, np.uint8)
        for _ in range(int(rng.integers(6, 16))):
            bh, bw = int(rng.integers(16, 80)), int(rng.integers(40, 300))
            y, x = int(rng.integers(2, h - bh - 2)), int(rng.integers(
                2, w - bw - 2))
            ann[y - 2:y + bh + 2, x - 2:x + bw + 2] = 255
            ann[y:y + bh, x:x + bw] = 100
            img[y:y + bh, x:x + bw] = rng.integers(0, 60, 3)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
        with open(os.path.join(root, "img", f"p{i:02d}.jpg"), "wb") as f:
            f.write(encode_jpeg(img.astype(np.uint8), 90))
        with open(os.path.join(root, "ann", f"p{i:02d}.png"), "wb") as f:
            f.write(encode_png(ann))


def phase28(dev, gpu: str, step16_ms=None) -> None:
    """The seg training journey through apps.seg.train, fed from a
    directory of JPEG photos and PNG annotations."""
    from fudanocr_tpu_torch.apps.seg import train as seg_app

    with tempfile.TemporaryDirectory(prefix="chip_smoke_seg_app_") as tmp:
        t0 = time.perf_counter()
        seg_app_photos(os.path.join(tmp, "train"), SEG_APP_SHAPES,
                       SEED + 28)
        seg_app_photos(os.path.join(tmp, "val"), SEG_APP_VAL_SHAPES,
                       SEED + 280)
        ckpt = os.path.join(tmp, "ckpt")
        print(f"phase 28: wrote {len(SEG_APP_SHAPES)} train photos (1024x768"
              f" and 768x1024) and {len(SEG_APP_VAL_SHAPES)} val photos, "
              f"JPEG q90 with TextSeg PNG annotations, in "
              f"{time.perf_counter() - t0:.2f} s [{gpu}]")

        def argv(iters: int) -> list:
            return [SEG_CONFIG, "--options",
                    f"data.img_dir={tmp}/train/img",
                    f"data.ann_dir={tmp}/train/ann",
                    f"data.val_img_dir={tmp}/val/img",
                    f"data.val_ann_dir={tmp}/val/ann",
                    f"schedule.total_iters={iters}",
                    f"schedule.eval_every={SEG_APP_ITERS}",
                    f"ckpt_dir={ckpt}"]

        torch.cuda.synchronize()
        reset_train_seg_counts()        # the journey's run, counted
        with recording(train_seg, "make_seg_train_step", SegTrainer,
                       train_seg_counts) as rec:
            t0 = time.perf_counter()
            res = seg_app.main(argv(SEG_APP_ITERS))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        losses = finite_losses(rec)
        per_step = {d for _, d, _ in rec["steps"]}
        want = TRAIN_RECIPES[0][1]
        saved = sorted(os.listdir(ckpt))
        print(f"phase 28: apps.seg.train on {SEG_CONFIG.split('/')[-1]} "
              f"(crop 512², batch 8, the full train pipeline; slide "
              f"evaluation at 1024² / 768²): {len(losses)} iterations in "
              f"{wall:.3f} s (the whole app), losses "
              f"{[round(v, 4) for v in losses]}; launches per step (B7 fwd, "
              f"B7 bwd, B6 fwd, B6 bwd) {sorted(per_step)} (expected "
              f"[{want}]); per evaluation "
              f"{[d for _, d in rec['evals']]}; final evaluation {res}; "
              f"checkpoints {saved} [{gpu}]")
        if (len(losses) != SEG_APP_ITERS or per_step != {want}
                or not all(d[0] > 0 for _, d in rec["evals"])
                or not {f"iter_{SEG_APP_ITERS}", "best"} <= set(saved)):
            raise AssertionError("phase 28: the app did not train, evaluate "
                                 "and checkpoint as configured")
        trainer = rec["trainers"][0]
        ev = [e for _, _, e in rec["steps"]]
        app_ms = ev[1].elapsed_time(ev[-1]) / (len(ev) - 2)
        random.seed(SEED)
        t0 = time.perf_counter()
        for i in range(SEG_HOST_SAMPLES):
            trainer.train_data[i]
        host_ms = (time.perf_counter() - t0) * 1e3 / SEG_HOST_SAMPLES

        # the run again with --auto-resume and 2 more iterations, profiled
        with recording(train_seg, "make_seg_train_step", SegTrainer,
                       train_seg_counts) as rec:
            rec["profile"] = {}
            seg_app.main(argv(SEG_APP_ITERS + SEG_APP_MORE)
                         + ["--auto-resume"])
        resumed = rec["trainers"][0]
        losses = finite_losses(rec)
        prof = rec["profile"]
        print(f"phase 28: --auto-resume with total_iters "
              f"{SEG_APP_ITERS + SEG_APP_MORE}: started at iteration "
              f"{resumed.start_iter} (expected {SEG_APP_ITERS}), took "
              f"{len(losses)} steps, losses {[round(v, 4) for v in losses]}"
              f" [{gpu}]")
        if resumed.start_iter != SEG_APP_ITERS or len(losses) != \
                SEG_APP_MORE:
            raise AssertionError("phase 28: --auto-resume did not continue "
                                 "from the saved iteration")
        ref = (f"; phase 16's step on resident batches {step16_ms:.3f} ms, "
               f"the app's {app_ms / step16_ms:.2f}x" if step16_ms else "")
        print(f"phase 28: app iteration (device timeline between step "
              f"starts, iterations 2-{SEG_APP_ITERS}) {app_ms:.3f} ms, "
              f"{trainer.batch_size * 1e3 / app_ms:.2f} img/s{ref}; host "
              f"pipeline (decode, resize, crop, flip, photometric, "
              f"normalise, pad) {host_ms:.3f} ms per sample over "
              f"{SEG_HOST_SAMPLES}, one process; the resumed run's "
              f"train() under the profiler: wall {prof['wall_ms']:.3f} ms, "
              f"kernels + copies {prof['busy_ms']:.3f} ms, device busy "
              f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f} % [{gpu}]")


# -- phases 29-30: the seg models in bf16 ------------------------------------

BF16 = torch.bfloat16
# the bf16 steps' attention calls (B, Lq, Lkv, D, heads, level side, sr,
# region-masked): the det recipe's four levels at batch 2 (B7 and B6), then
# the plain recipe's three kernel stages at batch 8 (B7)
STEP_ATTN_SHAPES = tuple(
    shape + (masked,) for shape in BWD_SHAPES[:4]
    for masked in (False, True)) + (
    (8, 16384, 256, 32, 1, 128, 8, False), (8, 4096, 256, 64, 2, 64, 4, False),
    (8, 1024, 256, 160, 5, 32, 2, False))


def bf16_segmentor(cfg, kernels: bool = True):
    """The config's segmentor with `dtype=torch.bfloat16` in its backbone
    and head, as the JAX package's bench_seg.py builds them, in eval mode
    on the CPU."""
    from fudanocr_tpu_torch.apps.seg.inference import (backbone_kwargs,
                                                       is_det_guided)
    from fudanocr_tpu_torch.models.seg import (CascadeMiT,
                                               CascadeMiTDetGuided,
                                               DetGuidedEncoderDecoder,
                                               EncoderDecoder, SegformerHead)

    kw = backbone_kwargs(cfg)
    det = is_det_guided(cfg)
    backbone = (CascadeMiTDetGuided if det else CascadeMiT)(
        **kw, kernels=kernels,
        drop_path_rate=cfg.model.backbone.get("drop_path_rate", 0.1),
        dtype=BF16)
    d, nh, h = kw["embed_dims"], kw["num_heads"], cfg.model.decode_head
    head = SegformerHead([d * n for n in (1,) + tuple(nh[1:])],
                         h.num_classes, h.channels,
                         h.get("dropout_ratio", 0.1), dtype=BF16)
    return (DetGuidedEncoderDecoder if det else EncoderDecoder)(
        backbone, head).eval()


def seg_twins(config: str, seed: int, dev) -> tuple:
    """(fp32 kernel-path segmentor, bf16 kernel path, bf16 plain path,
    config), one seeded set of weights with non-trivial BN and LN
    statistics, on `dev`."""
    fp, cfg = init_segmentor(config, device="cpu", seed=seed)
    randomize_stats(fp, torch.Generator().manual_seed(seed))
    twins = [bf16_segmentor(cfg, kernels) for kernels in (True, False)]
    for m in twins:
        m.load_state_dict(fp.state_dict())
    return (fp.to(dev), *(m.to(dev) for m in twins), cfg)


def attn_template_args(key: str) -> tuple:
    """(kernel name, template arguments) of a profiler kernel key."""
    key = re.sub(r"^void |\(anonymous namespace\)::", "", key)
    name = re.split(r"[<(]", key)[0]
    m = re.match(r"[^<(]*<([^>]*)>", key)
    args = tuple(a.strip() for a in m.group(1).split(",")) if m else ()
    return name, args


def bf16_step_launches(rows) -> dict:
    """Launches of the attention kernels in a profiled bf16 step, by role:
    csrc/unmasked_attention.cu's tensor-core STATS forward unmasked and
    MASKED (`attn_fwd_mma_kernel<DH, VEC16, MASKED, STATS=true>`), the
    backward's dq and dkv (`attn_bwd_{dq,dkv}_mma_kernel<DH, VEC16,
    MASKED>`, unmasked and MASKED) and the reduce; any other attention
    kernel (an inference forward, an fp32 or a CUDA-core one) under a role
    of its own, `other ...`."""
    out = {}
    for e in rows:
        name, args = attn_template_args(e.key)
        if not name.startswith("attn_"):
            continue
        if name == "attn_fwd_mma_kernel" and args[-1:] == ("true",):
            kind = "masked" if args[-2] == "true" else "plain"
            role = f"stats_fwd_{kind}"
        elif name in ("attn_bwd_dq_mma_kernel", "attn_bwd_dkv_mma_kernel"):
            kind = "masked" if args[-1] == "true" else "plain"
            role = f"{name[len('attn_bwd_'):-len('_mma_kernel')]}_{kind}"
        elif name == "attn_bwd_reduce_kernel" and "bfloat16" in args[0]:
            role = "reduce"
        else:
            role = f"other {name}<{', '.join(args)}>"
        out[role] = out.get(role, 0) + e.count
    return out


def bf16_step_recipe(config: str, want: tuple, dev, gpu: str) -> tuple:
    """Phase 29 for one recipe: the bf16 step against the bf16 plain step
    and the fp32 plain step, its launches (counters and profiler names),
    ms and img/s beside the fp32 kernel step; returns (launches, bf16 ms,
    fp32 ms)."""
    fp, model, plain, cfg = seg_twins(config, SEED + 29, dev)
    ref, _ = init_segmentor(config, device="cpu", kernels=False)
    ref = ref.to(dev)
    init = {k: v.clone() for k, v in fp.state_dict().items()}
    ref.load_state_dict(init)
    side, bs = cfg.data.crop_size[0], cfg.data.batch_size
    det = bool(cfg.model.get("det_guided", False))
    tag = f"{config.split('/')[-1]} ({side}², batch {bs})"
    batch = device_batch(next(SeededTextSeg(bs, side, SEED + 290, det)
                              .batches(bs)), dev)
    steps = [recipe_step(m, cfg)[1] for m in (model, plain, ref)]
    torch.backends.cudnn.deterministic = True
    torch.cuda.synchronize()
    reset_train_seg_counts()
    out = [steps[0](batch, torch.Generator(dev).manual_seed(7))]
    torch.cuda.synchronize()
    counts = train_seg_counts()
    out += [st(batch, torch.Generator(dev).manual_seed(7))
            for st in steps[1:]]
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    if not all(np.isfinite(v.item()) for v in out[0].values()):
        raise AssertionError(f"phase 29 {tag}: metrics are not finite")
    lk, lp, lr32 = (o["loss"].item() for o in out)
    r = bf16_step_bar(f"phase 29 {tag}", (lk, lp, lr32), (model, plain, ref))
    print(f"phase 29: {tag}: one bf16 train step, kernel path "
          f"{ {k: round(v.item(), 6) for k, v in out[0].items()} }; loss "
          f"plain bf16 {lp:.6f} (rel {r['loss_rel']:.3e}, bar "
          f"{BF16_STEP_LOSS_REL}), plain fp32 {lr32:.6f} (bf16 vs fp32 rel "
          f"{r['loss_bf16']:.3e}); gradients kernel vs plain bf16 "
          f"{r['grel']:.3e} norm-relative (bar {BF16_STEP_GRAD_REL} and the "
          f"plain bf16 step's distance from fp32, {r['grel16']:.3e}), worst "
          f"tensor {r['worst']:.3e} ({r['worst_name']}; plain bf16 vs fp32 "
          f"worst {r['worst16']:.3e}); launches (B7 fwd, B7 bwd, B6 fwd, "
          f"B6 bwd) {counts} (expected {want}) [{gpu}]")
    if counts != want:
        raise AssertionError(f"phase 29 {tag}: the bf16 step did not launch "
                             "the expected attention kernels")
    del ref, plain, steps, out
    torch.cuda.empty_cache()

    # launches by kernel name and the busy share of one profiled step; ms
    # and img/s beside the fp32 kernel-path step, in turns
    model.load_state_dict(init)
    fp.load_state_dict(init)
    _, step_k = recipe_step(model, cfg)
    _, step_f = recipe_step(fp, cfg)
    gk, gf = (torch.Generator(dev).manual_seed(9) for _ in range(2))
    rows, busy = profile_step(step_k, batch, gk, gpu, f"phase 29: {tag} bf16")
    by_role = bf16_step_launches(rows)
    attn_dev = sum(e.device_time_total for e in rows
                   if attn_template_args(e.key)[0].startswith("attn_")) / 1e3
    b7f, b7b, b6f, b6b = want
    want_roles = {"stats_fwd_plain": b7f, "dq_plain": b7b, "dkv_plain": b7b,
                  "reduce": b7b + b6b}
    if b6f:
        want_roles.update(stats_fwd_masked=b6f, dq_masked=b6b,
                          dkv_masked=b6b)
    print(f"phase 29: {tag}: bf16 launches per step by kernel (profiler "
          f"names of csrc/unmasked_attention.cu): {by_role} (expected "
          f"{want_roles}); attention {attn_dev:.3f} ms of {busy:.3f} ms "
          f"device time [{gpu}]")
    if by_role != want_roles:
        raise AssertionError(f"phase 29 {tag}: the profiled bf16 step ran "
                             f"{by_role}, want {want_roles}")
    rows_f, busy_f = profile_step(step_f, batch, gf, gpu,
                                  f"phase 29: {tag} fp32")
    k_ms, f_ms = in_turns(lambda: step_k(batch, gk),
                          lambda: step_f(batch, gf), 2)
    launches = [sum(e.count for e in r) for r in (rows, rows_f)]
    print(f"phase 29: {tag}: train step bf16 {k_ms:.3f} ms "
          f"({bs * 1e3 / k_ms:.2f} img/s, device {busy:.3f} ms in "
          f"{launches[0]} launches, busy {100 * busy / k_ms:.1f} % of the "
          f"unprofiled step), fp32 {f_ms:.3f} ms ({bs * 1e3 / f_ms:.2f} "
          f"img/s, device {busy_f:.3f} ms in {launches[1]} launches, busy "
          f"{100 * busy_f / f_ms:.1f} %), bf16 / fp32 {k_ms / f_ms:.3f} "
          f"[{gpu}]")
    del model, fp, batch
    torch.cuda.empty_cache()
    return counts, k_ms, f_ms


# the bf16 kernels against the CPU rounding model run on the card: the
# same rounding points, sums in another order (an fp32 sum can round a P
# or dS to the other bf16 neighbour); o32 carries p to ~16 bits
MODEL_O32_ATOL, MODEL_GRAD_REL = 1e-3, 2e-3


def bf16_ulps_over(got, want, floor: float) -> float:
    """The largest |got - want| over one bf16 ulp of `want` or `floor`,
    whichever is larger (both round to bf16: a differently ordered sum
    can land on the neighbouring value)."""
    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), e - 8)
    return ((got.float() - want.float()).abs()
            / ulp.clamp(min=floor)).max().item()


def model_check(name, q, k, v, ids, do, heads, stats_out, grads) -> str:
    """The bf16 STATS forward's (o, o32, m, inv) and the backward's
    (dq, dk, dv) against `bf16_attention_model` on the same inputs."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_attention_cases import bf16_attention_model

    o, o32, m, inv = stats_out
    mo, mo32, mm, minv, *mg = bf16_attention_model(q, k, v, heads, *ids,
                                                   do=do)
    o_ratio = bf16_ulps_over(o, mo, ATTN_ATOL[BF16] / 2)
    o32_err = (o32 - mo32).abs().max().item()
    stat_err = max((m - mm).abs().max().item(),
                   ((inv - minv).abs() / minv).max().item())
    rels = [rel_err(g, w) for g, w in zip(grads, mg)]
    note = (f"model: o {o_ratio:.3f} of an ulp or 1e-2, o32 max abs "
            f"{o32_err:.3e}, m and 1/l {stat_err:.3e}, dq/dk/dv rel "
            f"{rels[0]:.2e}/{rels[1]:.2e}/{rels[2]:.2e}")
    if (o_ratio > 1.0 or o32_err > MODEL_O32_ATOL or stat_err > 1e-4
            or max(rels) > MODEL_GRAD_REL):
        raise AssertionError(f"{name} bf16 disagrees with the rounding "
                             f"model: {note}")
    del mo, mo32, mg, mm, minv
    return note


def bf16_step_kernels(dev, gpu: str) -> dict:
    """B7 and B6 in bf16 at the bf16 steps' shapes, all on the tensor
    cores: the inference forward, the STATS forward and the backward, each
    against its plain twin and the rounding model, and beside SDPA in bf16
    (B6 with the float mask), with the bf16 bound (989 TFLOP/s) and the
    fp32 kernel's split-TF32 bound beside it."""
    gen = torch.Generator().manual_seed(SEED + 291)
    regions = blob_regions(dev)[1:]
    rows = {}
    for b, lq, lk, d, heads, side, sr, masked in STEP_ATTN_SHAPES:
        q, k, v = _attn_operands(gen, dev, BF16, b, lq, lk, d)
        dh = d // heads
        ids = mask = None
        if masked:
            ids = tuple(r.contiguous() for r in
                        region_vectors(regions, (side, side), sr))
            name = "region (B6)"
            kern = lambda: ra.region_flash_mha(q, k, v, *ids, heads)
            stats = lambda: ra.region_packed_fwd(q, k, v, *ids, heads,
                                                 stats=True)
            plain = lambda: ra.region_flash_mha_reference(q, k, v, *ids,
                                                          heads)
            mask = ra.region_mask(*ids)[:, None].to(BF16)
        else:
            name = "packed (B7)"
            kern = lambda: ra.packed_flash_mha(q, k, v, heads)
            stats = lambda: ra.unmasked_packed_fwd(q, k, v, heads,
                                                   stats=True)
            plain = lambda: ra.packed_flash_mha_reference(q, k, v, heads)
        want = plain()
        inf_o = kern()
        err = _attn_check(name, inf_o, want, BF16)
        stats_out = stats()
        err_s = _attn_check(f"{name} STATS", stats_out[0], want, BF16)
        # the STATS o is bf16(p) V / l, as the inference forward and the
        # plain twin round it; fully suppressed rows the mean of v
        if not torch.equal(stats_out[0], inf_o):
            raise AssertionError(f"{name} bf16: the STATS forward's o differs "
                                 "from the inference forward's")
        if masked:
            full = (ids[0][:, :, None] == ids[1][:, None, :]).all(-1)
            mean_v = v.float().mean(1, keepdim=True).expand(-1, lq, -1)
            full_err = (stats_out[0].float() - mean_v)[full].abs().max()
            if not full.any() or full_err.item() > ATTN_ATOL[BF16]:
                raise AssertionError(f"{name} bf16 STATS: fully suppressed "
                                     f"rows {int(full.sum())}, max err to "
                                     f"the mean of v {full_err.item()}")
            del full, mean_v
        del inf_o
        k_ms, p_ms = in_turns(kern, plain, 3)
        s_ms = cuda_ms(stats, 3)
        qh, kh, vh = (t.unflatten(-1, (heads, dh)).transpose(1, 2)
                      for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask)
        lib_ms = cuda_ms(sdpa, 3)
        extra = 4 * b * (lq + lk) if masked else 0
        bd = attn_bound(b, heads, lq, lk, dh, BF16, extra_bytes=extra)
        # the STATS forward also writes o32 and each row's max and 1/l
        bd_s = attn_bound(b, heads, lq, lk, dh, BF16,
                          extra_bytes=extra + 4 * b * lq * d
                          + 8 * b * heads * lq)
        bd32 = attn_bound(b, heads, lq, lk, dh, torch.float32,
                          extra_bytes=extra)
        bwd16, bwd32 = (bwd_bound(b, heads, lq, lk, dh, dt)
                        for dt in (BF16, torch.float32))
        print(f"phase 29: {name} forward q ({b}, {lq}, {d}), k/v ({b}, {lk},"
              f" {d}), {heads} heads, bf16: max abs err {err:.3e}, STATS "
              f"{err_s:.3e}; kernel {k_ms:.4f} ms, STATS forward "
              f"{s_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA "
              f"{'with the float mask ' if masked else ''}{lib_ms:.4f} ms, "
              f"{bound_note(bd)}, STATS {bound_note(bd_s)}; the fp32 "
              f"kernel's {bound_note(bd32)}; "
              f"backward {bound_note(bwd16)}, the fp32 kernel's "
              f"{bound_note(bwd32)} [{gpu}]")
        rows[("fwd", masked, lq, b)] = {
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **bd,
            "library_ms": lib_ms}
        rows[("stats", masked, lq, b)] = {
            "max_abs_err": err_s, "ms": s_ms, "plain_ms": p_ms, **bd_s,
            "library_ms": lib_ms}
        do = torch.randn(b, lq, d, generator=gen).to(dev, BF16)
        rows[("bwd", masked, lq, b)] = bwd_check(
            q, k, v, do, ids, heads, BF16, gpu, names=lq == 65536,
            phase="29")
        grads = (ra.region_packed_bwd(q, k, v, *ids, *stats_out[1:2], do,
                                      *stats_out[2:], heads) if masked
                 else ra.unmasked_packed_bwd(q, k, v, stats_out[1], do,
                                             *stats_out[2:], heads))
        note = model_check(name, q, k, v, ids or (None, None), do, heads,
                           stats_out, grads)
        print(f"phase 29: {name} q ({b}, {lq}, {d}), {heads} heads, bf16 "
              f"against the rounding model: {note} [{gpu}]")
        del q, k, v, do, qh, kh, vh, mask, want, stats_out, grads
        torch.cuda.empty_cache()
    return rows


def phase29(dev, gpu: str) -> dict:
    rows = bf16_step_kernels(dev, gpu)
    out = {}
    for config, want in TRAIN_RECIPES:
        out[config] = bf16_step_recipe(config, want, dev, gpu)
    lvl0 = lambda kind, masked: rows[(kind, masked, 65536, 2)]
    return {"launches": out[DET_CONFIG][0],
            "stats_plain": lvl0("stats", False),
            "stats_masked": lvl0("stats", True),
            "bwd_plain": lvl0("bwd", False), "bwd_masked": lvl0("bwd", True)}


def phase30(dev, gpu: str) -> dict:
    """bf16 seg inference: slide, whole image, det-guided slide and TTA
    through apps.seg.test, each against the bf16 plain path."""
    from fudanocr_tpu_torch.apps.seg import test as seg_test
    from fudanocr_tpu_torch.apps.seg.test import TTA_SCALES
    from fudanocr_tpu_torch.apps.seg.train import build_data
    from fudanocr_tpu_torch.core.config import (load_config,
                                                merge_cli_overrides)
    from fudanocr_tpu_torch.models.seg import slide_inference, tta_inference

    launches = {}
    fp, model, plain, _ = seg_twins(SEG_CONFIG, SEED + 30, dev)
    bars = dict(atol=SEG_BF16_ATOL, mean_bar=SEG_BF16_MEAN, what="bf16",
                ref32=fp)
    img = np.random.default_rng(SEED + 80).integers(0, 256, (1024, 2048, 3),
                                                    dtype=np.uint8)
    launches["slide"] = seg_run("30", model, plain, img, SEG_CROP,
                                SEG_STRIDE, (0, 8, 0), gpu, **bars)
    for (h, w), want in (((512, 1024), (0, 6, 2)),
                         ((2048, 2048), (0, 0, 8))):
        whole = np.random.default_rng(SEED + 90 + h).integers(
            0, 256, (h, w, 3), dtype=np.uint8)
        launches[(h, w)] = seg_run("30", model, plain, whole, None, None,
                                   want, gpu, **bars)
        torch.cuda.empty_cache()

    # apps.seg.test (fp32: the app has no dtype) on seeded photos, from a
    # checkpoint of these weights whose classifier bias centres the first
    # photo's median logit margin, so that both classes are predicted;
    # each metric against the kernels=False model's (init_segmentor on the
    # same checkpoint) through the app's own evaluation, with and without
    # TTA. Then tta_inference of the bf16 model over slide against the bf16
    # plain path on that photo
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seg_test_") as tmp:
        seg_app_photos(os.path.join(tmp, "val"), SEG_APP_VAL_SHAPES,
                       SEED + 300)
        opts = ["--options"] + [f"data.{k}={tmp}/val/{d}" for k, d in (
            ("img_dir", "img"), ("ann_dir", "ann"), ("val_img_dir", "img"),
            ("val_ann_dir", "ann"))]
        cfg = merge_cli_overrides(load_config(SEG_CONFIG), opts[1:])
        eval_data = build_data(cfg, train=False)
        x = torch.from_numpy(next(eval_data.batches(1))["img"]).to(dev)
        with torch.inference_mode():
            margin = fp(x).diff(dim=-1).median().item()
        sd = {k: v.clone() for k, v in fp.state_dict().items()}
        sd["decode_head.conv_seg.bias"][1] -= margin
        ckpt = os.path.join(tmp, "best")
        ckpt_lib.save(ckpt, {"state_dict": sd}, {"step": 0})
        plain32, _ = init_segmentor(SEG_CONFIG, device=dev, kernels=False,
                                    checkpoint=ckpt)
        with torch.inference_mode():
            share = plain32(x).argmax(-1).float().mean().item()
        argv = [SEG_CONFIG, "--checkpoint", ckpt] + opts
        torch.cuda.synchronize()
        reset_seg_counts()
        t0 = time.perf_counter()
        res_tta = seg_test.main(argv + ["--tta"])
        torch.cuda.synchronize()
        tta_s = time.perf_counter() - t0
        tta_counts = seg_counts()
        res = seg_test.main(argv)
        want_tta = seg_test.tta_metrics(plain32, eval_data, cfg)
        want = SegTrainer(plain32, eval_data, eval_data,
                          num_classes=cfg.model.decode_head.num_classes,
                          batch_size=cfg.data.batch_size, total_iters=1,
                          eval_every=10 ** 9).evaluate(0, save_best=False)
    del plain32
    keys = ("aAcc", "mIoU", "mDice", "mFscore")
    gap = max(abs(got[k] - ref[k]) for got, ref in ((res, want),
                                                    (res_tta, want_tta))
              for k in keys)
    tta_moves = max(abs(res_tta[k] - res[k]) for k in keys)
    print(f"phase 30: apps.seg.test --checkpoint over "
          f"{len(SEG_APP_VAL_SHAPES)} photos (fp32; text share {share:.4f} "
          f"on the first): {res}; with --tta (scales {TTA_SCALES} x flip, "
          f"each through slide): {res_tta} in {tta_s:.3f} s, launches (B6, "
          f"B7, B5) {tta_counts}; kernels=False: {want}, with TTA "
          f"{want_tta}; largest metric gap {gap:.3e} (bar "
          f"{SEG_METRIC_ATOL}), TTA moves a metric by {tta_moves:.3e} [{gpu}]")
    if not 0.3 < share < 0.7:
        raise AssertionError(f"phase 30: the app's weights predict text at "
                             f"{share:.4f} of the first photo")
    if any(set(r) != set(keys) or not all(0.0 <= v <= 1.0
                                          for v in r.values())
           for r in (res, res_tta)):
        raise AssertionError(f"phase 30: apps.seg.test gave {res}, {res_tta}")
    if gap > SEG_METRIC_ATOL or tta_moves <= SEG_METRIC_ATOL:
        raise AssertionError("phase 30: apps.seg.test on the kernel path "
                             "disagrees with kernels=False, or --tta changed "
                             "nothing")
    if tta_counts[1] == 0:
        raise AssertionError("phase 30: TTA ran no packed attention")

    def tta(m):
        with torch.inference_mode():
            return tta_inference(
                lambda t: slide_inference(m, t, SEG_CROP, SEG_STRIDE), x,
                TTA_SCALES)

    pk, pp = tta(model), tta(plain)
    err = (pk - pp).abs().max().item()
    sure = (top2_margin(pp[0]) > 2 * err).cpu()
    same = (pk.argmax(-1) == pp.argmax(-1))[0].cpu()
    k_ms, p_ms = in_turns(lambda: tta(model), lambda: tta(plain), 1)
    print(f"phase 30: tta_inference over slide, {tuple(x.shape[1:3])} photo, "
          f"bf16: probabilities vs kernels=False max abs err {err:.3e} (bar "
          f"{SEG_TTA_ATOL}); class maps equal at all {int(sure.sum())} "
          f"pixels whose top-2 margin exceeds {2 * err:.3e}: "
          f"{bool(same[sure].all())}; kernel path {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms [{gpu}]")
    if err > SEG_TTA_ATOL or not same[sure].all():
        raise AssertionError("phase 30: bf16 TTA disagrees with kernels=False")
    del fp, model, plain, x, pk, pp
    torch.cuda.empty_cache()

    # the det-guided model: slide on the 1024x2048 canvas
    fp, model, plain, _ = seg_twins(DET_CONFIG, SEED + 31, dev)
    det_img = np.random.default_rng(SEED + 110).integers(
        0, 256, (*DET_SLIDE_HW, 3), dtype=np.uint8)
    xd = normalized(det_img, dev)
    ch, cw, pos = crop_grid(*DET_SLIDE_HW, SEG_CROP, SEG_STRIDE)
    crops = torch.cat([xd[:, y:y + ch, c:c + cw] for y, c in pos])
    nontrivial_text_maps(model, plain, [crops], phase="30")
    if not torch.equal(det_maps(model, crops)[1], det_maps(plain, crops)[1]):
        raise AssertionError("phase 30: the bf16 instance maps of the kernel "
                             "and plain paths differ")
    del xd, crops
    launches["det_slide"] = seg_run("30", model, plain, det_img, SEG_CROP,
                                    SEG_STRIDE, DET_SLIDE_LAUNCHES, gpu,
                                    **dict(bars, ref32=fp))
    # every attention kernel of a bf16 det canvas is the tensor-core
    # forward (MASKED for the branches, unmasked for the stages)
    kernel_names("30", "bf16 det slide canvas", lambda: inference_segmentor(
        model, det_img, SEG_CROP, SEG_STRIDE, return_logits=True), BF16,
        "attn_", ["attn_fwd_mma_kernel"])
    del fp, model, plain
    torch.cuda.empty_cache()
    return launches


# phases 31-33: the CTR pillar through its entry points, at the JAX apps'
# default (published) widths on synthetic characters. B2 runs in every
# OCRDecoderLayer's three LayerNorms: 3 launches per decoder pass, at
# (B * max_len, d_model)
CTR_B = 32
CTR_SAMPLES = 128            # 4 steps an epoch; the test set one batch
CTR_LN = {"31": (CTR_B * 30, 1024), "32": (CTR_B * 48, 1024),
          "33": (CTR_B * 16, 512), "34": (CTR_B * 12, 1024)}
# each decoder pass runs over the whole (B, max_len + 1) token buffer
CTR_LN_DECODE = {k: (rows + CTR_B, d) for k, (rows, d) in CTR_LN.items()}
# decode step outputs (logits, or cosines against the gallery), kernel path
# against plain: about 10x the largest reading on the H100 (1.05e-5, PERF.md)
CTR_DECODE_ATOL = 1e-4
LN_NAME = "ln_residual_kernel"


def ctr_eval_batches() -> int:
    """Full batches of the apps' synthetic test set (a quarter of the
    training set, at least 8 samples)."""
    return max(CTR_SAMPLES // 4, 8) // CTR_B


def ctr_entry(phase: str, what: str, main, argv: list, want: int,
              gpu: str) -> tuple:
    """Run an app's `main(argv)` on the card with B2's counter from 0;
    fail unless it launched B2 `want` times and returned an accuracy.
    Returns (result, launches)."""
    torch.cuda.synchronize()
    fused_residual_layernorm.launches = 0
    t0 = time.perf_counter()
    res = main(argv)
    torch.cuda.synchronize()
    n = fused_residual_layernorm.launches
    print(f"phase {phase}: {what}: {res} in {time.perf_counter() - t0:.3f} "
          f"s, B2 launches {n} (expected {want}) [{gpu}]")
    if n != want or not 0.0 <= res["acc"] <= 1.0:
        raise AssertionError(f"phase {phase}: {what} did not run the "
                             "expected path")
    return res, n


def ctr_step_check(phase: str, what: str, step_k, step_p, model, plain,
                   batch: dict, gpu: str) -> int:
    """One train step of the kernel path against `kernels=False` from the
    same weights, batch and dropout generator (the training bar); returns
    the step's B2 launches."""
    from fudanocr_tpu_torch.train.seg import iteration_generator

    dev = batch["image"].device
    for (name, a), b in zip(model.state_dict().items(),
                            plain.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"phase {phase}: {name} differs at start")
    torch.cuda.synchronize()
    fused_residual_layernorm.launches = 0
    lk = step_k(batch, iteration_generator(SEED, 0, dev)).item()
    torch.cuda.synchronize()
    n = fused_residual_layernorm.launches
    lp = step_p(batch, iteration_generator(SEED, 0, dev)).item()
    loss_rel = abs(lk - lp) / abs(lp)
    worst, worst_name, zero = grads_agree(model, plain, f"phase {phase}")
    stats = max((a - b).abs().max().item() for (k, a), b in
                zip(model.named_buffers(), plain.buffers())
                if k.endswith(("running_mean", "running_var")))
    print(f"phase {phase}: one {what} step at batch {CTR_B}: kernel path "
          f"loss {lk:.6f}, plain {lp:.6f} (rel {loss_rel:.3e}, bar "
          f"{STEP_LOSS_REL}); per-tensor gradient rel err max {worst:.3e} "
          f"({worst_name}; bar {STEP_GRAD_REL}), {zero} zero-gradient "
          f"tensors equal; BN statistics max abs {stats:.3e} (bar 1e-5); "
          f"B2 launches {n} [{gpu}]")
    if (not np.isfinite(lk) or loss_rel > STEP_LOSS_REL
            or worst > STEP_GRAD_REL or stats > 1e-5):
        raise AssertionError(f"phase {phase}: the kernel path's step "
                             "disagrees with kernels=False")
    return n


def ctr_decode_check(phase: str, what: str, decode, model, plain,
                     x: torch.Tensor, gallery, gpu: str,
                     atol: float = CTR_DECODE_ATOL) -> int:
    """The kernel path's greedy decode against the plain path's: both
    paths' step outputs on the kernel path's token buffer within `atol`,
    and the ids equal up to each row's first difference, where the kernel
    path's top-2 margin is within twice the measured step-output distance.
    Returns B2's launches per decode."""
    torch.cuda.synchronize()
    fused_residual_layernorm.launches = 0
    ids_k = decode(model, x)
    torch.cuda.synchronize()
    n = fused_residual_layernorm.launches
    ids_p = decode(plain, x)
    buf = torch.cat([torch.zeros_like(ids_k[:, :1]), ids_k], 1)
    with torch.no_grad():
        sk, sp = (m.decode_step(m.encode(x), buf)[0][:, :-1].float()
                  for m in (model, plain))
    if gallery is not None:
        unit = lambda e: e / e.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        sk, sp = unit(sk) @ gallery.T, unit(sp) @ gallery.T
    err = (sk - sp).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"phase {phase}: {what} step outputs differ "
                             f"by {err} (bar {atol})")
    differ = (ids_k != ids_p).cpu()
    ties = 0
    for row in range(ids_k.shape[0]):
        cols = torch.nonzero(differ[row]).flatten()
        if cols.numel():
            top2 = sk[row, int(cols[0])].topk(2).values
            if (top2[0] - top2[1]).item() > 2 * err:
                raise AssertionError(f"phase {phase}: {what} ids differ at "
                                     f"row {row} with a clear margin")
            ties += 1
    print(f"phase {phase}: {what} greedy decode, {tuple(ids_k.shape)} ids: "
          f"step outputs max abs err {err:.3e} (bar {atol:.3e}); "
          f"rows equal to the plain path's {ids_k.shape[0] - ties}, the "
          f"rest split at a top-2 "
          f"margin within {2 * err:.3e}; B2 launches {n} [{gpu}]")
    return n


def profiled(fn, iters: int = 1) -> dict:
    """`profile_kernels(fn, iters)`, taken again (up to three times) when
    the trace holds no device event (late in a full run the profiler has
    returned such traces, in phases 22 and 31-33; PERF.md section 7)."""
    for _ in range(3):
        split = profile_kernels(fn, iters)
        if split:
            break
    return split


def profile_totals(fn) -> tuple:
    """(device ms, launches, B2 launches by kernel name) of one call of
    `fn` in a profiler trace."""
    split = profiled(fn)
    return (sum(ms for ms, _ in split.values()),
            sum(c for _, c in split.values()),
            {k: c for k, (_, c) in split.items() if k.startswith("ln_")})


def ctr_timings(phase: str, what: str, step_k, step_p, batch: dict,
                decode_k, decode_p, gpu: str) -> dict:
    """Step and decode ms of both paths in turns (CUDA events after a
    warm-up), and B2's launches by kernel name in a profiled step and
    decode."""
    from fudanocr_tpu_torch.train.seg import iteration_generator

    gen = iteration_generator(SEED, 1, batch["image"].device)
    k_ms, p_ms = in_turns(lambda: step_k(batch, gen),
                          lambda: step_p(batch, gen), 3)
    dk_ms, dp_ms = in_turns(decode_k, decode_p, 2)
    by_name, busy = {}, {}
    for key, fn in (("step", lambda: step_k(batch, gen)),
                    ("decode", decode_k)):
        split = profiled(fn)
        by_name[key] = {n: c for n, (_, c) in split.items()
                        if n.startswith("ln_")}
        busy[key] = sum(ms for ms, _ in split.values())
        top = sorted(split.items(), key=lambda kv: -kv[1][0])[:4]
        print(f"phase {phase}: {what} {key}: device {busy[key]:.3f} ms in "
              f"{sum(c for _, c in split.values()):.0f} launches; most: "
              + ", ".join(f"{n} {ms:.3f} ms x{c:.0f}" for n, (ms, c) in top)
              + f" [{gpu}]")
    print(f"phase {phase}: {what}: train step {k_ms:.3f} ms (plain "
          f"{p_ms:.3f}), {CTR_B * 1e3 / k_ms:.1f} img/s, busy "
          f"{100 * busy['step'] / k_ms:.1f} %; greedy decode {dk_ms:.3f} ms "
          f"per batch (plain {dp_ms:.3f}), busy "
          f"{100 * busy['decode'] / dk_ms:.1f} %; B2 by kernel name "
          f"{by_name} [{gpu}]")
    return {"step_ms": k_ms, "plain_step_ms": p_ms, "decode_ms": dk_ms,
            "plain_decode_ms": dp_ms, "step_device_ms": busy["step"],
            "decode_device_ms": busy["decode"], "b2_by_name": by_name}


def ctr_ln(phase: str, dev, gpu: str) -> tuple:
    """B2 against its plain version at the phase's training rows and at
    its decoder passes' rows."""
    gen = torch.Generator().manual_seed(SEED + int(phase))
    return tuple(ln_case(phase, *shapes[phase], torch.float32, gen, dev, gpu)
                 for shapes in (CTR_LN, CTR_LN_DECODE))


def ctr_report(phase: str, app: str, entry: int, per_step: int,
               per_decode: int, times: dict, ln: tuple, gpu: str) -> None:
    # the counters hold the launches; the trace names the kernel (and
    # counts it, unless the profiler drops events, as late in the process
    # it has: PERF.md section 7)
    for key, want in (("step", per_step), ("decode", per_decode)):
        got = times["b2_by_name"][key]
        if set(got) != {LN_NAME}:
            raise AssertionError(f"phase {phase}: the profiled {key} ran "
                                 f"{got}, want {want} x {LN_NAME}")
        if got[LN_NAME] != want:
            print(f"phase {phase}: the profiled {key} traced "
                  f"{got[LN_NAME]} of the counter's {want} B2 launches")
    print(json.dumps({"phase": int(phase), "app": app, "batch": CTR_B,
                      "entry_point_b2_launches": entry,
                      "b2_per_step": per_step, "b2_per_decode": per_decode,
                      **times, "b2_shape": list(CTR_LN[phase]),
                      "b2": ln[0],
                      "b2_decode_shape": list(CTR_LN_DECODE[phase]),
                      "b2_decode": ln[1], "card": gpu}))


def phase31(dev, gpu: str) -> tuple:
    """SLD in stroke mode: ResNet (3, 4, 6, 3) with the stem pool only,
    d_embed 512, d_model 1024, d_ff 2048, 32x32, batch 32, max_len 30,
    Adadelta lr 1.0; the confusable-matched evaluation."""
    from fudanocr_tpu_torch.apps.sld import train as sld
    from fudanocr_tpu_torch.core.config import merge_cli_overrides
    from fudanocr_tpu_torch.models.rec.ocr_transformer import greedy_decode

    opts = [f"batch={CTR_B}", f"synthetic_samples={CTR_SAMPLES}",
            "val_frequency=1000000"]
    steps, max_len = CTR_SAMPLES // CTR_B, sld.DEFAULT_CONFIG.max_len
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sld_") as tmp:
        _, entry = ctr_entry(
            "31", "apps.sld.train (stroke mode, 1 epoch, confusable-matched "
            "evaluation)", sld.main, ["--device", "cuda", "--options", *opts,
                                      f"ckpt_dir={tmp}/sld"],
            3 * steps + 3 * max_len * ctr_eval_batches(), gpu)
        if not os.path.isdir(f"{tmp}/sld/best"):
            raise AssertionError("phase 31: no best/ written")
    cfg = merge_cli_overrides(sld.DEFAULT_CONFIG, opts + ["ckpt_dir="])
    tk = sld.build_trainer(cfg, dev)
    tp = sld.build_trainer(cfg, dev, kernels=False)
    batch = tk.device_batch(*next(tk.train_data.batches(CTR_B)))
    per_step = ctr_step_check("31", "SLD", tk.train_step, tp.train_step,
                              tk.model, tp.model, batch, gpu)
    dec = lambda m, x: greedy_decode(m, x, max_len)
    x = batch["image"]
    per_decode = ctr_decode_check("31", "SLD", dec, tk.model, tp.model, x,
                                  None, gpu)
    times = ctr_timings("31", "SLD", tk.train_step, tp.train_step, batch,
                        lambda: dec(tk.model, x), lambda: dec(tp.model, x),
                        gpu)
    ln = ctr_ln("31", dev, gpu)
    ctr_report("31", "sld", entry, per_step, per_decode, times, ln, gpu)
    return entry, ln[0]


def phase32(dev, gpu: str) -> int:
    """CCR-CLIP: stage 1 (`pretrain`: ResNet-50 on 128x128, 12 text layers
    of width 512, 8 heads, embed 2048, context 30, batch 32), then stage 2
    (`train`: the image_ids encoder, out_dim 2048, 32x32, batch 32, max_len
    48, gallery decode) over stage 1's checkpoint."""
    from fudanocr_tpu_torch.apps.ccr_clip import pretrain
    from fudanocr_tpu_torch.apps.ccr_clip import train as ctr2
    from fudanocr_tpu_torch.core.config import merge_cli_overrides
    from fudanocr_tpu_torch.losses.clip_loss import first_occurrence_targets
    from fudanocr_tpu_torch.models.rec.ocr_transformer import \
        greedy_decode_gallery

    steps = CTR_SAMPLES // CTR_B
    opts = [f"batch={CTR_B}", f"synthetic_samples={CTR_SAMPLES}"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clip_") as tmp:
        ctr_entry("32", "apps.ccr_clip.pretrain (1 epoch, zero-shot "
                  "retrieval)", pretrain.main,
                  ["--device", "cuda", "--options", *opts,
                   f"ckpt_dir={tmp}/clip"], 0, gpu)
        s1 = pretrain.CLIPPretrainer(merge_cli_overrides(
            pretrain.DEFAULT_CONFIG, opts + ["ckpt_dir="]), dev)
        images, labels = next(s1.train_data.batches(CTR_B))
        im = torch.from_numpy(images).to(dev)
        text = s1.text_tokens(labels)
        tg = torch.from_numpy(first_occurrence_targets(labels)).to(dev)
        loss = s1.train_step(im, text, tg).item()
        tf = s1.charset_text_features().float()
        retrieve = lambda: (s1.model.encode_image(im).float() @ tf.T
                            ).argmax(1)
        s1_ms = cuda_ms(lambda: s1.train_step(im, text, tg), 3)
        with torch.no_grad():
            r_ms = cuda_ms(retrieve, 3)
        print(f"phase 32: CCR-CLIP stage 1 step at batch {CTR_B} "
              f"(128x128): loss {loss:.4f}, {s1_ms:.3f} ms, "
              f"{CTR_B * 1e3 / s1_ms:.1f} img/s; zero-shot retrieval "
              f"{r_ms:.3f} ms per batch [{gpu}]")
        if not np.isfinite(loss):
            raise AssertionError("phase 32: stage-1 loss not finite")
        del s1, im, text, tf
        torch.cuda.empty_cache()

        opts2 = opts + [f"radical_model={tmp}/clip/best",
                        "val_frequency=1000000"]
        max_len = ctr2.DEFAULT_CONFIG.max_len
        _, entry = ctr_entry(
            "32", "apps.ccr_clip.train (stage 2 over stage 1's best/, 1 "
            "epoch, gallery decode)", ctr2.main,
            ["--device", "cuda", "--options", *opts2,
             f"ckpt_dir={tmp}/ctr"],
            3 * steps + 3 * max_len * ctr_eval_batches(), gpu)
        if not os.path.isdir(f"{tmp}/ctr/best"):
            raise AssertionError("phase 32: no best/ written")
        cfg = merge_cli_overrides(ctr2.DEFAULT_CONFIG, opts2 + ["ckpt_dir="])
        tk, gallery = ctr2.build_trainer(cfg, dev)
        tp, gallery_p = ctr2.build_trainer(cfg, dev, kernels=False)
    if not torch.equal(gallery, gallery_p) or gallery.shape != (38, 2048):
        raise AssertionError("phase 32: the galleries differ")
    batch = tk.device_batch(*next(tk.train_data.batches(CTR_B)))
    per_step = ctr_step_check("32", "CCR-CLIP stage 2", tk.train_step,
                              tp.train_step, tk.model, tp.model, batch, gpu)
    dec = lambda m, x: greedy_decode_gallery(m, x, gallery, max_len)
    x = batch["image"]
    per_decode = ctr_decode_check("32", "CCR-CLIP stage 2", dec, tk.model,
                                  tp.model, x, gallery, gpu)
    times = ctr_timings("32", "CCR-CLIP stage 2", tk.train_step,
                        tp.train_step, batch, lambda: dec(tk.model, x),
                        lambda: dec(tp.model, x), gpu)
    ln = ctr_ln("32", dev, gpu)
    ctr_report("32", "ccr_clip", entry, per_step, per_decode,
               dict(times, stage1_step_ms=s1_ms, stage1_retrieval_ms=r_ms),
               ln, gpu)
    return entry


def phase33(dev, gpu: str) -> int:
    """OI-CTR: the oictr encoder (3, 4, 6), d_model 512, d_embed 256,
    32x128, batch 32, max_len 16; 11 epochs of 4 updates, across the SGDR
    restart at 10 epochs."""
    from fudanocr_tpu_torch.apps.oictr import train as oictr
    from fudanocr_tpu_torch.core.config import merge_cli_overrides
    from fudanocr_tpu_torch.models.rec.ocr_transformer import greedy_decode

    epochs, per_epoch = 11, CTR_SAMPLES // CTR_B
    opts = [f"batch={CTR_B}", f"synthetic_samples={CTR_SAMPLES}",
            f"epoch={epochs}", "val_frequency=1000000"]
    max_len = oictr.DEFAULT_CONFIG.max_len
    with tempfile.TemporaryDirectory(prefix="chip_smoke_oictr_") as tmp:
        _, entry = ctr_entry(
            "33", f"apps.oictr.train ({epochs} epochs of {per_epoch} "
            f"updates)", oictr.main, ["--device", "cuda", "--options", *opts,
                                      f"ckpt_dir={tmp}/oictr"],
            3 * epochs * per_epoch + 3 * max_len * ctr_eval_batches(), gpu)
        if not os.path.isdir(f"{tmp}/oictr/best"):
            raise AssertionError("phase 33: no best/ written")
    cfg = merge_cli_overrides(oictr.DEFAULT_CONFIG, opts + ["ckpt_dir="])
    tk = oictr.OICTRTrainer(cfg, dev)
    tp = oictr.OICTRTrainer(cfg, dev, kernels=False)
    sched, t0 = tk.optimizer.schedule, 10 * per_epoch
    print(f"phase 33: lr at updates {t0 - 1}, {t0}, {t0 + 1}: "
          f"{sched(t0 - 1):.3e}, {sched(t0):.3e}, {sched(t0 + 1):.3e}; "
          f"the run took {epochs * per_epoch} updates [{gpu}]")
    if not (tk.steps_per_epoch == per_epoch and sched(t0 - 1) < 0.01
            and sched(t0) == cfg.lr):
        raise AssertionError("phase 33: the run does not cross a restart")
    batch = tk.device_batch(*next(tk.train_data.batches(CTR_B)))
    per_step = ctr_step_check("33", "OI-CTR", tk.train_step, tp.train_step,
                              tk.model, tp.model, batch, gpu)
    dec = lambda m, x: greedy_decode(m, x, max_len)
    x = batch["image"]
    per_decode = ctr_decode_check("33", "OI-CTR", dec, tk.model, tp.model, x,
                                  None, gpu)
    times = ctr_timings("33", "OI-CTR", tk.train_step, tp.train_step, batch,
                        lambda: dec(tk.model, x), lambda: dec(tp.model, x),
                        gpu)
    ln = ctr_ln("33", dev, gpu)
    ctr_report("33", "oictr", entry, per_step, per_decode, times, ln, gpu)
    return entry


def phase34(dev, gpu: str) -> tuple:
    """ACPM: the ResNet encoder (3, 4, 6, 3) with the stem pool only,
    d_model 1024, 32x32, batch 32, max_len 12, Adadelta lr 1.0, the L1
    radical counter; 4 steps, then the profile-matching evaluation of one
    test batch (a test set of 128 // 4 = 32 samples). Then one step of the
    VGG and DenseNet encoders and of the STN with the CE counter, each
    against `kernels=False`."""
    from fudanocr_tpu_torch.apps.acpm import train as acpm
    from fudanocr_tpu_torch.core.config import merge_cli_overrides
    from fudanocr_tpu_torch.models.rec.ocr_transformer import greedy_decode

    opts = [f"batch={CTR_B}", f"synthetic_samples={CTR_SAMPLES}",
            "val_frequency=1000000"]
    steps, max_len = CTR_SAMPLES // CTR_B, acpm.DEFAULT_CONFIG.max_len
    with tempfile.TemporaryDirectory(prefix="chip_smoke_acpm_") as tmp:
        # B2 three times a training forward; an evaluation batch decodes
        # (max_len passes) and runs one forward on zero text for the
        # profile heads; the template encodings reach no decoder
        _, entry = ctr_entry(
            "34", "apps.acpm.train (1 epoch, profile-matching evaluation)",
            acpm.main, ["--device", "cuda", "--options", *opts,
                        f"ckpt_dir={tmp}/acpm"],
            3 * steps + (3 * max_len + 3) * ctr_eval_batches(), gpu)
        if not os.path.isdir(f"{tmp}/acpm/best"):
            raise AssertionError("phase 34: no best/ written")
    cfg = merge_cli_overrides(acpm.DEFAULT_CONFIG, opts + ["ckpt_dir="])
    tk = acpm.ACPMTrainer(cfg, dev)
    tp = acpm.ACPMTrainer(cfg, dev, kernels=False)
    host = next(tk.train_data.batches(CTR_B))
    batch = tk.device_batch(*host)
    per_step = ctr_step_check("34", "ACPM", tk.train_step, tp.train_step,
                              tk.model, tp.model, batch, gpu)
    dec = lambda m, x: greedy_decode(m, x, max_len)
    x = batch["image"]
    per_decode = ctr_decode_check("34", "ACPM", dec, tk.model, tp.model, x,
                                  None, gpu)
    times = ctr_timings("34", "ACPM", tk.train_step, tp.train_step, batch,
                        lambda: dec(tk.model, x), lambda: dec(tp.model, x),
                        gpu)
    del tk, tp
    torch.cuda.empty_cache()
    for extra in (["encoder=vgg"], ["encoder=densenet"],
                  ["stn=True", "rn_loss=CE"]):
        c = merge_cli_overrides(acpm.DEFAULT_CONFIG,
                                opts + extra + ["ckpt_dir="])
        ek, ep = acpm.ACPMTrainer(c, dev), acpm.ACPMTrainer(c, dev, False)
        n = ctr_step_check("34", f"ACPM ({', '.join(extra)})", ek.train_step,
                           ep.train_step, ek.model, ep.model,
                           ek.device_batch(*host), gpu)
        if n != per_step:
            raise AssertionError(f"phase 34: {extra} launched B2 {n} times "
                                 f"a step, not {per_step}")
        del ek, ep
        torch.cuda.empty_cache()
    ln = ctr_ln("34", dev, gpu)
    ctr_report("34", "acpm", entry, per_step, per_decode, times, ln, gpu)
    return entry


# phase 35: the bf16 CTR paths, JAX's benched configurations (bench_ctr.py:
# SLD in bf16 at batch 32; bench_clip.py: CCR-CLIP stage 1 in bf16 at batch
# 128). bf16 B2 is held against its plain version at every CTR row of
# phases 31-34, training and decoder passes
CLIP_BF16_B, CLIP_WARM_STEPS = 128, 30
CTR_LN_BF16 = sorted(set(CTR_LN.values()) | set(CTR_LN_DECODE.values()))


def grad_groups(model, other) -> dict:
    """By top-level module: (the norm-relative distance of `model`'s
    gradients from `other`'s, all together, and their scale along
    `other`'s, <g, f> / <f, f>)."""
    sums = {}
    for (name, pk), pp in zip(model.named_parameters(), other.parameters()):
        g, f = pk.grad.double(), pp.grad.double()
        acc = sums.setdefault(name.split(".")[0], [0.0, 0.0, 0.0])
        acc[0] += ((g - f) ** 2).sum().item()
        acc[1] += (g * f).sum().item()
        acc[2] += (f ** 2).sum().item()
    return {k: (round((d / max(ff, 1e-60)) ** 0.5, 4),
                round(gf / max(ff, 1e-60), 4))
            for k, (d, gf, ff) in sums.items()}


def phase35(dev, gpu: str) -> tuple:
    """SLD (phase 31's model and batch) in bf16: one step and one greedy
    decode against `kernels=False`, step and decode ms beside fp32's in
    turns; CCR-CLIP stage 1 (phase 32's model) at batch 128 in bf16 beside
    fp32 in turns; bf16 B2 against its plain version at every CTR row."""
    from fudanocr_tpu_torch.apps.ccr_clip import pretrain
    from fudanocr_tpu_torch.apps.sld import train as sld
    from fudanocr_tpu_torch.apps.sr_common import seeded
    from fudanocr_tpu_torch.core.config import merge_cli_overrides
    from fudanocr_tpu_torch.losses.clip_loss import first_occurrence_targets
    from fudanocr_tpu_torch.models.rec.ccr_clip import CCRCLIP
    from fudanocr_tpu_torch.models.rec.ocr_transformer import greedy_decode
    from fudanocr_tpu_torch.train.ctr import make_ctr_train_step
    from fudanocr_tpu_torch.train.seg import iteration_generator
    from fudanocr_tpu_torch.train.state import clip_adam, ctr_adadelta

    bf, f32 = torch.bfloat16, torch.float32
    gen_of = lambda: iteration_generator(SEED, 0, dev)
    cfg = merge_cli_overrides(sld.DEFAULT_CONFIG, [
        f"batch={CTR_B}", f"synthetic_samples={CTR_SAMPLES}", "ckpt_dir="])
    codec, _, train_data, _ = sld.build_codec_and_data(cfg)
    # (bf16 kernel path, bf16 plain, fp32 plain, fp32 kernel path)
    models = [sld.build_model(cfg, codec.num_classes, dev, k, dt)
              for k, dt in ((True, bf), (False, bf), (False, f32),
                            (True, f32))]
    steps = [make_ctr_train_step(m, ctr_adadelta(m.parameters(), cfg.lr))
             for m in models]
    images, labels = next(train_data.batches(CTR_B))
    ti, tg, ln = codec.encode(labels, cfg.max_len)
    put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    batch = {"image": put(images), "text_input": put(ti).long(),
             "text_gt": put(tg).long(), "lengths": put(ln)}
    x = batch["image"]
    dec = lambda m: greedy_decode(m, x, cfg.max_len)
    # the decode bar: twice the plain path's own bf16 distance from fp32 in
    # the step outputs on the fp32 plain path's token buffer
    buf = torch.cat([torch.zeros_like(x[:, 0, 0, :1], dtype=torch.long),
                     dec(models[2])], 1)
    with torch.no_grad():
        s16, s32 = (m.decode_step(m.encode(x), buf)[0][:, :-1].float()
                    for m in (models[1], models[2]))
    atol = 2 * (s16 - s32).abs().max().item()
    per_decode = ctr_decode_check("35", "bf16 SLD", lambda m, _: dec(m),
                                  models[0], models[1], x, None, gpu, atol)
    torch.cuda.synchronize()
    fused_residual_layernorm.launches = 0
    lk = steps[0](batch, gen_of()).item()
    torch.cuda.synchronize()
    per_step = fused_residual_layernorm.launches
    lp, l32 = (st(batch, gen_of()).item() for st in steps[1:3])
    r = bf16_step_bar("phase 35 SLD", (lk, lp, l32), models[:3])
    print(f"phase 35: one bf16 SLD step: loss kernel path {lk:.6f}, plain "
          f"{lp:.6f} (rel {r['loss_rel']:.3e}, bar {BF16_STEP_LOSS_REL}), "
          f"fp32 plain {l32:.6f}; gradients kernel vs plain {r['grel']:.3e} "
          f"norm-relative (bar {BF16_STEP_GRAD_REL} and the plain bf16 "
          f"step's distance from fp32, {r['grel16']:.3e}), worst tensor "
          f"{r['worst']:.3e} ({r['worst_name']}); B2 launches {per_step} "
          f"[{gpu}]")
    gen = iteration_generator(SEED, 1, dev)
    s_ms = in_turns(lambda: steps[0](batch, gen), lambda: steps[3](batch, gen),
                    3)
    d_ms = in_turns(lambda: dec(models[0]), lambda: dec(models[3]), 2)
    prof = {"step": [profile_totals(lambda: st(batch, gen)) for st in
                     (steps[0], steps[3])],
            "decode": [profile_totals(lambda: dec(m)) for m in
                       (models[0], models[3])]}
    for key, want in (("step", per_step), ("decode", per_decode)):
        got = prof[key][0][2]
        if set(got) != {LN_NAME}:
            raise AssertionError(f"phase 35: the profiled bf16 {key} ran "
                                 f"{got}, want {want} x {LN_NAME}")
    sld_row = {"step_ms": s_ms, "decode_ms": d_ms,
               "step_device_ms": [p[0] for p in prof["step"]],
               "decode_device_ms": [p[0] for p in prof["decode"]],
               "step_launches": [p[1] for p in prof["step"]],
               "decode_launches": [p[1] for p in prof["decode"]]}
    print(f"phase 35: SLD train step bf16 {s_ms[0]:.3f} ms, fp32 "
          f"{s_ms[1]:.3f} ms ({CTR_B * 1e3 / s_ms[0]:.1f} / "
          f"{CTR_B * 1e3 / s_ms[1]:.1f} img/s), device "
          f"{sld_row['step_device_ms'][0]:.3f} / "
          f"{sld_row['step_device_ms'][1]:.3f} ms in "
          f"{sld_row['step_launches'][0]:.0f} / "
          f"{sld_row['step_launches'][1]:.0f} launches, busy "
          f"{100 * sld_row['step_device_ms'][0] / s_ms[0]:.1f} / "
          f"{100 * sld_row['step_device_ms'][1] / s_ms[1]:.1f} %; greedy "
          f"decode bf16 {d_ms[0]:.3f} ms, fp32 {d_ms[1]:.3f} ms, device "
          f"{sld_row['decode_device_ms'][0]:.3f} / "
          f"{sld_row['decode_device_ms'][1]:.3f} ms, busy "
          f"{100 * sld_row['decode_device_ms'][0] / d_ms[0]:.1f} / "
          f"{100 * sld_row['decode_device_ms'][1] / d_ms[1]:.1f} % [{gpu}]")
    launches = per_step + per_decode
    del models, steps
    torch.cuda.empty_cache()

    # CCR-CLIP stage 1 at batch 128 (bench_clip.py): the towers reach no
    # kernel, so the bf16 step is held to the fp32 step's loss
    pcfg = merge_cli_overrides(pretrain.DEFAULT_CONFIG, [
        f"batch={CLIP_BF16_B}", f"synthetic_samples={CLIP_BF16_B}",
        "ckpt_dir="])
    s1 = pretrain.CLIPPretrainer(pcfg, dev)
    images, labels = next(s1.train_data.batches(CLIP_BF16_B))
    cbatch = (put(images), s1.text_tokens(labels),
              put(first_occurrence_targets(labels)))
    clip = [seeded(lambda: CCRCLIP(
        vocab_size=s1.codec.num_classes, context_length=pcfg.max_len,
        transformer_layers=pcfg.transformer_layers, dtype=dt), 0, dev)
        for dt in (bf, None)]
    csteps = [pretrain.make_clip_train_step(m, clip_adam(
        m.parameters(), lambda count: pcfg.lr)) for m in clip]
    c16, c32 = (st(*cbatch).item() for st in csteps)
    grel16, worst16, worst16_name = grad_distance(clip[0], clip[1])
    groups = grad_groups(clip[0], clip[1])
    # the same readings once the towers have left random init (no bar:
    # the towers reach no kernel): the fp32 model takes CLIP_WARM_STEPS
    # steps on the batch, the bf16 model its weights, then one step each
    for _ in range(CLIP_WARM_STEPS):
        warm32 = csteps[1](*cbatch).item()
    clip[0].load_state_dict(clip[1].state_dict())
    w16, w32 = (st(*cbatch).item() for st in csteps)
    warm = {"steps": CLIP_WARM_STEPS, "loss_before": warm32,
            "loss_bf16": w16, "loss_fp32": w32,
            "grad_rel_to_fp32": grad_distance(clip[0], clip[1])[0],
            "by_group": grad_groups(clip[0], clip[1])}
    c_ms = in_turns(lambda: csteps[0](*cbatch), lambda: csteps[1](*cbatch),
                    3)
    cprof = [profile_totals(lambda: st(*cbatch)) for st in csteps]
    print(f"phase 35: CCR-CLIP stage 1 step at batch {CLIP_BF16_B} "
          f"(128x128): loss bf16 {c16:.6f}, fp32 {c32:.6f} (rel "
          f"{abs(c16 - c32) / abs(c32):.3e}, bar {BF16_STEP_LOSS_REL}); "
          f"gradients bf16 vs fp32 {grel16:.3e} norm-relative, worst tensor "
          f"{worst16:.3e} ({worst16_name}), by group (distance, scale "
          f"along fp32) {groups}; after {CLIP_WARM_STEPS} fp32 steps (loss "
          f"{warm32:.6f}): loss bf16 {w16:.6f}, fp32 {w32:.6f}, gradients "
          f"{warm['grad_rel_to_fp32']:.3e}, by group {warm['by_group']}; "
          f"step bf16 {c_ms[0]:.3f} ms, fp32 "
          f"{c_ms[1]:.3f} ms ({CLIP_BF16_B * 1e3 / c_ms[0]:.1f} / "
          f"{CLIP_BF16_B * 1e3 / c_ms[1]:.1f} img/s), device "
          f"{cprof[0][0]:.3f} / {cprof[1][0]:.3f} ms in {cprof[0][1]:.0f} / "
          f"{cprof[1][1]:.0f} launches, busy "
          f"{100 * cprof[0][0] / c_ms[0]:.1f} / "
          f"{100 * cprof[1][0] / c_ms[1]:.1f} % [{gpu}]")
    if (not np.isfinite(c16)
            or abs(c16 - c32) / abs(c32) > BF16_STEP_LOSS_REL):
        raise AssertionError("phase 35: the bf16 stage-1 step's loss is off "
                             "the fp32 step's")
    del s1, clip, csteps
    torch.cuda.empty_cache()

    gen_ln = torch.Generator().manual_seed(SEED + 35)
    ln = {shape: ln_case("35", *shape, bf, gen_ln, dev, gpu)
          for shape in CTR_LN_BF16}
    print(json.dumps({
        "phase": 35, "sld_bf16": {"batch": CTR_B, **sld_row,
                                  "b2_per_step": per_step,
                                  "b2_per_decode": per_decode},
        "clip_stage1_bf16": {"batch": CLIP_BF16_B, "step_ms": c_ms,
                             "step_device_ms": [p[0] for p in cprof],
                             "grad_rel_to_fp32": grel16,
                             "by_group": groups, "warm": warm},
        "b2_bf16": {f"{r}x{d}": v for (r, d), v in ln.items()},
        "card": gpu}))
    return launches, ln[CTR_LN["31"]]


# -- phase 36: checkpoint interchange with the JAX package's format

# (c): the plain seg recipe's trainer, checkpoints every 2 iterations
CKPT_SEG_ITERS = 2


def timed_ms(fn) -> tuple:
    """(fn(), wall ms), the card drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def ckpt_sizes(path: str) -> dict:
    """{file: bytes} of a checkpoint directory."""
    return {f: os.path.getsize(os.path.join(path, f))
            for f in sorted(os.listdir(path))}


def jax_only(src: str, dst: str) -> str:
    """A copy of checkpoint `src` as the JAX package writes one:
    state.msgpack and meta.json, no state.pt."""
    os.makedirs(dst)
    for name in (ckpt_lib.JAX_STATE, "meta.json"):
        shutil.copy(os.path.join(src, name), dst)
    return dst


def rewrites_bytes(path: str) -> bool:
    """state.msgpack read and written back by the port is the same bytes."""
    with open(os.path.join(path, ckpt_lib.JAX_STATE), "rb") as f:
        raw = f.read()
    return serialization.to_bytes(serialization.from_bytes(raw)) == raw


def phase36a(dev, gpu: str, tmp: str) -> dict:
    """Phase 2's TBSRN (bf16, batch 256) serves a batch, is saved as best/
    in JAX's format, and that checkpoint is loaded into the same warm
    module (after a perturbed load it has served with, so that operands
    cached from other weights would show) and into a fresh one:
    pixels -> strings through B1 bit-equal to the source's."""
    sr, _, crnn, gen = ocr_models(dev)
    conv = CTCLabelConverter(ALPHABET)
    pipe = PixelsToStrings(sr, crnn, conv, device=dev)
    lr = torch.rand(BATCH, *LR_HW, 3, generator=gen).to(dev)
    pipe.ids_fn(lr)                         # warm: B1's operands cached
    texts, out = pipe(lr, return_sr=True)
    best = os.path.join(tmp, "tbsrn", "best")
    _, save_ms = timed_ms(lambda: ckpt_lib.save_jax(
        best, jax_variables(sr), {"step": 0}))
    same_bytes = rewrites_bytes(best)

    perturbed = {k: v + 0.05 * torch.randn(v.shape, generator=gen).to(v)
                 if v.is_floating_point() and k.endswith("weight") else v
                 for k, v in sr.state_dict().items()}
    sr.load_state_dict(perturbed)
    _, out_p = pipe(lr, return_sr=True)
    sd, load_ms = timed_ms(lambda: ckpt_lib.load_model_state(best,
                                                             module=sr))
    sr.load_state_dict(sd)
    torch.cuda.synchronize()
    fused_enhancer.launches = 0
    texts_w, out_w = pipe(lr, return_sr=True)
    torch.cuda.synchronize()
    n_warm = fused_enhancer.launches

    torch.manual_seed(SEED + 36)            # other weights than the source
    fresh = TBSRN(scale_factor=2, width=128, height=32, stn=True,
                  srb_nums=SRB_NUMS, hidden_units=32,
                  dtype=torch.bfloat16).to(dev).eval()
    fresh.load_state_dict(ckpt_lib.load_model_state(best, module=fresh))
    pipe_f = PixelsToStrings(fresh, crnn, conv, device=dev)
    torch.cuda.synchronize()
    fused_enhancer.launches = 0
    texts_f, out_f = pipe_f(lr, return_sr=True)
    torch.cuda.synchronize()
    n_fresh = fused_enhancer.launches
    sizes = ckpt_sizes(best)
    ok = (torch.equal(out_w, out) and torch.equal(out_f, out)
          and texts_w == texts == texts_f)
    print(f"phase 36a: TBSRN (5 SRBs, STN, bf16) best/ in JAX's format: "
          f"{sizes} bytes, saved in {save_ms:.3f} ms, read through the "
          f"porter in {load_ms:.3f} ms; read and written back byte-equal: "
          f"{same_bytes}; after a perturbed load the warm module served "
          f"other SR output: {not torch.equal(out_p, out)}; pixels -> "
          f"strings at batch {BATCH} of the source, the warm module and a "
          f"fresh one bit-equal (SR output and strings): {ok}; B1 launches "
          f"{n_warm} (warm), {n_fresh} (fresh), expected {2 * SRB_NUMS} "
          f"[{gpu}]")
    if not (same_bytes and ok and not torch.equal(out_p, out)
            and n_warm == n_fresh == 2 * SRB_NUMS):
        raise AssertionError("phase 36a: the JAX-format TBSRN checkpoint "
                             "does not serve as its source")
    return {"tbsrn_best": {"bytes": sizes, "save_ms": save_ms,
                           "load_ms": load_ms}}


def phase36b(dev, gpu: str, tmp: str) -> dict:
    """scene_text_telescope.main --text_focus, 2 steps, resumed (--resume
    auto) from a best/ holding only state.msgpack, three times: with the
    seeded oracle, with an oracle of other (perturbed) weights in memory,
    and with those weights read from a JAX-format
    TRAIN.VAL.oracle_checkpoint. The first step's loss of the last two is
    bit-equal and differs from the seeded oracle's, so the checkpoint was
    read; the SR weights each run starts training from are bit-equal to
    the resumed best/'s source."""
    from fudanocr_tpu_torch.apps import sr_common
    from fudanocr_tpu_torch.apps.scene_text_telescope import main as stt

    build_oracle = sr_common.build_oracle
    gen = torch.Generator().manual_seed(SEED + 362)
    other = {k: v + 0.05 * torch.randn(v.shape, generator=gen).to(v)
             if v.is_floating_point() and k.endswith("weight") else v
             for k, v in build_oracle(sr_common.DEFAULTS, LOSS_VOCAB,
                                      "cpu").state_dict().items()}

    def other_oracle(cfg, vocab, device):
        oracle = build_oracle(cfg, vocab, device)
        oracle.load_state_dict(other)
        return oracle

    held = other_oracle(sr_common.DEFAULTS, LOSS_VOCAB, "cpu")
    oracle_dir = os.path.join(tmp, "oracle")
    _, oracle_save_ms = timed_ms(lambda: ckpt_lib.save_jax(
        oracle_dir, jax_variables(held), {"step": 0}))
    source = sr_common.seeded(lambda: TBSRN(stn=True, srb_nums=SRB_NUMS),
                              SEED + 361, "cpu")
    runs, started = {}, {}
    train = SRTrainer.train
    for name, extra, oracle_fn in (
            ("seeded", [], build_oracle),
            ("in_memory", [], other_oracle),
            ("from_checkpoint",
             [f"TRAIN.VAL.oracle_checkpoint={oracle_dir}"], build_oracle)):
        cfg, ckpt, _ = sr_app_config(tmp, f"stt_{name}", [], [], 1, 10 ** 6)
        ckpt_lib.save_jax(os.path.join(ckpt, "best"), jax_variables(source),
                          {"step": 0})
        argv = ["--config", cfg, "--arch", "tbsrn", "--STN", "--text_focus",
                "--resume", "auto", "--device", str(dev), "--options",
                f"TRAIN.synthetic_samples={2 * TRAIN_B}", *extra]
        torch.cuda.synchronize()
        reset_counts()
        with recording(train_sr, "make_sr_train_step", SRTrainer,
                       train_counts) as rec:
            recorded = SRTrainer.train

            def snapshot_train(self, *args, _name=name, **kw):
                started[_name] = {k: v.detach().cpu().clone() for k, v in
                                  self.model.state_dict().items()}
                return recorded(self, *args, **kw)

            SRTrainer.train = snapshot_train
            sr_common.build_oracle = oracle_fn
            try:
                _, wall = timed_ms(lambda: stt.main(argv))
            finally:
                SRTrainer.train = recorded
                sr_common.build_oracle = build_oracle
        runs[name] = (finite_losses(rec), [d for _, d, _ in rec["steps"]],
                      train_counts(), wall)
    assert SRTrainer.train is train
    want = source.state_dict()
    resumed = {name: all(torch.equal(sd[k], want[k]) for k in want
                         if not k.endswith("num_batches_tracked"))
               for name, sd in started.items()}
    (l_seed, _, _, _), (l_mem, d_mem, _, _), (l_ckpt, d_ckpt, total, wall) = (
        runs["seeded"], runs["in_memory"], runs["from_checkpoint"])
    b4 = [(d[1], d[2]) for d in d_mem + d_ckpt]
    print(f"phase 36b: scene_text_telescope.main --text_focus --resume auto "
          f"from a best/ holding only state.msgpack, {len(l_ckpt)} steps at "
          f"batch {TRAIN_B}: first losses with the seeded oracle "
          f"{l_seed[0]!r}, with other oracle weights in memory {l_mem[0]!r}, "
          f"with those read from a JAX-format oracle_checkpoint "
          f"({ckpt_sizes(oracle_dir)} bytes, saved in "
          f"{oracle_save_ms:.3f} ms) {l_ckpt[0]!r}: the last two bit-equal "
          f"{l_mem[0] == l_ckpt[0]}, all losses equal {l_mem == l_ckpt}, the "
          f"seeded oracle's differs {l_seed[0] != l_ckpt[0]}; SR weights at "
          f"the first step bit-equal to the resumed best/'s source "
          f"{resumed}; B4 launches per step (fwd, bwd) {b4} (expected "
          f"({SRB_NUMS}, {SRB_NUMS})); the app's B2 launches {total[0]}; "
          f"{wall:.1f} ms the whole app [{gpu}]")
    if (len(l_ckpt) != 2 or l_mem[0] != l_ckpt[0] or l_seed[0] == l_ckpt[0]
            or len(resumed) != 3 or not all(resumed.values())
            or set(b4) != {(SRB_NUMS, SRB_NUMS)} or total[0] == 0):
        raise AssertionError("phase 36b: the app resumed from JAX-format "
                             "checkpoints does not train as from memory")
    return {"oracle": {"bytes": ckpt_sizes(oracle_dir),
                       "save_ms": oracle_save_ms},
            "text_focus_first_loss": l_ckpt[0]}


def opt_states_equal(a: SegTrainer, b: SegTrainer) -> bool:
    """Adam's step, exp_avg and exp_avg_sq of every parameter bit-equal
    (a step read from state.pt sits on the card, a new one on the host)."""
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    return all(torch.equal(a.optimizer.adam.state[pa[n]][k].cpu(),
                           b.optimizer.adam.state[pb[n]][k].cpu())
               for n in pa for k in ("step", "exp_avg", "exp_avg_sq"))


def phase36c(dev, gpu: str, tmp: str) -> dict:
    """The plain seg recipe (512², batch 8): iter_2/ written by SegTrainer,
    resumed from a copy holding only state.msgpack and from state.pt, the
    restored state bit-equal, one resumed step each (B7); apps.seg.test
    --checkpoint on a best/ holding only state.msgpack against its
    state.pt twin."""
    from fudanocr_tpu_torch.apps.seg import test as seg_test

    def trainer(seed: int, ckpt_dir=None):
        model, cfg = init_segmentor(SEG_CONFIG, device=dev, seed=seed)
        side, bs = cfg.data.crop_size[0], cfg.data.batch_size
        kw = {**trainer_kwargs(cfg), "eval_every": 10 ** 9}
        return SegTrainer(model, SeededTextSeg(2 * bs, side, SEED + 362,
                                               False),
                          SeededTextSeg(bs, side, SEED + 363, False),
                          ckpt_dir=ckpt_dir, ckpt_every=CKPT_SEG_ITERS,
                          **kw), side, bs

    src, side, bs = trainer(SEED + 36, os.path.join(tmp, "seg"))
    randomize_stats(src.model, torch.Generator().manual_seed(SEED + 36))
    src.train(stop_after=CKPT_SEG_ITERS)
    it_dir = os.path.join(tmp, "seg", f"iter_{CKPT_SEG_ITERS}")
    _, pt_ms = timed_ms(lambda: ckpt_lib.save(
        os.path.join(tmp, "pt_only"), src._payload()))
    _, jax_ms = timed_ms(lambda: ckpt_lib.save_jax(
        os.path.join(tmp, "jax_only"), src._jax_tree(opt_state=True)))
    sizes = ckpt_sizes(it_dir)
    msg = jax_only(it_dir, os.path.join(tmp, "seg_jax", "iter_2"))
    resumed = {}
    for name, path in (("state.msgpack", msg), ("state.pt", it_dir)):
        t, _, _ = trainer(SEED + 364)
        _, ms = timed_ms(lambda: t.resume(path))
        resumed[name] = (t, ms)
    (tj, jms), (tp, pms) = resumed["state.msgpack"], resumed["state.pt"]
    sd_j, sd_p = tj.model.state_dict(), tp.model.state_dict()
    weights_equal = all(torch.equal(sd_j[k], v) for k, v in sd_p.items()
                        if not k.endswith("num_batches_tracked"))
    state_equal = (opt_states_equal(tj, tp)
                   and tj.optimizer.count == tp.optimizer.count
                   == CKPT_SEG_ITERS and tj.start_iter == tp.start_iter)

    batch = device_batch(next(src.train_data.batches(bs)), dev)
    losses, launches = [], []
    torch.backends.cudnn.deterministic = True
    for t in (tj, tp):
        torch.cuda.synchronize()
        reset_train_seg_counts()
        out = t.train_step(batch, torch.Generator(dev).manual_seed(36))
        losses.append(out["loss"].item())
        torch.cuda.synchronize()
        launches.append(train_seg_counts())
    torch.backends.cudnn.deterministic = False
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])

    tp.ckpt_dir = os.path.join(tmp, "seg_best")
    tp.evaluate(CKPT_SEG_ITERS + 1)
    best = os.path.join(tmp, "seg_best", "best")
    best_jax = jax_only(best, os.path.join(tmp, "seg_best_jax", "best"))
    opts = ["--device", str(dev), "--options",
            f"data.synthetic_samples={4 * bs}"]
    metrics = {name: seg_test.main([SEG_CONFIG, "--checkpoint", path, *opts])
               for name, path in (("state.msgpack", best_jax),
                                  ("state.pt", best))}
    print(f"phase 36c: {SEG_CONFIG.split('/')[-1]} ({side}², batch {bs}): "
          f"iter_{CKPT_SEG_ITERS}/ {sizes} bytes; writing state.pt "
          f"{pt_ms:.3f} ms, state.msgpack (porter, optimizer state, codec) "
          f"{jax_ms:.3f} ms; resume from state.msgpack {jms:.3f} ms, from "
          f"state.pt {pms:.3f} ms; weights and BN statistics bit-equal: "
          f"{weights_equal}; exp_avg, exp_avg_sq, steps and counts "
          f"bit-equal: {state_equal}; one resumed step each: losses "
          f"{losses} (rel {loss_rel:.3e}, bar {STEP_LOSS_REL}), launches "
          f"(B7 fwd, B7 bwd, B6 fwd, B6 bwd) {launches} (expected "
          f"{TRAIN_RECIPES[0][1]}); apps.seg.test --checkpoint best/ from "
          f"state.msgpack {metrics['state.msgpack']}, from state.pt "
          f"{metrics['state.pt']} [{gpu}]")
    if not (weights_equal and state_equal and loss_rel <= STEP_LOSS_REL
            and launches == [TRAIN_RECIPES[0][1]] * 2
            and metrics["state.msgpack"] == metrics["state.pt"]
            and rewrites_bytes(it_dir)):
        raise AssertionError("phase 36c: the seg trainer does not resume "
                             "from state.msgpack as from state.pt")
    return {"seg_iter": {"bytes": sizes, "save_pt_ms": pt_ms,
                         "save_msgpack_ms": jax_ms,
                         "resume_msgpack_ms": jms, "resume_pt_ms": pms}}


def phase36d(dev, gpu: str, tmp: str) -> dict:
    """CCR-CLIP stage 2's gallery from a stage-1 best/ holding only
    state.msgpack, bit-equal to the gallery from its state.pt."""
    from fudanocr_tpu_torch.apps.ccr_clip import train as ctr2
    from fudanocr_tpu_torch.apps.sr_common import seeded
    from fudanocr_tpu_torch.data.codecs import radical_codec
    from fudanocr_tpu_torch.models.rec.ccr_clip import CCRCLIP

    codec = radical_codec(None, None)
    charset = sorted(codec.decomposition)
    clip = seeded(lambda: CCRCLIP(vocab_size=codec.num_classes,
                                  context_length=ctr2.GALLERY_CONTEXT),
                  SEED + 365, "cpu")
    best = os.path.join(tmp, "clip", "best")
    _, save_ms = timed_ms(lambda: ckpt_lib.save(
        best, {"state_dict": clip.state_dict()}, {"epoch": 0},
        jax_tree=jax_variables(clip)))
    best_jax = jax_only(best, os.path.join(tmp, "clip_jax", "best"))
    galleries = {}
    for name, path in (("state.msgpack", best_jax), ("state.pt", best)):
        cfg = ctr2.merge_cli_overrides(ctr2.DEFAULT_CONFIG,
                                       [f"radical_model={path}"])
        galleries[name], ms = timed_ms(lambda: ctr2.build_gallery(
            cfg, charset, codec, dev))
        galleries[name + " ms"] = ms
    equal = torch.equal(galleries["state.msgpack"], galleries["state.pt"])
    sizes = ckpt_sizes(best)
    print(f"phase 36d: CCR-CLIP stage-1 best/ {sizes} bytes (both payloads "
          f"written in {save_ms:.3f} ms); stage 2's gallery "
          f"{tuple(galleries['state.pt'].shape)} from state.msgpack in "
          f"{galleries['state.msgpack ms']:.3f} ms, from state.pt in "
          f"{galleries['state.pt ms']:.3f} ms, bit-equal: {equal} [{gpu}]")
    if not equal or not rewrites_bytes(best):
        raise AssertionError("phase 36d: the gallery from state.msgpack "
                             "differs from the gallery from state.pt")
    return {"clip_best": {"bytes": sizes, "save_ms": save_ms,
                          "gallery_msgpack_ms": galleries["state.msgpack ms"],
                          "gallery_pt_ms": galleries["state.pt ms"]}}


def phase36(dev, gpu: str) -> None:
    """Checkpoint interchange on the card: (a) TBSRN serving, (b) the text-
    focus app, (c) the seg trainer and apps.seg.test, (d) CCR-CLIP stage
    2, each from checkpoints in the JAX package's format."""
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        for part in (phase36a, phase36b, phase36c, phase36d):
            t0 = time.perf_counter()
            out.update(part(dev, gpu, tmp))
            torch.cuda.empty_cache()
            seconds[part.__name__[-1]] = time.perf_counter() - t0
    print(json.dumps({"phase": 36, **out, "seconds": seconds,
                      "card": gpu}))


STANDALONE = {"1": phase1, "4": phase4, "5": phase5, "6": phase6,
              "7": phase7, "10": phase10, "13": phase13, "17": phase17,
              "19": phase19, "20": phase20_alone, "22": phase22,
              "24": phase24, "25": phase25, "26": phase26_alone,
              "27": phase27, "28": phase28, "29": phase29, "30": phase30,
              "31": phase31, "32": phase32, "33": phase33, "34": phase34,
              "35": phase35, "36": phase36}


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a "
              "GPU", file=sys.stderr)
        return 1
    only = argv[1].split(",") if len(argv) == 2 and argv[0] == "--phases" \
        else None
    if argv and (only is None or not set(only) <= STANDALONE.keys()):
        print(f"usage: chip_smoke.py [--phases N,...] with N among "
              f"{sorted(STANDALONE, key=int)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = card()
    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    _build.load_library()
    print(f"phase 0: built {path.name} in {nvcc_s:.2f} s of nvcc "
          f"({time.perf_counter() - t0:.2f} s with loading)")
    if only:
        for n in only:
            STANDALONE[n](dev, gpu)
            torch.cuda.empty_cache()
        print(f"chip_smoke: ran phases {only} only; no result line")
        return 0
    enh = phase1(dev, gpu)
    pipe, lr, launches = phase2(dev, gpu)
    phase3(pipe, lr, gpu)
    torch.cuda.empty_cache()
    ln, ln_bf16 = phase4(dev, gpu)
    b4 = phase5(dev, gpu)
    torch.cuda.empty_cache()
    (ln_n, fwd_n, bwd_n, _), step6_ms = phase6(dev, gpu)
    torch.cuda.empty_cache()
    b7, b5, b7_bf16, b5_bf16 = phase7(dev, gpu)
    models = seg_models(dev)
    b7_n = phase8(dev, gpu, models)
    b5_n = phase9(dev, gpu, models)
    del models
    torch.cuda.empty_cache()
    b6, b6_bf16 = phase10(dev, gpu)
    b6_n = phase11_12(dev, gpu)
    torch.cuda.empty_cache()
    b7_bwd, b6_bwd = phase13(dev, gpu)
    step16_ms = {}
    for config, want in TRAIN_RECIPES:
        counts, step16_ms[config] = train_recipe(config, want, dev, gpu)
    b7_bwd_n, b6_bwd_n = counts[1], counts[3]   # per det-recipe step
    torch.cuda.empty_cache()
    b3 = phase17(dev, gpu)
    b3_n = phase18(dev, gpu, pipe, lr)
    b8 = phase19(dev, gpu)
    b8_n = phase20(dev, gpu, pipe.rec_apply, lr)
    torch.cuda.empty_cache()
    phase21(dev, gpu)
    torch.cuda.empty_cache()
    b9 = phase22(dev, gpu)
    b9_n = phase23(dev, gpu, pipe, lr)
    phase26(dev, gpu, pipe)
    del pipe, lr
    torch.cuda.empty_cache()
    b10_b11, b10_b11_n = phase24(dev, gpu)
    torch.cuda.empty_cache()
    ln_bf16_n, b4_mma_fwd_n, b4_mma_bwd_n, _ = phase25(dev, gpu)
    torch.cuda.empty_cache()
    phase27(dev, gpu, step6_ms)
    torch.cuda.empty_cache()
    phase28(dev, gpu, step16_ms[SEG_CONFIG])
    torch.cuda.empty_cache()
    bf16 = phase29(dev, gpu)
    torch.cuda.empty_cache()
    inf16 = phase30(dev, gpu)
    torch.cuda.empty_cache()
    sld_n, ln_ctr = phase31(dev, gpu)
    torch.cuda.empty_cache()
    clip_n = phase32(dev, gpu)
    torch.cuda.empty_cache()
    oictr_n = phase33(dev, gpu)
    torch.cuda.empty_cache()
    acpm_n = phase34(dev, gpu)
    torch.cuda.empty_cache()
    ctr16_n, ln_ctr16 = phase35(dev, gpu)
    torch.cuda.empty_cache()
    phase36(dev, gpu)
    bf16_b = (torch.bfloat16, TRAIN_B)
    b10, b11_fwd, b11_bwd = b10_b11[(torch.float32, TRAIN_B)]
    _, b11_mma_fwd, b11_mma_bwd = b10_b11[bf16_b]
    b10_n, b11_fwd_n, b11_bwd_n = b10_b11_n[(torch.float32, TRAIN_B)]
    _, b11_mma_fwd_n, b11_mma_bwd_n = b10_b11_n[bf16_b]
    attn_fwd, attn_bwd = b4[(torch.float32, TRAIN_B)]
    b4_mma_fwd, b4_mma_bwd = b4[(torch.bfloat16, STEP_B)]
    attn_src = "fudanocr_tpu_torch/csrc/flash_attention_dropout.cu"
    # the source and CUDA kernels of the fp32 dropout rows (phases 5, 24)
    drop32 = {"source": "fudanocr_tpu_torch/csrc/"
                        "flash_attention_dropout_tf32x3.cu",
              "cuda_kernels": DROPOUT_KERNELS[torch.float32]}
    seg_src = "fudanocr_tpu_torch/csrc/unmasked_attention.cu"
    # the sources and CUDA kernels of the fp32 seg attention rows (phases 7,
    # 10, 13, 24; the backward's reduce is in seg_src) and of B3's bf16 row
    # (phase 17)
    fwd32 = {"source": "fudanocr_tpu_torch/csrc/"
                       "unmasked_attention_fwd_tf32x3.cu",
             "cuda_kernels": ["attn_fwd_tf32x3_kernel"]}
    bwd32 = {"source": "fudanocr_tpu_torch/csrc/"
                       "unmasked_attention_bwd_tf32x3.cu",
             "cuda_kernels": BWD_KERNELS[torch.float32]}
    rows = [
        {"name": "fused_enhancer", "route": "cuda",
         "source": "fudanocr_tpu_torch/csrc/fused_enhancer.cu",
         "replaces": "fudanocr_tpu/ops/fused_enhancer.py:188",
         "launches": launches, **enh},
        {"name": "fused_residual_layernorm", "route": "cuda",
         "source": "fudanocr_tpu_torch/csrc/fused_layernorm.cu",
         "replaces": "fudanocr_tpu/ops/fused_layernorm.py:53",
         "launches": ln_n, **ln},
        # the CTR decoders' B2 (phases 31-34): launches of the four entry
        # points' runs, numbers at SLD's (32 * 30, 1024) fp32
        {"name": "fused_residual_layernorm_ctr", "route": "cuda",
         "source": "fudanocr_tpu_torch/csrc/fused_layernorm.cu",
         "replaces": "fudanocr_tpu/ops/fused_layernorm.py:53",
         "launches": sld_n + clip_n + oictr_n + acpm_n, **ln_ctr},
        # the bf16 CTR decoders' B2 (phase 35): launches of the bf16 SLD
        # step and decode, numbers at SLD's (32 * 30, 1024) bf16
        {"name": "fused_residual_layernorm_ctr_bf16", "route": "cuda",
         "source": "fudanocr_tpu_torch/csrc/fused_layernorm.cu",
         "replaces": "fudanocr_tpu/ops/fused_layernorm.py:53",
         "launches": ctr16_n, **ln_ctr16},
        {"name": "fused_residual_layernorm_bf16", "route": "cuda",
         "source": "fudanocr_tpu_torch/csrc/fused_layernorm.cu",
         "replaces": "fudanocr_tpu/ops/fused_layernorm.py:53",
         "launches": ln_bf16_n, **ln_bf16},
        {"name": "qkv_dropout_attention_fwd", "route": "cuda", **drop32,
         "replaces": "fudanocr_tpu/ops/flash_attention.py:505",
         "launches": fwd_n, **attn_fwd},
        {"name": "qkv_dropout_attention_bwd", "route": "cuda", **drop32,
         "replaces": "fudanocr_tpu/ops/flash_attention.py:528",
         "launches": bwd_n, **attn_bwd},
        {"name": "unmasked_attention_packed", "route": "cuda", **fwd32,
         "replaces": "fudanocr_tpu/ops/region_attention.py:280",
         "launches": b7_n, **b7},
        {"name": "unmasked_attention_bhld", "route": "cuda", **fwd32,
         "replaces": "fudanocr_tpu/ops/flash_attention.py:653",
         "launches": b5_n, **b5},
        {"name": "region_attention_packed", "route": "cuda", **fwd32,
         "replaces": "fudanocr_tpu/ops/region_attention.py:167",
         "launches": b6_n, **b6},
        {"name": "unmasked_attention_packed_bwd", "route": "cuda", **bwd32,
         "replaces": "fudanocr_tpu/ops/region_attention.py:306",
         "launches": b7_bwd_n, **b7_bwd},
        {"name": "region_attention_packed_bwd", "route": "cuda", **bwd32,
         "replaces": "fudanocr_tpu/ops/region_attention.py:201",
         "launches": b6_bwd_n, **b6_bwd},
        {"name": "flash_mha_qkv_packed", "route": "cuda", "source": seg_src,
         "cuda_kernels": ["attn_fwd_mma_kernel"],
         "replaces": "fudanocr_tpu/ops/flash_attention.py:220",
         "launches": b3_n, **b3},
        {"name": "fused_bigru", "route": "cuda",
         "source": "fudanocr_tpu_torch/csrc/fused_gru.cu",
         "replaces": "fudanocr_tpu/ops/fused_gru.py:80",
         "launches": b8_n, **b8},
        {"name": "fused_srb", "route": "cuda",
         "source": "fudanocr_tpu_torch/csrc/fused_srb.cu",
         "cuda_kernels": sorted(B9_KERNELS[torch.bfloat16]),
         "replaces": "fudanocr_tpu/ops/fused_srb.py:124",
         "launches": b9_n, **b9},
        {"name": "flash_mha_packed", "route": "cuda", **fwd32,
         "replaces": "fudanocr_tpu/ops/flash_attention.py:164",
         "launches": b10_n, **b10},
        {"name": "packed_dropout_attention_fwd", "route": "cuda", **drop32,
         "replaces": "fudanocr_tpu/ops/flash_attention.py:373",
         "launches": b11_fwd_n, **b11_fwd},
        {"name": "packed_dropout_attention_bwd", "route": "cuda", **drop32,
         "replaces": "fudanocr_tpu/ops/flash_attention.py:401",
         "launches": b11_bwd_n, **b11_bwd},
        {"name": "qkv_dropout_attention_fwd_mma", "route": "cuda",
         "source": attn_src,
         "replaces": "fudanocr_tpu/ops/flash_attention.py:505",
         "launches": b4_mma_fwd_n, **b4_mma_fwd},
        {"name": "qkv_dropout_attention_bwd_mma", "route": "cuda",
         "source": attn_src,
         "replaces": "fudanocr_tpu/ops/flash_attention.py:528",
         "launches": b4_mma_bwd_n, **b4_mma_bwd},
        {"name": "packed_dropout_attention_fwd_mma", "route": "cuda",
         "source": attn_src,
         "replaces": "fudanocr_tpu/ops/flash_attention.py:373",
         "launches": b11_mma_fwd_n, **b11_mma_fwd},
        {"name": "packed_dropout_attention_bwd_mma", "route": "cuda",
         "source": attn_src,
         "replaces": "fudanocr_tpu/ops/flash_attention.py:401",
         "launches": b11_mma_bwd_n, **b11_mma_bwd},
        # the bf16 seg attention (phases 7, 10, 29, 30): inference forwards
        # at the slide shapes, launches per bf16 canvas; the training
        # forward (STATS) and backward at the det step's level 0, launches
        # per bf16 det step
        {"name": "unmasked_attention_packed_bf16", "route": "cuda",
         "source": seg_src, "cuda_kernels": ["attn_fwd_mma_kernel"],
         "replaces": "fudanocr_tpu/ops/region_attention.py:280",
         "launches": inf16["slide"][1], **b7_bf16},
        {"name": "unmasked_attention_bhld_bf16", "route": "cuda",
         "source": seg_src, "cuda_kernels": ["attn_fwd_mma_kernel"],
         "replaces": "fudanocr_tpu/ops/flash_attention.py:653",
         "launches": inf16[(2048, 2048)][2], **b5_bf16},
        {"name": "region_attention_packed_bf16", "route": "cuda",
         "source": seg_src, "cuda_kernels": ["attn_fwd_mma_kernel"],
         "replaces": "fudanocr_tpu/ops/region_attention.py:167",
         "launches": inf16["det_slide"][0], **b6_bf16},
        {"name": "unmasked_attention_packed_stats_bf16", "route": "cuda",
         "source": seg_src, "cuda_kernels": ["attn_fwd_mma_kernel"],
         "replaces": "fudanocr_tpu/ops/region_attention.py:280",
         "launches": bf16["launches"][0], **bf16["stats_plain"]},
        {"name": "region_attention_packed_stats_bf16", "route": "cuda",
         "source": seg_src, "cuda_kernels": ["attn_fwd_mma_kernel"],
         "replaces": "fudanocr_tpu/ops/region_attention.py:167",
         "launches": bf16["launches"][2], **bf16["stats_masked"]},
        {"name": "unmasked_attention_packed_bwd_bf16", "route": "cuda",
         "source": seg_src, "cuda_kernels": BWD_KERNELS[torch.bfloat16],
         "replaces": "fudanocr_tpu/ops/region_attention.py:306",
         "launches": bf16["launches"][1], **bf16["bwd_plain"]},
        {"name": "region_attention_packed_bwd_bf16", "route": "cuda",
         "source": seg_src, "cuda_kernels": BWD_KERNELS[torch.bfloat16],
         "replaces": "fudanocr_tpu/ops/region_attention.py:201",
         "launches": bf16["launches"][3], **bf16["bwd_masked"]}]
    # the CUDA-core floor is computed, not measured: the phase lines print
    # it, the kernels line carries only `bound_ms`
    for row in rows:
        row.pop("cuda_core_bound_ms", None)
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
