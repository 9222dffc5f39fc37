"""How far one fp32 det seg step's gradients move under changes that leave
its math alone, on the card: chip_smoke.py phase 38b's one-process step
(the det recipe at 1024², batch 2) against itself run again, with Lovász's
sort made stable, and with cuDNN free to pick other convolution
algorithms (benchmark mode, not deterministic), and against itself with
cuDNN off (PyTorch's own convolutions, one image at a time). Prints, per
variant, the worst per-tensor gradient relative error (and the tensor,
its norm over the largest) and the norm-relative distance of all
gradients together. With --ddp, phase 38b itself with cuDNN off in the
ranks and the one process (its lines; it may raise at its bar).

    python3 scripts/ddp_seg_noise.py [--ddp]
"""

from __future__ import annotations

import functools
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from fudanocr_tpu_torch.core.mesh import make_mesh_for_batch  # noqa: E402
from fudanocr_tpu_torch.losses import seg_losses  # noqa: E402


def step() -> dict:
    out = cs.p38_step(cs.p38_seg_case, torch.device("cuda", 0),
                      make_mesh_for_batch(2))
    torch.cuda.empty_cache()
    return out


def report(what: str, got: dict, want: dict) -> None:
    top = max(w.norm().item() for w in want["grads"].values())
    worst, name, share = 0.0, "", 0.0
    for k, w in want["grads"].items():
        if w.norm().item() <= 1e-6 * top:
            continue
        err = cs.rel_err(got["grads"][k], w)
        if err > worst:
            worst, name, share = err, k, w.norm().item() / top
    g = torch.cat([v.flatten() for v in got["grads"].values()])
    w = torch.cat([want["grads"][k].flatten() for k in got["grads"]])
    print(f"{what}: worst per-tensor gradient rel {worst:.3e} ({name}, norm "
          f"{share:.2e} of the largest), all gradients norm-relative "
          f"{((g - w).norm() / w.norm()).item():.3e}, loss rel "
          f"{abs(got['loss'] - want['loss']) / abs(want['loss']):.3e} "
          f"[{cs.card()}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("ddp_seg_noise: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--ddp"]:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            try:
                cs.phase38b(torch.device("cuda", 0), cs.card(), tmp,
                            cudnn=False)
            except AssertionError as e:
                print(f"phase 38b without cuDNN: {e}")
        return 0
    torch.backends.cudnn.deterministic = True
    base = step()
    report("run again", step(), base)
    sort = seg_losses._weights_in_place
    seg_losses._weights_in_place = functools.partial(sort, stable=True)
    try:
        report("Lovász's sort stable", step(), base)
    finally:
        seg_losses._weights_in_place = sort
    torch.backends.cudnn.enabled = False
    report("cuDNN off", step(), base)
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    report("cuDNN benchmark mode", step(), base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
