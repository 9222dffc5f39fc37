"""The multi-rank dry run (port of __graft_entry__.dryrun_multichip).

    python -m fudanocr_tpu_torch.parallel.dryrun 4

starts N processes on this host, one rank each of a gloo process group on
the CPU (the JAX check runs over N virtual CPU devices), and runs in each
at JAX's tiny shapes, with a global batch of b = max(N, 8):

* one TBSRN train step with the text-focus loss of a small frozen
  OCRTransformer oracle (`train/sr.make_sr_train_step`, dropout on): on
  the data axis of `make_mesh_for_batch(b)`, or, with N >= 4 and even, as
  JAX runs it, over a (data = N/2, model = 2) device mesh with TBSRN's
  parameters placed (`parallel/tp.TensorParallel`: each sharded parameter
  gathered over 'model' for the step, its gradient reduce-scattered back);
* one det-guided segmentation step, CE + Lovász + 0.1 x the det loss
  (`train/seg.make_seg_train_step`), on the data axis of all N ranks (JAX
  places nothing there either);

and, with N >= 4 and even, checks that `parallel/tp.shard_params_tp`'s
placement of TBSRN over that mesh holds the same values. Each loss must be
finite and the same on every rank (the global batch's).
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List

import torch

ROOT = Path(__file__).resolve().parents[2]


def dryrun_multichip(n: int, timeout: float = 600.0) -> List[str]:
    """Run the dry run on `n` spawned CPU ranks; returns rank 0's report
    lines. Raises if a rank fails."""
    with tempfile.TemporaryDirectory(prefix="fudanocr_dryrun_") as tmp:
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT), os.environ.get("PYTHONPATH", "")]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "fudanocr_tpu_torch.parallel.dryrun",
             str(n), "--rank", str(r), "--init", f"file://{tmp}/rendezvous"],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} of {n} failed "
                               f"(rc={p.returncode}):\n{out}")
    return [line for line in outs[0].splitlines() if "dryrun" in line]


def _same_on_ranks(value: float, what: str) -> None:
    import torch.distributed as dist

    t = torch.tensor([value, -value], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if not (math.isfinite(value) and t[0] == value and -t[1] == value):
        raise AssertionError(f"{what}: {value} is not finite and the same "
                             f"on every rank ({float(t[0])}, "
                             f"{-float(t[1])})")


def sr_step(n: int, model_par: int = 1) -> tuple:
    """One TBSRN + text-focus-oracle step on this rank's rows, on the data
    axis, or over a (n / model_par, model_par) mesh with the parameters
    placed; (loss, parameters sharded over 'model', parameters)."""
    from fudanocr_tpu_torch.core.mesh import make_mesh_for_batch, shard_batch
    from fudanocr_tpu_torch.losses.sr_losses import (TextFocusLoss,
                                                     encode_text_labels)
    from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
    from fudanocr_tpu_torch.models.sr import TBSRN
    from fudanocr_tpu_torch.parallel.tp import TensorParallel, make_mesh
    from fudanocr_tpu_torch.train.sr import make_sr_train_step
    from fudanocr_tpu_torch.train.state import adam_with_clip

    b = max(n, 8)
    torch.manual_seed(0)
    model = TBSRN(scale_factor=2, width=64, height=32, stn=False,
                  srb_nums=1)
    oracle = OCRTransformer(vocab=37, num_in=1, layers=(1, 1, 1, 1),
                            num_heads=4, d_embed=64, d_model=128, d_ff=256)
    if model_par > 1:
        mesh = make_mesh("cpu", data=n // model_par, model=model_par)
        run = TensorParallel(model, mesh)
        data = run.data
    else:
        mesh = data = make_mesh_for_batch(b)
        run = model
    text_input, text_gt, lengths = encode_text_labels(["dryrun"] * b, 8)
    batch = shard_batch(data, {
        "lr": torch.full((b, 16, 32, 3), 0.4),
        "hr": torch.full((b, 32, 64, 3), 0.4),
        "text_input": torch.from_numpy(text_input).long(),
        "text_gt": torch.from_numpy(text_gt).long(),
        "lengths": torch.from_numpy(lengths).long()})
    step = make_sr_train_step(run, TextFocusLoss(oracle),
                              adam_with_clip(run.parameters(), 1e-4),
                              mesh=mesh)
    loss = float(step(batch, torch.Generator().manual_seed(2))["loss"])
    sharded = (sum(sp[1].is_shard() for sp in run.specs.values())
               if model_par > 1 else 0)
    return loss, sharded, len(list(model.parameters()))


def seg_step(n: int) -> float:
    """One det-guided segmentation step on this rank's rows."""
    from fudanocr_tpu_torch.core.mesh import make_mesh_for_batch, shard_batch
    from fudanocr_tpu_torch.models.seg import (CascadeMiTDetGuided,
                                               DetGuidedEncoderDecoder,
                                               SegformerHead)
    from fudanocr_tpu_torch.train.seg import (iteration_generator,
                                              make_seg_optimizer,
                                              make_seg_train_step)

    b = max(n, 8)
    torch.manual_seed(3)
    model = DetGuidedEncoderDecoder(
        CascadeMiTDetGuided(embed_dims=8, num_layers=(1, 1, 1, 1),
                            drop_path_rate=0.0),
        SegformerHead([8, 16, 40, 64], num_classes=2, channels=32))
    mesh = make_mesh_for_batch(b)
    step = make_seg_train_step(model, make_seg_optimizer(model,
                                                         total_iters=10),
                               {"ce": 1.0, "lovasz": 1.0},
                               det_loss_ratio=0.1, mesh=mesh)
    batch = shard_batch(mesh, {
        "img": torch.full((b, 32, 32, 3), 0.3),
        "gt_seg": torch.zeros((b, 32, 32), dtype=torch.long),
        "gt_det": torch.zeros((b, 32, 32), dtype=torch.long)})
    return float(step(batch, iteration_generator(4, 0, "cpu"))["loss"])


def placement(n: int) -> str:
    """TBSRN's parameters placed over (data = n/2, model = 2): every
    placed tensor holds the original's values; returns a report line."""
    from fudanocr_tpu_torch.models.sr import TBSRN
    from fudanocr_tpu_torch.parallel.tp import make_mesh, shard_params_tp

    torch.manual_seed(0)
    params = dict(TBSRN(width=64, stn=False, srb_nums=1).named_parameters())
    placed = shard_params_tp({k: v.detach() for k, v in params.items()},
                             make_mesh("cpu", data=n // 2, model=2))
    sharded = 0
    for k, v in placed.items():
        if not torch.equal(v.full_tensor(), params[k].detach()):
            raise AssertionError(f"placement changed {k}")
        sharded += any(p.is_shard() for p in v.placements)
    return (f"dryrun placement (data={n // 2}, model=2) ok: {sharded} of "
            f"{len(placed)} parameters sharded over 'model'")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ranks", type=int)
    p.add_argument("--rank", type=int, default=None,
                   help="run as this rank (the launcher passes it)")
    p.add_argument("--init", default=None,
                   help="the process group's init_method (file://...)")
    args = p.parse_args(argv)
    if args.rank is None:
        for line in dryrun_multichip(args.ranks):
            print(line)
        return 0

    import torch.distributed as dist

    from fudanocr_tpu_torch.core.mesh import setup_distributed

    torch.set_num_threads(1)
    setup_distributed("cpu", init_method=args.init, world_size=args.ranks,
                      rank=args.rank)
    n = args.ranks
    tp = n >= 4 and n % 2 == 0
    loss, sharded, total = sr_step(n, 2 if tp else 1)
    _same_on_ranks(loss, "TBSRN step loss")
    seg = seg_step(n)
    _same_on_ranks(seg, "det-guided seg step loss")
    report = [f"dryrun_multichip({n}) ok: loss={loss:.4f}",
              f"dryrun seg det-guided({n}) ok: loss={seg:.4f}"]
    if tp:
        report += [placement(n),
                   f"dryrun tensor-parallel TBSRN step (data={n // 2}, "
                   f"model=2) ok: {sharded} of {total} parameters sharded "
                   f"over 'model' and gathered for the step; "
                   f"loss={loss:.4f} on every rank"]
    if args.rank == 0:
        print("\n".join(report), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
