"""Data-parallel runs of the port's trainers on the CPU, shared by
tests/test_torch_distributed.py, tests/test_torch_ddp_steps.py and
tests/test_torch_tp.py.

`run_ranks(world, cases, tmp)` starts `world` processes of this file, one
per rank (a gloo group over a `file://` rendezvous in `tmp`, so parallel
test workers never share a port; one torch thread each), runs the named
cases in order in each, and returns every rank's results (`torch.save`d
dicts of numpy arrays and floats). Each case is a function of no argument
that builds its seeded model and data, drives a trainer through its
public methods and returns what the tests compare: with no process group
(the test's own process) it is one process on the global batch, under
`run_ranks` it is one rank's run on its rows. Everything is float64.

    python tests/torch_ddp_cases.py <rank> <world> <dir> <case>[,<case>...]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64


def run_ranks(world: int, cases, tmp, timeout: float = 600.0) -> list:
    """Run `cases` (names of this module's CASES) on `world` spawned ranks;
    [rank 0's {case: result}, rank 1's, ...]."""
    return start_ranks(world, cases, tmp)(timeout)


def start_ranks(world: int, cases, tmp):
    """Start `run_ranks`'s processes and return `wait(timeout=600)`, which
    waits for them and returns their results; the caller computes in the
    meantime."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]), OMP_NUM_THREADS="1",
        MKL_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(tmp),
         ",".join(cases)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def wait(timeout: float = 600.0) -> list:
        deadline = time.monotonic() + timeout
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} of {world} failed:\n{out}"
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(world)]

    return wait


# -- what the cases return ----------------------------------------------------

def state_of(module: torch.nn.Module) -> dict:
    """Every parameter and buffer (BN statistics included), as numpy."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def moved(start: dict, module: torch.nn.Module) -> float:
    """The largest move of any parameter or buffer from `start`."""
    return max(float(np.abs(v - start[k]).max(initial=0.0))
               for k, v in state_of(module).items())


def seeded(build, seed: int = 0):
    """`build()` under torch's CPU generator seeded with `seed`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def randomize_bn(module: torch.nn.Module, seed: int = 1) -> None:
    """Non-trivial BatchNorm statistics, so the running update shows."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            with torch.no_grad():
                m.running_mean.copy_(torch.rand(m.running_mean.shape,
                                                generator=g) * 0.2 - 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=g) * 0.5 + 0.75)


def linear_updates(optimizer: torch.optim.Optimizer) -> None:
    """eps = 1 in every group of an Adam or Adadelta: the first updates
    are then ~ lr x the gradient (as in tests/test_torch_sr_train.py), not
    ~ lr x its sign, which would blow the rounding of a gradient that
    cancels to ~eps (a bias in front of a train-mode BatchNorm, a
    LayerNorm fed by float32 islands) up to a whole update."""
    for g in optimizer.param_groups:
        g["eps"] = 1.0


def recorded(trainer, attr: str = "train_step") -> list:
    """Wrap the trainer's step so each call's metrics are kept."""
    rec, step = [], getattr(trainer, attr)

    def wrapped(*a, **k):
        out = step(*a, **k)
        rec.append({n: float(v) for n, v in
                    (out.items() if isinstance(out, dict)
                     else [("loss", out)])})
        return out

    setattr(trainer, attr, wrapped)
    return rec


class Float64(object):
    """A dataset whose batches' float arrays are float64."""

    def __init__(self, data):
        self.data = data
        self.builds_rows = getattr(data, "builds_rows", False)

    def __len__(self):
        return len(self.data)

    def batches(self, *a, **k):
        def cast(v):
            if isinstance(v, np.ndarray) and v.dtype == np.float32:
                return v.astype(np.float64)
            return v
        for b in self.data.batches(*a, **k):
            yield ({n: cast(v) for n, v in b.items()} if isinstance(b, dict)
                   else tuple(cast(v) for v in b))


# -- comparing runs -----------------------------------------------------------

REL = 1e-9
# values that are float32 by design: the clip's global norm (AdamWithClip
# takes it in float32) and the GAN's pixel L1 (a float32 mean, as JAX's)
F32_KEYS, F32_REL = ("grad_norm", "pix"), 1e-6


def assert_same_run(got: dict, want: dict, what: str) -> float:
    """`got` (a rank's case result) equals `want` (one process's) within
    REL relative to the scale of each group: a step's metrics to the
    largest of that step (F32_KEYS within F32_REL of themselves), the
    evaluation's to its largest, the parameters and buffers (BatchNorm
    statistics included) to the largest entry of the whole state. Returns
    the largest relative distance seen."""
    worst = 0.0

    def close(g, w, scale, rel, name):
        nonlocal worst
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        d = float(np.abs(g - w).max(initial=0.0)) / max(scale, 1e-300)
        assert d <= rel, f"{what} {name}: {d:.3e} > {rel:.0e}"
        worst = max(worst, d) if rel == REL else worst

    def top(values):
        return max(float(np.abs(np.asarray(v, np.float64)).max(initial=0.0))
                   for v in values)

    assert len(got["steps"]) == len(want["steps"]) > 0, what
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert g.keys() == w.keys(), (what, i)
        scale = top(v for k, v in w.items() if k not in F32_KEYS)
        for k in w:
            if k in F32_KEYS:
                close(g[k], w[k], abs(w[k]), F32_REL, f"step {i} {k}")
            else:
                close(g[k], w[k], scale, REL, f"step {i} {k}")
    assert got["state"].keys() == want["state"].keys(), what
    scale = top(want["state"].values())
    for k, w in want["state"].items():
        close(got["state"][k], w, scale, REL, k)
    if want.get("eval") is not None:
        assert got["eval"].keys() == want["eval"].keys(), what
        scale = top(want["eval"].values())
        for k, w in want["eval"].items():
            close(got["eval"][k], w, scale, REL, f"eval {k}")
    return worst


# -- the cases ----------------------------------------------------------------

SR_B, SR_SAMPLES = 4, 8
ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"


def small_text_zoom(n: int, seed: int):
    """SyntheticTextZoom collated at 32x64 HR (LR 16x32: 512 tokens)."""
    from fudanocr_tpu_torch.data.synthetic import SyntheticTextZoom

    class Small(SyntheticTextZoom):
        def collate(self, items, **kw):
            return super().collate(items, img_h=32, img_w=64, **kw)

    return Small(n, seed=seed, hr_size=(64, 32))


ORACLE = dict(vocab=37, num_in=1, layers=(1, 1, 1, 1), num_heads=4,
              d_embed=32, d_model=64, d_ff=64, encoder_width_div=8)


def sr_case(stroke: bool = False) -> dict:
    """TBSRN (x2 to 32x64, no STN, 1 SRB; dropout on: the enhancer's
    hash-dropout route at L = 512 and the feed-forward dropout) with the
    text-focus loss, or, with `stroke`, the stroke-focus loss and its
    oracle through `StrokeSRTrainer` (on TBSRN: TSRN's GRU runs in
    float32 only): 2 steps of `train()` at batch 4, then `evaluate()`
    with a float32 CRNN reading the SR images."""
    from fudanocr_tpu_torch.eval.ctc import CTCLabelConverter
    from fudanocr_tpu_torch.losses.sr_losses import TextFocusLoss
    from fudanocr_tpu_torch.losses.stroke_focus import StrokeFocusLoss
    from fudanocr_tpu_torch.models.rec.crnn import CRNN
    from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
    from fudanocr_tpu_torch.models.sr import TBSRN
    from fudanocr_tpu_torch.train.sr import SRTrainer, StrokeSRTrainer

    model = seeded(lambda: TBSRN(width=64, stn=False, srb_nums=1,
                                 dtype=F64).double())
    if stroke:
        oracle = seeded(lambda: OCRTransformer(**dict(ORACLE, vocab=10),
                                               dtype=F64), 2).double()
        loss_fn, cls = StrokeFocusLoss(oracle), StrokeSRTrainer
    else:
        oracle = seeded(lambda: OCRTransformer(**ORACLE, dtype=F64),
                        2).double()
        loss_fn, cls = TextFocusLoss(oracle), SRTrainer
    randomize_bn(model)
    crnn = seeded(lambda: CRNN(hidden=16), 3).eval()   # float32: its LSTM
    train, val = small_text_zoom(SR_SAMPLES, 0), small_text_zoom(SR_B, 1)
    t = cls(model, loss_fn, train, val, batch_size=SR_B, epochs=1,
            eval_every=10 ** 6, recognizer=lambda x: crnn(x.float()),
            converter=CTCLabelConverter(ALPHABET),
            seed=5)
    linear_updates(t.optimizer.adam)
    rec, start = recorded(t), state_of(model)
    t.train()
    res = t.evaluate(t.step)
    return {"steps": rec, "state": state_of(model), "eval": res,
            "moved": moved(start, model)}


def seg_case(det: bool = False, lovasz_impl: str = "sort") -> dict:
    """A small CascadeMiT + SegFormer head (drop-path 0.1, head dropout),
    CE; with `det` the det-guided model with CE + Lovász (`lovasz_impl`)
    + 0.1 x the det loss: 2 iterations of `SegTrainer.train()` at batch 4
    (the second batch padded: 6 samples), then `evaluate()`."""
    from fudanocr_tpu_torch.data.seg_dataset import SyntheticTextSeg
    from fudanocr_tpu_torch.data.seg_pipeline import Normalize
    from fudanocr_tpu_torch.models.seg import (CascadeMiT,
                                               CascadeMiTDetGuided,
                                               DetGuidedEncoderDecoder,
                                               EncoderDecoder, SegformerHead)
    from fudanocr_tpu_torch.train.seg import SegTrainer

    kw = dict(embed_dims=8, num_layers=(1, 1, 1, 1), drop_path_rate=0.1,
              dtype=F64)

    def build():
        head = SegformerHead([8, 16, 40, 64], 2, 16, dtype=F64)
        if det:
            return DetGuidedEncoderDecoder(CascadeMiTDetGuided(**kw), head)
        return EncoderDecoder(CascadeMiT(**kw), head)

    model = seeded(build).double()
    randomize_bn(model)
    train = Float64(SyntheticTextSeg(6, (32, 32), [Normalize()], seed=0,
                                     with_det=det))
    val = Float64(SyntheticTextSeg(4, (32, 32), [Normalize()], seed=1))
    weights = {"ce": 1.0, "lovasz": 1.0} if det else {"ce": 1.0}
    t = SegTrainer(model, train, val, batch_size=4, total_iters=2,
                   eval_every=10 ** 6, loss_weights=weights, seed=7,
                   lovasz_impl=lovasz_impl)
    linear_updates(t.optimizer.adam)
    t.optimizer.count = 1500      # past the warmup: the recipe's own lr
    rec, start = recorded(t), state_of(model)
    t.train()
    res = t.evaluate(2, save_best=False)
    return {"steps": rec, "state": state_of(model), "eval": res,
            "moved": moved(start, model)}


def sld_case() -> dict:
    """SLD (stroke mode, the app's codec and synthetic characters) at
    small width through `CTRTrainer`: 2 steps at batch 4, then
    `evaluate()` (greedy decodes)."""
    from fudanocr_tpu_torch.apps.sld import train as sld
    from fudanocr_tpu_torch.data.rec_dataset import SyntheticCharDataset
    from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
    from fudanocr_tpu_torch.train.ctr import CTRTrainer

    cfg = sld.merge_cli_overrides(sld.DEFAULT_CONFIG, [])
    codec, rectifier, _, _ = sld.build_codec_and_data(cfg)
    model = seeded(lambda: OCRTransformer(
        vocab=codec.num_classes, num_in=3, layers=(1, 1, 1, 1), num_heads=4,
        d_embed=32, d_model=64, d_ff=64, encoder_width_div=8,
        dtype=F64)).double()
    randomize_bn(model)
    train = Float64(SyntheticCharDataset(num_samples=8, seed=0))
    val = Float64(SyntheticCharDataset(num_samples=8, seed=1))
    # lr 0.1: the decoder keeps float32 islands (LayerNorm, the attention
    # softmax), whose roundings flip once the parameters differ in their
    # last float64 bits; at the recipe's lr 1 the second step carries them
    # into the embedding at ~1e-9 of the state, at 0.1 at ~1e-10
    t = CTRTrainer(model, codec, train, val, batch_size=4, lr=0.1, epochs=1,
                   eval_every=10 ** 6, max_len=8, rectifier=rectifier)
    linear_updates(t.optimizer.optimizer)
    rec, start = recorded(t), state_of(model)
    t.train()
    res = t.evaluate(2)
    return {"steps": rec, "state": state_of(model), "eval": res,
            "moved": moved(start, model)}


def gan_case() -> dict:
    """`GANSRTrainer` (RRDBNet against the SRGAN discriminator, both with
    train-mode BatchNorm in D): two iterations at batch 4, on this rank's
    rows of two global batches."""
    from fudanocr_tpu_torch.core.mesh import make_mesh_for_batch, shard_batch
    from fudanocr_tpu_torch.data.synthetic import SyntheticTextZoom
    from fudanocr_tpu_torch.models.sr.baselines import (RRDBNet,
                                                        SRDiscriminator)
    from fudanocr_tpu_torch.train.gan import GANSRTrainer

    t = GANSRTrainer(RRDBNet(nf=8, nb=1, gc=4).double(),
                     SRDiscriminator().double(), None, batch_size=4,
                     seed=3, mesh=make_mesh_for_batch(4))
    linear_updates(t.g_opt.adam)
    linear_updates(t.d_opt.adam)
    randomize_bn(t.d)
    data = SyntheticTextZoom(8, hr_size=(32, 16), scale=2, seed=0)
    start_g, start_d = state_of(t.g), state_of(t.d)
    steps = []
    for hr, lr, _ in data.batches(4):
        hr, lr = shard_batch(t.mesh, (hr, lr))
        hr_t, lr_t = (torch.from_numpy(np.asarray(a, np.float64))
                      for a in (hr, lr))
        d = t.d_step(lr_t, hr_t)
        g = t.g_step(lr_t, hr_t)
        steps.append({"d_loss": float(d),
                      **{k: float(v) for k, v in g.items()}})
    return {"steps": steps, "state": {**{"g." + k: v for k, v in
                                          state_of(t.g).items()},
                                       **{"d." + k: v for k, v in
                                          state_of(t.d).items()}},
            "moved": min(moved(start_g, t.g), moved(start_d, t.d))}


# -- the mesh helpers and collectives (tests/test_torch_distributed.py) -------

MESH_ROWS = 2          # each rank's rows in mesh_case


def mesh_inputs(world: int) -> dict:
    """The global inputs of mesh_case, the same on every rank: a BN input,
    seg logits whose errors tie (a few levels) with labels and ignored
    pixels, and token logits with lengths."""
    rng = np.random.default_rng(21)
    b = MESH_ROWS * world
    return {"bn": rng.standard_normal((b, 3, 4, 5)) * 2 + 1,
            "seg": rng.integers(-2, 3, (b, 4, 4, 2)).astype(np.float64),
            "labels": rng.choice([0, 1, 255], (b, 4, 4), p=[.5, .4, .1]),
            "tokens": rng.standard_normal((b, 5, 7)),
            "targets": rng.integers(0, 7, (b, 5)),
            "lengths": rng.integers(0, 6, (b,)),
            "w": rng.standard_normal((world, 4 * world))}


# the seg losses whose shares mesh_case takes (names in losses/seg_losses)
SEG_LOSSES_BY_NAME = {"ce": "cross_entropy_loss",
                      "lovasz": "lovasz_softmax_loss",
                      "lovasz_bucketed": "lovasz_softmax_bucketed",
                      "dice": "dice_loss", "focal": "focal_loss",
                      "tversky": "tversky_loss"}


def mesh_case() -> dict:
    """On 3 ranks: JAX's gcd rule at batches 4 and 6, the striping, and,
    on the 3-rank axis, the collectives' values and gradients, the
    global draws, and BatchNorm, the seg losses of SEG_LOSSES_BY_NAME
    (Lovász with tied errors), seg accuracy and the masked token CE of
    this rank's rows."""
    from fudanocr_tpu_torch.core import mesh as M
    from fudanocr_tpu_torch.losses import seg_losses
    from fudanocr_tpu_torch.nn.layers import batch_norm, dropout
    from fudanocr_tpu_torch.train.ctr import masked_token_ce

    SEG_LOSSES = {k: getattr(seg_losses, v)
                  for k, v in SEG_LOSSES_BY_NAME.items()}
    rank, world = M.world()
    m4, m6 = M.make_mesh_for_batch(4), M.make_mesh_for_batch(6)
    out = {"m4": (m4.size, m4.index), "m6": (m6.size, m6.index),
           "stripes": list(M.host_shard_indices(30, 4)),
           "local_batch": M.local_batch_size(6),
           "offset": M.batch_offset(5)}
    inp = mesh_inputs(m6.size)
    rows = m6.rows(MESH_ROWS * m6.size)
    t = {k: torch.from_numpy(np.asarray(v)[rows]) for k, v in inp.items()
         if k != "w"}
    with M.data_parallel(m6):
        out["offset_in"] = M.batch_offset(5)
        # the sum all-reduce and the all-gather, values and gradients
        x = torch.arange(4, dtype=F64, requires_grad=True)
        s = M.all_reduce_sum(x * (rank + 1))
        (s * (rank + 1)).sum().backward()
        out["sum"], out["sum_grad"] = s.detach().numpy(), x.grad.numpy()
        y = (torch.arange(4, dtype=F64) + 10 * rank).requires_grad_()
        g = M.all_gather(y)
        (g * torch.from_numpy(inp["w"][rank])).sum().backward()
        out["gather"], out["gather_grad"] = g.detach().numpy(), y.grad.numpy()
        out["rand"] = M.global_rand((MESH_ROWS, 3), torch.Generator()
                                    .manual_seed(9), "cpu").numpy()
        out["dropout"] = dropout(torch.ones(MESH_ROWS, 6, dtype=F64), 0.5,
                                 torch.Generator().manual_seed(9)).numpy()
        # BatchNorm: output, gradients, running statistics
        bn = torch.nn.BatchNorm2d(3).double()
        xb = t["bn"].clone().requires_grad_()
        yb = batch_norm(bn, xb, train=True)
        (yb * yb * (rank + 1)).sum().backward()
        out["bn"] = {"y": yb.detach().numpy(), "dx": xb.grad.numpy(),
                     "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
                     "mean": bn.running_mean.numpy(),
                     "var": bn.running_var.numpy()}
        # the seg losses and the masked token CE: shares and gradients
        for name, fn in SEG_LOSSES.items():
            lg = t["seg"].clone().requires_grad_()
            share = fn(lg, t["labels"])
            share.backward()
            out[name] = {"loss": float(M.all_reduce_sum(share.detach())),
                         "grad": lg.grad.numpy()}
        out["acc"] = float(seg_losses.seg_accuracy(t["seg"], t["labels"]))
        lg = t["tokens"].clone().requires_grad_()
        share = masked_token_ce(lg, t["targets"], t["lengths"])
        share.backward()
        out["token_ce"] = {"loss": float(M.all_reduce_sum(share.detach())),
                           "grad": lg.grad.numpy()}
    out["rows"] = (rows.start, rows.stop)
    return out


def tp_case() -> dict:
    """On 4 ranks: `last_dim_spec` placements over a (2, 2) and a (4, 1)
    ('data', 'model') mesh, the placed values, and a product through the
    placed weight (DTensor ops) against the plain one."""
    from torch.distributed.tensor import distribute_tensor, Replicate

    from fudanocr_tpu_torch.parallel.tp import make_mesh, shard_params_tp

    g = torch.Generator().manual_seed(4)
    tree = {"linear.weight": torch.randn(8, 4, generator=g, dtype=F64),
            "linear.bias": torch.randn(8, generator=g, dtype=F64),
            "odd.weight": torch.randn(7, 4, generator=g, dtype=F64),
            "conv.weight": torch.randn(6, 3, 3, 3, generator=g, dtype=F64)}
    x = torch.randn(5, 4, generator=g, dtype=F64)
    out = {}
    for shape in ((2, 2), (4, 1)):
        mesh = make_mesh("cpu", data=shape[0], model=shape[1])
        placed = shard_params_tp(tree, mesh)
        w, b = placed["linear.weight"], placed["linear.bias"]
        xd = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        y = torch.nn.functional.linear(xd, w, b)
        out[shape] = {
            "placements": {k: [str(p) for p in v.placements]
                           for k, v in placed.items()},
            "local": {k: tuple(v.to_local().shape) for k, v in placed.items()},
            "equal": all(torch.equal(v.full_tensor(), tree[k])
                         for k, v in placed.items()),
            "y": y.full_tensor().numpy(),
            "want": torch.nn.functional.linear(x, tree["linear.weight"],
                                               tree["linear.bias"]).numpy()}
    return out


def tp_step_case(model_par: int = 2, placed: bool = True) -> dict:
    """TBSRN (sr_case's: no STN, 1 SRB, dropout on) with the text-focus
    loss, 2 steps of `make_sr_train_step` at global batch 4, Adam at eps 1.
    On 4 ranks: over a (data 4 / model_par, model model_par) mesh with the
    parameters placed (`parallel.tp.TensorParallel`), the batch cut along
    'data', "shards" this rank's placed parameters after the steps; not
    `placed`, on the data axis of `make_mesh_for_batch`. With no
    process group: one process on the global batch."""
    from fudanocr_tpu_torch.core import mesh as M
    from fudanocr_tpu_torch.losses.sr_losses import (TextFocusLoss,
                                                     encode_text_labels)
    from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
    from fudanocr_tpu_torch.models.sr import TBSRN
    from fudanocr_tpu_torch.parallel.tp import (TensorParallel, make_mesh,
                                                shard_params_tp)
    from fudanocr_tpu_torch.train.sr import make_sr_train_step
    from fudanocr_tpu_torch.train.state import AdamWithClip

    model = seeded(lambda: TBSRN(width=64, stn=False, srb_nums=1,
                                 dtype=F64).double())
    oracle = seeded(lambda: OCRTransformer(**ORACLE, dtype=F64), 2).double()
    randomize_bn(model)
    start = state_of(model)
    run, mesh, rows, tp = model, None, slice(None), None
    if M.world()[1] > 1 and placed:
        mesh = make_mesh("cpu", data=M.world()[1] // model_par,
                         model=model_par)
        run = tp = TensorParallel(model, mesh)
        rows = tp.data.rows(SR_B)
        want = shard_params_tp({k: v.detach() for k, v in
                                model.named_parameters()}, mesh)
        placed = tp.placed()
        placed_as_shard_params_tp = all(
            v.placements == want[k].placements and torch.equal(
                v.to_local(), want[k].to_local()) for k, v in placed.items())
    elif M.world()[1] > 1:
        mesh = M.make_mesh_for_batch(SR_B)
        rows = mesh.rows(SR_B)
    opt = AdamWithClip(run.parameters(), lr=1e-3, eps=1.0)
    step = make_sr_train_step(run, TextFocusLoss(oracle), opt, mesh=mesh)
    gen, steps = torch.Generator().manual_seed(5), []
    for hr, lr, labels in small_text_zoom(SR_SAMPLES, 0).batches(SR_B):
        ti, tg, ln = encode_text_labels(labels, 32)
        batch = {"hr": torch.from_numpy(np.asarray(hr, np.float64)[rows]),
                 "lr": torch.from_numpy(np.asarray(lr, np.float64)[rows]),
                 **{k: torch.from_numpy(np.asarray(v, np.int64)[rows])
                    for k, v in (("text_input", ti), ("text_gt", tg),
                                 ("lengths", ln))}}
        steps.append({k: float(v) for k, v in step(batch, gen).items()})
    out = {"steps": steps}
    if tp is not None:
        out["shards"] = {k: t.detach().numpy().copy()
                         for k, t in tp.local.items()}
        out["sharded"] = sorted(k for k, sp in tp.specs.items()
                                if sp[1].is_shard())
        out["model_index"] = tp.model.index
        out["placed_as_shard_params_tp"] = placed_as_shard_params_tp
        tp.write_back()
    out["state"] = state_of(model)
    out["moved"] = moved(start, model)
    return out


CASE_DIR = None   # the run's directory (main sets it): the witness's input


def witness_case() -> dict:
    """The port's TBSRN text-focus step (dropout off, Adam at lr = eps = 1)
    from the JAX variables and batch that tests/test_torch_distributed.py
    saved in CASE_DIR: this rank's rows, the step's metrics and the
    variables after it in JAX's layout."""
    from fudanocr_tpu_torch.core.mesh import make_mesh_for_batch, shard_batch
    from fudanocr_tpu_torch.losses.sr_losses import TextFocusLoss
    from fudanocr_tpu_torch.models.rec.ocr_transformer import OCRTransformer
    from fudanocr_tpu_torch.models.sr import TBSRN
    from fudanocr_tpu_torch.train.sr import make_sr_train_step
    from fudanocr_tpu_torch.train.state import AdamWithClip
    from fudanocr_tpu_torch.utils.weights import (load_jax_variables,
                                                  to_jax_variables)

    inp = torch.load(os.path.join(CASE_DIR, "witness_in.pt"),
                     weights_only=False)
    model = load_jax_variables(TBSRN(srb_nums=2), "tbsrn", inp["v"],
                               srb_nums=2)
    for m in model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    oracle = load_jax_variables(OCRTransformer(**inp["oracle_cfg"]),
                                "ocr_transformer", inp["ov"],
                                layers=inp["oracle_cfg"]["layers"])
    mesh = make_mesh_for_batch(len(inp["batch"]["hr"]))
    batch = {k: torch.from_numpy(v) for k, v in
             shard_batch(mesh, inp["batch"]).items()}
    for k in ("text_input", "text_gt", "lengths"):
        batch[k] = batch[k].long()
    step = make_sr_train_step(model, TextFocusLoss(oracle),
                              AdamWithClip(model.parameters(), lr=1.0,
                                           eps=1.0), mesh=mesh)
    got = step(batch, torch.Generator().manual_seed(0))
    return {"metrics": {k: float(v) for k, v in got.items()},
            "variables": to_jax_variables(model, "tbsrn", srb_nums=2),
            "mesh": (mesh.size, mesh.index)}


CASES = {"sr": sr_case, "stroke": lambda: sr_case(stroke=True),
         "seg": seg_case, "seg_det": lambda: seg_case(det=True),
         "seg_bucketed": lambda: seg_case(det=True, lovasz_impl="bucketed"),
         "sld": sld_case, "gan": gan_case, "mesh": mesh_case, "tp": tp_case,
         "tp_step": tp_step_case, "tp_model1": lambda: tp_step_case(1),
         "tp_data": lambda: tp_step_case(1, placed=False),
         "witness": witness_case}


def main(argv) -> int:
    global CASE_DIR
    rank, world, tmp, names = int(argv[0]), int(argv[1]), argv[2], argv[3]
    CASE_DIR = tmp
    torch.set_num_threads(1)
    from fudanocr_tpu_torch.core.mesh import setup_distributed
    import torch.distributed as dist

    setup_distributed("cpu", init_method=f"file://{tmp}/rendezvous",
                      world_size=world, rank=rank)
    out = {}
    for name in names.split(","):
        t0 = time.perf_counter()
        out[name] = CASES[name]()
        out[name]["seconds"] = time.perf_counter() - t0
        dist.barrier()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
