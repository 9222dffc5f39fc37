"""Adversarial SR training (port of fudanocr_tpu/train/gan.py; the ESRGAN
path of text-gestalt/model/esrgan.py).

Per batch, as the JAX trainer orders them (gan.py:60-117), first the
discriminator step and then the generator step:

* D minimises the real/fake BCE on its logits
  (`losses/aux_losses.gan_discriminator_loss`) of the HR batch and of the
  generator's SR image, made in inference mode and detached. Both D
  passes run in training mode (batch statistics); D's BatchNorm running
  statistics move with the HR pass only, as JAX keeps the mutation of
  that pass and drops the SR pass's;
* G minimises lambda_pix * L1(SR, HR) + lambda_adv * the non-saturating
  loss (`gan_generator_loss`) of the updated D, run in inference mode;
  G's BatchNorm statistics (SRResNet has some, RRDBNet none) move in its
  training forward; D receives no update.

Each net has its own Adam(lr, b1 0.9), no clip (optax.adam). The nets'
device; under a process group each rank of the trainer's mesh
(`core/mesh.make_mesh_for_batch`, the JAX trainer's data-sharded mesh)
holds its rows of each global batch, and both steps are the global
batch's (as train/sr.py): BatchNorm statistics and the losses' means are
global, and each step sums its own net's gradients over the ranks before
that net's Adam. Both nets are initialised from `rng`, a CPU
torch.Generator, the generator first (JAX draws them from PRNGKey(seed)
and seed + 1), by torch's default initialisers (`init_parameters`), so
the same seed gives the same weights on any device; the forwards' draws
(none in these nets) come from a device generator seeded from it.
"""

from __future__ import annotations

import contextlib
import logging
import math
from typing import Dict, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fudanocr_tpu_torch.core.mesh import (Mesh, all_reduce_grads,
                                          current, data_parallel,
                                          global_values, make_mesh_for_batch,
                                          mean_share, rank_batches)
from fudanocr_tpu_torch.losses.aux_losses import (gan_discriminator_loss,
                                                  gan_generator_loss)
from fudanocr_tpu_torch.train.state import AdamWithClip

log = logging.getLogger("fudanocr_tpu_torch.gan")


@torch.no_grad()
def init_parameters(module: nn.Module, rng: torch.Generator) -> nn.Module:
    """Redraw every parameter of `module` from `rng` (a CPU generator), in
    module order, as torch's defaults draw them: conv and linear weights
    and biases uniform in +-1/sqrt(fan_in), BatchNorm scale 1 and bias 0
    with statistics 0 and 1, PReLU 0.25. Other parameterised modules
    raise."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                          generator=rng))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)
        elif any(True for _ in m.parameters(recurse=False)):
            raise TypeError(f"init_parameters: no initialiser for "
                            f"{type(m).__name__}")
    return module


@contextlib.contextmanager
def bn_statistics_kept(module: nn.Module) -> Iterator[None]:
    """Training-mode forwards inside leave `module`'s BatchNorm running
    statistics as they were (flax: a mutation that is not kept)."""
    saved = [(b, b.running_mean.clone(), b.running_var.clone())
             for b in module.modules()
             if isinstance(b, nn.modules.batchnorm._BatchNorm)]
    try:
        yield
    finally:
        for b, mean, var in saved:
            b.running_mean.copy_(mean)
            b.running_var.copy_(var)


@contextlib.contextmanager
def frozen(module: nn.Module) -> Iterator[None]:
    """`module`'s parameters take no gradient inside."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class GANSRTrainer:
    """`generator` (an SR net, e.g. `models/sr/baselines.RRDBNet`) against
    `discriminator` (`SRDiscriminator`), both on one device, over
    `train_data.batches(batch_size)` of (hr, lr, labels), NHWC float numpy
    arrays in [0, 1]. `train()` returns the last iteration's
    {"d_loss", "pix", "g_adv"}. `mesh` (default
    `make_mesh_for_batch(batch_size)`) is the data axis; `batch_size` is
    the global batch."""

    def __init__(self, generator: nn.Module, discriminator: nn.Module,
                 train_data, batch_size: int = 16, g_lr: float = 1e-4,
                 d_lr: float = 1e-4, lambda_adv: float = 5e-3,
                 lambda_pix: float = 1.0, epochs: int = 1, seed: int = 0,
                 rng: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None):
        self.g, self.d = generator, discriminator
        self.train_data = train_data
        self.batch_size = batch_size
        self.epochs = epochs
        self.lambda_adv, self.lambda_pix = lambda_adv, lambda_pix
        rng = rng if rng is not None else torch.Generator().manual_seed(seed)
        init_parameters(generator, rng)
        init_parameters(discriminator, rng)
        self.device = next(generator.parameters()).device
        self.mesh = mesh or make_mesh_for_batch(batch_size)
        self.draws = torch.Generator(self.device).manual_seed(int(
            torch.randint(2 ** 62, (1,), generator=rng)))
        self.g_opt = AdamWithClip(generator.parameters(), g_lr, beta1=0.9,
                                  clip=None)
        self.d_opt = AdamWithClip(discriminator.parameters(), d_lr,
                                  beta1=0.9, clip=None)

    def d_step(self, lr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        """One discriminator update; returns its loss (a device tensor).
        On the mesh, lr and hr are this rank's rows and the loss is the
        global batch's."""
        with data_parallel(self.mesh):
            with torch.no_grad():
                sr = self.g(lr)
            self.d_opt.zero_grad()
            real = self.d(hr, train=True, generator=self.draws)
            with bn_statistics_kept(self.d):
                fake = self.d(sr, train=True, generator=self.draws)
            loss = gan_discriminator_loss(real, fake)
            loss.backward()
            all_reduce_grads(self.d_opt.params, self.mesh)
            self.d_opt.step()
            return global_values({"d": loss.detach()})["d"]

    def g_step(self, lr: torch.Tensor, hr: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """One generator update against the current discriminator; returns
        {"pix", "g_adv"} (device tensors; the global batch's on the
        mesh). pix is a float32 mean, as JAX casts SR and HR to it."""
        with data_parallel(self.mesh):
            self.g_opt.zero_grad()
            sr = self.g(lr, train=True, generator=self.draws)
            with frozen(self.d):
                adv = gan_generator_loss(self.d(sr))
            pix = (F.l1_loss(sr.float(), hr.float()) if current() is None
                   else mean_share((sr.float() - hr.float()).abs()))
            (self.lambda_pix * pix + self.lambda_adv * adv).backward()
            all_reduce_grads(self.g_opt.params, self.mesh)
            self.g_opt.step()
            return global_values({"pix": pix.detach(), "g_adv": adv.detach()})

    def train(self) -> Dict[str, float]:
        last: Dict[str, float] = {}
        if not self.mesh.active:
            return last
        for _ in range(self.epochs):
            for hr, lr, _ in rank_batches(self.train_data, self.batch_size,
                                          self.mesh):
                hr_t, lr_t = (torch.from_numpy(a).float().to(self.device)
                              for a in (hr, lr))
                d_loss = self.d_step(lr_t, hr_t)
                aux = self.g_step(lr_t, hr_t)
                last = {"d_loss": float(d_loss),
                        **{k: float(v) for k, v in aux.items()}}
        log.info("gan train done: %s", last)
        return last
