"""ASTER's attention recognition head (port of
fudanocr_tpu/models/rec/aster_head.py; reference scene-text-telescope/
model/attention_recognition_head.py:10-181).

A GRU decoder attends over the (B, T, D) encoder sequence with an
additive attention unit (tanh(x W_x + s W_s) -> a scalar per step, a
softmax over T in float32), embeds the previous symbol, and emits each
step's class logits. The last embedding row, index `num_classes`, is
<BOS>. Three decodes, as in JAX:

* `forward(x, targets)`: teacher forcing, (B, L) targets -> (B, L, C);
* `sample(x)`: greedy, `max_len` steps -> ids and their probabilities
  (both decodes run without autograd);
* `beam_search(x, beam_width, eos)`: JAX's dense beam search, only beam
  0 of each image alive at the start, a finished beam keeping its score
  and emitting `eos` again; every step keeps the `beam_width` best of
  beam x class candidates in JAX's `lax.top_k` order (ties to the lower
  flat index, by a stable sort), all `max_len` steps run, and the best
  beam is the first of the highest final scores.

Module names follow the reference (`decoder.attention_unit.{xEmbed,
sEmbed, wEmbed}`, `decoder.tgt_embedding`, `decoder.gru`, `decoder.fc`),
which `utils/porters.port_aster_head` reads; the step computes the GRU
cell from `decoder.gru`'s weights (torch's gate order r, z, n). No JAX
entry point calls the head; no kernel runs in it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class AttentionUnit(nn.Module):
    def __init__(self, s_dim: int, x_dim: int, att_dim: int):
        super().__init__()
        self.sEmbed = nn.Linear(s_dim, att_dim)
        self.xEmbed = nn.Linear(x_dim, att_dim)
        self.wEmbed = nn.Linear(att_dim, 1)


class DecoderUnit(nn.Module):
    def __init__(self, s_dim: int, x_dim: int, y_dim: int, att_dim: int):
        super().__init__()
        self.attention_unit = AttentionUnit(s_dim, x_dim, att_dim)
        self.tgt_embedding = nn.Embedding(y_dim + 1, att_dim)
        self.gru = nn.GRU(x_dim + att_dim, s_dim, batch_first=True)
        self.fc = nn.Linear(s_dim, y_dim)


class ASTERAttentionHead(nn.Module):
    def __init__(self, num_classes: int, in_planes: int = 512,
                 s_dim: int = 512, att_dim: int = 512, max_len: int = 100):
        super().__init__()
        self.num_classes, self.s_dim, self.max_len = (num_classes, s_dim,
                                                      max_len)
        self.decoder = DecoderUnit(s_dim, in_planes, num_classes, att_dim)
        self.jax_porter = ("aster_head", {})

    def _step(self, x: torch.Tensor, x_proj: torch.Tensor,
              state: torch.Tensor, y_prev: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decoder step -> (logits (B, C), new state (B, S))."""
        d = self.decoder
        att = d.attention_unit
        e = att.wEmbed(torch.tanh(x_proj + att.sEmbed(state)[:, None]))[..., 0]
        alpha = torch.softmax(e.float(), dim=-1).to(x.dtype)
        context = torch.einsum("bt,btd->bd", alpha, x)
        inp = torch.cat([d.tgt_embedding(y_prev), context], dim=-1)
        g = d.gru
        xr, xz, xn = F.linear(inp, g.weight_ih_l0, g.bias_ih_l0).chunk(3, -1)
        hr, hz, hn = F.linear(state, g.weight_hh_l0,
                              g.bias_hh_l0).chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        new_state = (1.0 - z) * n + z * state
        return d.fc(new_state), new_state

    def _start(self, x: torch.Tensor):
        b = x.shape[0]
        return (self.decoder.attention_unit.xEmbed(x),
                x.new_zeros(b, self.s_dim),
                torch.full((b,), self.num_classes, dtype=torch.long,
                           device=x.device))

    def forward(self, x: torch.Tensor, targets: torch.Tensor
                ) -> torch.Tensor:
        """Teacher-forced: (B, T, D) features, (B, L) targets -> (B, L, C);
        step t reads target t - 1 (<BOS> at 0)."""
        x_proj, state, y = self._start(x)
        outs = []
        for t in range(targets.shape[1]):
            out, state = self._step(x, x_proj, state, y)
            outs.append(out)
            y = targets[:, t].long()
        return torch.stack(outs, 1)

    @torch.no_grad()
    def sample(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decode -> (ids (B, max_len), probabilities (B, max_len))."""
        x_proj, state, y = self._start(x)
        ids, scores = [], []
        for _ in range(self.max_len):
            out, state = self._step(x, x_proj, state, y)
            probs = torch.softmax(out.float(), dim=-1)
            y = probs.argmax(dim=-1)        # the first maximum, as JAX's
            ids.append(y)
            scores.append(probs.amax(dim=-1))
        return torch.stack(ids, 1), torch.stack(scores, 1)

    @torch.no_grad()
    def beam_search(self, x: torch.Tensor, beam_width: int, eos: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (the best beam's ids (B, max_len), its score (B,), the summed
        log-probabilities)."""
        b, k, c = x.shape[0], beam_width, self.num_classes
        dev = x.device
        xk = x.repeat_interleave(k, dim=0)
        x_proj, state, y = self._start(xk)
        alive0 = torch.arange(b * k, device=dev) % k == 0
        seq = torch.where(alive0, 0.0, float("-inf")).to(torch.float32)
        tokens = torch.zeros(b * k, self.max_len, dtype=torch.long,
                             device=dev)
        finished = torch.zeros(b * k, dtype=torch.bool, device=dev)
        pos = (torch.arange(b, device=dev) * k)[:, None]
        eos_only = torch.where(torch.arange(c, device=dev) == eos, 0.0,
                               float("-inf"))
        for i in range(self.max_len):
            out, new_state = self._step(xk, x_proj, state, y)
            logp = torch.log_softmax(out.float(), dim=-1)
            step = torch.where(finished[:, None], eos_only[None], logp)
            cand = (seq[:, None] + step).reshape(b, k * c)
            # lax.top_k's order: descending, ties to the lower index
            top, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
            top, idx = top[:, :k], idx[:, :k]
            sym = (idx % c).reshape(b * k)
            pred = (idx // c + pos).reshape(b * k)
            state = new_state[pred]
            tokens = tokens[pred]
            tokens[:, i] = sym
            finished = finished[pred] | (sym == eos)
            seq = top.reshape(b * k)
            y = sym
        seq = seq.reshape(b, k)
        best = seq.argmax(dim=-1)
        rows = torch.arange(b, device=dev)
        return (tokens.reshape(b, k, self.max_len)[rows, best],
                seq[rows, best])
