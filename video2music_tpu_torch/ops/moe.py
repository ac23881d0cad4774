"""MoE feed-forward (counterpart of ops/moe.py:MoELayer), at eval and in a
training call, with GLU (SwiGLU), SiLU-MLP or KAN experts, with or without
the shared expert.

Semantics kept: top-k over the gate logits with the first index winning a
tie, softmax over the selected raw logits, the shared expert divided by k.
A sequence routes densely (every expert computes every token, combined with
zero weight where unselected, ops/moe.py:265-290); one token at eval
gathers only its k experts (ops/moe.py:250-258), except with KAN experts,
which always route densely (:242). A training call (a ``generator`` given)
adds the JAX module's dropout inside the GLU and MLP experts (:66, :93,
:121) and on the expert outputs (:282), records the step's
``expert_counts`` and ``maxvio``, and, with ``cfg.balancing``, selects with
the balancing bias and then moves it (:294-296). Not ported, and raising:
the capacity dispatch, the top-k scheduler in training, the temperature
schedule (ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..core.config import MoEConfig

from .attention import not_ported
from .dropout import dropout
from .kan import KANLinear


class SwiGLU(nn.Module):
    """h * silu(g) feed-forward, dropout on h before ``linear2`` in a
    training call (models/layers.py:88). ``w1g`` rows are [linear1; gate]
    (2F, D)."""

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_ff = d_ff
        self.dropout_rate = dropout_rate
        self.w1g = nn.Linear(d_model, 2 * d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x, generator=None):
        h, g = self.w1g(x).split(self.d_ff, dim=-1)
        return self.linear2(dropout(h * F.silu(g), self.dropout_rate,
                                    generator))


class SiLUMLP(nn.Module):
    """One SiLU-MLP expert D -> Fe -> D (the V1 shared expert): ``w1g``
    (Fe, D), ``linear2`` (D, Fe), the names of :class:`SwiGLU` so the
    decode packs read both alike."""

    def __init__(self, d_model: int, d_hidden: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.w1g = nn.Linear(d_model, d_hidden)
        self.linear2 = nn.Linear(d_hidden, d_model)

    def forward(self, x, generator=None):
        return self.linear2(dropout(F.silu(self.w1g(x)), self.dropout_rate,
                                    generator))


class KANExpert(KANLinear):
    """One KANLinear(D, D) expert (the V2.3 expert), no dropout."""

    def __init__(self, d_model: int):
        super().__init__(d_model, d_model)

    def forward(self, x, generator=None):
        return super().forward(x)


class MoELayer(nn.Module):
    """Top-k MoE. GLU experts: w1g (E, 2F, D) = [w1; wg] rows, b1g (E, 2F),
    w2 (E, D, F), b2 (E, D); MLP experts (hidden Fe = 2D): w1g (E, Fe, D),
    b1g (E, Fe), w2 (E, D, Fe), b2; KAN experts: ``kan`` (E KANExperts).
    Plus ``gate`` (E, D) and, with ``cfg.shared_expert``, the ``shared``
    expert of the same kind (SwiGLU, SiLUMLP or KANExpert)."""

    def __init__(self, cfg: MoEConfig, d_model: int, d_ff: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        if cfg.expert not in ("glu", "mlp", "kan"):
            raise ValueError(f"unknown expert type {cfg.expert!r}")
        if cfg.temperature_schedule:
            raise not_ported("the routing temperature schedule",
                             "Queue 1 item 10")
        if cfg.dispatch != "dense":
            raise not_ported(f"the {cfg.dispatch!r} MoE dispatch",
                             "Queue 1 item 10")
        E = cfg.n_experts
        self.cfg = cfg
        self.k = cfg.n_experts_per_token
        self.dropout_rate = dropout_rate
        self.gate = nn.Linear(d_model, E)
        if cfg.expert == "kan":
            self.kan = nn.ModuleList(KANExpert(d_model) for _ in range(E))
            shared = lambda: KANExpert(d_model)
        else:
            glu = cfg.expert == "glu"
            # the hidden width of one expert; a GLU expert projects twice
            self.d_ff = d_ff if glu else 2 * d_model
            G = 2 * self.d_ff if glu else self.d_ff
            self.w1g = nn.Parameter(torch.zeros(E, G, d_model))
            self.b1g = nn.Parameter(torch.zeros(E, G))
            self.w2 = nn.Parameter(torch.zeros(E, d_model, self.d_ff))
            self.b2 = nn.Parameter(torch.zeros(E, d_model))
            shared = (lambda: SwiGLU(d_model, d_ff, dropout_rate)) if glu \
                else (lambda: SiLUMLP(d_model, self.d_ff, dropout_rate))
        self.shared = shared() if cfg.shared_expert else None
        if cfg.balancing:
            # the JAX module's "moe_state" balance_bias: moves in training
            # calls, selects only in training calls
            self.register_buffer("balance_bias", torch.zeros(E))
        # the last training call's load metrics (E,) and ()
        self.expert_counts = self.maxvio = None

    def _act(self, hg, generator):
        if self.cfg.expert == "glu":
            h, g = hg.split(self.d_ff, dim=-1)
            hg = h * F.silu(g)
        else:
            hg = F.silu(hg)
        return dropout(hg, self.dropout_rate, generator)

    def _experts(self, x, idx=None, generator=None):
        """x (..., D) through every expert (..., E, D), or through the
        experts idx (K,) for a single token -> (K, D)."""
        if self.cfg.expert == "kan":
            return torch.stack([kan(x) for kan in self.kan], dim=-2)
        if idx is None:
            hg = torch.einsum("...d,egd->...eg", x, self.w1g) + self.b1g
            h = self._act(hg, generator)
            return torch.einsum("...ef,edf->...ed", h, self.w2) + self.b2
        hg = torch.einsum("d,kgd->kg", x.reshape(-1), self.w1g[idx]) \
            + self.b1g[idx]
        return torch.einsum("kf,kdf->kd", self._act(hg, None), self.w2[idx]) \
            + self.b2[idx]

    def forward(self, x, generator=None):
        """generator: a torch.Generator on x's device makes this a training
        call (dropout, load metrics, balancing)."""
        training = generator is not None
        if training and self.cfg.topk_schedule:
            raise not_ported("training with the top-k scheduler",
                             "Queue 1 item 10")
        logits = self.gate(x).float()  # (B, L, E)
        E, k = logits.shape[-1], self.k
        select = logits
        if training and self.cfg.balancing:
            select = logits + self.balance_bias
        # descending order, ties to the first index (stable, as jnp.argsort
        # and lax.top_k)
        order = torch.argsort(-select, dim=-1, stable=True)
        if (not training and x.shape[0] * x.shape[1] == 1 and k < E
                and self.cfg.expert != "kan"):
            idx = order.reshape(E)[:k]
            w = torch.softmax(logits.reshape(E)[idx], dim=-1).to(x.dtype)
            out = (w[:, None] * self._experts(x, idx)).sum(0).view_as(x)
        else:
            selected = torch.argsort(order, dim=-1, stable=True) < k
            w = torch.softmax(logits.masked_fill(~selected, float("-inf")),
                              dim=-1).to(x.dtype)
            experts = dropout(self._experts(x, generator=generator),
                              self.dropout_rate, generator)
            out = torch.einsum("ble,bled->bld", w, experts)
            if training:
                self._record_load(selected)
        if self.shared is not None:
            out = out + self.shared(x, generator) / k
        return out

    @torch.no_grad()
    def _record_load(self, selected):
        counts = selected.sum(dim=(0, 1)).float()
        mean = counts.mean()
        self.expert_counts = counts
        self.maxvio = (counts.max() - mean.clamp(min=1e-6)) \
            / mean.clamp(min=1e-6)
        if self.cfg.balancing:
            self.balance_bias += self.cfg.balancing_update_rate \
                * (mean - counts)
