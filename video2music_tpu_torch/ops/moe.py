"""SharedMoE feed-forward at eval (counterpart of ops/moe.py:MoELayer with
GLU experts and the shared expert).

Semantics kept: top-k over the raw gate logits with the first index
winning a tie, softmax over the selected raw logits, the shared expert
divided by k. A sequence routes densely (every expert computes every
token, combined with zero weight where unselected, ops/moe.py:265-290);
one token gathers only its k experts (ops/moe.py:250-258). Training-time
machinery (balancing updates, the top-k scheduler, dropout, load metrics)
is not ported: at eval the scheduler uses its floor k and balancing does
not touch the output.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from video2music_tpu.core.config import MoEConfig

from .attention import not_ported


class SwiGLU(nn.Module):
    """h * silu(g) feed-forward. ``w1g`` rows are [linear1; gate] (2F, D)."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.d_ff = d_ff
        self.w1g = nn.Linear(d_model, 2 * d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x):
        h, g = self.w1g(x).split(self.d_ff, dim=-1)
        return self.linear2(h * F.silu(g))


class SharedMoE(nn.Module):
    """Experts stacked as w1g (E, 2F, D) = [w1; wg] rows, b1g (E, 2F),
    w2 (E, D, F), b2 (E, D); plus ``gate`` (E, D) and the ``shared``
    SwiGLU."""

    def __init__(self, cfg: MoEConfig, d_model: int, d_ff: int):
        super().__init__()
        if cfg.expert != "glu" or not cfg.shared_expert:
            raise not_ported(f"{cfg.expert!r} experts without the shared one",
                             "Queue 1, variant wirings")
        if cfg.temperature_schedule:
            raise not_ported("the routing temperature schedule",
                             "Queue 1, variant wirings")
        E = cfg.n_experts
        self.k = cfg.n_experts_per_token
        self.d_ff = d_ff
        self.gate = nn.Linear(d_model, E)
        self.w1g = nn.Parameter(torch.zeros(E, 2 * d_ff, d_model))
        self.b1g = nn.Parameter(torch.zeros(E, 2 * d_ff))
        self.w2 = nn.Parameter(torch.zeros(E, d_model, d_ff))
        self.b2 = nn.Parameter(torch.zeros(E, d_model))
        self.shared = SwiGLU(d_model, d_ff)

    def _experts(self, x, idx=None):
        """x (..., D) through every expert (..., E, D), or through the
        experts idx (K,) for a single token -> (K, D)."""
        F_ = self.d_ff
        if idx is None:
            hg = torch.einsum("...d,efd->...ef", x, self.w1g) + self.b1g
            h, g = hg.split(F_, dim=-1)
            return torch.einsum("...ef,edf->...ed", h * F.silu(g),
                                self.w2) + self.b2
        hg = torch.einsum("d,kfd->kf", x.reshape(-1), self.w1g[idx]) \
            + self.b1g[idx]
        h, g = hg.split(F_, dim=-1)
        return torch.einsum("kf,kdf->kd", h * F.silu(g), self.w2[idx]) \
            + self.b2[idx]

    def forward(self, x):
        logits = self.gate(x).float()  # (B, L, E)
        E, k = logits.shape[-1], self.k
        # descending order, ties to the first index (stable, as jnp.argsort
        # and lax.top_k)
        order = torch.argsort(-logits, dim=-1, stable=True)
        if x.shape[0] * x.shape[1] == 1 and k < E:
            idx = order.reshape(E)[:k]
            w = torch.softmax(logits.reshape(E)[idx], dim=-1).to(x.dtype)
            out = (w[:, None] * self._experts(x, idx)).sum(0).view_as(x)
        else:
            selected = torch.argsort(order, dim=-1, stable=True) < k
            w = torch.softmax(logits.masked_fill(~selected, float("-inf")),
                              dim=-1).to(x.dtype)
            out = torch.einsum("ble,bled->bld", w, self._experts(x))
        return out + self.shared(x) / k
