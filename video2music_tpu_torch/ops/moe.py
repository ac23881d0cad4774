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
the balancing bias and then moves it (:294-296).

The options of the JAX module:
  * the top-k scheduler (``topk_schedule``, :186-202): a training call
    routes to k = max(k_min, E - (step + 1) // topk_update_step) experts
    and steps once; eval routes to k_min. The step is a host int (choosing
    k needs no device read), mirrored into the ``sched_step`` buffer so the
    state dict carries it;
  * the routing temperature schedule (``temperature_schedule``,
    :213-230): the softmax over the selected logits divides by t = min(
    t_min + step * t_step, t_max), the step counted before use; a training
    call steps and keeps it (``temp_step``), and with a shared expert an
    eval call uses the next step too without keeping it (the JAX quirk:
    the SharedMoE scheduler steps in eval, where the JAX eval step drops
    the mutated state);
  * ``dispatch="capacity"`` (:304-343): per expert a buffer of
    ceil(T k / E * capacity_factor) token slots, filled in token order,
    the assignments past it dropped; each expert runs once over its
    buffer. An annealing top-k scheduler in training routes densely, as
    in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.config import MoEConfig

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
        if cfg.dispatch not in ("dense", "capacity"):
            raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}")
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
        # the schedules' steps: host ints, mirrored into int32 buffers
        self.steps = {}
        for name, on in (("sched_step", cfg.topk_schedule),
                         ("temp_step", cfg.temperature_schedule)):
            if on:
                self.steps[name] = 0
                self.register_buffer(name, torch.zeros((), dtype=torch.int32))
        # the last training call's load metrics (E,) and ()
        self.expert_counts = self.maxvio = None

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        """A state dict without a schedule's step (a JAX param tree bridged
        without its "moe_state") starts that step at 0, the JAX init; a
        loaded step also sets the host int."""
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)
        for name in self.steps:
            key = prefix + name
            if key in state_dict:
                self.steps[name] = int(state_dict[key])
            else:
                if key in missing_keys:
                    missing_keys.remove(key)
                self.set_step(name, 0)

    def set_step(self, name: str, value: int) -> None:
        """Set a schedule's step (host int and buffer)."""
        self.steps[name] = int(value)
        getattr(self, name).fill_(int(value))

    def _advance(self, name: str) -> int:
        """Step a schedule: the new count (the buffer written without a
        host sync)."""
        self.set_step(name, self.steps[name] + 1)
        return self.steps[name]

    def _top_k(self, training: bool) -> int:
        """k of this call: the top-k scheduler's in a training call (which
        steps it), else the floor k."""
        cfg = self.cfg
        if not (training and cfg.topk_schedule):
            return self.k
        step = self.steps["sched_step"]
        self._advance("sched_step")
        return max(cfg.n_experts_per_token,
                   cfg.n_experts - (step + 1) // cfg.topk_update_step)

    def _temperature(self, training: bool):
        """The routing softmax's divisor of this call, or None."""
        cfg = self.cfg
        if not cfg.temperature_schedule or not (training
                                                or cfg.shared_expert):
            return None
        step = (self._advance("temp_step") if training
                else self.steps["temp_step"] + 1)
        t = min(float(np.float32(cfg.temperature_min)
                      + np.float32(step) * np.float32(cfg.temperature_step)),
                cfg.temperature_max)
        return float(np.float32(t))

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

    def _per_expert(self, buf, generator):
        """A dispatch buffer (E, C, D) through its experts -> (E, C, D)."""
        if self.cfg.expert == "kan":
            return torch.stack([kan(buf[e]) for e, kan in enumerate(self.kan)])
        hg = torch.einsum("ecd,egd->ecg", buf, self.w1g) + self.b1g[:, None]
        h = self._act(hg, generator)
        return torch.einsum("ecf,edf->ecd", h, self.w2) + self.b2[:, None]

    def _capacity(self, x, logits, select, t_div, generator):
        """The capacity dispatch: (out (B, L, D), selected (B, L, E))."""
        B, L, D = x.shape
        E, k = self.cfg.n_experts, self.k
        T = B * L
        cap = max(1, math.ceil(T * k / E * self.cfg.capacity_factor))
        idx = torch.argsort(-select.reshape(T, E), dim=-1,
                            stable=True)[:, :k]                   # (T, k)
        gsel = logits.reshape(T, E).gather(-1, idx)
        if t_div is not None:
            gsel = gsel / t_div
        w = torch.softmax(gsel, dim=-1).reshape(-1)               # (T k,)
        flat_e = idx.reshape(-1)
        flat_tok = torch.arange(T, device=x.device).repeat_interleave(k)
        onehot = F.one_hot(flat_e, E)
        # each assignment's slot: the earlier assignments to its expert
        pos = ((onehot.cumsum(0) - onehot) * onehot).sum(1)
        keep = pos < cap
        slot = pos.clamp(max=cap - 1)
        xf = x.reshape(T, D)
        buf = x.new_zeros(E * cap, D).index_add_(
            0, flat_e * cap + slot, xf[flat_tok] * keep[:, None].to(x.dtype))
        out_e = dropout(self._per_expert(buf.view(E, cap, D), generator),
                        self.dropout_rate, generator)
        gathered = out_e[flat_e, slot]
        comb = (w.to(out_e.dtype) * keep.to(out_e.dtype))[:, None]
        out = out_e.new_zeros(T, D).index_add_(0, flat_tok, gathered * comb)
        selected = F.one_hot(idx, E).sum(1).bool().view(B, L, E)
        return out.view(B, L, D), selected

    def forward(self, x, generator=None):
        """generator: a torch.Generator on x's device makes this a training
        call (dropout, load metrics, balancing, the schedules' steps)."""
        training = generator is not None
        logits = self.gate(x).float()  # (B, L, E)
        E = logits.shape[-1]
        k = self._top_k(training)
        t_div = self._temperature(training)
        select = logits
        if training and self.cfg.balancing:
            select = logits + self.balance_bias
        gather = (not training and x.shape[0] * x.shape[1] == 1
                  and self.k < E and self.cfg.expert != "kan")
        if gather:
            # descending order, ties to the first index (stable, as
            # jnp.argsort and lax.top_k)
            idx = torch.argsort(-select.reshape(E), stable=True)[:k]
            gsel = logits.reshape(E)[idx]
            if t_div is not None:
                gsel = gsel / t_div
            w = torch.softmax(gsel, dim=-1).to(x.dtype)
            out = (w[:, None] * self._experts(x, idx)).sum(0).view_as(x)
        elif self.cfg.dispatch == "capacity" and not (
                training and self.cfg.topk_schedule):
            out, selected = self._capacity(x, logits, select, t_div,
                                           generator)
        else:
            order = torch.argsort(-select, dim=-1, stable=True)
            selected = torch.argsort(order, dim=-1, stable=True) < k
            masked = logits.masked_fill(~selected, float("-inf"))
            if t_div is not None:
                masked = masked / t_div
            w = torch.softmax(masked, dim=-1).to(x.dtype)
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
