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
the balancing bias and then moves it (:294-296). An eval call given the
tokens' dominant-emotion ids (``emotion_ids``, asked for by the model's
caller: models/amt.py ``count_emotions``) records its ``expert_counts``
and ``maxvio`` too and adds its selections per (emotion, expert) to
``expert_emotion_counts`` (6, E), over the first min(L, L') positions
(:308-320); no other call counts, so the serving and train paths launch
nothing more.

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

Sharded (parallel/shard.py sets ``tp``, the model group, and cuts the
weights): the expert stacks split on E (expert parallelism) where the
model axis divides E, else, under tensor parallelism, on their inner
d_ff (``b2`` then added by model rank 0 alone, through *f*). The router
stays replicated: each rank computes its experts for every token, the
gate logits and the tokens enter the expert region through *f* and the
partial combine leaves through *g* (or a reduce-scatter along a
sequence-sharded stream). SwiGLU and SiLU-MLP feed-forwards (and shared
experts) split their hidden columns the same way. The capacity dispatch
fills the global token order: each data rank's slots start after the
earlier ranks' assignments and the capacity counts the global tokens.
The load counts that move ``balance_bias`` and the emotion counts are
summed over the data group, so every rank moves it as the unsharded step
does. Each dropout draws the unsharded tensor and keeps its slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.config import MoEConfig

from ..parallel.comm import (all_gather, all_reduce, copy_to, enter,
                             reduce_out, whole_out)
from .dropout import batch_span, dropout
from .kan import KANLinear


def hidden_origin(module, x, width_global: int, first: int = 0):
    """The dropout origin of a (B, ..., F_local) hidden of ``module``
    computed from ``x`` (B, ..., D): the batch shard, whole middle dims,
    the columns [first, first + F_local) of ``width_global``; None
    unsharded."""
    if getattr(module, "mesh", None) is None:
        return None
    return ([batch_span(module, x.shape[0])]
            + [(0, n) for n in x.shape[1:-1]] + [(first, width_global)])


def row_parallel_out(linear: nn.Linear, h, tp, seq):
    """``linear`` of a hidden h: whole, or under tensor parallelism the
    row-parallel product of this rank's columns summed over ``tp`` (a
    reduce-scatter along a sequence-sharded stream) plus the bias."""
    if tp is None:
        return whole_out(linear(h), seq)
    return reduce_out(F.linear(h, linear.weight), tp, seq, linear.bias)


class _Hidden(nn.Module):
    """Shared state of the two-matrix feed-forwards: the hidden width
    (local under tensor parallelism) and the shard's place."""

    def _shard_init(self, d_ff: int):
        self.d_ff = d_ff
        self.tp = None          # the model group when the columns split
        self.ff0 = 0            # first local hidden column
        self.d_ff_global = d_ff
        self.mesh = None


class SwiGLU(_Hidden):
    """h * silu(g) feed-forward, dropout on h before ``linear2`` in a
    training call (models/layers.py:88). ``w1g`` rows are [linear1; gate]
    (2F, D); under tensor parallelism this rank's rows of each block."""

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0):
        super().__init__()
        self._shard_init(d_ff)
        self.dropout_rate = dropout_rate
        self.w1g = nn.Linear(d_model, 2 * d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x, generator=None, seq=None):
        x = enter(x, self.tp, seq)
        h, g = self.w1g(x).split(self.d_ff, dim=-1)
        h = dropout(h * F.silu(g), self.dropout_rate, generator,
                    hidden_origin(self, x, self.d_ff_global, self.ff0))
        return row_parallel_out(self.linear2, h, self.tp, seq)


class SiLUMLP(_Hidden):
    """One SiLU-MLP expert D -> Fe -> D (the V1 shared expert): ``w1g``
    (Fe, D), ``linear2`` (D, Fe), the names of :class:`SwiGLU` so the
    decode packs read both alike."""

    def __init__(self, d_model: int, d_hidden: int, dropout_rate: float = 0.0):
        super().__init__()
        self._shard_init(d_hidden)
        self.dropout_rate = dropout_rate
        self.w1g = nn.Linear(d_model, d_hidden)
        self.linear2 = nn.Linear(d_hidden, d_model)

    def forward(self, x, generator=None, seq=None):
        x = enter(x, self.tp, seq)
        h = dropout(F.silu(self.w1g(x)), self.dropout_rate, generator,
                    hidden_origin(self, x, self.d_ff_global, self.ff0))
        return row_parallel_out(self.linear2, h, self.tp, seq)


class KANExpert(KANLinear):
    """One KANLinear(D, D) expert (the V2.3 expert), no dropout."""

    def __init__(self, d_model: int):
        super().__init__(d_model, d_model)

    def forward(self, x, generator=None, seq=None):
        return whole_out(super().forward(enter(x, None, seq)), seq)


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
        # the last recorded call's load metrics (E,) and (); the counting
        # eval calls' selections by dominant emotion (6, E), summed
        self.expert_counts = self.maxvio = None
        self.expert_emotion_counts = None
        # sharding (parallel/shard.py): the model group when the expert
        # stacks split, how ("ep" on E, "inner" on d_ff), the local experts
        # [e0, e0 + n_local) and hidden columns from ff0; the mesh
        self.tp = self.split = None
        self.e0, self.n_local = 0, E
        self.ff0 = 0
        self.d_ff_global = getattr(self, "d_ff", None)
        self.mesh = None

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

    def _origin(self, lead, width_global: int, first: int,
                experts_first: bool = False):
        """Dropout origin of a (*lead, E_local, width) tensor, or with
        ``experts_first`` an (E_local, *lead, width) one: ``lead`` the
        (offset, global size) of the token or slot dimensions, then this
        rank's experts and columns [first, ...) of ``width_global``; None
        unsharded."""
        if self.mesh is None:
            return None
        e, w = (self.e0, self.cfg.n_experts), (first, width_global)
        return [e, *lead, w] if experts_first else [*lead, e, w]

    def _tokens(self, x):
        """The (offset, global size) of x's (B, ..., D) token dimensions."""
        return [batch_span(self, x.shape[0])] + [(0, n)
                                                 for n in x.shape[1:-1]]

    def _b2(self):
        """b2, added by model rank 0 alone when the inner d_ff splits
        (through *f*, so every rank holds its summed gradient)."""
        if self.split != "inner":
            return self.b2
        b2 = copy_to(self.b2, self.tp)
        return b2 if self.tp.rank == 0 else b2 * 0.0

    def _act(self, hg, generator, origin=None):
        if self.cfg.expert == "glu":
            h, g = hg.split(self.d_ff, dim=-1)
            hg = h * F.silu(g)
        else:
            hg = F.silu(hg)
        return dropout(hg, self.dropout_rate, generator, origin)

    def _experts(self, x, idx=None, generator=None):
        """x (..., D) through every (local) expert (..., E, D), or through
        the experts idx (K,) for a single token -> (K, D)."""
        if self.cfg.expert == "kan":
            return torch.stack([kan(x) for kan in self.kan], dim=-2)
        if idx is None:
            hg = torch.einsum("...d,egd->...eg", x, self.w1g) + self.b1g
            h = self._act(hg, generator, self._origin(
                self._tokens(x), self.d_ff_global, self.ff0))
            return torch.einsum("...ef,edf->...ed", h, self.w2) + self._b2()
        hg = torch.einsum("d,kgd->kg", x.reshape(-1), self.w1g[idx]) \
            + self.b1g[idx]
        return torch.einsum("kf,kdf->kd", self._act(hg, None), self.w2[idx]) \
            + self.b2[idx]

    def _per_expert(self, buf, generator):
        """A dispatch buffer (E, C, D) through its experts -> (E, C, D)."""
        if self.cfg.expert == "kan":
            return torch.stack([kan(buf[e]) for e, kan in enumerate(self.kan)])
        hg = torch.einsum("ecd,egd->ecg", buf, self.w1g) + self.b1g[:, None]
        h = self._act(hg, generator, self._origin(
            [(0, buf.shape[1])], self.d_ff_global, self.ff0,
            experts_first=True))
        return torch.einsum("ecf,edf->ecd", h, self.w2) + self._b2()[:, None]

    def _capacity(self, x, logits, select, t_div, generator):
        """The capacity dispatch: (out (B, L, D), selected (B, L, E)),
        the slots numbered in the global token order, this rank's
        experts' part of the combine."""
        B, L, D = x.shape
        E, k = self.cfg.n_experts, self.k
        T = B * L
        data = None if self.mesh is None else self.mesh.data
        Tg = T * (1 if data is None else data.size)
        cap = max(1, math.ceil(Tg * k / E * self.cfg.capacity_factor))
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
        # (on earlier data ranks too)
        pos = ((onehot.cumsum(0) - onehot) * onehot).sum(1)
        if data is not None and data.size > 1:
            before = all_gather(onehot.sum(0)[None], data)[:data.rank]
            pos = pos + before.sum(0)[flat_e]
        keep = pos < cap
        slot = pos.clamp(max=cap - 1)
        # this rank's experts' assignments
        le = flat_e - self.e0
        keep = keep & (le >= 0) & (le < self.n_local)
        le = le.clamp(0, self.n_local - 1)
        xf = x.reshape(T, D)
        buf = x.new_zeros(self.n_local * cap, D).index_add_(
            0, le * cap + slot, xf[flat_tok] * keep[:, None].to(x.dtype))
        out_e = self._per_expert(buf.view(self.n_local, cap, D), generator)
        out_e = dropout(out_e, self.dropout_rate, generator,
                        self._origin([(0, cap)], D, 0, experts_first=True))
        gathered = out_e[le, slot]
        comb = (w.to(out_e.dtype) * keep.to(out_e.dtype))[:, None]
        out = out_e.new_zeros(T, D).index_add_(0, flat_tok, gathered * comb)
        selected = F.one_hot(idx, E).sum(1).bool().view(B, L, E)
        return out.view(B, L, D), selected

    def reset_metrics(self) -> None:
        """Forget the recorded load metrics and emotion counts."""
        self.expert_counts = self.maxvio = None
        self.expert_emotion_counts = None

    def forward(self, x, generator=None, emotion_ids=None, seq=None):
        """generator: a torch.Generator on x's device makes this a training
        call (dropout, load metrics, balancing, the schedules' steps).
        emotion_ids: (B, L') ints in [-1, 5] make an eval call count its
        selections by dominant emotion (ignored in a training call). seq:
        the model group when the caller's stream is sharded by sequence
        (x, this rank's shard, is gathered whole: the router sees every
        token on every rank, so the gradient that reaches x is whole there
        and *f* sums the experts' parts; the output leaves as this rank's
        shard)."""
        training = generator is not None
        shard, x = x, enter(x, None, seq)
        logits = self.gate(x).float()  # (B, L, E)
        E = logits.shape[-1]
        k = self._top_k(training)
        t_div = self._temperature(training)
        select = logits
        if training and self.cfg.balancing:
            select = logits + self.balance_bias
        gather = (not training and x.shape[0] * x.shape[1] == 1
                  and self.k < E and self.cfg.expert != "kan"
                  and self.tp is None)
        # the expert region: tokens and gate logits through f
        xe, gl = copy_to(x, self.tp), copy_to(logits, self.tp)
        if gather:
            # descending order, ties to the first index (stable, as
            # jnp.argsort and lax.top_k)
            idx = torch.argsort(-select.reshape(E), stable=True)[:k]
            gsel = logits.reshape(E)[idx]
            if t_div is not None:
                gsel = gsel / t_div
            w = torch.softmax(gsel, dim=-1).to(x.dtype)
            out = (w[:, None] * self._experts(x, idx)).sum(0).view_as(x)
            if emotion_ids is not None:
                selected = torch.zeros(1, 1, E, dtype=torch.bool,
                                       device=x.device)
                selected[0, 0, idx] = True
        elif self.cfg.dispatch == "capacity" and not (
                training and self.cfg.topk_schedule):
            out, selected = self._capacity(xe, gl, select, t_div, generator)
        else:
            order = torch.argsort(-select, dim=-1, stable=True)
            selected = torch.argsort(order, dim=-1, stable=True) < k
            masked = gl.masked_fill(~selected, float("-inf"))
            if t_div is not None:
                masked = masked / t_div
            w = torch.softmax(masked, dim=-1).to(x.dtype)
            experts = dropout(self._experts(xe, generator=generator),
                              self.dropout_rate, generator,
                              self._origin(self._tokens(x), x.shape[-1], 0))
            out = torch.einsum("ble,bled->bld",
                               w[..., self.e0:self.e0 + self.n_local],
                               experts)
        out = (whole_out(out, seq) if self.tp is None
               else reduce_out(out, self.tp, seq))
        if training:
            self._record_load(selected, balance=self.cfg.balancing)
        elif emotion_ids is not None:
            self._record_load(selected, balance=False)
            self._count_emotions(selected, emotion_ids)
        if self.shared is not None:
            out = out + self.shared(shard, generator, seq=seq) / k
        return out

    def _data_sum(self, t):
        return t if self.mesh is None else all_reduce(t, self.mesh.data)

    @torch.no_grad()
    def _record_load(self, selected, balance: bool):
        counts = self._data_sum(selected.sum(dim=(0, 1)).float())
        mean = counts.mean()
        self.expert_counts = counts
        self.maxvio = (counts.max() - mean.clamp(min=1e-6)) \
            / mean.clamp(min=1e-6)
        if balance:
            self.balance_bias += self.cfg.balancing_update_rate \
                * (mean - counts)

    @torch.no_grad()
    def _count_emotions(self, selected, emotion_ids):
        L = min(selected.shape[1], emotion_ids.shape[1])
        onehot = emotion_ids[:, :L, None] == torch.arange(
            6, device=selected.device)
        counts = self._data_sum(torch.einsum(
            "blc,ble->ce", onehot.float(), selected[:, :L].float()))
        self.expert_emotion_counts = counts if \
            self.expert_emotion_counts is None \
            else self.expert_emotion_counts + counts
