"""Encoder / decoder layers (counterpart of models/layers.py), in the
post-norm wiring x = norm1(x + attn(x)); [x = norm2(x + cross(x))];
x = norm(x + ffn(x)) or the pre-norm wiring (AMT 3.2)
x = x + attn(norm1(x)); [x = x + cross(norm2(x))]; x = x + ffn(norm(x)),
with LayerNorm or RMSNorm as the config says. A ``generator`` makes a
forward a training call: the attention and feed-forward dropouts draw from
it, and, with ``residual_dropout`` (the base AMT's torch layers: the JAX
model sets it for ``version is None`` only, models/amt.py:107), so does a
dropout on each sublayer output before its residual add. ``emotion_ids``
(B, L') reach an MoE feed-forward only, which counts its selections by
dominant emotion in an eval call (ops/moe.py).

Sequence parallelism (the counterpart of the JAX layers' ``_seq_shard``):
a layer given ``seq`` (the model group) holds its stream as this rank's
sequence shard (B, L/m, D). Each sublayer gathers it whole (backward, its
shard of the gradient), runs tensor-parallel and leaves as the shard
again (a reduce-scatter); the norms, the residual adds and the residual
dropout run on the shard, the norms' parameters through *f* (each rank
sees only its positions, so their gradients sum over the group). The
model decides per stream (models/amt.py): one whose length the group
does not divide stays whole, on plain tensor parallelism."""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from ..core.config import AMTConfig, LayerSpec

from ..ops.attention import MultiHeadAttention
from ..ops.dropout import batch_span, dropout
from ..ops.moe import (MoELayer, SwiGLU, _Hidden, hidden_origin,
                       row_parallel_out)
from ..ops.norms import make_norm
from ..parallel.comm import enter, summed_call

__all__ = ["ReluFFN", "SwiGLU", "EncoderLayer", "DecoderLayer", "make_ffn"]


class ReluFFN(_Hidden):
    """torch TransformerEncoderLayer feed-forward: linear1, ReLU, dropout
    in a training call, linear2 (models/layers.py:62-74); under tensor
    parallelism linear1 column-parallel, linear2 row-parallel."""

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0):
        super().__init__()
        self._shard_init(d_ff)
        self.dropout_rate = dropout_rate
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x, generator=None, seq=None):
        x = enter(x, self.tp, seq)
        h = dropout(F.relu(self.linear1(x)), self.dropout_rate, generator,
                    hidden_origin(self, x, self.d_ff_global, self.ff0))
        return row_parallel_out(self.linear2, h, self.tp, seq)


def make_ffn(spec: LayerSpec, cfg: AMTConfig) -> nn.Module:
    if spec.ffn == "relu_mlp":
        return ReluFFN(cfg.d_model, cfg.d_ff, cfg.dropout)
    if spec.ffn == "swiglu":
        return SwiGLU(cfg.d_model, cfg.d_ff, cfg.dropout)
    if spec.ffn == "moe":
        return MoELayer(cfg.moe, cfg.d_model, cfg.d_ff, cfg.dropout)
    raise ValueError(f"unknown ffn kind {spec.ffn!r}")


class _Layer(nn.Module):
    def __init__(self, cfg: AMTConfig, residual_dropout: bool):
        super().__init__()
        self.pre_norm = cfg.pre_norm
        self.residual_rate = cfg.dropout if residual_dropout else 0.0
        self.mesh = None

    def _drop(self, x, generator, seq=None):
        origin = None
        if self.mesh is not None:
            B, L, D = x.shape
            lo = (0, L) if seq is None else (seq.rank * L, seq.size * L)
            origin = [batch_span(self, B), lo, (0, D)]
        return dropout(x, self.residual_rate, generator, origin)

    def _ffn(self, h, generator, emotion_ids, seq=None):
        if emotion_ids is not None and isinstance(self.ffn, MoELayer):
            return self.ffn(h, generator, emotion_ids, seq=seq)
        return self.ffn(h, generator, seq=seq)


class EncoderLayer(_Layer):
    def __init__(self, spec: LayerSpec, cfg: AMTConfig, depth: int = 0,
                 residual_dropout: bool = False):
        super().__init__(cfg, residual_dropout)
        self.self_attn = MultiHeadAttention(spec.attn, cfg.d_model,
                                            max_cache_len=cfg.max_seq_video,
                                            dropout_rate=cfg.dropout,
                                            depth=depth)
        self.ffn = make_ffn(spec, cfg)
        self.norm1 = make_norm(cfg.norm, cfg.d_model)
        self.norm2 = make_norm(cfg.norm, cfg.d_model)

    def forward(self, x, generator=None, emotion_ids=None, seq=None):
        """seq: the model group when x is this rank's sequence shard."""
        g, e = generator, emotion_ids
        n1 = lambda h: summed_call(self.norm1, seq, h)
        n2 = lambda h: summed_call(self.norm2, seq, h)
        sa = lambda h: self.self_attn(h, generator=g, seq=seq)
        d = lambda h: self._drop(h, g, seq)
        if self.pre_norm:
            x = x + d(sa(n1(x)))
            return x + d(self._ffn(n2(x), g, e, seq))
        x = n1(x + d(sa(x)))
        return n2(x + d(self._ffn(x, g, e, seq)))


class DecoderLayer(_Layer):
    def __init__(self, spec: LayerSpec, cfg: AMTConfig, depth: int = 0,
                 residual_dropout: bool = False):
        super().__init__(cfg, residual_dropout)
        self.self_attn = MultiHeadAttention(spec.attn, cfg.d_model,
                                            max_cache_len=cfg.max_seq_chord,
                                            dropout_rate=cfg.dropout,
                                            depth=depth)
        self.cross_attn = MultiHeadAttention(
            spec.cross_attn or spec.attn, cfg.d_model, is_cross=True,
            max_cache_len=cfg.max_seq_video, max_query_len=cfg.max_seq_chord,
            dropout_rate=cfg.dropout, depth=depth)
        self.ffn = make_ffn(spec, cfg)
        self.norm1 = make_norm(cfg.norm, cfg.d_model)
        self.norm2 = make_norm(cfg.norm, cfg.d_model)
        self.norm3 = make_norm(cfg.norm, cfg.d_model)

    def prime(self, memory):
        """Cross-attention K/V of the encoder memory, (B, Sm, k_dim) and
        (B, Sm, v_dim)."""
        return self.cross_attn(None, memory, mode="prime")

    def _wire(self, x, sa, ca, ffn, g=None, seq=None):
        d = lambda h: self._drop(h, g, seq)
        n1, n2, n3 = (lambda h, n=n: summed_call(n, seq, h)
                      for n in (self.norm1, self.norm2, self.norm3))
        if self.pre_norm:
            x = x + d(sa(n1(x)))
            x = x + d(ca(n2(x)))
            return x + d(ffn(n3(x)))
        x = n1(x + d(sa(x)))
        x = n2(x + d(ca(x)))
        return n3(x + d(ffn(x)))

    def forward(self, x, memory, generator=None, emotion_ids=None, seq=None):
        """Full sequence: causal self-attention, cross-attention to memory
        (whole on every rank). seq: the model group when x is this rank's
        sequence shard."""
        g = generator
        return self._wire(
            x, lambda h: self.self_attn(h, causal=True, generator=g,
                                        seq=seq),
            lambda h: self.cross_attn(h, memory, generator=g, seq=seq),
            lambda h: self._ffn(h, g, emotion_ids, seq), g, seq)

    def step(self, x, pos: int, cache):
        """One cached step. cache: dict with self "k"/"v" (B, S, k_dim) /
        (B, S, v_dim), written in place at ``pos``, and primed cross
        "ck"/"cv"."""
        return self._wire(
            x, lambda h: self.self_attn(h, mode="step", pos=pos,
                                        cache=(cache["k"], cache["v"])),
            lambda h: self.cross_attn(h, mode="step", pos=pos,
                                      cache=(cache["ck"], cache["cv"])),
            self.ffn)
