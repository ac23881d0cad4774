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
dominant emotion in an eval call (ops/moe.py)."""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from ..core.config import AMTConfig, LayerSpec

from ..ops.attention import MultiHeadAttention
from ..ops.dropout import dropout
from ..ops.moe import MoELayer, SwiGLU
from ..ops.norms import make_norm

__all__ = ["ReluFFN", "SwiGLU", "EncoderLayer", "DecoderLayer", "make_ffn"]


class ReluFFN(nn.Module):
    """torch TransformerEncoderLayer feed-forward: linear1, ReLU, dropout
    in a training call, linear2 (models/layers.py:62-74)."""

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x, generator=None):
        return self.linear2(dropout(F.relu(self.linear1(x)),
                                    self.dropout_rate, generator))


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

    def _drop(self, x, generator):
        return dropout(x, self.residual_rate, generator)

    def _ffn(self, h, generator, emotion_ids):
        if emotion_ids is not None and isinstance(self.ffn, MoELayer):
            return self.ffn(h, generator, emotion_ids)
        return self.ffn(h, generator)


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

    def forward(self, x, generator=None, emotion_ids=None):
        g, e = generator, emotion_ids
        if self.pre_norm:
            x = x + self._drop(self.self_attn(self.norm1(x), generator=g), g)
            return x + self._drop(self._ffn(self.norm2(x), g, e), g)
        x = self.norm1(x + self._drop(self.self_attn(x, generator=g), g))
        return self.norm2(x + self._drop(self._ffn(x, g, e), g))


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

    def _wire(self, x, sa, ca, ffn, g=None):
        d = lambda h: self._drop(h, g)
        if self.pre_norm:
            x = x + d(sa(self.norm1(x)))
            x = x + d(ca(self.norm2(x)))
            return x + d(ffn(self.norm3(x)))
        x = self.norm1(x + d(sa(x)))
        x = self.norm2(x + d(ca(x)))
        return self.norm3(x + d(ffn(x)))

    def forward(self, x, memory, generator=None, emotion_ids=None):
        """Full sequence: causal self-attention, cross-attention to memory."""
        return self._wire(
            x, lambda h: self.self_attn(h, causal=True, generator=generator),
            lambda h: self.cross_attn(h, memory, generator=generator),
            lambda h: self._ffn(h, generator, emotion_ids), generator)

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
