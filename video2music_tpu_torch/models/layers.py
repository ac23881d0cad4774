"""Encoder / decoder layers (counterpart of models/layers.py), in the
post-norm wiring x = norm1(x + attn(x)); [x = norm2(x + cross(x))];
x = norm(x + ffn(x)) or the pre-norm wiring (AMT 3.2)
x = x + attn(norm1(x)); [x = x + cross(norm2(x))]; x = x + ffn(norm(x)),
with LayerNorm or RMSNorm as the config says. A ``generator`` makes a
forward a training call: the attention and feed-forward dropouts draw from
it. Residual dropout is not ported yet (only the base AMT uses it: the JAX
model sets ``residual_dropout`` only for it, models/amt.py:111)."""

from __future__ import annotations

from torch import nn

from ..core.config import AMTConfig, LayerSpec

from ..ops.attention import MultiHeadAttention, not_ported
from ..ops.moe import SharedMoE, SwiGLU
from ..ops.norms import make_norm

__all__ = ["SwiGLU", "EncoderLayer", "DecoderLayer", "make_ffn"]


def make_ffn(spec: LayerSpec, cfg: AMTConfig) -> nn.Module:
    if spec.ffn == "swiglu":
        return SwiGLU(cfg.d_model, cfg.d_ff, cfg.dropout)
    if spec.ffn == "moe":
        return SharedMoE(cfg.moe, cfg.d_model, cfg.d_ff, cfg.dropout)
    raise not_ported(f"the {spec.ffn!r} feed-forward",
                     "Queue 1, variant wirings")


class EncoderLayer(nn.Module):
    def __init__(self, spec: LayerSpec, cfg: AMTConfig, depth: int = 0):
        super().__init__()
        self.pre_norm = cfg.pre_norm
        self.self_attn = MultiHeadAttention(spec.attn, cfg.d_model,
                                            max_cache_len=cfg.max_seq_video,
                                            dropout_rate=cfg.dropout,
                                            depth=depth)
        self.ffn = make_ffn(spec, cfg)
        self.norm1 = make_norm(cfg.norm, cfg.d_model)
        self.norm2 = make_norm(cfg.norm, cfg.d_model)

    def forward(self, x, generator=None):
        if self.pre_norm:
            x = x + self.self_attn(self.norm1(x), generator=generator)
            return x + self.ffn(self.norm2(x), generator)
        x = self.norm1(x + self.self_attn(x, generator=generator))
        return self.norm2(x + self.ffn(x, generator))


class DecoderLayer(nn.Module):
    def __init__(self, spec: LayerSpec, cfg: AMTConfig, depth: int = 0):
        super().__init__()
        self.pre_norm = cfg.pre_norm
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
        """Cross-attention K/V of the encoder memory, (B, Sm, qk_dim) and
        (B, Sm, D)."""
        return self.cross_attn(None, memory, mode="prime")

    def _wire(self, x, sa, ca, ffn):
        if self.pre_norm:
            x = x + sa(self.norm1(x))
            x = x + ca(self.norm2(x))
            return x + ffn(self.norm3(x))
        x = self.norm1(x + sa(x))
        x = self.norm2(x + ca(x))
        return self.norm3(x + ffn(x))

    def forward(self, x, memory, generator=None):
        """Full sequence: causal self-attention, cross-attention to memory."""
        return self._wire(
            x, lambda h: self.self_attn(h, causal=True, generator=generator),
            lambda h: self.cross_attn(h, memory, generator=generator),
            lambda h: self.ffn(h, generator))

    def step(self, x, pos: int, cache):
        """One cached step. cache: dict with self "k"/"v" (B, S, qk_dim) /
        (B, S, D), written in place at ``pos``, and primed cross "ck"/"cv"."""
        return self._wire(
            x, lambda h: self.self_attn(h, mode="step", pos=pos,
                                        cache=(cache["k"], cache["v"])),
            lambda h: self.cross_attn(h, mode="step", pos=pos,
                                      cache=(cache["ck"], cache["cv"])),
            self.ffn)
