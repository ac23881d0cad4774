"""Post-norm encoder / decoder layers of AMT 2.2 (counterpart of
models/layers.py): x = norm1(x + attn(x)); [x = norm2(x + cross(x))];
x = norm(x + ffn(x)). A ``generator`` makes a forward a training call: the
attention and feed-forward dropouts draw from it. Pre-norm wirings and
residual dropout are not ported yet (no 2.x layer uses them: the JAX model
sets ``residual_dropout`` only for the base AMT, models/amt.py:111)."""

from __future__ import annotations

from torch import nn

from ..core.config import AMTConfig, LayerSpec

from ..ops.attention import MultiHeadAttention, not_ported
from ..ops.moe import SharedMoE, SwiGLU
from ..ops.norms import LayerNorm

__all__ = ["SwiGLU", "EncoderLayer", "DecoderLayer", "make_ffn"]


def make_ffn(spec: LayerSpec, cfg: AMTConfig) -> nn.Module:
    if spec.ffn == "swiglu":
        return SwiGLU(cfg.d_model, cfg.d_ff, cfg.dropout)
    if spec.ffn == "moe":
        return SharedMoE(cfg.moe, cfg.d_model, cfg.d_ff, cfg.dropout)
    raise not_ported(f"the {spec.ffn!r} feed-forward",
                     "Queue 1, variant wirings")


class EncoderLayer(nn.Module):
    def __init__(self, spec: LayerSpec, cfg: AMTConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(spec.attn, cfg.d_model,
                                            max_cache_len=cfg.max_seq_video,
                                            dropout_rate=cfg.dropout)
        self.ffn = make_ffn(spec, cfg)
        self.norm1 = LayerNorm(cfg.d_model)
        self.norm2 = LayerNorm(cfg.d_model)

    def forward(self, x, generator=None):
        x = self.norm1(x + self.self_attn(x, generator=generator))
        return self.norm2(x + self.ffn(x, generator))


class DecoderLayer(nn.Module):
    def __init__(self, spec: LayerSpec, cfg: AMTConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(spec.attn, cfg.d_model,
                                            max_cache_len=cfg.max_seq_chord,
                                            dropout_rate=cfg.dropout)
        self.cross_attn = MultiHeadAttention(
            spec.cross_attn or spec.attn, cfg.d_model, is_cross=True,
            max_cache_len=cfg.max_seq_video, max_query_len=cfg.max_seq_chord,
            dropout_rate=cfg.dropout)
        self.ffn = make_ffn(spec, cfg)
        self.norm1 = LayerNorm(cfg.d_model)
        self.norm2 = LayerNorm(cfg.d_model)
        self.norm3 = LayerNorm(cfg.d_model)

    def prime(self, memory):
        """Cross-attention K/V of the encoder memory, each (B, Sm, D)."""
        return self.cross_attn(None, memory, mode="prime")

    def forward(self, x, memory, generator=None):
        """Full sequence: causal self-attention, cross-attention to memory."""
        x = self.norm1(x + self.self_attn(x, causal=True, generator=generator))
        x = self.norm2(x + self.cross_attn(x, memory, generator=generator))
        return self.norm3(x + self.ffn(x, generator))

    def step(self, x, pos: int, cache):
        """One cached step. cache: dict with self "k"/"v" (B, S, D), written
        in place at ``pos``, and primed cross "ck"/"cv" (B, Sm, D)."""
        x = self.norm1(x + self.self_attn(x, mode="step", pos=pos,
                                          cache=(cache["k"], cache["v"])))
        x = self.norm2(x + self.cross_attn(x, mode="step", pos=pos,
                                           cache=(cache["ck"], cache["cv"])))
        return self.norm3(x + self.ffn(x))
