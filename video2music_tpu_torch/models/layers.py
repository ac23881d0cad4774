"""Post-norm encoder / decoder layers of AMT 2.2 (counterpart of
models/layers.py): x = norm1(x + attn(x)); [x = norm2(x + cross(x))];
x = norm(x + ffn(x)). Pre-norm wirings and residual dropout are not ported
yet (no 2.2 layer uses them)."""

from __future__ import annotations

from torch import nn

from video2music_tpu.core.config import AMTConfig, LayerSpec

from ..ops.attention import MultiHeadAttention, not_ported
from ..ops.moe import SharedMoE, SwiGLU
from ..ops.norms import LayerNorm

__all__ = ["SwiGLU", "EncoderLayer", "DecoderLayer", "make_ffn"]


def make_ffn(spec: LayerSpec, cfg: AMTConfig) -> nn.Module:
    if spec.ffn == "swiglu":
        return SwiGLU(cfg.d_model, cfg.d_ff)
    if spec.ffn == "moe":
        return SharedMoE(cfg.moe, cfg.d_model, cfg.d_ff)
    raise not_ported(f"the {spec.ffn!r} feed-forward",
                     "Queue 1, variant wirings")


class EncoderLayer(nn.Module):
    def __init__(self, spec: LayerSpec, cfg: AMTConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(spec.attn, cfg.d_model,
                                            max_cache_len=cfg.max_seq_video)
        self.ffn = make_ffn(spec, cfg)
        self.norm1 = LayerNorm(cfg.d_model)
        self.norm2 = LayerNorm(cfg.d_model)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.ffn(x))


class DecoderLayer(nn.Module):
    def __init__(self, spec: LayerSpec, cfg: AMTConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(spec.attn, cfg.d_model,
                                            max_cache_len=cfg.max_seq_chord)
        self.cross_attn = MultiHeadAttention(
            spec.cross_attn or spec.attn, cfg.d_model, is_cross=True,
            max_cache_len=cfg.max_seq_video, max_query_len=cfg.max_seq_chord)
        self.ffn = make_ffn(spec, cfg)
        self.norm1 = LayerNorm(cfg.d_model)
        self.norm2 = LayerNorm(cfg.d_model)
        self.norm3 = LayerNorm(cfg.d_model)

    def prime(self, memory):
        """Cross-attention K/V of the encoder memory, each (B, Sm, D)."""
        return self.cross_attn(None, memory, mode="prime")

    def forward(self, x, memory):
        """Full sequence: causal self-attention, cross-attention to memory."""
        x = self.norm1(x + self.self_attn(x, causal=True))
        x = self.norm2(x + self.cross_attn(x, memory))
        return self.norm3(x + self.ffn(x))

    def step(self, x, pos: int, cache):
        """One cached step. cache: dict with self "k"/"v" (B, S, D), written
        in place at ``pos``, and primed cross "ck"/"cv" (B, Sm, D)."""
        x = self.norm1(x + self.self_attn(x, mode="step", pos=pos,
                                          cache=(cache["k"], cache["v"])))
        x = self.norm2(x + self.cross_attn(x, mode="step", pos=pos,
                                           cache=(cache["ck"], cache["cv"])))
        return self.norm3(x + self.ffn(x))
