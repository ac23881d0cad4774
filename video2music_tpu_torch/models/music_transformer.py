"""MusicTransformer, the no-video baseline (counterpart of
models/music_transformer.py): an encoder-only model over chord tokens.

Root and attr embeddings summed, the scalar key appended and projected by
``linear_chord``, the sinusoidal positions (with their dropout in a
training call), then ``n_layers`` post-norm layers of (RPR unless
``cfg.rpr`` is False) self-attention and a ReLU feed-forward:

    x = norm1(x + drop(attn(x)));  x = norm2(x + drop(ff2(drop(relu(ff1(x))))))

the LayerNorms at eps 1e-5, a final LayerNorm and the 159-way ``wout``.
``causal`` (True unless given) applies the causal mask the reference meant
to apply; False reproduces its unmasked encoder. The eval forward runs the
flash attention kernel (ops/flash_attention.py) with the full RPR bias; a
training forward (``deterministic=False`` with a ``generator``) runs the
dropout attention kernel (ops/flash_attention_dropout.py) with it, whose
dbias carries the gradient of each layer's ``Er``. The JAX model's
cached ``decode_step`` is reached by no entry point of the JAX package
(its sampler and pipeline decode VideoMusicTransformer only) and is not
ported.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..core import constants as C
from ..core.config import AttentionConfig, MusicTransformerConfig

from ..ops.attention import MultiHeadAttention
from ..ops.dropout import dropout
from ..ops.embeddings import SinusoidalPE
from ..ops.norms import LayerNorm

MT_LN_EPS = 1e-5


class MTLayer(nn.Module):
    def __init__(self, cfg: MusicTransformerConfig):
        super().__init__()
        self.rate = cfg.dropout
        attn = AttentionConfig(num_heads=cfg.num_heads,
                               kind="rpr" if cfg.rpr else "vanilla",
                               er_len=cfg.max_seq_chord)
        self.self_attn = MultiHeadAttention(attn, cfg.d_model,
                                            max_cache_len=cfg.max_seq_chord,
                                            dropout_rate=cfg.dropout)
        self.norm1 = LayerNorm(cfg.d_model, MT_LN_EPS)
        self.norm2 = LayerNorm(cfg.d_model, MT_LN_EPS)
        self.ff1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.ff2 = nn.Linear(cfg.d_ff, cfg.d_model)

    def forward(self, x, causal: bool = True, generator=None):
        d = lambda h: dropout(h, self.rate, generator)
        h = self.self_attn(x, causal=causal, generator=generator)
        x = self.norm1(x + d(h))
        h = self.ff2(d(F.relu(self.ff1(x))))
        return self.norm2(x + d(h))


class MusicTransformer(nn.Module):
    def __init__(self, cfg: MusicTransformerConfig, causal: bool = True):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        D = cfg.d_model
        self.embedding_root = nn.Embedding(C.CHORD_ROOT_SIZE, D)
        self.embedding_attr = nn.Embedding(C.CHORD_ATTR_SIZE, D)
        self.linear_chord = nn.Linear(D + 1, D)
        self.pe = SinusoidalPE(D, cfg.max_seq_chord, cfg.dropout)
        self.layers = nn.ModuleList(MTLayer(cfg) for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(D, MT_LN_EPS)
        self.wout = nn.Linear(D, C.CHORD_SIZE)

    def _embed(self, x_root, x_attr, key):
        emb = self.embedding_root(x_root) + self.embedding_attr(x_attr)
        B, L = emb.shape[:2]
        key = key.to(emb.dtype).reshape(B, 1, 1).expand(B, L, 1)
        return self.linear_chord(torch.cat([emb, key], dim=-1))

    def forward(self, x, x_root, x_attr, key, deterministic: bool = True,
                generator=None):
        """(B, L) chord / root / attr ids and the (B, 1) key -> (B, L, 159)
        logits. ``x`` is not read (the JAX signature). With
        ``deterministic=False`` a training forward: ``generator`` drives
        every dropout."""
        del x
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("a training forward (deterministic=False) "
                             "needs a generator")
        h = self.pe(self._embed(x_root, x_attr, key), generator)
        for layer in self.layers:
            h = layer(h, causal=self.causal, generator=generator)
        return self.wout(self.final_norm(h))
