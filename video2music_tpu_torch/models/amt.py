"""VideoMusicTransformer for the AMT 2.x (RoPE) and 3.x wirings
(counterpart of models/amt.py), built from the port's copy of
``core.config.amt_config``.

Chord tokens embed as emb_root(x_root) + emb_attr(x_attr), the scalar key
is appended and Linear_chord projects; video features
[semantic | scene_offset | motion | emotion] project by Linear_vis; no
additive positions (RoPE sits inside attention); an encoder over the video
tokens, a causal decoder with cross-attention, final norms and the 159-way
head. 2.x: post-norm LayerNorm, vanilla attention. 3.0: RMSNorm,
differential decoder attention; 3.1 differential attention everywhere; 3.2
as 3.1 in the pre-norm wiring (models/layers.py). Base AMT, V1, 2.0 and KAN
2.3 are not ported yet.

Decoding is ``encode -> prime -> decode_step``; the product decode loop
runs the fused kernel step of decode/fused.py instead of
:meth:`VideoMusicTransformer.decode_step`, which stays the unfused
reference. The full forward with ``deterministic=False`` and a
``generator`` is the training forward: every dropout of the layers draws
from the generator. ``drop_token_rate`` is not ported to training
(ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ..core import constants as C
from ..core.config import AMTConfig

from ..ops.attention import not_ported
from ..ops.norms import make_norm
from .layers import DecoderLayer, EncoderLayer


def check_supported(cfg: AMTConfig) -> None:
    """Raise NotImplementedError for wirings this port does not cover yet
    (everything but the V2 family with RoPE, e.g. 2.2 and 2.1, and the V3
    family 3.0 / 3.1 / 3.2)."""
    problems = []
    if cfg.version is None or not cfg.version.startswith(("2.", "3.")):
        problems.append(f"AMT version {cfg.version!r}")
    if cfg.pos_encoding != "none":
        problems.append(f"{cfg.pos_encoding!r} position encoding")
    if cfg.chord_embed or cfg.scene_embed or cfg.separated:
        problems.append("chord / scene embedding tables or separated heads")
    if cfg.kv_heads is not None:
        problems.append("grouped-query attention")
    if problems:
        raise not_ported(", ".join(problems),
                         "Queue 1, variant wirings")


class VideoMusicTransformer(nn.Module):
    def __init__(self, cfg: AMTConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        D = cfg.d_model
        self.embedding_root = nn.Embedding(C.CHORD_ROOT_SIZE, D)
        self.embedding_attr = nn.Embedding(C.CHORD_ATTR_SIZE, D)
        self.linear_chord = nn.Linear(D + 1, D)
        self.linear_vis = nn.Linear(cfg.total_vf_dim, D)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(spec, cfg, depth=i)
            for i, spec in enumerate(cfg.encoder_layers))
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(spec, cfg, depth=i)
            for i, spec in enumerate(cfg.decoder_layers))
        self.encoder_norm = make_norm(cfg.norm, D)
        self.decoder_norm = make_norm(cfg.norm, D)
        self.wout = nn.Linear(D, C.CHORD_SIZE)

    # -- embeddings ---------------------------------------------------------
    def _embed_chords(self, x_root, x_attr, key):
        """(B, L) root/attr ids + (B,) or (B, 1) key -> (B, L, D)."""
        emb = self.embedding_root(x_root) + self.embedding_attr(x_attr)
        key = key.to(emb.dtype).reshape(emb.shape[0], 1, 1)
        key = key.expand(emb.shape[0], emb.shape[1], 1)
        return self.linear_chord(torch.cat([emb, key], dim=-1))

    def _embed_video(self, semantic, scene_offset, motion, emotion):
        dt = semantic.dtype
        if motion.dim() == 2:
            motion = motion[..., None]
        feats = torch.cat([semantic, scene_offset[..., None].to(dt),
                           motion.to(dt), emotion.to(dt)], dim=-1)
        return self.linear_vis(feats)

    # -- decomposed pieces ----------------------------------------------------
    def encode(self, semantic, scene_offset, motion, emotion, generator=None):
        """Video features -> encoder memory (B, Lv, D)."""
        vf = self._embed_video(semantic, scene_offset, motion, emotion)
        for layer in self.encoder_layers:
            vf = layer(vf, generator)
        return self.encoder_norm(vf)

    def prime(self, memory) -> List[tuple]:
        """Every decoder layer's cross-attention (K, V), (B, Sm, qk_dim)
        and (B, Sm, D)."""
        return [layer.prime(memory) for layer in self.decoder_layers]

    def init_cache(self, cross: List[tuple]) -> List[Dict[str, torch.Tensor]]:
        """Cache for :meth:`decode_step`: zero self K (B, S, qk_dim) and V
        (B, S, D) per layer beside the primed cross K/V."""
        S = self.cfg.max_seq_chord
        return [dict(k=cv.new_zeros(cv.shape[0], S, layer.self_attn.qk_dim),
                     v=cv.new_zeros(cv.shape[0], S, cv.shape[2]), ck=ck,
                     cv=cv)
                for layer, (ck, cv) in zip(self.decoder_layers, cross)]

    def decode_step(self, token, token_root, token_attr, key, pos: int,
                    cache):
        """One cached step (unfused reference). token_*: (B, 1) ids of the
        current token; pos: its position. Returns (B, 159) logits; the self
        caches are written in place."""
        del token  # root/attr ids carry the chord (no chord_embed table)
        out = self._embed_chords(token_root, token_attr, key)
        for layer, c in zip(self.decoder_layers, cache):
            out = layer.step(out, pos, c)
        return self.wout(self.decoder_norm(out))[:, 0]

    def head(self, out):
        return self.wout(self.decoder_norm(out))

    def forward(self, x, x_root, x_attr, semantic, key, scene_offset, motion,
                emotion, deterministic: bool = True, generator=None):
        """Teacher-forced full forward -> (B, L, 159) logits. With
        ``deterministic=False`` a training forward: ``generator`` (a
        torch.Generator on the inputs' device) drives every dropout."""
        del x
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("a training forward (deterministic=False) "
                             "needs a generator")
        elif self.cfg.drop_token_rate > 0.0:
            raise not_ported("drop_token_rate in training", "Queue 1 item 10")
        memory = self.encode(semantic, scene_offset, motion, emotion,
                             generator)
        out = self._embed_chords(x_root, x_attr, key)
        for layer in self.decoder_layers:
            out = layer(out, memory, generator)
        return self.head(out)

    def moe_metrics(self):
        """The last training forward's load metrics of the SharedMoE layers
        (encoder first, then decoder): ``expert_counts`` (n, E) and
        ``maxvio`` (n,), or an empty dict without MoE layers."""
        moes = [layer.ffn for layer in (*self.encoder_layers,
                                        *self.decoder_layers)
                if getattr(layer.ffn, "expert_counts", None) is not None]
        if not moes:
            return {}
        return {"expert_counts": torch.stack([m.expert_counts for m in moes]),
                "maxvio": torch.stack([m.maxvio for m in moes])}
