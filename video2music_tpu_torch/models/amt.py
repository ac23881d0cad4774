"""VideoMusicTransformer, every wiring of the port's copy of
``core.config.amt_config`` (counterpart of models/amt.py): the base AMT
(``version=None``), V1.x, V2.x and V3.x, with grouped-query attention
(``kv_heads``) as an option of any of them.

Chord tokens embed as emb_root(x_root) + emb_attr(x_attr), or through the
frozen ``chord_embedding`` table (``chord_embed``), the scalar key is
appended and Linear_chord projects; video features [semantic |
scene_offset | motion | emotion] project by Linear_vis (with
``scene_embed`` the scene offset indexes ``scene_embedding`` instead of
joining the features); positions are added per ``pos_encoding``
(sinusoidal for the base AMT, learned for V1 and 2.0, none where RoPE sits
inside attention); an encoder over the video tokens, a causal decoder with
cross-attention, final norms and the 159-way head, or the root / attr
heads with ``separated``. The layer wiring (attention kind, feed-forward,
norm, pre- or post-norm, residual dropout for the base AMT) is
models/layers.py's.

Decoding is ``encode -> prime -> decode_step``; the product decode loop
runs the fused kernel step of decode/fused.py instead of
:meth:`VideoMusicTransformer.decode_step`, which stays the unfused
reference, where a kernel covers the wiring. The full forward with
``deterministic=False`` and a ``generator`` is the training forward: every
dropout of the layers draws from the generator, and so does
``drop_token_rate``: each (B, L) video token's projected features are kept
with probability 1 - rate and zeroed otherwise, not rescaled
(models/amt.py:164-167). ``count_emotions=True`` makes an eval forward
(or ``encode``) count each MoE layer's selections by the tokens' dominant
emotion (ops/moe.py, obs/logging.py); nothing else counts.

Sharded training (parallel/shard.py) keeps the embeddings, positions,
final norms and heads replicated; the layers split as the plan says.
With ``sp`` (sequence parallelism) a stream whose length the model group
divides runs through its layers as this rank's sequence shard, gathered
whole again before the final norm. The pipeline step (train/pp.py) runs
the pieces one by one: ``embed_video_input``, ``embed_decoder_input``,
the layers, ``finalize_encoder`` and ``head``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ..core import constants as C
from ..core.config import AMTConfig

from ..ops.dropout import batch_span, keep_mask
from ..ops.embeddings import LearnedPE, SinusoidalPE
from ..ops.norms import make_norm
from ..parallel.comm import gather_seq, split_seq
from .layers import DecoderLayer, EncoderLayer


def chord_table(cfg: AMTConfig) -> torch.Tensor:
    """The frozen chord table (CHORD_SIZE, chord_embed_dim) of
    ``cfg.chord_table``, as the JAX model initialises it (models/amt.py:
    60-88): the reference's trained Word2Vec table (indexed positionally,
    or re-aligned by symbol for "word2vec_keyed"), which exists only at
    512 dims, so other dims take the deterministic table, as the JAX
    package does."""
    from ..features.chord2vec import (deterministic_chord_table,
                                      word2vec_chord_table)
    dim = cfg.chord_embed_dim
    if cfg.chord_table == "deterministic":
        table = deterministic_chord_table(dim)
    elif cfg.chord_table in ("word2vec", "word2vec_keyed"):
        try:
            table = word2vec_chord_table(
                dim, positional=cfg.chord_table == "word2vec")
        except ValueError:
            table = deterministic_chord_table(dim)
    else:
        raise ValueError(f"unknown chord_table {cfg.chord_table!r}")
    return torch.from_numpy(table.astype("float32"))


def dominant_emotion_ids(emotion: torch.Tensor) -> torch.Tensor:
    """(B, L, n_emo) probabilities -> (B, L) dominant-emotion ids, -1 where
    the row is all zero (PAD) (models/amt.py:40-46)."""
    ids = torch.argmax(emotion, dim=-1)
    return torch.where((emotion == 0).all(dim=-1), -1, ids)


class VideoMusicTransformer(nn.Module):
    def __init__(self, cfg: AMTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        if cfg.chord_embed:
            self.chord_embedding = nn.Embedding.from_pretrained(
                chord_table(cfg), freeze=True)
            chord_in = cfg.chord_embed_dim
        else:
            self.embedding_root = nn.Embedding(C.CHORD_ROOT_SIZE, D)
            self.embedding_attr = nn.Embedding(C.CHORD_ATTR_SIZE, D)
            chord_in = D
        self.linear_chord = nn.Linear(chord_in + 1, D)
        self.linear_vis = nn.Linear(
            cfg.total_vf_dim - (1 if cfg.scene_embed else 0), D)
        if cfg.scene_embed:
            self.scene_embedding = nn.Embedding(C.SCENE_OFFSET_MAX, D)
        if cfg.pos_encoding == "sinusoidal":
            self.pe_chord = SinusoidalPE(D, cfg.max_seq_chord, cfg.dropout)
            self.pe_video = SinusoidalPE(D, cfg.max_seq_video, cfg.dropout)
        elif cfg.pos_encoding == "learned":
            self.pe_chord = LearnedPE(D, cfg.max_seq_chord)
            self.pe_video = LearnedPE(D, cfg.max_seq_video)
        elif cfg.pos_encoding != "none":
            raise ValueError(f"unknown pos_encoding {cfg.pos_encoding!r}")
        residual_dropout = cfg.version is None
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(spec, cfg, depth=i,
                         residual_dropout=residual_dropout)
            for i, spec in enumerate(cfg.encoder_layers))
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(spec, cfg, depth=i,
                         residual_dropout=residual_dropout)
            for i, spec in enumerate(cfg.decoder_layers))
        self.encoder_norm = make_norm(cfg.norm, D)
        self.decoder_norm = make_norm(cfg.norm, D)
        if cfg.separated:
            self.wout_root = nn.Linear(D, C.CHORD_ROOT_SIZE)
            self.wout_attr = nn.Linear(D, C.CHORD_ATTR_SIZE)
        else:
            self.wout = nn.Linear(D, C.CHORD_SIZE)
        # sharded training (parallel/shard.py): the mesh, and whether the
        # streams shard by sequence over its model group
        self.mesh = None
        self.sp = False

    def _seq(self, h):
        """The model group when ``h`` (B, L, D) shards by sequence, else
        None."""
        if not self.sp or h.shape[1] % self.mesh.model.size:
            return None
        return self.mesh.model

    # -- embeddings ---------------------------------------------------------
    def _embed_chords(self, x, x_root, x_attr, key):
        """(B, L) chord / root / attr ids + (B,) or (B, 1) key ->
        (B, L, D). ``x`` is read only with the chord table."""
        if self.cfg.chord_embed:
            emb = self.chord_embedding(x.long())
        else:
            emb = self.embedding_root(x_root) + self.embedding_attr(x_attr)
        key = key.to(emb.dtype).reshape(emb.shape[0], 1, 1)
        key = key.expand(emb.shape[0], emb.shape[1], 1)
        return self.linear_chord(torch.cat([emb, key], dim=-1))

    def _embed_video(self, semantic, scene_offset, motion, emotion,
                     generator=None):
        dt = semantic.dtype
        if motion.dim() == 2:
            motion = motion[..., None]
        feats = [semantic]
        if not self.cfg.scene_embed:
            feats.append(scene_offset[..., None].to(dt))
        feats += [motion.to(dt), emotion.to(dt)]
        vf = self.linear_vis(torch.cat(feats, dim=-1))
        if self.cfg.scene_embed:
            vf = vf + self.scene_embedding(scene_offset.long())
        rate = self.cfg.drop_token_rate
        if generator is not None and rate > 0.0:
            B, L = vf.shape[:2]
            keep = keep_mask((B, L), rate, generator, vf.device,
                             None if self.mesh is None
                             else [batch_span(self, B), (0, L)])
            vf = vf * keep[..., None].to(vf.dtype)
        return vf

    def position_row(self, pos: int, device) -> torch.Tensor:
        """The decoder's position row at ``pos`` (D,), or None without
        additive positions (the decode step adds it in the model dtype)."""
        if self.cfg.pos_encoding == "none":
            return None
        return self.pe_chord.row(pos, device)

    def embed_step(self, token, token_root, token_attr, key, pos: int):
        """The decoder input of one cached step: (B, 1) ids of the current
        token (``token`` read only with the chord table) at position
        ``pos`` -> (B, 1, D), the position row added as in the JAX
        decode_step (models/amt.py:250-254)."""
        xf = self._embed_chords(token, token_root, token_attr, key)
        row = self.position_row(pos, xf.device)
        return xf if row is None else xf + row.to(xf.dtype)

    # -- decomposed pieces ----------------------------------------------------
    def embed_video_input(self, semantic, scene_offset, motion, emotion,
                          generator=None):
        """Video features -> positioned encoder input (B, Lv, D)."""
        vf = self._embed_video(semantic, scene_offset, motion, emotion,
                               generator)
        if self.cfg.pos_encoding == "sinusoidal":
            return self.pe_video(vf, generator)
        if self.cfg.pos_encoding == "learned":
            return self.pe_video(vf)
        return vf

    def embed_decoder_input(self, x, x_root, x_attr, key, generator=None):
        """Chord tokens + key -> positioned decoder input (B, L, D)."""
        xf = self._embed_chords(x, x_root, x_attr, key)
        if self.cfg.pos_encoding == "sinusoidal":
            return self.pe_chord(xf, generator)
        if self.cfg.pos_encoding == "learned":
            return self.pe_chord(xf)
        return xf

    def encode(self, semantic, scene_offset, motion, emotion, generator=None,
               count_emotions: bool = False):
        """Video features -> encoder memory (B, Lv, D)."""
        vf = self.embed_video_input(semantic, scene_offset, motion, emotion,
                                    generator)
        ids = dominant_emotion_ids(emotion) if count_emotions else None
        return self.finalize_encoder(self._run(self.encoder_layers, vf,
                                               generator, ids))

    def _run(self, layers, h, generator, ids, memory=None):
        """A layer stack over the stream h, sharded by sequence over its
        length when ``sp`` allows it, returned whole."""
        seq = self._seq(h)
        if seq is not None:
            h = split_seq(h, seq)
        for layer in layers:
            h = (layer(h, generator, ids, seq=seq) if memory is None
                 else layer(h, memory, generator, ids, seq=seq))
        return h if seq is None else gather_seq(h, seq)

    def finalize_encoder(self, h):
        """The encoder stack's output -> memory (the final norm)."""
        return self.encoder_norm(h)

    def prime(self, memory) -> List[tuple]:
        """Every decoder layer's cross-attention (K, V), (B, Sm, k_dim)
        and (B, Sm, v_dim)."""
        return [layer.prime(memory) for layer in self.decoder_layers]

    def init_cache(self, cross: List[tuple]) -> List[Dict[str, torch.Tensor]]:
        """Cache for :meth:`decode_step`: zero self K (B, S, k_dim) and V
        (B, S, v_dim) per layer beside the primed cross K/V."""
        S = self.cfg.max_seq_chord
        return [dict(k=cv.new_zeros(cv.shape[0], S, layer.self_attn.k_dim),
                     v=cv.new_zeros(cv.shape[0], S, layer.self_attn.v_dim),
                     ck=ck, cv=cv)
                for layer, (ck, cv) in zip(self.decoder_layers, cross)]

    def decode_step(self, token, token_root, token_attr, key, pos: int,
                    cache):
        """One cached step (unfused reference). token_*: (B, 1) ids of the
        current token (``token`` may be None without the chord table);
        pos: its position. Returns (B, 159) logits, or the (root, attr)
        logits of separated heads; the self caches are written in place."""
        out = self.embed_step(token, token_root, token_attr, key, pos)
        for layer, c in zip(self.decoder_layers, cache):
            out = layer.step(out, pos, c)
        out = self.head(out)
        if self.cfg.separated:
            return out[0][:, 0], out[1][:, 0]
        return out[:, 0]

    def head(self, out):
        """Decoder output -> chord logits, or (root, attr) logits."""
        out = self.decoder_norm(out)
        if self.cfg.separated:
            return self.wout_root(out), self.wout_attr(out)
        return self.wout(out)

    def forward(self, x, x_root, x_attr, semantic, key, scene_offset, motion,
                emotion, deterministic: bool = True, generator=None,
                count_emotions: bool = False):
        """Teacher-forced full forward -> (B, L, 159) logits (or the root /
        attr pair). With ``deterministic=False`` a training forward:
        ``generator`` (a torch.Generator on the inputs' device) drives every
        dropout. ``count_emotions``: an eval forward's MoE layers count
        their selections by dominant emotion (ignored in training)."""
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("a training forward (deterministic=False) "
                             "needs a generator")
        count_emotions = count_emotions and generator is None
        memory = self.encode(semantic, scene_offset, motion, emotion,
                             generator, count_emotions)
        out = self.embed_decoder_input(x, x_root, x_attr, key, generator)
        ids = dominant_emotion_ids(emotion) if count_emotions else None
        return self.head(self._run(self.decoder_layers, out, generator, ids,
                                   memory))

    def moe_metrics(self):
        """The last recorded forward's load metrics of the MoE layers
        (encoder first, then decoder): ``expert_counts`` (n, E) and
        ``maxvio`` (n,), or an empty dict without MoE layers."""
        moes = [layer.ffn for layer in (*self.encoder_layers,
                                        *self.decoder_layers)
                if getattr(layer.ffn, "expert_counts", None) is not None]
        if not moes:
            return {}
        return {"expert_counts": torch.stack([m.expert_counts for m in moes]),
                "maxvio": torch.stack([m.maxvio for m in moes])}
