"""Fused decode step at B=1 (counterpart of decode/fused.py:
``init_fused_caches`` and the split "ends" step of
``make_fused_ends_step``, the product's B=1 backend).

The first layer runs with the chord-embedding prologue folded in, the
middle layers as plain decode-layer steps, the last layer with the
final-LayerNorm + head epilogue (ops/decode_layer.py). The whole-step
monolith (``split=False``) and the other fused backends are not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.decode_layer import (decode_ends_step, decode_layer_step,
                                pack_decoder_layers, pack_ends)
from ..ops.embeddings import rope_table


def init_fused_caches(model, cross) -> Dict[str, torch.Tensor]:
    """Zero self-attention caches k{i}/v{i} (S, D) beside the primed cross
    K/V ck{i}/cv{i} (Sm, D) of one clip (``cross`` from model.prime)."""
    S = model.cfg.max_seq_chord
    caches = {}
    for i, (ck, cv) in enumerate(cross):
        if ck.shape[0] != 1:
            raise ValueError("the fused step decodes one clip (B=1)")
        D = ck.shape[-1]
        caches[f"k{i}"] = ck.new_zeros(S, D)
        caches[f"v{i}"] = ck.new_zeros(S, D)
        caches[f"ck{i}"] = ck[0].contiguous()
        caches[f"cv{i}"] = cv[0].contiguous()
    return caches


def make_fused_ends_step(model):
    """Returns ``step_logits(caches, token_root, token_attr, key, pos)`` ->
    (1, CHORD_SIZE) logits in the model dtype; token_root / token_attr /
    key are (1,) tensors on the model's device, pos a host int. The self
    caches are written in place."""
    cfg = model.cfg
    layers = pack_decoder_layers(model)
    head = pack_ends(model)
    H = cfg.num_heads
    k_top = cfg.moe.n_experts_per_token
    L = len(layers)
    rope = None
    if cfg.decoder_layers[0].attn.rope:
        table = rope_table(max(cfg.max_seq_chord, cfg.max_seq_video),
                           cfg.d_model // H, layers[0]["wqkv"].device)
        rope = (table[..., 0].contiguous(), table[..., 1].contiguous())
    kw = dict(n_heads=H, k_top=k_top, rope=rope)

    def kv(caches, i):
        return (caches[f"k{i}"], caches[f"v{i}"], caches[f"ck{i}"],
                caches[f"cv{i}"])

    def step_logits(caches, token_root, token_attr, key, pos: int):
        x = decode_ends_step(token_root, token_attr, key, pos, layers[0],
                             head, *kv(caches, 0), embed=True,
                             fold_head=(L == 1), **kw)
        if L == 1:
            return x
        for i in range(1, L - 1):
            x = decode_layer_step(x, pos, layers[i], *kv(caches, i), **kw)
        return decode_ends_step(None, None, None, pos, layers[-1], head,
                                *kv(caches, L - 1), embed=False,
                                fold_head=True, x=x, **kw)

    return step_logits
