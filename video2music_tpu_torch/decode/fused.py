"""Fused decode steps (counterpart of decode/fused.py).

The V2 family (AMT 2.x with RoPE) has every B=1 backend of the JAX
sampler, each a ``step_logits(caches, token_root, token_attr, key, pos)``
closure beside the ``init_*caches`` it decodes on:
  * "ends" (``init_fused_caches`` / ``make_fused_ends_step``), the product
    default: the first layer runs with the chord-embedding prologue folded
    in, the middle layers as decode-layer steps, the last layer with the
    final-LayerNorm + head epilogue (ops/decode_layer.py). With
    ``split=False`` the whole step is one launch of the cooperative kernel
    (ops/decode_stack.py ``decode_flat_monolith_step``) over all layers;
  * "layer" / "on" (``make_fused_step``, on the same caches): one
    decode-layer step per layer, the embedding and the final norm + head as
    plain PyTorch glue (``model._embed_chords``, ``model.head``), as the
    JAX step keeps them in XLA; ``quantize="int8"`` reads int8 weights;
  * "stack" (``init_fused_stack_caches`` / ``make_fused_stack_step``): one
    cooperative-kernel launch per run of same-kind layers over (n, S, D)
    caches (two for 2.2), the same glue around them;
  * "monolith" (``init_fused_monolith_caches`` /
    ``make_fused_monolith_step``): the whole step in one launch over
    (L, S, D) caches, the embed and head folded as in "ends".
The cooperative kernel takes at most ``kernels.MAX_STACK_LAYERS`` (16)
layers a launch, so "monolith", ``split=False`` and each segment of
"stack" cut a longer run into chunks of at most 16 layers, one launch
each: the embed folds into the first chunk, the head into the last, and a
chunk hands the next its output in the model dtype, where the JAX kernels
round the residual stream after every layer too.
At B>1 the batched step (``init_fused_batch_caches`` /
``make_fused_batch_step``): every layer runs the batched attention step
(ops/decode_batch.py); every MoE layer finishes with the batched MoE step,
which routes in the kernel. ``ends=True`` folds the embedding into the
first step and the head into the last MoE step; ``ends=False`` keeps both
as plain glue. ``kv_quant="int8"`` keeps every self and cross cache as
int8 rows with f32 row scales (``ksc{i}`` / ``vsc{i}`` / ``cksc{i}`` /
``cvsc{i}``), which the attention step reads and appends to.

The variant wirings (the base AMT, V1.x, 2.0 and V3): one variant kernel
per layer at B=1 (``init_fused_variant_caches`` /
``make_fused_variant_step``, ops/decode_variant.py; ``quantize="int8"``
reads int8 weights) and the batched pair at B>1
(``init_fused_batch_variant_caches`` / ``make_fused_batch_variant_step``,
ops/decode_batch_variant.py). The embedding (through the frozen chord
table where the wiring has one, so these steps take the current chord ids
as ``token=``), the sinusoidal or learned position row at ``pos``, and the
final norm + head are plain PyTorch glue around the kernels, as the JAX
steps keep them in XLA (decode/fused.py:352-377); differential layers
carry 2D-wide K caches.

Not ported: cache segmentation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .. import kernels
from ..ops.decode_batch import (batched_layer_step, batched_moe_ffn,
                                quantize_kv_rows)
from ..ops.decode_batch_variant import (batched_variant_layer_step,
                                        batched_variant_moe_ffn)
from ..ops.decode_layer import (decode_ends_step, decode_layer_step,
                                pack_decoder_layers, pack_ends)
from ..ops.decode_stack import (decode_flat_monolith_step,
                                decode_monolith_step, decode_segment_step,
                                decoder_segments, pack_decoder_segments,
                                pack_monolith)
from ..ops.decode_variant import (decode_variant_layer_step,
                                  pack_variant_layers)
from ..ops.embeddings import rope_table


def rope_tables(model, device):
    """(cos, sin) float32 tables (S, head_dim/2) of the decoder's pairwise
    RoPE on ``device``, or None for a wiring without RoPE."""
    cfg = model.cfg
    if not cfg.decoder_layers[0].attn.rope:
        return None
    table = rope_table(max(cfg.max_seq_chord, cfg.max_seq_video),
                       cfg.d_model // cfg.num_heads, device)
    return table[..., 0].contiguous(), table[..., 1].contiguous()


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


def _kw(model, layers):
    cfg = model.cfg
    return dict(n_heads=cfg.num_heads, k_top=cfg.moe.n_experts_per_token,
                rope=rope_tables(model, layers[0]["wqkv"].device))


def _chunks(n: int) -> List[Tuple[int, int]]:
    """[a, b) runs of at most kernels.MAX_STACK_LAYERS of n layers, in
    order: one cooperative-kernel launch each."""
    m = kernels.MAX_STACK_LAYERS
    return [(a, min(a + m, n)) for a in range(0, n, m)]


def _rows(t: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Layers [a, b) of stacked caches (a view; t itself when whole)."""
    return t if (a, b) == (0, t.shape[0]) else t[a:b]


def make_fused_ends_step(model, split: bool = True):
    """Returns ``step_logits(caches, token_root, token_attr, key, pos)`` ->
    (1, CHORD_SIZE) logits in the model dtype; token_root / token_attr /
    key are (1,) tensors on the model's device, pos a host int. The self
    caches are written in place. ``split=False``: the whole step, embed and
    head folded, as one cooperative-kernel launch over every layer (one per
    chunk of 16 layers beyond 16)."""
    layers = pack_decoder_layers(model)
    head = pack_ends(model)
    L = len(layers)
    kw = _kw(model, layers)

    def kv(caches, i):
        return (caches[f"k{i}"], caches[f"v{i}"], caches[f"ck{i}"],
                caches[f"cv{i}"])

    if not split:
        runs = [(a, b, layers[a:b]) for a, b in _chunks(L)]
        plans = [{} for _ in runs]

        def whole_step(caches, token_root, token_attr, key, pos: int):
            x = None
            for (a, b, chunk), plan in zip(runs, plans):
                x = decode_flat_monolith_step(
                    token_root, token_attr, key, pos, chunk, head,
                    [kv(caches, i) for i in range(a, b)], embed=a == 0,
                    fold_head=b == L, x=x, plans=plan, **kw)
            return x

        return whole_step

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


def make_fused_step(model, quantize=None):
    """The "layer" backend on :func:`init_fused_caches` caches: the chord
    embedding as plain glue (``model._embed_chords``), one decode-layer step
    per layer, the final norm + head as plain glue (``model.head``).
    ``quantize="int8"``: the layers read int8 weights with per-row scales
    (ops/decode_layer.py). Same step_logits contract as
    :func:`make_fused_ends_step`."""
    layers = pack_decoder_layers(model, quantize=quantize)
    kw = _kw(model, layers)

    def step_logits(caches, token_root, token_attr, key, pos: int):
        x = _embed(model, None, token_root, token_attr, key, pos)
        for i, layer in enumerate(layers):
            x = decode_layer_step(x, pos, layer, caches[f"k{i}"],
                                  caches[f"v{i}"], caches[f"ck{i}"],
                                  caches[f"cv{i}"], **kw)
        return model.head(x)

    return step_logits


def init_fused_stack_caches(model, cross) -> Dict[str, torch.Tensor]:
    """Per segment (ops/decode_stack.decoder_segments) zero self caches
    sk{s} / sv{s} (n, S, D) beside the stacked primed cross K/V sck{s} /
    scv{s} (n, Sm, D) of one clip."""
    if cross[0][0].shape[0] != 1:
        raise ValueError("the fused stack step decodes one clip (B=1)")
    S = model.cfg.max_seq_chord
    caches = {}
    for s, seg in enumerate(decoder_segments(model.cfg)):
        ck = torch.stack([cross[i][0][0] for i in seg["layers"]])
        cv = torch.stack([cross[i][1][0] for i in seg["layers"]])
        n, _, D = ck.shape
        caches[f"sk{s}"] = ck.new_zeros(n, S, D)
        caches[f"sv{s}"] = ck.new_zeros(n, S, D)
        caches[f"sck{s}"] = ck.contiguous()
        caches[f"scv{s}"] = cv.contiguous()
    return caches


def make_fused_stack_step(model):
    """The "stack" backend on :func:`init_fused_stack_caches` caches: one
    :func:`decode_segment_step` launch per segment (per chunk of 16 layers
    of a longer one) between the plain embed and head glue of
    :func:`make_fused_step`."""
    segs = pack_decoder_segments(model)
    kw = _kw(model, segs[0]["layers"])
    runs = [(s, a, b, dict(seg, layers=seg["layers"][a:b]))
            for s, seg in enumerate(segs)
            for a, b in _chunks(len(seg["layers"]))]
    plans = [{} for _ in runs]

    def step_logits(caches, token_root, token_attr, key, pos: int):
        x = _embed(model, None, token_root, token_attr, key, pos)
        for (s, a, b, seg), plan in zip(runs, plans):
            x = decode_segment_step(
                x, pos, seg, *(_rows(caches[f"{n}{s}"], a, b)
                               for n in ("sk", "sv", "sck", "scv")),
                plans=plan, **kw)
        return model.head(x)

    return step_logits


def init_fused_monolith_caches(model, cross) -> Dict[str, torch.Tensor]:
    """(L, S, D) zero self caches k / v beside the (L, Sm, D) stacked
    primed cross K/V ck / cv of one clip."""
    if cross[0][0].shape[0] != 1:
        raise ValueError("the fused monolith step decodes one clip (B=1)")
    ck = torch.stack([c[0][0] for c in cross])
    cv = torch.stack([c[1][0] for c in cross])
    L, _, D = ck.shape
    S = model.cfg.max_seq_chord
    return {"k": ck.new_zeros(L, S, D), "v": ck.new_zeros(L, S, D),
            "ck": ck.contiguous(), "cv": cv.contiguous()}


def make_fused_monolith_step(model):
    """The "monolith" backend on :func:`init_fused_monolith_caches` caches:
    the whole step (embed, every layer, final norm, head) as one
    :func:`decode_monolith_step` launch (one per chunk of 16 layers of a
    deeper model, over views of the stacked caches)."""
    packed = pack_monolith(model)
    kw = _kw(model, packed["layers"])
    L = len(packed["layers"])
    runs = [(a, b, dict(packed, layers=packed["layers"][a:b]))
            for a, b in _chunks(L)]
    plans = [{} for _ in runs]

    def step_logits(caches, token_root, token_attr, key, pos: int):
        x = None
        for (a, b, chunk), plan in zip(runs, plans):
            x = decode_monolith_step(
                token_root, token_attr, key, pos, chunk,
                *(_rows(caches[n], a, b) for n in ("k", "v", "ck", "cv")),
                embed=a == 0, fold_head=b == L, x=x, plans=plan, **kw)
        return x

    return step_logits


def init_fused_batch_caches(model, cross, kv_quant: Optional[str] = None
                            ) -> Dict[str, torch.Tensor]:
    """Batched analogue of :func:`init_fused_caches`: zero (B, S, D) self
    caches k{i}/v{i} beside the primed (B, Sm, D) cross K/V ck{i}/cv{i},
    heads concatenated along D. ``kv_quant="int8"``: every cache is int8,
    the self caches with (B, S, 1) f32 row scales ksc{i}/vsc{i} that start
    at zero, the primed cross K/V quantized here once (quantize_kv_rows)
    with their scales cksc{i}/cvsc{i} (JAX decode/fused.py:421-457)."""
    if kv_quant not in (None, "int8"):
        raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
    S = model.cfg.max_seq_chord
    caches = {}
    for i, (ck, cv) in enumerate(cross):
        B, _, D = ck.shape
        if kv_quant is None:
            caches[f"k{i}"] = ck.new_zeros(B, S, D)
            caches[f"v{i}"] = ck.new_zeros(B, S, D)
            caches[f"ck{i}"] = ck.contiguous()
            caches[f"cv{i}"] = cv.contiguous()
            continue
        for name in ("k", "v"):
            caches[f"{name}{i}"] = torch.zeros(B, S, D, dtype=torch.int8,
                                               device=ck.device)
            caches[f"{name}sc{i}"] = torch.zeros(B, S, 1, device=ck.device)
        caches[f"ck{i}"], caches[f"cksc{i}"] = quantize_kv_rows(ck)
        caches[f"cv{i}"], caches[f"cvsc{i}"] = quantize_kv_rows(cv)
    return caches


def make_fused_batch_step(model, ends: bool = True,
                          kv_quant: Optional[str] = None):
    """Returns ``step_logits(caches, token_root, token_attr, key, pos)`` ->
    (B, CHORD_SIZE) logits in the model dtype; token_root / token_attr /
    key are (B,) tensors on the model's device, pos a host int shared by
    every clip. The self caches are written in place.

    Each MoE layer routes inside its MoE step. ``ends=True`` (the JAX
    form of "auto" / "ends"): the embedding prologue folds into layer 0's
    attention step and the last layer, a MoE layer in every 2.x wiring,
    emits the logits. ``ends=False`` ("on" at B>1): the embedding and the
    final norm + head run as plain glue around the kernels.
    ``kv_quant="int8"``: the caches of :func:`init_fused_batch_caches`
    with ``kv_quant="int8"``, their scales passed to every layer."""
    if kv_quant not in (None, "int8"):
        raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
    cfg = model.cfg
    layers = pack_decoder_layers(model)
    if ends and "gate_w" not in layers[-1]:
        raise ValueError("the batched step folds the head into a last MoE "
                         "layer; this wiring ends with a SwiGLU layer")
    head = pack_ends(model)
    H = cfg.num_heads
    k_top = cfg.moe.n_experts_per_token
    L = len(layers)
    rope = rope_tables(model, layers[0]["wqkv"].device)

    def step_logits(caches, token_root, token_attr, key, pos: int):
        x = None if ends else _embed(model, None, token_root, token_attr,
                                     key, pos)
        for i, layer in enumerate(layers):
            fold = ends and i == 0
            x = batched_layer_step(
                x, pos, layer, caches[f"k{i}"], caches[f"v{i}"],
                caches[f"ck{i}"], caches[f"cv{i}"], n_heads=H, rope=rope,
                tokens=(token_root, token_attr, key) if fold else None,
                embed_pack=head if fold else None,
                kv_scales=None if kv_quant is None else tuple(
                    caches[f"{n}{i}"] for n in ("ksc", "vsc", "cksc",
                                                "cvsc")))
            if "gate_w" in layer:
                x = batched_moe_ffn(
                    x, layer, k_top=k_top,
                    head_pack=head if ends and i == L - 1 else None)
        return x if ends else model.head(x)

    return step_logits


def init_fused_variant_caches(model, cross) -> Dict[str, torch.Tensor]:
    """Variant analogue of :func:`init_fused_caches`: zero self caches
    k{i} (S, Dk) / v{i} (S, D), where Dk = 2D for a differential layer,
    beside the primed cross K/V ck{i} / cv{i} of one clip."""
    caches = init_fused_batch_variant_caches(model, cross)
    if caches["k0"].shape[0] != 1:
        raise ValueError("the fused variant step decodes one clip (B=1)")
    return {k: v[0] for k, v in caches.items()}


def init_fused_batch_variant_caches(model, cross) -> Dict[str, torch.Tensor]:
    """Zero (B, S, Dk) / (B, S, D) self caches beside the primed (B, Sm, .)
    cross K/V, heads concatenated along the width."""
    S = model.cfg.max_seq_chord
    caches = {}
    for i, (layer, (ck, cv)) in enumerate(zip(model.decoder_layers, cross)):
        B, _, D = cv.shape
        caches[f"k{i}"] = cv.new_zeros(B, S, layer.self_attn.qk_dim)
        caches[f"v{i}"] = cv.new_zeros(B, S, D)
        caches[f"ck{i}"] = ck.contiguous()
        caches[f"cv{i}"] = cv.contiguous()
    return caches


def _variant_setup(model, quantize: Optional[str] = None):
    """Packed layers, metas and the step's keyword arguments."""
    cfg = model.cfg
    layers, metas = pack_variant_layers(model, quantize=quantize)
    kw = dict(n_heads=cfg.num_heads, norm=cfg.norm, pre_norm=cfg.pre_norm,
              rope=rope_tables(model, layers[0]["wqkv"].device))
    return layers, metas, kw


def _embed(model, token, token_root, token_attr, key, pos: int):
    """The decoder input of the current tokens at ``pos``: (B,) ids -> (B,
    D), the chord embedding plus the position row (model.embed_step)."""
    ids = [None if t is None else t.reshape(-1, 1)
           for t in (token, token_root, token_attr)]
    return model.embed_step(*ids, key, pos)[:, 0]


def make_fused_variant_step(model, quantize: Optional[str] = None):
    """Returns ``step_logits(caches, token_root, token_attr, key, pos,
    token=None)`` -> (1, CHORD_SIZE) logits in the model dtype for a variant
    wiring at B=1: the embedding and position row, one variant kernel per
    layer, the final norm and head. token_root / token_attr / key (and the
    chord ids ``token``, read with the chord table only) are (1,) tensors
    on the model's device, pos a host int; the self caches are written in
    place.
    ``quantize="int8"``: the layers read int8 weights with per-row scales
    (ops/decode_variant.py)."""
    layers, metas, kw = _variant_setup(model, quantize)
    k_top = model.cfg.moe.n_experts_per_token

    def step_logits(caches, token_root, token_attr, key, pos: int,
                    token=None):
        x = _embed(model, token, token_root, token_attr, key, pos)
        for i, (p, meta) in enumerate(zip(layers, metas)):
            x = decode_variant_layer_step(
                x, pos, p, meta, caches[f"k{i}"], caches[f"v{i}"],
                caches[f"ck{i}"], caches[f"cv{i}"], k_top=k_top, **kw)
        return model.head(x)

    return step_logits


def make_fused_batch_variant_step(model):
    """Batched (B>1) analogue of :func:`make_fused_variant_step`: each layer
    runs the batched variant attention step, a deep layer then the batched
    variant MoE step. Returns (B, CHORD_SIZE) logits; pos is shared by every
    clip."""
    layers, metas, kw = _variant_setup(model)
    k_top = model.cfg.moe.n_experts_per_token
    norm = dict(norm=kw["norm"], pre_norm=kw["pre_norm"])

    def step_logits(caches, token_root, token_attr, key, pos: int,
                    token=None):
        x = _embed(model, token, token_root, token_attr, key, pos)
        for i, (p, meta) in enumerate(zip(layers, metas)):
            x = batched_variant_layer_step(
                x, pos, p, meta, caches[f"k{i}"], caches[f"v{i}"],
                caches[f"ck{i}"], caches[f"cv{i}"], **kw)
            if meta.ffn == "moe":
                x = batched_variant_moe_ffn(x, p, meta, k_top=k_top, **norm)
        return model.head(x)

    return step_logits
