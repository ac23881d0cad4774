"""Batched (B>1) decoder-layer step of the variant wirings, kernels 9 and
10 of the port: csrc/decode_variant.cu (v2m_variant_batched_layer,
v2m_variant_batched_moe).

Counterparts:
  * ops/pallas_decode_batch_variant.py:batched_variant_layer_step ->
    :func:`batched_variant_layer_step` (the attention half of a layer for B
    clips at one shared ``pos``, plus the FFN of a shallow layer; a deep
    layer returns x2 for the MoE half);
  * ops/pallas_decode_batch_variant.py:batched_variant_moe_ffn ->
    :func:`batched_variant_moe_ffn` (router, the shared expert when present,
    the routed GLU or SiLU-MLP experts, the closing residual in the layer's
    norm wiring).
The wirings, packed dicts and metas are those of ops/decode_variant.py.

Unlike the Pallas kernel, whose caches are pure inputs and which returns
the new K/V rows for the caller to append, the port writes this step's
K/V rows IN PLACE at ``(b, pos)`` of the (B, S, Dk) / (B, S, D) self
caches, as the B=1 step does.

Rounding follows the batched Pallas kernel, not the B=1 one: q, the cache
rows' probabilities and RPR biases, the value products, the differential
combine and the attention output are rounded to the compute dtype (the
current row's probability and bias stay f32); x2 crosses into the MoE half
in the compute dtype, and the MoE adds its experts in expert order.
"""

from __future__ import annotations

from .. import kernels
from .decode_variant import (VariantLayerMeta, _moe_expert_order, _norm,
                             launch, layer_plain)


def batched_variant_layer_plain(x, pos: int, p, meta: VariantLayerMeta,
                                k_cache, v_cache, k_cross, v_cross, *,
                                n_heads: int, rope=None,
                                norm: str = "rmsnorm",
                                pre_norm: bool = False):
    """Plain version of :func:`batched_variant_layer_step`."""
    return layer_plain(x, pos, p, meta, k_cache, v_cache, k_cross, v_cross,
                       n_heads=n_heads, rope=rope, k_top=0, norm=norm,
                       pre_norm=pre_norm, batched=True)


def batched_variant_moe_plain(x2, p, meta: VariantLayerMeta, *, k_top: int,
                              norm: str = "rmsnorm", pre_norm: bool = False):
    """Plain version of :func:`batched_variant_moe_ffn`."""
    ns, nb = p["norm_scale"], p["norm_bias"]
    xn = _norm(x2, ns[2], nb[2], norm).to(x2.dtype) if pre_norm else x2
    x3 = x2.float() + _moe_expert_order(xn, p, meta, k_top, x2.dtype)
    if not pre_norm:
        x3 = _norm(x3, ns[2], nb[2], norm)
    return x3.to(x2.dtype)


def batched_variant_layer_step(x, pos: int, layer, meta: VariantLayerMeta,
                               k_cache, v_cache, k_cross, v_cross, *,
                               n_heads: int, rope=None,
                               norm: str = "rmsnorm",
                               pre_norm: bool = False):
    """Attention half (plus the FFN of a shallow layer) of one batched
    variant decoder-layer step.

    Args:
      x: (B, D) layer input in the compute dtype.
      pos: position of the current token, shared by every clip (a host int).
      layer, meta: one dict and meta of
        ops/decode_variant.py:pack_variant_layers.
      k_cache, v_cache: (B, S, Dk) / (B, S, D) self caches, written in place
        at row ``pos`` of every clip.
      k_cross, v_cross: (B, Sm, Dc) / (B, Sm, D) primed memory K/V.
      rope: (cos, sin) float32 tables (>= S, head_dim/2) or None.
      norm: "layernorm" | "rmsnorm"; pre_norm: the residual wiring.
    Returns:
      (B, D) in the compute dtype: the layer output of a shallow layer, or
      x2 of a deep (MoE) layer, which :func:`batched_variant_moe_ffn`
      finishes.
    """
    what = "batched_variant_layer_step"
    kw = dict(n_heads=n_heads, rope=rope, norm=norm, pre_norm=pre_norm)
    if kernels.use_plain(k_cache, what):
        return batched_variant_layer_plain(x, pos, layer, meta, k_cache,
                                           v_cache, k_cross, v_cross, **kw)
    y = launch("batched_layer", x, pos, layer, meta, k_cache, v_cache,
               k_cross, v_cross, k_top=0, what=what, **kw)
    batched_variant_layer_step.launches += 1
    return y


batched_variant_layer_step.launches = 0


def batched_variant_moe_ffn(x2, layer, meta: VariantLayerMeta, *,
                            k_top: int, norm: str = "rmsnorm",
                            pre_norm: bool = False):
    """MoE half of a deep variant layer for the whole batch: x2 (B, D) from
    :func:`batched_variant_layer_step` -> (B, D) layer output, both in the
    compute dtype. Each expert's weights are read once for the clips its
    router listed."""
    what = "batched_variant_moe_ffn"
    if kernels.use_plain(x2, what):
        return batched_variant_moe_plain(x2, layer, meta, k_top=k_top,
                                         norm=norm, pre_norm=pre_norm)
    y = launch("batched_moe", x2, 0, layer, meta, None, None, None, None,
               n_heads=0, rope=None, k_top=k_top, norm=norm,
               pre_norm=pre_norm, what=what)
    batched_variant_moe_ffn.launches += 1
    return y


batched_variant_moe_ffn.launches = 0
