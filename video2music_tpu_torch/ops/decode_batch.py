"""Batched (B>1) decoder-layer step of AMT 2.2, kernels 5 and 6 of the
port: csrc/decode_batch.cu.

Counterparts:
  * ops/pallas_decode_batch.py:batched_layer_step ->
    :func:`batched_layer_step` (the attention half of a layer for B clips
    at one shared ``pos``: the optional chord-embedding prologue, fused
    QKV + pairwise RoPE, masked self-attention over each clip's cache,
    cross-attention over its primed memory, and the SwiGLU FFN of a
    shallow layer);
  * ops/pallas_decode_batch.py:batched_moe_ffn (``gate=True``) ->
    :func:`batched_moe_ffn` (per-row router, shared expert / k, the
    routed experts weighted by their combine weights with every expert's
    weights read once per step for the whole batch, the residual + norm3,
    and with ``head_pack`` the final LayerNorm + chord head).

The Pallas kernel computes one attention function in two layouts
(``_wide_attention`` and ``_segmented_attention``, its ``wide=False``
form); the port computes that function once. The sublane-stacked slabs,
one-hot replication matmuls, diagonal probe and ``pick_block_b`` answer
Mosaic limits and are not carried over.

Unlike the Pallas kernel, whose caches are pure inputs and which returns
the new K/V rows for a ``dynamic_update_slice``, the port writes this
step's K/V rows IN PLACE at ``(b, pos)`` of the (B, S, D) self caches, as
the B=1 kernel does; the attention then reads rows 0..pos of the cache.

Rounding follows the batched Pallas kernel, not the B=1 one: q, the
cache-row probabilities before P.V and the attention output are rounded
to the compute dtype (the current row's probability stays f32); the deep
layer's output x2 leaves the attention half rounded, and the MoE residual
adds that rounded x2. In float32 every rounding is a no-op.

Layouts: weights (out, in) row-major, the dicts of
ops/decode_layer.py:pack_decoder_layers / pack_ends; caches (B, S, D) and
(B, Sm, D) with the heads concatenated along D.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import kernels
from .decode_layer import (MAX_TOP_K, _dot, _layer_norm, _rope_at, _rotate,
                           _swiglu, attend, embed_plain)

MAX_K = 1024  # csrc/batch_decode.cuh kMaxK: longest row a warp holds


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def batched_layer_step_plain(x, pos: int, p, k_cache, v_cache, k_cross,
                             v_cross, *, n_heads: int, rope=None,
                             tokens=None, embed_pack=None):
    """Plain version of :func:`batched_layer_step`."""
    dt = k_cache.dtype
    D = k_cache.shape[-1]
    if tokens is not None:
        x = embed_plain(*tokens, embed_pack, dt)
    qkv = _dot(x, p["wqkv"]) + p["bqkv"].float()
    q, k, v = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
    if rope is not None:
        cos, sin = _rope_at(rope, pos, D)
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    k_cache[:, pos] = k.to(dt)
    v_cache[:, pos] = v.to(dt)
    attn = attend(q.to(dt).float(), k_cache[:, :pos + 1],
                  v_cache[:, :pos + 1], n_heads, cur=pos, batched=True)
    x1 = _layer_norm(x.float() + (_dot(attn, p["wo"]) + p["bo"].float()),
                     p["norm_scale"][0], p["norm_bias"][0])
    cq = _dot(x1, p["cwq"]) + p["cbq"].float()
    if rope is not None:
        cq = _rotate(cq, cos, sin)
    cattn = attend(cq.to(dt).float(), k_cross, v_cross, n_heads,
                   batched=True)
    x2 = _layer_norm(x1 + (_dot(cattn, p["cwo"]) + p["cbo"].float()),
                     p["norm_scale"][1], p["norm_bias"][1])
    if "gate_w" not in p:
        h = _swiglu(x2, p["w1g"], p["b1g"], p["w2"], p["b2"])
        x2 = _layer_norm(x2 + h, p["norm_scale"][2], p["norm_bias"][2])
    return x2.to(dt)


def route_plain(x2, gate_w, gate_b, k_top: int):
    """Per-row top-k combine weights (B, E) f32: softmax over the k
    selected raw gate logits, zero elsewhere; the first index wins a tie.
    The expert ids stay on the device."""
    logits = _dot(x2, gate_w) + gate_b.float()
    remaining = logits.clone()
    idx, vals = [], []
    for _ in range(k_top):
        e = torch.argmax(remaining, dim=-1, keepdim=True)  # first maximal
        idx.append(e)
        vals.append(logits.gather(-1, e))
        remaining = remaining.scatter(-1, e, float("-inf"))
    exps = [torch.exp(v - vals[0]) for v in vals]
    denom = sum(exps)
    cw = torch.zeros_like(logits)
    for e, w in zip(idx, exps):
        cw = cw.scatter(-1, e, w / denom)
    return cw


def batched_moe_ffn_plain(x2, p, *, k_top: int = 2, head_pack=None):
    """Plain version of :func:`batched_moe_ffn`: every expert runs on every
    row and adds in expert order with its combine weight (zero where not
    selected), as the Pallas kernel's expert cells do."""
    dt = x2.dtype
    cw = route_plain(x2, p["gate_w"], p["gate_b"], k_top)
    acc = _swiglu(x2, p["w1g"], p["b1g"], p["w2"], p["b2"]) / float(k_top)
    for e in range(p["gate_w"].shape[0]):
        y = _swiglu(x2, p["ew1g"][e], p["eb1g"][e], p["ew2"][e], p["eb2"][e])
        acc = acc + cw[:, e:e + 1] * y
    x3 = _layer_norm(x2.float() + acc, p["norm_scale"][2], p["norm_bias"][2])
    if head_pack is None:
        return x3.to(dt)
    xf = _layer_norm(x3.to(dt), head_pack["dn_scale"], head_pack["dn_bias"])
    return (_dot(xf, head_pack["wout"]) + head_pack["bout"].float()).to(dt)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_LAYER_KEYS = ("wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo",
               "norm_scale", "norm_bias")
_FFN_KEYS = ("w1g", "b1g", "w2", "b2")
_EXPERT_KEYS = ("gate_w", "gate_b", "ew1g", "eb1g", "ew2", "eb2")
_EMBED_KEYS = ("emb_root", "emb_attr", "lc_w", "lc_krow", "lc_b")
_HEAD_KEYS = ("dn_scale", "dn_bias", "wout", "bout")


def _require_widths(D: int, F: int, what: str) -> None:
    kernels.require(D % 8 == 0 and F % 8 == 0, what,
                    f"D={D} and F={F} must be multiples of 8")
    kernels.require(D <= MAX_K and F <= MAX_K, what,
                    f"D={D} and F={F} must be at most {MAX_K}")


def layer_workspace_size(B: int, D: int, F: int) -> int:
    """f32 scratch of one batched layer step (csrc/decode_batch.cu
    run_layer)."""
    return B * (10 * D + F)


def moe_workspace_size(B: int, D: int, F: int, E: int) -> int:
    """f32 scratch of one batched MoE step (csrc/decode_batch.cu run_moe)."""
    return B * (MAX_TOP_K + (E + 1) * (F + D) + D)


def moe_route_size(B: int, E: int) -> int:
    """int32 scratch of one batched MoE step: the experts each clip chose
    (B, MAX_TOP_K), clips per expert (32) and their lists (E, B)."""
    return B * MAX_TOP_K + 32 + E * B


def _launch_layer(x, pos: int, p, k_cache, v_cache, k_cross, v_cross, *,
                  n_heads: int, rope, tokens, embed_pack, what: str):
    B, S, D = k_cache.shape
    F = p["w2"].shape[-1]
    dev, dt = k_cache.device, k_cache.dtype
    code = kernels.dtype_code(k_cache, what)
    hd = D // n_heads if n_heads else 0
    kernels.require(n_heads > 0 and D % n_heads == 0 and hd % 8 == 0
                    and hd <= 256, what, f"bad head split D={D} H={n_heads}")
    _require_widths(D, F, what)
    kernels.require(0 <= pos < S, what, f"pos {pos} outside cache of {S}")
    kernels.require(k_cross.dim() == 3 and k_cross.shape[0] == B
                    and k_cross.shape[2] == D
                    and v_cross.shape == k_cross.shape
                    and v_cache.shape == k_cache.shape, what,
                    "caches must be (B, S, D) and cross K/V (B, Sm, D)")
    shallow = "gate_w" not in p
    tensors = {k: p[k] for k in _LAYER_KEYS + (_FFN_KEYS if shallow else ())}
    tensors.update(k_cache=k_cache, v_cache=v_cache, k_cross=k_cross,
                   v_cross=v_cross)
    if tokens is None:
        kernels.require(x is not None and x.shape == (B, D), what,
                        "x must be (B, D) without the embed prologue")
        tensors["x"] = x
    else:
        tensors.update({k: embed_pack[k] for k in _EMBED_KEYS})
    kernels.require_like(tensors, k_cache, what)
    kernels.require(p["wqkv"].shape == (3 * D, D), what,
                    "wqkv must be (3D, D)")
    work = torch.empty(layer_workspace_size(B, D, F), device=dev,
                       dtype=torch.float32)
    y = torch.empty(B, D, device=dev, dtype=dt)
    a = kernels.BatchLayerArgs()
    P = kernels.ptr
    for name, t in tensors.items():
        setattr(a, name, P(t).value)
    if rope is not None:
        cos, sin = (t.to(device=dev, dtype=torch.float32).contiguous()
                    for t in rope)
        kernels.require(cos.shape[1] == hd // 2 and cos.shape[0] > pos, what,
                        "rope tables must be (>pos, head_dim/2)")
        a.rope_cos, a.rope_sin = P(cos).value, P(sin).value
    if tokens is not None:
        root, attr, key = tokens
        ids = [t.reshape(-1).to(device=dev, dtype=torch.int32).contiguous()
               for t in (root, attr)]
        kf = key.reshape(-1).to(device=dev, dtype=torch.float32).contiguous()
        kernels.require(all(t.numel() == B for t in ids + [kf]), what,
                        "token_root / token_attr / key must hold B values")
        a.token_root, a.token_attr = P(ids[0]).value, P(ids[1]).value
        a.key = P(kf).value
    a.work, a.y = P(work).value, P(y).value
    a.shallow = int(shallow)
    a.B, a.D, a.H, a.F, a.S, a.Sm, a.pos = (B, D, n_heads, F, S,
                                            k_cross.shape[1], pos)
    status = kernels.library().v2m_batched_layer(code, ctypes.byref(a),
                                                 kernels.stream_of(k_cache))
    kernels.check(status, what)
    return y


def batched_layer_step(x, pos: int, layer, k_cache, v_cache, k_cross,
                       v_cross, *, n_heads: int, rope=None,
                       tokens: Optional[Tuple] = None,
                       embed_pack: Optional[Dict[str, torch.Tensor]] = None):
    """Attention half (plus the SwiGLU FFN of a shallow layer) of one
    batched decoder-layer step.

    Args:
      x: (B, D) layer input in the compute dtype; None with ``tokens``.
      pos: position of the current token, shared by every clip (a host int).
      layer: one dict of ops/decode_layer.py:pack_decoder_layers.
      k_cache, v_cache: (B, S, D) self-attention caches, written in place
        at row ``pos`` of every clip.
      k_cross, v_cross: (B, Sm, D) primed memory K/V.
      rope: (cos, sin) float32 tables (>= S, head_dim/2) or None.
      tokens: optional (token_root, token_attr, key), each (B,) on the
        device: folds the chord-embedding prologue into this layer; needs
        ``embed_pack`` (ops/decode_layer.py:pack_ends).
    Returns:
      (B, D) in the compute dtype: the layer output of a shallow layer, or
      the post-norm2 activation of a deep (MoE) layer, which
      :func:`batched_moe_ffn` finishes.
    """
    what = "batched_layer_step"
    if kernels.use_plain(k_cache, what):
        return batched_layer_step_plain(
            x, pos, layer, k_cache, v_cache, k_cross, v_cross,
            n_heads=n_heads, rope=rope, tokens=tokens, embed_pack=embed_pack)
    y = _launch_layer(x, pos, layer, k_cache, v_cache, k_cross, v_cross,
                      n_heads=n_heads, rope=rope, tokens=tokens,
                      embed_pack=embed_pack, what=what)
    batched_layer_step.launches += 1
    return y


batched_layer_step.launches = 0


def batched_moe_ffn(x2, layer, *, k_top: int = 2,
                    head_pack: Optional[Dict[str, torch.Tensor]] = None):
    """MoE half of a deep layer for the whole batch.

    Args:
      x2: (B, D) post-norm2 activations from :func:`batched_layer_step`.
      layer: the deep layer's dict (gate_w (E, D), gate_b, the shared
        expert w1g/b1g/w2/b2 and the stacked experts ew1g (E, 2F, D),
        eb1g, ew2 (E, D, F), eb2).
      k_top: experts per row.
      head_pack: optional dict with dn_scale/dn_bias/wout/bout: folds the
        final LayerNorm + chord head in and returns logits.
    Returns:
      (B, D) layer output, or (B, n_out) logits with ``head_pack``, in the
      compute dtype.
    """
    what = "batched_moe_ffn"
    if kernels.use_plain(x2, what):
        return batched_moe_ffn_plain(x2, layer, k_top=k_top,
                                     head_pack=head_pack)
    B, D = x2.shape
    E, F2, _ = layer["ew1g"].shape
    F = F2 // 2
    dev, dt = x2.device, x2.dtype
    code = kernels.dtype_code(x2, what)
    _require_widths(D, F, what)
    kernels.require(1 <= k_top <= min(E, MAX_TOP_K) and E <= 32, what,
                    f"k_top={k_top} E={E} not supported")
    tensors = {k: layer[k] for k in _EXPERT_KEYS + _FFN_KEYS
               + ("norm_scale", "norm_bias")}
    if head_pack is not None:
        tensors.update({k: head_pack[k] for k in _HEAD_KEYS})
    tensors["x2"] = x2
    kernels.require_like(tensors, x2, what)
    kernels.require(layer["ew2"].shape == (E, D, F)
                    and layer["gate_w"].shape == (E, D), what,
                    "expert weights must be (E, 2F, D) / (E, D, F)")
    n_out = head_pack["wout"].shape[0] if head_pack is not None else D
    work = torch.empty(moe_workspace_size(B, D, F, E), device=dev,
                       dtype=torch.float32)
    sel = torch.empty(moe_route_size(B, E), device=dev, dtype=torch.int32)
    out = torch.empty(B, n_out, device=dev, dtype=dt)
    a = kernels.BatchMoeArgs()
    P = kernels.ptr
    for name, t in tensors.items():
        setattr(a, name, P(t).value)
    a.out, a.work, a.sel = P(out).value, P(work).value, P(sel).value
    a.B, a.D, a.F, a.E, a.k_top = B, D, F, E, k_top
    a.n_out = n_out if head_pack is not None else 0
    status = kernels.library().v2m_batched_moe(code, ctypes.byref(a),
                                               kernels.stream_of(x2))
    kernels.check(status, what)
    batched_moe_ffn.launches += 1
    return out


batched_moe_ffn.launches = 0
