"""Batched (B>1) decoder-layer step of AMT 2.2, kernels 5 and 6 of the
port: csrc/decode_batch.cu.

Counterparts:
  * ops/pallas_decode_batch.py:batched_layer_step ->
    :func:`batched_layer_step` (the attention half of a layer for B clips
    at one shared ``pos``: the optional chord-embedding prologue, fused
    QKV + pairwise RoPE, masked self-attention over each clip's cache,
    cross-attention over its primed memory, and the SwiGLU FFN of a
    shallow layer; with ``kv_scales`` over int8 caches);
  * ops/pallas_decode_batch.py:quantize_kv_rows -> :func:`quantize_kv_rows`;
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

int8 KV caches (``kv_scales=``, the Pallas kernel's ``quant=True`` form,
kv_quant="int8" of the sampler): the four caches hold int8 rows with one
f32 scale per row (:func:`quantize_kv_rows`). This step quantizes its K/V
rows from the f32 roped rows and writes them and their scales in place at
``pos``. A cached row's logit is (q . k_int) / sqrt(hd) times its K scale,
and its probability times its V scale is rounded to the compute dtype
before P.V over the integer V (the Pallas ``_wide_attention``); the
current row attends with its dequantized K/V rounded to the compute dtype
and an f32 probability, as the Pallas kernel's (C, C) probe does.

Layouts: weights (out, in) row-major, the dicts of
ops/decode_layer.py:pack_decoder_layers / pack_ends; caches (B, S, D) and
(B, Sm, D) with the heads concatenated along D; scales (B, S, 1) and
(B, Sm, 1).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import kernels
from .decode_layer import (_dot, _layer_norm, _rope_at, _rotate,
                           _swiglu, attend, decode_shape_fault, embed_plain,
                           log_route, selw_floats)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def quantize_kv_rows(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of KV-cache rows (JAX quantize_kv_rows):
    (..., D) -> (int8 (..., D), f32 scales (..., 1)). s = max|x| / 127 as
    an IEEE division (1 for an all-zero row), q = round(x / s), half to
    even. The divisors are tensors: PyTorch turns a division by a Python
    scalar on the card into a product with its reciprocal."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = amax / torch.full_like(amax, 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return torch.round(xf / s).to(torch.int8), s


def attend_int8(q, k, v, k_scale, v_scale, n_heads: int, dt, k_cur=None,
                v_cur=None):
    """The int8-KV attention of the batched kernel: q (B, D) f32, already
    rounded to ``dt``, over the int8 rows of k / v (B, R, D) with their
    (B, R, 1) f32 scales and, for self-attention, the current row k_cur /
    v_cur (B, D) f32 (dequantized and rounded to dt) -> (B, D) f32 rounded
    to dt. A cached row's logit is (q . k) / sqrt(hd) * k_scale and its
    probability times v_scale is rounded to dt before P.V; the current
    row's logit is q . k_cur / sqrt(hd) and its probability stays f32."""
    B, R, D = k.shape
    hd = D // n_heads
    qh = q.view(B, n_heads, hd)
    logits = torch.einsum("bhd,bshd->bhs", qh,
                          k.float().view(B, R, n_heads, hd)) * hd ** -0.5 \
        * k_scale.view(B, 1, R)
    if k_cur is not None:
        cur = torch.einsum("bhd,bhd->bh", qh, k_cur.view(B, n_heads, hd)) \
            * hd ** -0.5
        logits = torch.cat([logits, cur[..., None]], dim=-1)
    p = torch.softmax(logits, dim=-1)
    pv = (p[..., :R] * v_scale.view(B, 1, R)).to(dt).float()
    out = torch.einsum("bhs,bshd->bhd", pv, v.float().view(B, R, n_heads, hd))
    if v_cur is not None:
        out = out + p[..., R:] * v_cur.view(B, n_heads, hd)
    return out.to(dt).float().reshape(B, D)


def batched_layer_step_plain(x, pos: int, p, k_cache, v_cache, k_cross,
                             v_cross, *, n_heads: int, rope=None,
                             tokens=None, embed_pack=None, kv_scales=None):
    """Plain version of :func:`batched_layer_step`."""
    dt = p["wqkv"].dtype
    D = k_cache.shape[-1]
    if tokens is not None:
        x = embed_plain(*tokens, embed_pack, dt)
    qkv = _dot(x, p["wqkv"]) + p["bqkv"].float()
    q, k, v = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
    if rope is not None:
        cos, sin = _rope_at(rope, pos, D)
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    if kv_scales is None:
        k_cache[:, pos] = k.to(dt)
        v_cache[:, pos] = v.to(dt)
        attn = attend(q.to(dt).float(), k_cache[:, :pos + 1],
                      v_cache[:, :pos + 1], n_heads, cur=pos, batched=True)
    else:
        k_scale, v_scale = kv_scales[:2]
        current = []
        for row, cache, scale in ((k, k_cache, k_scale),
                                  (v, v_cache, v_scale)):
            q8, s = quantize_kv_rows(row)
            cache[:, pos] = q8
            scale[:, pos] = s
            current.append((q8.float() * s).to(dt).float())
        attn = attend_int8(q.to(dt).float(), k_cache[:, :pos],
                           v_cache[:, :pos], k_scale[:, :pos],
                           v_scale[:, :pos], n_heads, dt, *current)
    x1 = _layer_norm(x.float() + (_dot(attn, p["wo"]) + p["bo"].float()),
                     p["norm_scale"][0], p["norm_bias"][0])
    cq = _dot(x1, p["cwq"]) + p["cbq"].float()
    if rope is not None:
        cq = _rotate(cq, cos, sin)
    if kv_scales is None:
        cattn = attend(cq.to(dt).float(), k_cross, v_cross, n_heads,
                       batched=True)
    else:
        cattn = attend_int8(cq.to(dt).float(), k_cross, v_cross,
                            kv_scales[2], kv_scales[3], n_heads, dt)
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
    log_route(torch.cat(idx, dim=-1))
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


def batched_gemv_plain(x, w, bias):
    """Plain version of :func:`batched_gemv`."""
    return (_dot(x, w) + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def batched_gemv(x, w, bias):
    """y = x . w^T + bias for x (B, K), w (N, K), bias (N,), all in one
    compute dtype, accumulated in f32 -> (B, N) in that dtype: the GEMV of
    the batched decode chains alone (csrc/batch_decode.cuh; for bf16 at
    B >= 2 the tensor-core instance), a yardstick for the block."""
    what = "batched_gemv"
    if kernels.use_plain(x, what):
        return batched_gemv_plain(x, w, bias)
    B, K = x.shape
    N = w.shape[0]
    code = kernels.dtype_code(x, what)
    kernels.require(K % 8 == 0 and w.shape == (N, K) and bias.shape == (N,),
                    what, "x (B, K), w (N, K), bias (N,), K a multiple of 8")
    kernels.require_like(dict(x=x, w=w, bias=bias), x, what)
    y = torch.empty(B, N, device=x.device, dtype=x.dtype)
    P = kernels.ptr
    kernels.check(kernels.library().v2m_batched_gemv(
        code, P(x), P(w), P(bias), P(y), B, K, N, kernels.stream_of(x)), what)
    batched_gemv.launches += 1
    return y


batched_gemv.launches = 0


_LAYER_KEYS = ("wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo",
               "norm_scale", "norm_bias")
_FFN_KEYS = ("w1g", "b1g", "w2", "b2")
_EXPERT_KEYS = ("gate_w", "gate_b", "ew1g", "eb1g", "ew2", "eb2")
_EMBED_KEYS = ("emb_root", "emb_attr", "lc_w", "lc_krow", "lc_b")
_HEAD_KEYS = ("dn_scale", "dn_bias", "wout", "bout")


def layer_workspace_size(B: int, D: int, F: int, quant: bool = False) -> int:
    """f32 scratch of one batched layer step (csrc/decode_batch.cu
    run_layer); the int8-KV form adds the f32 K/V rows and their
    dequantized copies, (B, 2D) each."""
    return B * (10 * D + F + (4 * D if quant else 0))


def moe_workspace_size(B: int, D: int, F: int, E: int, k_top: int) -> int:
    """f32 scratch of one batched MoE step (csrc/decode_batch.cu run_moe):
    the router weights (B, k_top), padded to a multiple of 4, the
    activations (E + 1, B, F), the expert outputs (E + 1, B, D) and the
    closing rows (B, D)."""
    return selw_floats(B * k_top) + B * ((E + 1) * (F + D) + D)


def dense_experts(B: int, E: int, k_top: int, dtype) -> bool:
    """Whether a MoE step runs its experts densely (csrc/decode_batch.cu
    run_moe: every expert slot takes every clip on the tensor-core GEMV,
    no clip lists; the close reads only the selected experts' outputs, so
    an unselected one never reaches the sum) rather than routed (each
    expert slot stages and computes only the clips its router listed, on
    the FMA kernel). The tensor cores take bf16 at B >= 2 only. The cut,
    2 B k_top >= 3 E, is where the two crossed on an H100 (chip_smoke.py
    "expert cut", PERF.md: dense ~0.029 ms at B=2-8 for 6 experts top-2,
    routed 0.023 at B=2 rising to 0.034 at B=8, equal near B=4-5; at 40
    experts top-10 dense ~0.11 ms, routed 0.07 at B=2, equal at B=6)."""
    return dtype == torch.bfloat16 and B >= 2 and 2 * B * k_top >= 3 * E


def moe_route_size(B: int, E: int, k_top: int) -> int:
    """int32 scratch of one batched MoE step: the experts each clip chose
    (B, k_top), clips per expert (E) and their lists (E, B)."""
    return B * k_top + E + E * B


def _launch_layer(x, pos: int, p, k_cache, v_cache, k_cross, v_cross, *,
                  n_heads: int, rope, tokens, embed_pack, kv_scales,
                  what: str):
    B, S, D = k_cache.shape
    F = p["w2"].shape[-1]
    dev, dt = k_cache.device, p["wqkv"].dtype
    code = kernels.dtype_code(p["wqkv"], what)
    hd = D // n_heads if n_heads else 0
    quant = kv_scales is not None
    fault = decode_shape_fault(D, n_heads, (F,))
    kernels.require(fault is None, what, fault)
    kernels.require(0 <= pos < S, what, f"pos {pos} outside cache of {S}")
    kernels.require(k_cross.dim() == 3 and k_cross.shape[0] == B
                    and k_cross.shape[2] == D
                    and v_cross.shape == k_cross.shape
                    and v_cache.shape == k_cache.shape, what,
                    "caches must be (B, S, D) and cross K/V (B, Sm, D)")
    shallow = "gate_w" not in p
    tensors = {k: p[k] for k in _LAYER_KEYS + (_FFN_KEYS if shallow else ())}
    caches = dict(k_cache=k_cache, v_cache=v_cache, k_cross=k_cross,
                  v_cross=v_cross)
    if quant:  # int8 caches beside f32 row scales, checked apart
        Sm = k_cross.shape[1]
        kernels.require(len(kv_scales) == 4, what,
                        "kv_scales must be (k, v, ck, cv) scales")
        for name, t in caches.items():
            kernels.require(t.dtype == torch.int8 and t.device == dev
                            and t.is_contiguous(), what,
                            f"{name} must be a contiguous int8 tensor on "
                            f"{dev}")
        scales = dict(zip(("k_scale", "v_scale", "ck_scale", "cv_scale"),
                          kv_scales))
        for (name, t), rows in zip(scales.items(), (S, S, Sm, Sm)):
            kernels.require(t.dtype == torch.float32 and t.device == dev
                            and t.is_contiguous()
                            and tuple(t.shape) == (B, rows, 1), what,
                            f"{name} must be a contiguous float32 "
                            f"({B}, {rows}, 1) tensor on {dev}")
    else:
        tensors.update(caches)
    if tokens is None:
        kernels.require(x is not None and x.shape == (B, D), what,
                        "x must be (B, D) without the embed prologue")
        tensors["x"] = x
    else:
        tensors.update({k: embed_pack[k] for k in _EMBED_KEYS})
    kernels.require_like(tensors, p["wqkv"], what)
    kernels.require(p["wqkv"].shape == (3 * D, D), what,
                    "wqkv must be (3D, D)")
    work = torch.empty(layer_workspace_size(B, D, F, quant), device=dev,
                       dtype=torch.float32)
    y = torch.empty(B, D, device=dev, dtype=dt)
    a = kernels.BatchLayerArgs()
    P = kernels.ptr
    for name, t in tensors.items():
        setattr(a, name, P(t).value)
    if quant:
        for name, t in {**caches, **scales}.items():
            setattr(a, name, P(t).value)
        a.quant = 1
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
                       embed_pack: Optional[Dict[str, torch.Tensor]] = None,
                       kv_scales: Optional[Tuple] = None):
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
      kv_scales: optional (k_scale, v_scale, ck_scale, cv_scale), f32
        (B, S, 1), (B, S, 1), (B, Sm, 1), (B, Sm, 1): the four caches are
        then int8 (:func:`quantize_kv_rows`), and this step's int8 rows
        and their scales are written in place at ``pos``.
    Returns:
      (B, D) in the compute dtype (the layer's): the layer output of a
      shallow layer, or the post-norm2 activation of a deep (MoE) layer,
      which :func:`batched_moe_ffn` finishes.
    """
    what = "batched_layer_step"
    if kernels.use_plain(k_cache, what):
        return batched_layer_step_plain(
            x, pos, layer, k_cache, v_cache, k_cross, v_cross,
            n_heads=n_heads, rope=rope, tokens=tokens, embed_pack=embed_pack,
            kv_scales=kv_scales)
    y = _launch_layer(x, pos, layer, k_cache, v_cache, k_cross, v_cross,
                      n_heads=n_heads, rope=rope, tokens=tokens,
                      embed_pack=embed_pack, kv_scales=kv_scales, what=what)
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
    fault = decode_shape_fault(D, None, (F,))
    kernels.require(fault is None, what, fault)
    kernels.require(1 <= k_top <= E, what,
                    f"k_top={k_top} must be in [1, E={E}]")
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
    work = torch.empty(moe_workspace_size(B, D, F, E, k_top), device=dev,
                       dtype=torch.float32)
    sel = torch.empty(moe_route_size(B, E, k_top), device=dev,
                      dtype=torch.int32)
    out = torch.empty(B, n_out, device=dev, dtype=dt)
    a = kernels.BatchMoeArgs()
    P = kernels.ptr
    for name, t in tensors.items():
        setattr(a, name, P(t).value)
    a.out, a.work, a.sel = P(out).value, P(work).value, P(sel).value
    a.B, a.D, a.F, a.E, a.k_top = B, D, F, E, k_top
    a.n_out = n_out if head_pack is not None else 0
    a.dense = int(dense_experts(B, E, k_top, dt))
    status = kernels.library().v2m_batched_moe(code, ctypes.byref(a),
                                               kernels.stream_of(x2))
    kernels.check(status, what)
    batched_moe_ffn.launches += 1
    log_route(sel[:B * k_top].view(B, k_top))
    return out


batched_moe_ffn.launches = 0
