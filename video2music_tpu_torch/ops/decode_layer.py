"""B=1 decoder-layer step of AMT 2.2, kernels 2 and 3 of the port:
csrc/decode_layer.cu.

Counterparts:
  * ops/pallas_decode.py:decode_layer_step -> :func:`decode_layer_step`
    (one post-norm V2 decoder layer: fused QKV, pairwise RoPE, cache append
    at ``pos``, masked cached self-attention, cross-attention over primed
    memory, SwiGLU or top-k shared-expert MoE);
  * ops/pallas_decode_stack.py:decode_flat_monolith_step, as the product
    uses it (a one-layer run with the embed prologue or the final-LN + head
    epilogue) -> :func:`decode_ends_step`;
  * ops/pallas_decode.py:pack_decoder_layers -> :func:`pack_decoder_layers`
    (and pack_monolith's embed/head keys -> :func:`pack_ends`);
  * ops/pallas_decode.py:quantize_weight / dequantize /
    fake_quantize_decoder_params -> the same names here, on the port's
    (out, in) layout.

int8 weights: ``pack_decoder_layers(model, quantize="int8")`` stores the
layer's large matmul weights as int8 with an f32 scale per output row
(``<key>_s``); :func:`decode_layer_step` then reads int8 rows, scales each
f32 dot by its row's scale and adds the bias (the Pallas ``_scaled_dot``).
:func:`decode_ends_step` takes compute-dtype weights only, as in the JAX
package.

Both wrappers run the plain PyTorch versions on CPU tensors and launch the
CUDA chain on CUDA tensors. The self-attention caches are updated IN PLACE
at row ``pos`` on both paths (JAX returns new caches; here nothing else
holds them).

Layouts: weights (out, in) row-major, as ``nn.Linear`` keeps them; caches
(S, D) with the heads concatenated along D, as the JAX fused path keeps
them. Every matmul input is rounded to the weight dtype and accumulated in
f32; the residual stream inside a layer stays f32; the layer output is
rounded to the compute dtype. That is the Pallas kernels' arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from .. import kernels
from .norms import LN_EPS, SUBLN_EPS

_DEEP_KEYS = ("gate_w", "gate_b", "ew1g", "eb1g", "ew2", "eb2")
# the weights int8 decode quantizes (pallas_decode.py:544-549): attention
# and the SwiGLU (the shared expert in a MoE layer), then the experts
QUANT_KEYS = ("wqkv", "wo", "cwq", "cwo", "w1g", "w2")
QUANT_DEEP_KEYS = ("ew1g", "ew2")


# ---------------------------------------------------------------------------
# eligibility and packing
# ---------------------------------------------------------------------------

def fused_decode_eligible(cfg) -> bool:
    """True when the decoder wiring is the V2 family these kernels cover
    (the JAX package's predicate, pallas_decode.py:554-580): post-norm
    LayerNorm blocks, vanilla (optionally RoPE) MHA with biases, SwiGLU or
    shared-GLU-MoE FFN, no position add, no temperature quirk."""
    if cfg.version is None or cfg.separated or cfg.chord_embed:
        return False
    if cfg.pos_encoding != "none" or cfg.pre_norm or cfg.norm != "layernorm":
        return False
    if cfg.moe.temperature_schedule or cfg.moe.expert != "glu":
        return False
    if cfg.kv_heads is not None:
        return False
    if cfg.d_model % cfg.num_heads or (cfg.d_model // cfg.num_heads) % 2:
        return False
    for spec in cfg.decoder_layers:
        for att in (spec.attn, spec.cross_attn):
            if att is None or att.kind != "vanilla" or not att.bias:
                return False
            if att.rope != cfg.decoder_layers[0].attn.rope:
                return False
        if spec.ffn not in ("swiglu", "moe"):
            return False
        if spec.ffn == "moe" and not cfg.moe.shared_expert:
            return False
    return True


def decode_shape_fault(D: int, H: Optional[int], widths=(), *,
                       int8_rows: bool = False) -> Optional[str]:
    """Why the CUDA decode kernels (rows 2-10) cannot take width D, H heads
    and FFN widths ``widths``, or None where they can: a head size D / H
    that is a multiple of 8 and at most 256 (int8 KV caches too: their
    rows load 16 or 8 values at a time), D and every width a multiple of 8
    (of 16 with int8 weight rows, which load 16 weights at a time). ``H`` None skips the head
    check (the MoE halves run no attention). The one statement of these
    limits: the wrappers raise on it, and the sampler sends what it refuses
    to the plain step (:func:`cuda_decode_shapes_ok`)."""
    if H is not None:
        hd = D // H if H > 0 and D % H == 0 else 0
        if hd == 0 or hd % 8 or hd > 256:
            return (f"bad head split D={D} H={H}: the head size must be a "
                    "multiple of 8, at most 256")
    mult = 16 if int8_rows else 8
    if any(n % mult for n in (D, *widths)):
        return (f"widths {(D, *widths)} must be multiples of {mult}"
                + (" (int8 rows)" if int8_rows else ""))
    return None


def cuda_decode_shapes_ok(cfg, B: int, quantize=None) -> bool:
    """True when the CUDA decode kernels take ``cfg``'s shapes at batch
    ``B`` (:func:`decode_shape_fault`), with int8 weight rows at B=1 under
    ``quantize`` (int8 KV caches add no limit). The
    counterpart of the JAX package's fused_decode_mosaic_ok
    (pallas_decode.py:583), with these kernels' limits for Mosaic's."""
    expert = 2 * cfg.d_model if cfg.moe.expert == "mlp" else cfg.d_ff
    return decode_shape_fault(
        cfg.d_model, cfg.num_heads, (cfg.d_ff, expert),
        int8_rows=quantize is not None and B == 1) is None


def quantize_weight(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per output row: w (..., out, in) -> (int8 (..., out,
    in), f32 scales (..., out)); a row's scale is max|w| over its inputs /
    127, at least 1e-12, and q = round(w / scale), half to even (the JAX
    quantize_weight on its (in, out) layout). The divisor is a tensor: on
    the card PyTorch turns a division by a Python scalar into a product
    with its reciprocal, which is not the same f32 value."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1)
    s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    return torch.round(wf / s.unsqueeze(-1)).to(torch.int8), s


def dequantize(q, s) -> torch.Tensor:
    """Inverse of :func:`quantize_weight`, in f32."""
    return q.float() * s.unsqueeze(-1)


def _fake_quant(w) -> torch.Tensor:
    return dequantize(*quantize_weight(w)).to(w.dtype)


def fake_quantize_decoder_params(model):
    """A copy of ``model`` whose decoder weights that int8 decode quantizes
    went through int8 and back (dequantize(quantize(w))): the self-attention
    projections, the cross-attention query rows (2D of them for
    differential attention) and out-projection (the cross K/V rows prime in
    full precision), the ReLU / SwiGLU feed-forward, and the GLU or MLP
    experts with their shared expert where there is one (the JAX
    fake_quantize_decoder_params, pallas_decode.py:466-479). The biases,
    norms, MoE gate, RPR table, differential lambda / subln, embeddings and
    head stay. The plain decode step with this copy is the numerical
    oracle of the int8 kernels, in the V2 and the variant wirings."""
    import copy

    out = copy.deepcopy(model)
    with torch.no_grad():
        for layer in out.decoder_layers:
            sa, ca, ffn = layer.self_attn, layer.cross_attn, layer.ffn
            for lin in (sa.in_proj, sa.out_proj, ca.out_proj):
                lin.weight.copy_(_fake_quant(lin.weight))
            Dq = ca.qk_dim
            ca.in_proj.weight[:Dq] = _fake_quant(ca.in_proj.weight[:Dq])
            dense = [ffn]  # a feed-forward of nn.Linear layers
            if hasattr(ffn, "gate"):  # MoE
                dense = [ffn.shared] if ffn.shared is not None else []
                if hasattr(ffn, "w1g"):  # GLU / MLP experts, not KAN
                    ffn.w1g.copy_(_fake_quant(ffn.w1g))
                    ffn.w2.copy_(_fake_quant(ffn.w2))
            for mod in dense:
                for lin in mod.children():
                    if isinstance(lin, torch.nn.Linear):
                        lin.weight.copy_(_fake_quant(lin.weight))
    return out


def pack_decoder_layers(model, quantize: Optional[str] = None
                        ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer weight dicts of a port VideoMusicTransformer, as views of
    its parameters (the cross-attention query rows are a slice of
    ``in_proj``): wqkv (3D, D), bqkv, wo, bo, cwq (D, D), cbq, cwo, cbo,
    norm_scale / norm_bias (3, D), and w1g (2F, D) = [linear1; gate],
    b1g, w2 (D, F), b2 of the SwiGLU — the shared expert in a MoE layer,
    which adds gate_w (E, D), gate_b, ew1g (E, 2F, D), eb1g, ew2 (E, D, F),
    eb2. ``quantize="int8"`` replaces the weights of QUANT_KEYS (and
    QUANT_DEEP_KEYS) by int8 copies and adds their row scales under
    ``<key>_s``."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    layers = []
    D = model.cfg.d_model
    with torch.no_grad():
        for layer in model.decoder_layers:
            sa, ca, ffn = layer.self_attn, layer.cross_attn, layer.ffn
            norms = (layer.norm1, layer.norm2, layer.norm3)
            p = dict(
                wqkv=sa.in_proj.weight, bqkv=sa.in_proj.bias,
                wo=sa.out_proj.weight, bo=sa.out_proj.bias,
                cwq=ca.in_proj.weight[:D], cbq=ca.in_proj.bias[:D],
                cwo=ca.out_proj.weight, cbo=ca.out_proj.bias,
                norm_scale=torch.stack([n.weight for n in norms]),
                norm_bias=torch.stack([n.bias for n in norms]))
            swiglu = getattr(ffn, "shared", ffn)
            p.update(w1g=swiglu.w1g.weight, b1g=swiglu.w1g.bias,
                     w2=swiglu.linear2.weight, b2=swiglu.linear2.bias)
            if swiglu is not ffn:  # SharedMoE
                p.update(gate_w=ffn.gate.weight, gate_b=ffn.gate.bias,
                         ew1g=ffn.w1g, eb1g=ffn.b1g, ew2=ffn.w2, eb2=ffn.b2)
            p = {k: v.detach() for k, v in p.items()}
            if quantize == "int8":
                for key in QUANT_KEYS + (QUANT_DEEP_KEYS if "gate_w" in p
                                         else ()):
                    p[key], p[key + "_s"] = quantize_weight(p[key])
            layers.append(p)
    return layers


def pack_ends(model) -> Dict[str, torch.Tensor]:
    """Embed / head weights for :func:`decode_ends_step`: the embedding
    tables, Linear_chord split as lc_w (D, D) + lc_krow (D,) (the weight
    column of the appended key) + lc_b, the final norm and the head."""
    D = model.cfg.d_model
    with torch.no_grad():
        lc = model.linear_chord.weight.detach()
        return dict(
            emb_root=model.embedding_root.weight.detach(),
            emb_attr=model.embedding_attr.weight.detach(),
            lc_w=lc[:, :D].contiguous(), lc_krow=lc[:, D].contiguous(),
            lc_b=model.linear_chord.bias.detach(),
            dn_scale=model.decoder_norm.weight.detach(),
            dn_bias=model.decoder_norm.bias.detach(),
            wout=model.wout.weight.detach(), bout=model.wout.bias.detach())


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _dot(x, w, s=None, dt=None):
    """x (..., K) rounded to w's dtype, times w (N, K)^T, accumulated f32.
    With int8 w: x rounded to the compute dtype ``dt`` and the f32 dot
    scaled by the row scales ``s`` (N,)."""
    if s is None:
        return x.to(w.dtype).float() @ w.float().t()
    return (x.to(dt).float() @ w.float().t()) * s.float()


def _layer_norm(x, g, b):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + LN_EPS) * g.float() + b.float()


def _rotate(y, cos, sin):
    """Pairwise RoPE of y (..., n) with per-pair cos/sin (n/2,)."""
    y0, y1 = y[..., 0::2], y[..., 1::2]
    return torch.stack([y0 * cos - y1 * sin, y1 * cos + y0 * sin],
                       dim=-1).reshape(y.shape)


def attend(q, k, v, n_heads: int, *, lam=None, subw=None, er=None,
           pos: int = 0, cur: Optional[int] = None, batched: bool = False):
    """q (B, nq D) f32 over the rows of k (B, R, nq D) / v (B, R, D), nq = 2
    for differential attention (``lam`` given) -> (B, D) f32. ``er``: the
    RPR table, its bias for row j = q . er[er_len - 1 - pos + j] added to
    the unscaled logits. ``batched``: round the RPR table and biases, the
    probabilities (not row ``cur``), the value products and the
    differential combine to the cache dtype, as the batched kernel does."""
    B, R, Dk = k.shape
    D = v.shape[-1]
    H = n_heads
    hd = D // H
    nq = Dk // D
    dt = k.dtype

    def rnd(t):
        return t.to(dt).float() if batched else t

    logits = torch.einsum("bhd,bshd->bhs", q.view(B, nq * H, hd),
                          k.float().view(B, R, nq * H, hd))
    if er is not None:
        rows = er.shape[0] - 1 - pos + torch.arange(R, device=er.device)
        rel = rnd(er[rows].float()).view(R, H, hd)
        bias = torch.einsum("bhd,shd->bhs", q.view(B, H, hd), rel)
        if batched:
            exact = bias[..., cur].clone()
            bias = rnd(bias)
            bias[..., cur] = exact
        logits = logits + bias
    p = torch.softmax(logits * hd ** -0.5, dim=-1)
    if batched:
        pr = rnd(p)
        if cur is not None:
            pr[..., cur] = p[..., cur]
        p = pr
    vv = v.float().view(B, R, H, hd)
    if nq == 2:
        vv = vv.repeat_interleave(2, dim=2)
    pv = torch.einsum("bhs,bshd->bhd", p, vv)
    if lam is None:
        return rnd(pv).reshape(B, D)
    c = rnd(rnd(pv[:, 0::2]) - lam.float() * rnd(pv[:, 1::2]))
    c = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + SUBLN_EPS)
    return (c * subw.float().view(H, hd)).reshape(B, D)


def _swiglu(x, w1g, b1g, w2, b2, s1g=None, s2=None, dt=None):
    F = w2.shape[-1]
    hg = _dot(x, w1g, s1g, dt) + b1g.float()
    h, g = hg[..., :F], hg[..., F:]
    h = h * (g * torch.sigmoid(g))
    return _dot(h, w2, s2, dt) + b2.float()


# When a list, every MoE router of the decode steps, kernel or plain, at
# B=1 or B>1 (here, in ops/decode_stack.py, ops/decode_batch.py and
# ops/decode_variant.py), appends the (B, k) expert ids it chose in
# selection order, left on the device. chip_smoke.py sets it to compare a
# kernel step's choices with its plain step's.
route_log: Optional[list] = None


def log_route(ids) -> None:
    if route_log is not None:
        route_log.append(ids)


def logging_routes() -> bool:
    return route_log is not None


def _moe(x2, p, k_top: int, dt=None):
    """Top-k shared-expert MoE at one token: first index wins a tie,
    softmax over the selected raw logits, shared expert divided by k.
    Expert ids stay on the device (no host read), so the function can be
    captured into a CUDA graph. ``dt``: the compute dtype of int8 packs."""
    logits = _dot(x2, p["gate_w"]) + p["gate_b"].float()
    remaining = logits.clone()
    sel, vals = [], []
    for _ in range(k_top):
        e = torch.argmax(remaining).view(1)  # first maximal index
        sel.append(e)
        vals.append(remaining.gather(0, e))
        remaining = remaining.index_fill(0, e, float("-inf"))
    log_route(torch.cat(sel).view(1, k_top))
    vals = torch.cat(vals)
    exps = torch.exp(vals - vals[0])
    w = exps / exps.sum()
    h = _swiglu(x2, p["w1g"], p["b1g"], p["w2"], p["b2"], p.get("w1g_s"),
                p.get("w2_s"), dt) / float(k_top)
    quant = "ew1g_s" in p
    for j, e in enumerate(sel):
        keys = ("ew1g", "eb1g", "ew2", "eb2") + (
            ("ew1g_s", "ew2_s") if quant else ())
        expert = [p[k].index_select(0, e)[0] for k in keys]
        h = h + w[j] * _swiglu(x2, *expert, dt=dt)
    return h


def _rope_at(rope, pos: int, n: int):
    cos, sin = rope
    reps = n // (2 * cos.shape[1])
    return cos[pos].repeat(reps), sin[pos].repeat(reps)


def decode_layer_plain(x, pos: int, p, k_cache, v_cache, k_cross, v_cross, *,
                       n_heads: int, k_top: int = 2, rope=None):
    """Plain version of :func:`decode_layer_step`: x (1, D) -> y (1, D)."""
    dt = k_cache.dtype
    x0 = x.reshape(-1)
    D = x0.shape[0]

    def mm(v, key):  # against layer weight `key`, int8 or not
        return _dot(v, p[key], p.get(key + "_s"), dt)

    qkv = mm(x0, "wqkv") + p["bqkv"].float()
    q, k, v = qkv[:D], qkv[D:2 * D], qkv[2 * D:]
    if rope is not None:
        cos, sin = _rope_at(rope, pos, D)
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    k_cache[pos] = k.to(dt)
    v_cache[pos] = v.to(dt)
    attn = attend(q[None], k_cache[None, :pos + 1], v_cache[None, :pos + 1],
                  n_heads)[0]
    x1 = _layer_norm(x0.float() + (mm(attn, "wo") + p["bo"].float()),
                     p["norm_scale"][0], p["norm_bias"][0])
    cq = mm(x1, "cwq") + p["cbq"].float()
    if rope is not None:
        cq = _rotate(cq, cos, sin)
    cattn = attend(cq[None], k_cross[None], v_cross[None], n_heads)[0]
    x2 = _layer_norm(x1 + (mm(cattn, "cwo") + p["cbo"].float()),
                     p["norm_scale"][1], p["norm_bias"][1])
    if "gate_w" in p:
        h = _moe(x2, p, k_top, dt)
    else:
        h = _swiglu(x2, p["w1g"], p["b1g"], p["w2"], p["b2"], p.get("w1g_s"),
                    p.get("w2_s"), dt)
    y = _layer_norm(x2 + h, p["norm_scale"][2], p["norm_bias"][2])
    return y.to(dt).reshape(1, D)


def embed_plain(token_root, token_attr, key, head, dtype):
    """Chord embedding + Linear_chord as emb @ lc_w + key * lc_krow + lc_b,
    rounded to ``dtype``: (B,) root / attr ids and keys -> (B, D)."""
    emb = (head["emb_root"][token_root.reshape(-1).long()].float()
           + head["emb_attr"][token_attr.reshape(-1).long()].float())
    x = _dot(emb, head["lc_w"])
    x = x + key.reshape(-1, 1).float() * head["lc_krow"].float()
    return (x + head["lc_b"].float()).to(dtype)


def head_plain(y, head):
    """Final LayerNorm + chord head: (1, D) -> (1, n_out) in y's dtype."""
    xf = _layer_norm(y, head["dn_scale"], head["dn_bias"])
    return (_dot(xf, head["wout"]) + head["bout"].float()).to(y.dtype)


def decode_ends_plain(token_root, token_attr, key, pos: int, p, head,
                      k_cache, v_cache, k_cross, v_cross, *, n_heads: int,
                      k_top: int = 2, rope=None, embed: bool = True,
                      fold_head: bool = True, x=None):
    """Plain version of :func:`decode_ends_step`."""
    if embed:
        x = embed_plain(token_root, token_attr, key, head, k_cache.dtype)
    y = decode_layer_plain(x, pos, p, k_cache, v_cache, k_cross, v_cross,
                           n_heads=n_heads, k_top=k_top, rope=rope)
    return head_plain(y, head) if fold_head else y


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def selw_floats(k_top: int) -> int:
    """Floats of the router weights in a workspace: k_top rounded up to a
    multiple of 4 (csrc/decode_step.cuh selw_floats)."""
    return -(-k_top // 4) * 4


def workspace_size(D: int, F: int, k_top: int) -> int:
    """f32 scratch of one layer step (csrc/decode_step.cuh Work): ten
    D-wide rows, the router weights, the (k_top + 1, F) expert activations
    and, for the chain (csrc/decode_layer.cu), the (k_top + 1, D) expert
    outputs and the closing LayerNorm's block counter (one int)."""
    return 10 * D + selw_floats(k_top) + (k_top + 1) * (F + D) + 1


def _launch(x, pos: int, p, k_cache, v_cache, k_cross, v_cross, *,
            n_heads: int, k_top: int, rope, what: str,
            ends: Optional[Tuple] = None) -> Tuple[torch.Tensor,
                                                   Optional[torch.Tensor]]:
    """Validate and launch one layer chain. ``ends`` = (token_root,
    token_attr, key, head, embed, fold_head). Returns (y, logits)."""
    S, D = k_cache.shape
    F = p["w2"].shape[-1]
    dev, dt = k_cache.device, k_cache.dtype
    code = kernels.dtype_code(k_cache, what)
    deep = "gate_w" in p
    E = p["gate_w"].shape[0] if deep else 0
    hd = D // n_heads if n_heads else 0
    qkeys = (QUANT_KEYS + (QUANT_DEEP_KEYS if deep else ())
             if "wqkv_s" in p else ())
    fault = decode_shape_fault(D, n_heads, (F,), int8_rows=bool(qkeys))
    kernels.require(fault is None, what, fault)
    kernels.require(0 <= pos < S, what, f"pos {pos} outside cache of {S}")
    kernels.require(not deep or 1 <= k_top <= E, what,
                    f"k_top={k_top} must be in [1, E={E}]")
    for name in qkeys:  # int8 rows, f32 scales
        q, sc = p[name], p[name + "_s"]
        kernels.require(ends is None, what, "int8 weights run through "
                        "decode_layer_step only")
        kernels.require(q.dtype == torch.int8 and q.device == dev
                        and q.is_contiguous(), what,
                        f"{name} must be a contiguous int8 tensor on {dev}")
        kernels.require(sc.dtype == torch.float32 and sc.device == dev
                        and sc.is_contiguous()
                        and sc.shape == q.shape[:-1], what,
                        f"{name}_s must be contiguous f32 row scales")
    quant = set(qkeys) | {name + "_s" for name in qkeys}
    tensors = {k: v for k, v in p.items() if k not in quant}
    tensors.update(k_cache=k_cache, v_cache=v_cache, k_cross=k_cross,
                   v_cross=v_cross)
    if x is not None:
        tensors["x"] = x
    embed = fold_head = False
    if ends is not None:
        token_root, token_attr, key, head, embed, fold_head = ends
        if embed or fold_head:
            tensors.update(head)
    kernels.require_like(tensors, k_cache, what)
    kernels.require(k_cross.shape[1] == D and v_cross.shape == k_cross.shape,
                    what, "cross K/V must be (Sm, D)")
    work = torch.empty(workspace_size(D, F, k_top), device=dev,
                       dtype=torch.float32)
    sel = torch.empty(max(k_top, 1), device=dev, dtype=torch.int32)
    y = torch.empty(1, D, device=dev, dtype=dt)
    a = kernels.DecodeLayerArgs()
    P = kernels.ptr
    for name in ("wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo",
                 "norm_scale", "norm_bias", "w1g", "b1g", "w2", "b2"):
        setattr(a, name, P(p[name]).value)
    if deep:
        for name in _DEEP_KEYS:
            setattr(a, name, P(p[name]).value)
    for name in qkeys:
        setattr(a, name + "_s", P(p[name + "_s"]).value)
    if rope is not None:
        cos, sin = (t.to(device=dev, dtype=torch.float32).contiguous()
                    for t in rope)
        kernels.require(cos.shape[1] == hd // 2 and cos.shape[0] > pos, what,
                        "rope tables must be (>pos, head_dim/2)")
        a.rope_cos, a.rope_sin = P(cos).value, P(sin).value
    a.k_cache, a.v_cache = P(k_cache).value, P(v_cache).value
    a.k_cross, a.v_cross = P(k_cross).value, P(v_cross).value
    a.work, a.sel, a.y = P(work).value, P(sel).value, P(y).value
    logits = None
    if embed:
        ids = [t.reshape(-1)[:1].to(device=dev, dtype=torch.int32)
               for t in (token_root, token_attr)]
        kf = key.reshape(-1)[:1].to(device=dev, dtype=torch.float32)
        a.token_root, a.token_attr = P(ids[0]).value, P(ids[1]).value
        a.key = P(kf).value
        for name in ("emb_root", "emb_attr", "lc_w", "lc_krow", "lc_b"):
            setattr(a, name, P(head[name]).value)
    else:
        kernels.require(x is not None and x.numel() == D, what,
                        "x must be (1, D) without the embed prologue")
        a.x = P(x).value
    if fold_head:
        n_out = head["wout"].shape[0]
        logits = torch.empty(1, n_out, device=dev, dtype=dt)
        for name in ("dn_scale", "dn_bias", "wout", "bout"):
            setattr(a, name, P(head[name]).value)
        a.logits, a.n_out = P(logits).value, n_out
    a.D, a.H, a.F, a.E, a.k_top = D, n_heads, F, E, k_top
    a.Sm, a.pos = k_cross.shape[0], pos
    status = kernels.library().v2m_decode_layer(code, ctypes.byref(a),
                                                kernels.stream_of(k_cache))
    kernels.check(status, what)
    if deep:
        log_route(sel[:k_top].view(1, k_top))
    return y, logits


def decode_layer_step(x, pos: int, layer, k_cache, v_cache, k_cross,
                      v_cross, *, n_heads: int, k_top: int = 2, rope=None):
    """One decoder-layer step at B=1.

    Args:
      x: (1, D) layer input in the compute dtype.
      pos: position of the current token (a host int: the loop index).
      layer: one dict of :func:`pack_decoder_layers`, int8 or not.
      k_cache, v_cache: (S, D) self-attention caches, written in place at
        row ``pos``.
      k_cross, v_cross: (Sm, D) primed memory K/V.
      rope: (cos, sin) float32 tables (>= S, head_dim/2) or None.
    Returns:
      y: (1, D) in the compute dtype.
    """
    what = "decode_layer_step"
    if kernels.use_plain(k_cache, what):
        return decode_layer_plain(x, pos, layer, k_cache, v_cache, k_cross,
                                  v_cross, n_heads=n_heads, k_top=k_top,
                                  rope=rope)
    y, _ = _launch(x, pos, layer, k_cache, v_cache, k_cross, v_cross,
                   n_heads=n_heads, k_top=k_top, rope=rope, what=what)
    decode_layer_step.launches += 1
    return y


decode_layer_step.launches = 0


def decode_ends_step(token_root, token_attr, key, pos: int, layer, head,
                     k_cache, v_cache, k_cross, v_cross, *, n_heads: int,
                     k_top: int = 2, rope=None, embed: bool = True,
                     fold_head: bool = True, x=None):
    """An end layer of the decoder: one layer step with the chord-embedding
    prologue (``embed``: token_root / token_attr (1,) int ids and key (1,)
    on the device) and/or the final-LayerNorm + chord-head epilogue
    (``fold_head``). Without ``embed`` pass the layer input ``x`` (1, D).
    Returns logits (1, n_out) when ``fold_head``, else y (1, D); the
    caches are written in place as in :func:`decode_layer_step`."""
    what = "decode_ends_step"
    if kernels.use_plain(k_cache, what):
        return decode_ends_plain(token_root, token_attr, key, pos, layer,
                                 head, k_cache, v_cache, k_cross, v_cross,
                                 n_heads=n_heads, k_top=k_top, rope=rope,
                                 embed=embed, fold_head=fold_head, x=x)
    y, logits = _launch(x, pos, layer, k_cache, v_cache, k_cross, v_cross,
                        n_heads=n_heads, k_top=k_top, rope=rope, what=what,
                        ends=(token_root, token_attr, key, head, embed,
                              fold_head))
    decode_ends_step.launches += 1
    return logits if fold_head else y


decode_ends_step.launches = 0
