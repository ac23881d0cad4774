"""B=1 decoder-layer step of the variant wirings, kernel 8 of the port:
csrc/decode_variant.cu (v2m_variant_layer).

Counterparts:
  * ops/pallas_decode_variant.py:decode_variant_layer_step ->
    :func:`decode_variant_layer_step` (one decoder layer of any wiring the
    V2 kernels do not cover: vanilla, RPR or differential self-attention,
    vanilla or differential cross-attention, optional pairwise RoPE; a
    ReLU, SwiGLU or top-k MoE feed-forward with GLU or SiLU-MLP experts,
    with or without the shared expert; LayerNorm or RMSNorm; post- or
    pre-norm residuals; bf16 / f32 or int8 weights);
  * its ``VariantLayerMeta``, ``QUANT_KEYS``, ``pack_variant_layers`` and
    ``fused_variant_eligible`` -> the same names here (the packing reads a
    port VideoMusicTransformer of any eligible wiring: the base AMT, V1.x,
    2.0, RoPE V2 and V3).

int8 weights: ``pack_variant_layers(model, quantize="int8")`` stores each
``QUANT_KEYS`` weight as int8 with an f32 scale per output row under
``<key>_s`` (ops/decode_layer.py:quantize_weight; expert scales (E, G) and
(E, D)); the RPR table and the differential lambda / subln rows stay f32.
Each dot of such a weight reads int8 rows, multiplies its f32 sum by the
row's scale, then adds the bias (the Pallas ``_dot``). Only the B=1 layer
takes int8 weights, as in the JAX package.

The wrapper runs the plain PyTorch version on CPU tensors and launches the
CUDA chain on CUDA tensors. The self caches are updated IN PLACE at row
``pos`` on both paths.

Layouts: weights (out, in) row-major; the packed dict of a layer holds
wqkv (Dq + Dk + D, D) = q | k | v rows (Dq = Dk = 2D for differential
attention, else D), bqkv, wo, bo, cwq (Dc, D), cbq, cwo, cbo (zeros where
the projection has no bias), lam (1,) and subw (D,) for differential
self-attention, clam / csubw for differential cross-attention (f32; subw
is the subln weight tiled over the heads times (1 - lambda_init)), er
(er_len, D) f32 for RPR (Er tiled over the heads), norm_scale /
norm_bias (3, D) (zero bias for RMSNorm), fw1g / fb1g / fw2 / fb2 for a
ReLU (F rows) or SwiGLU ([linear1; gate], 2F rows) FFN, and for MoE
gate_w (E, D), gate_b, ew1g (E, G, D) (G = 2Fe for GLU experts, Fe for
MLP), eb1g, ew2 (E, D, Fe), eb2 and the shared expert sw1g / sb1g / sw2 /
sb2. Caches (S, Dk) / (S, D) and cross (Sm, Dc) / (Sm, D), heads
concatenated along the width.

Rounding is the B=1 Pallas kernel's: matmul inputs rounded to the compute
dtype, q, the softmax, the value products and the residual stream in f32;
the MoE adds the routed experts in selection order.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .. import kernels
from ..core.config import AMTConfig
from .decode_batch import dense_experts, log_route, route_plain
from .decode_layer import (_dot, _layer_norm, _rope_at, _rotate,
                           attend, decode_shape_fault, quantize_weight,
                           selw_floats)
from .norms import RMS_EPS, LayerNorm

LAYER_ROWS = 12    # csrc/decode_variant.cu kLayerRows
ATTN = {"vanilla": 0, "rpr": 1, "differential": 2}
FFN = {"relu": 0, "swiglu": 1, "moe": 2}
# the weights int8 decode quantizes (pallas_decode_variant.py:474): every
# large matmul; the RPR er table and the differential rows stay f32
QUANT_KEYS = ("wqkv", "wo", "cwq", "cwo", "fw1g", "fw2",
              "sw1g", "sw2", "ew1g", "ew2")


@dataclasses.dataclass(frozen=True)
class VariantLayerMeta:
    """Static per-layer wiring (the JAX package's VariantLayerMeta)."""

    attn: str            # "vanilla" | "rpr" | "differential"
    cross: str           # "vanilla" | "differential"
    ffn: str             # "relu" | "swiglu" | "moe"
    expert: str = "glu"  # MoE expert kind: "glu" | "mlp"
    shared: bool = False  # SharedMoE always-on expert present


# ---------------------------------------------------------------------------
# eligibility and packing
# ---------------------------------------------------------------------------

def fused_variant_eligible(cfg: AMTConfig) -> bool:
    """True when the decoder wiring is one the variant kernels cover (the
    JAX package's predicate, pallas_decode_variant.py:615-653): post- or
    pre-norm LayerNorm/RMSNorm blocks, vanilla/RPR/differential attention
    (differential without biases), ReLU/SwiGLU/MoE (GLU or MLP experts,
    shared or not, k < E) FFN, single chord head, even head dims."""
    if cfg.separated or cfg.kv_heads is not None:
        return False
    if cfg.norm not in ("layernorm", "rmsnorm"):
        return False
    if cfg.moe.temperature_schedule or cfg.moe.expert not in ("glu", "mlp"):
        return False
    if cfg.d_model % cfg.num_heads or (cfg.d_model // cfg.num_heads) % 2:
        return False
    if not cfg.decoder_layers:
        return False
    rope0 = cfg.decoder_layers[0].attn.rope
    for spec in cfg.decoder_layers:
        attn, cross = spec.attn, spec.cross_attn
        if attn is None or cross is None:
            return False
        for a in (attn, cross):
            if a.kind not in ("vanilla", "rpr", "differential"):
                return False
            if a.kind == "differential" and a.bias:
                return False
            if a.rope != rope0:
                return False
        if cross.kind == "rpr":
            return False
        if attn.kind == "rpr" and attn.rope:
            return False
        if spec.ffn not in ("relu_mlp", "swiglu", "moe"):
            return False
        if spec.ffn == "moe" and cfg.moe.n_experts_per_token \
                >= cfg.moe.n_experts:
            return False
    return True


def _bias(lin, n: int, like: torch.Tensor) -> torch.Tensor:
    return lin.bias if lin.bias is not None else like.new_zeros(n)


def _attention_pack(attn, prefix: str, n_heads: int) -> Dict:
    """Differential extras of one attention module: lambda (1,) and the
    subln row (D,) times (1 - lambda_init), both f32."""
    if not attn.diff:
        return {}
    lam = attn.diff_lambda().float().reshape(1)
    subw = attn.subln.weight.float().repeat(n_heads) \
        * (1.0 - attn.lambda_init)
    return {prefix + "lam": lam, prefix + "subw": subw}


def pack_variant_layers(model, quantize: Optional[str] = None
                        ) -> Tuple[List[Dict[str, torch.Tensor]],
                                   List[VariantLayerMeta]]:
    """Per-layer packed dicts (module docstring) and metas of a port
    VideoMusicTransformer whose config is :func:`fused_variant_eligible`.
    Views of the parameters where the layout allows; zero rows for absent
    biases. ``quantize="int8"`` replaces the weights of QUANT_KEYS by int8
    copies and adds their row scales under ``<key>_s``."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    cfg = model.cfg
    if not fused_variant_eligible(cfg):
        raise ValueError("pack_variant_layers: the decoder wiring is not "
                         "covered by the variant kernels")
    H = cfg.num_heads
    layers, metas = [], []
    with torch.no_grad():
        for layer, spec in zip(model.decoder_layers, cfg.decoder_layers):
            sa, ca, ffn = layer.self_attn, layer.cross_attn, layer.ffn
            w = sa.in_proj.weight
            meta = VariantLayerMeta(
                attn=spec.attn.kind,
                cross="differential" if ca.diff else "vanilla",
                ffn={"relu_mlp": "relu", "swiglu": "swiglu",
                     "moe": "moe"}[spec.ffn],
                expert=cfg.moe.expert, shared=cfg.moe.shared_expert)
            Dc = ca.qk_dim
            norms = (layer.norm1, layer.norm2, layer.norm3)
            p = dict(
                wqkv=w, bqkv=_bias(sa.in_proj, w.shape[0], w),
                wo=sa.out_proj.weight,
                bo=_bias(sa.out_proj, cfg.d_model, w),
                cwq=ca.in_proj.weight[:Dc],
                cbq=_bias(ca.in_proj, ca.in_proj.weight.shape[0], w)[:Dc],
                cwo=ca.out_proj.weight,
                cbo=_bias(ca.out_proj, cfg.d_model, w),
                norm_scale=torch.stack([n.weight for n in norms]),
                norm_bias=torch.stack([
                    n.bias if isinstance(n, LayerNorm)
                    else torch.zeros_like(n.weight) for n in norms]))
            p.update(_attention_pack(sa, "", H))
            p.update(_attention_pack(ca, "c", H))
            if meta.attn == "rpr":  # Er (er_len, hd) tiled over the heads
                p["er"] = sa.Er.float().repeat(1, H)
            if meta.ffn == "moe":
                p.update(gate_w=ffn.gate.weight, gate_b=ffn.gate.bias,
                         ew1g=ffn.w1g, eb1g=ffn.b1g, ew2=ffn.w2, eb2=ffn.b2)
                if ffn.shared is not None:
                    sh = ffn.shared
                    p.update(sw1g=sh.w1g.weight, sb1g=sh.w1g.bias,
                             sw2=sh.linear2.weight, sb2=sh.linear2.bias)
            else:  # ReLU ([linear1] rows) or SwiGLU ([linear1; gate] rows)
                w1g = ffn.linear1 if meta.ffn == "relu" else ffn.w1g
                p.update(fw1g=w1g.weight, fb1g=w1g.bias,
                         fw2=ffn.linear2.weight, fb2=ffn.linear2.bias)
            p = {k: v.detach().contiguous() for k, v in p.items()}
            if quantize == "int8":
                for key in QUANT_KEYS:
                    if key in p:
                        p[key], p[key + "_s"] = quantize_weight(p[key])
            layers.append(p)
            metas.append(meta)
    return layers, metas


# ---------------------------------------------------------------------------
# plain PyTorch versions (shared with ops/decode_batch_variant.py)
# ---------------------------------------------------------------------------

def _norm(x, scale, bias, kind: str):
    """LayerNorm (eps 1e-5) or RMSNorm (eps 1e-6) of x, in f32."""
    if kind == "layernorm":
        return _layer_norm(x, scale, bias)
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + RMS_EPS) \
        * scale.float()


def _ffn(x, w1g, b1g, w2, b2, act: str, s1g=None, s2=None, dt=None):
    """Two-matmul feed-forward, f32 out. act: "glu" (w1g = [linear1; gate],
    h * silu(g)), "silu" or "relu". s1g / s2: the row scales of int8
    weights, whose inputs round to the compute dtype ``dt``."""
    hg = _dot(x, w1g, s1g, dt) + b1g.float()
    if act == "glu":
        F = w2.shape[-1]
        h, g = hg[..., :F], hg[..., F:]
        h = h * (g * torch.sigmoid(g))
    elif act == "silu":
        h = hg * torch.sigmoid(hg)
    else:
        h = torch.relu(hg)
    return _dot(h, w2, s2, dt) + b2.float()


def _shared_ffn(xn, p, act: str, dt):
    return _ffn(xn, p["sw1g"], p["sb1g"], p["sw2"], p["sb2"], act,
                p.get("sw1g_s"), p.get("sw2_s"), dt)


def _expert(p, e) -> List[torch.Tensor]:
    """Expert e's (w1g, b1g, w2, b2, and the int8 row scales or None),
    e a python int or a (1,) index tensor left on the device."""
    keys = ("ew1g", "eb1g", "ew2", "eb2", "ew1g_s", "ew2_s")
    if isinstance(e, int):
        return [p[k][e] if k in p else None for k in keys]
    return [p[k].index_select(0, e)[0] if k in p else None for k in keys]


def _moe_selection_order(xn, p, meta: VariantLayerMeta, k_top: int, dt):
    """Top-k MoE of one row xn (1, D): router over the raw gate logits
    (first index wins a tie), softmax over the selected logits, the shared
    expert / k (when present) plus each selected expert in selection order.
    Expert ids stay on the device."""
    act = "glu" if meta.expert == "glu" else "silu"
    logits = _dot(xn, p["gate_w"]) + p["gate_b"].float()
    remaining = logits.clone()
    sel, vals = [], []
    for _ in range(k_top):
        e = torch.argmax(remaining, dim=-1)  # first maximal index
        sel.append(e)
        vals.append(logits.gather(-1, e[:, None]))
        remaining = remaining.scatter(-1, e[:, None], float("-inf"))
    log_route(torch.stack(sel, dim=-1))
    exps = [torch.exp(v - vals[0]) for v in vals]
    denom = sum(exps)
    if meta.shared:
        h = _shared_ffn(xn, p, act, dt) / k_top
    else:
        h = torch.zeros(xn.shape, device=xn.device)
    for j, e in enumerate(sel):
        w1g, b1g, w2, b2, s1g, s2 = _expert(p, e)
        h = h + (exps[j] / denom) * _ffn(xn, w1g, b1g, w2, b2, act, s1g, s2,
                                         dt)
    return h


def _moe_expert_order(xn, p, meta: VariantLayerMeta, k_top: int, dt):
    """The same MoE for B rows as the batched kernel sums it: the shared
    expert / k, then every expert in expert order with its combine weight
    (zero where it was not selected)."""
    act = "glu" if meta.expert == "glu" else "silu"
    cw = route_plain(xn, p["gate_w"], p["gate_b"], k_top)
    if meta.shared:
        acc = _shared_ffn(xn, p, act, dt) / k_top
    else:
        acc = torch.zeros(xn.shape, device=xn.device)
    for e in range(p["gate_w"].shape[0]):
        w1g, b1g, w2, b2, s1g, s2 = _expert(p, e)
        y = _ffn(xn, w1g, b1g, w2, b2, act, s1g, s2, dt)
        acc = acc + cw[:, e:e + 1] * y
    return acc


def layer_plain(x, pos: int, p, meta: VariantLayerMeta, k_cache, v_cache,
                k_cross, v_cross, *, n_heads: int, rope, k_top: int,
                norm: str, pre_norm: bool, batched: bool):
    """One layer for B rows x (B, D) over caches (B, S, Dk) / (B, S, D)
    (written in place at pos) and cross K/V (B, Sm, Dc) / (B, Sm, D).
    batched=False: the B=1 kernel's arithmetic, the whole layer.
    batched=True: the batched kernel's, the attention half (+ the FFN of a
    shallow layer); a deep layer returns x2 for the MoE half
    (ops/decode_batch_variant.py:batched_variant_moe_plain). Weights of an
    int8 pack go through their row scales."""
    dt = k_cache.dtype
    ns, nb = p["norm_scale"], p["norm_bias"]
    Dq = k_cache.shape[-1]

    def nrm(t, i):
        return _norm(t, ns[i], nb[i], norm)

    def mm(t, key):  # against weight `key`, int8 or not
        return _dot(t, p[key], p.get(key + "_s"), dt)

    def query(t):  # the batched kernel rounds q to the compute dtype
        return t.to(dt).float() if batched else t

    def self_block(xin):
        qkv = mm(xin, "wqkv") + p["bqkv"].float()
        q, k, v = qkv[:, :Dq], qkv[:, Dq:2 * Dq], qkv[:, 2 * Dq:]
        if rope is not None:
            cos, sin = _rope_at(rope, pos, Dq)
            q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        k_cache[:, pos] = k.to(dt)
        v_cache[:, pos] = v.to(dt)
        diff = meta.attn == "differential"
        attn = attend(query(q), k_cache[:, :pos + 1], v_cache[:, :pos + 1],
                      n_heads, lam=p["lam"] if diff else None,
                      subw=p["subw"] if diff else None,
                      er=p["er"] if meta.attn == "rpr" else None, pos=pos,
                      cur=pos, batched=batched)
        return mm(attn, "wo") + p["bo"].float()

    def cross_block(xin):
        cq = mm(xin, "cwq") + p["cbq"].float()
        if rope is not None:
            cos, sin = _rope_at(rope, pos, cq.shape[-1])
            cq = _rotate(cq, cos, sin)
        diff = meta.cross == "differential"
        attn = attend(query(cq), k_cross, v_cross, n_heads,
                      lam=p["clam"] if diff else None,
                      subw=p["csubw"] if diff else None, batched=batched)
        return mm(attn, "cwo") + p["cbo"].float()

    if pre_norm:
        x0 = x.float()
        x1 = x0 + self_block(nrm(x0, 0))
        x2 = x1 + cross_block(nrm(x1, 1))
    else:
        x1 = nrm(x.float() + self_block(x), 0)
        x2 = nrm(x1 + cross_block(x1), 1)
    if meta.ffn == "moe" and batched:
        return x2.to(dt)
    xn = nrm(x2, 2) if pre_norm else x2
    if meta.ffn == "moe":
        h = _moe_selection_order(xn, p, meta, k_top, dt)
    else:
        h = _ffn(xn, p["fw1g"], p["fb1g"], p["fw2"], p["fb2"],
                 "glu" if meta.ffn == "swiglu" else "relu", p.get("fw1g_s"),
                 p.get("fw2_s"), dt)
    x3 = x2 + h if pre_norm else nrm(x2 + h, 2)
    return x3.to(dt)


def decode_variant_layer_plain(x, pos: int, p, meta: VariantLayerMeta,
                               k_cache, v_cache, k_cross, v_cross, *,
                               n_heads: int, rope=None, k_top: int = 2,
                               norm: str = "rmsnorm",
                               pre_norm: bool = False):
    """Plain version of :func:`decode_variant_layer_step`."""
    D = v_cache.shape[-1]
    y = layer_plain(x.reshape(1, D), pos, p, meta, k_cache[None],
                    v_cache[None], k_cross[None], v_cross[None],
                    n_heads=n_heads, rope=rope, k_top=k_top, norm=norm,
                    pre_norm=pre_norm, batched=False)
    return y.reshape(1, D)


# ---------------------------------------------------------------------------
# kernel launch (shared with ops/decode_batch_variant.py)
# ---------------------------------------------------------------------------

def layer_workspace_size(B: int, D: int, F: int) -> int:
    """f32 scratch of the attention half (csrc/decode_variant.cu
    run_layer): LAYER_ROWS rows of (B, D) and the FFN activations."""
    return B * (LAYER_ROWS * D + F)


def moe_workspace_size(B: int, D: int, Fe: int, E: int, k_top: int) -> int:
    """f32 scratch of the MoE half (csrc/decode_variant.cu run_moe): the
    normalised rows (B, D), the router weights (B, k_top) padded to a
    multiple of 4, the activations (E + 1, B, Fe) and the expert outputs
    (E + 1, B, D)."""
    return B * D + selw_floats(B * k_top) + B * (E + 1) * (Fe + D)


def moe_route_size(B: int, E: int, k_top: int) -> int:
    """int32 scratch of the MoE half: the experts each clip chose
    (B, k_top), clips per expert (E) and their lists (E, B)."""
    return B * k_top + E + E * B


_NEEDS = {"self": ("wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo",
                   "norm_scale", "norm_bias"),
          "ffn": ("fw1g", "fb1g", "fw2", "fb2"),
          "moe": ("gate_w", "gate_b", "ew1g", "eb1g", "ew2", "eb2")}
_SHARED = ("sw1g", "sb1g", "sw2", "sb2")


def launch(entry: str, x, pos: int, p, meta: VariantLayerMeta, k_cache,
           v_cache, k_cross, v_cross, *, n_heads: int, rope, k_top: int,
           norm: str, pre_norm: bool, what: str) -> torch.Tensor:
    """Validate and launch one of csrc/decode_variant.cu's entry points:
    "layer" (B=1 layer; x (1, D), caches (S, .)), "batched_layer" (x (B, D),
    caches (B, S, .)) or "batched_moe" (x = x2 (B, D); caches unused).
    Returns y, (B, D) in the compute dtype."""
    dev, dt = x.device, x.dtype
    code = kernels.dtype_code(x, what)
    B, D = x.shape
    H = n_heads
    hd = D // H if H else 0
    deep = meta.ffn == "moe"
    moe_only = entry == "batched_moe"
    kernels.require(norm in ("layernorm", "rmsnorm"), what,
                    f"unknown norm {norm!r}")
    with_moe = deep and entry != "batched_layer"  # this launch runs the MoE
    if moe_only:
        keys = _NEEDS["moe"] + ("norm_scale", "norm_bias")
    else:
        keys = _NEEDS["self"] + (_NEEDS["moe"] if with_moe else ()) \
            + (() if deep else _NEEDS["ffn"])
    if with_moe and meta.shared:
        keys += _SHARED
    quantizable = [k for k in keys if k in QUANT_KEYS]
    qkeys = [k for k in quantizable if k + "_s" in p]
    kernels.require(len(qkeys) in (0, len(quantizable)), what,
                    "an int8 pack quantizes every weight of QUANT_KEYS")
    f32 = {k + "_s": p[k + "_s"] for k in qkeys}
    for name in qkeys:  # int8 rows, f32 row scales
        q, sc = p[name], p[name + "_s"]
        kernels.require(entry == "layer", what,
                        "int8 weights run through the B=1 layer only")
        kernels.require(q.dtype == torch.int8 and q.device == dev
                        and q.is_contiguous(), what,
                        f"{name} must be a contiguous int8 tensor on {dev}")
        kernels.require(sc.shape == q.shape[:-1], what,
                        f"{name}_s must be the row scales of {name}")
    tensors = {k: p[k] for k in keys if k not in qkeys}
    tensors["x"] = x
    if not moe_only:
        if entry == "layer":
            kernels.require(k_cache.dim() == 2, what, "caches must be (S, .)")
            k_cache, v_cache, k_cross, v_cross = (
                t[None] for t in (k_cache, v_cache, k_cross, v_cross))
        nq = 2 if meta.attn == "differential" else 1
        nc = 2 if meta.cross == "differential" else 1
        S, Sm = k_cache.shape[1], k_cross.shape[1]
        kernels.require(
            k_cache.shape == (B, S, nq * D) and v_cache.shape == (B, S, D)
            and k_cross.shape == (B, Sm, nc * D)
            and v_cross.shape == (B, Sm, D)
            and p["wqkv"].shape == (2 * nq * D + D, D)
            and p["cwq"].shape == (nc * D, D), what,
            f"caches / weights do not fit the {meta.attn} / {meta.cross} "
            f"wiring at B={B}, D={D}")
        kernels.require(0 <= pos < S, what, f"pos {pos} outside cache of {S}")
        tensors.update(k_cache=k_cache, v_cache=v_cache, k_cross=k_cross,
                       v_cross=v_cross)
        if nq == 2:
            f32.update(lam=p["lam"], subw=p["subw"])
        if nc == 2:
            f32.update(clam=p["clam"], csubw=p["csubw"])
        if meta.attn == "rpr":
            f32["er"] = p["er"]
            kernels.require(p["er"].shape[0] >= S and p["er"].shape[1] == D,
                            what, "er must be (>= S, D)")
    kernels.require_like(tensors, x, what)
    for name, t in f32.items():
        kernels.require(t.device == dev and t.dtype == torch.float32
                        and t.is_contiguous(), what,
                        f"{name} must be a contiguous float32 tensor on {dev}")
    F = 0 if deep else p["fw2"].shape[-1]
    E = p["gate_w"].shape[0] if deep else 0
    Fe = p["ew2"].shape[-1] if deep else 0
    fault = decode_shape_fault(D, None if moe_only else H, (F, Fe),
                               int8_rows=bool(qkeys))
    kernels.require(fault is None, what, fault)
    if with_moe:
        kernels.require(1 <= k_top < E, what,
                        f"k_top={k_top} must be in [1, E={E}) (the JAX "
                        "kernel's top-k loop assumes k < E)")
    n_work = 0 if moe_only else layer_workspace_size(B, D, F)
    if with_moe:
        n_work += moe_workspace_size(B, D, Fe, E, k_top)
    work = torch.empty(n_work, device=dev, dtype=torch.float32)
    sel = torch.empty(moe_route_size(B, E, k_top) if deep else 1,
                      device=dev, dtype=torch.int32)
    y = torch.empty(B, D, device=dev, dtype=dt)
    a = kernels.VariantArgs()
    for name, t in {**tensors, **f32, **{k: p[k] for k in qkeys}}.items():
        setattr(a, name, kernels.ptr(t).value)
    if rope is not None and not moe_only:
        cos, sin = (t.to(device=dev, dtype=torch.float32).contiguous()
                    for t in rope)
        kernels.require(cos.shape[1] == hd // 2 and cos.shape[0] > pos, what,
                        "rope tables must be (>pos, head_dim/2)")
        a.rope_cos, a.rope_sin = kernels.ptr(cos).value, kernels.ptr(sin).value
    a.y, a.work, a.sel = (kernels.ptr(t).value for t in (y, work, sel))
    a.B, a.D, a.H, a.pos = B, D, H, pos
    if not moe_only:
        a.S, a.Sm = k_cache.shape[1], k_cross.shape[1]
        a.er_len = p["er"].shape[0] if meta.attn == "rpr" else 0
    a.attn, a.cross = ATTN[meta.attn], ATTN[meta.cross]
    a.ffn, a.expert = FFN[meta.ffn], int(meta.expert == "mlp")
    a.F, a.Fe, a.E, a.k_top = F, Fe, E, k_top
    a.rms, a.pre_norm = int(norm == "rmsnorm"), int(pre_norm)
    a.dense = int(with_moe and dense_experts(B, E, k_top, dt))
    fn = getattr(kernels.library(), "v2m_variant_" + entry)
    kernels.check(fn(code, ctypes.byref(a), kernels.stream_of(x)), what)
    if with_moe:
        log_route(sel[:B * k_top].view(B, k_top))
    return y


def decode_variant_layer_step(x, pos: int, layer, meta: VariantLayerMeta,
                              k_cache, v_cache, k_cross, v_cross, *,
                              n_heads: int, rope=None, k_top: int = 2,
                              norm: str = "rmsnorm", pre_norm: bool = False):
    """One decoder-layer step of a variant wiring at B=1.

    Args:
      x: (1, D) layer input in the compute dtype.
      pos: position of the current token (a host int: the loop index).
      layer, meta: one dict and meta of :func:`pack_variant_layers`.
      k_cache, v_cache: (S, Dk) / (S, D) self caches, written in place at
        row ``pos``.
      k_cross, v_cross: (Sm, Dc) / (Sm, D) primed memory K/V.
      rope: (cos, sin) float32 tables (>= S, head_dim/2) or None.
      k_top: experts per token of a MoE layer.
      norm: "layernorm" | "rmsnorm"; pre_norm: the residual wiring.
    Returns:
      y: (1, D) in the compute dtype.
    """
    what = "decode_variant_layer_step"
    kw = dict(n_heads=n_heads, rope=rope, k_top=k_top, norm=norm,
              pre_norm=pre_norm)
    if kernels.use_plain(k_cache, what):
        return decode_variant_layer_plain(x, pos, layer, meta, k_cache,
                                          v_cache, k_cross, v_cross, **kw)
    y = launch("layer", x.reshape(1, -1), pos, layer, meta, k_cache, v_cache,
               k_cross, v_cross, what=what, **kw)
    decode_variant_layer_step.launches += 1
    return y


decode_variant_layer_step.launches = 0
