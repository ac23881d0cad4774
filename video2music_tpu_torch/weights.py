"""Weights of the port: random initialisation from a seed, and the bridge
from the JAX package's flax param trees.

``amt_from_jax`` / ``regression_from_jax`` take a flax param tree (nested
dicts of arrays, the ``"params"`` collection) and return a float32 state
dict that ``load_state_dict`` takes with ``strict=True``. flax Dense
kernels are (in, out); the port keeps nn.Linear's (out, in). The port also
fuses what the kernels read as one block: attention q|k|v rows into
``in_proj``, SwiGLU linear1|gate rows into ``w1g``, and per-expert w1|wg
into ``w1g`` (E, 2F, D). Bias-free projections (differential attention)
stay bias-free; RMSNorms carry only ``weight``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from .models.mamba import MambaBlock
from .ops.attention import MultiHeadAttention
from .ops.moe import SharedMoE
from .ops.norms import LayerNorm, RMSNorm


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(p):
    """flax Dense -> (weight (out, in), bias or None)."""
    bias = _t(p["bias"]) if "bias" in p else None
    return _t(p["kernel"]).t().contiguous(), bias


def _put_linear(sd, prefix, p):
    sd[f"{prefix}.weight"], bias = _dense(p)
    if bias is not None:
        sd[f"{prefix}.bias"] = bias


def _put_norm(sd, prefix, p):
    """flax LayerNorm (scale, bias) or the JAX package's RMSNorm
    (weight)."""
    if "weight" in p:
        sd[f"{prefix}.weight"] = _t(p["weight"])
    else:
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = (_t(p["scale"]),
                                                        _t(p["bias"]))


def _put_attention(sd, prefix, p):
    parts = [_dense(p[name]) for name in ("q_proj", "k_proj", "v_proj")]
    sd[f"{prefix}.in_proj.weight"] = torch.cat([w for w, _ in parts])
    if parts[0][1] is not None:
        sd[f"{prefix}.in_proj.bias"] = torch.cat([b for _, b in parts])
    _put_linear(sd, f"{prefix}.out_proj", p["out_proj"])
    if "subln" in p:  # differential attention
        for name in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            sd[f"{prefix}.{name}"] = _t(p[name])
        _put_norm(sd, f"{prefix}.subln", p["subln"])


def _put_swiglu(sd, prefix, w1, b1, wg, bg, w2, b2):
    sd[f"{prefix}.w1g.weight"] = torch.cat([_t(w1).t(), _t(wg).t()])
    sd[f"{prefix}.w1g.bias"] = torch.cat([_t(b1), _t(bg)])
    sd[f"{prefix}.linear2.weight"] = _t(w2).t().contiguous()
    sd[f"{prefix}.linear2.bias"] = _t(b2)


def _put_ffn(sd, prefix, p):
    if "experts" not in p:  # SwiGLU
        _put_swiglu(sd, prefix, p["linear1"]["kernel"], p["linear1"]["bias"],
                    p["gate"]["kernel"], p["gate"]["bias"],
                    p["linear2"]["kernel"], p["linear2"]["bias"])
        return
    e, s = p["experts"], p["shared_expert"]
    _put_linear(sd, f"{prefix}.gate", p["gate"])
    w1g = torch.cat([_t(e["w1"]), _t(e["wg"])], dim=2)       # (E, D, 2F)
    sd[f"{prefix}.w1g"] = w1g.transpose(1, 2).contiguous()   # (E, 2F, D)
    sd[f"{prefix}.b1g"] = torch.cat([_t(e["b1"]), _t(e["bg"])], dim=1)
    sd[f"{prefix}.w2"] = _t(e["w2"]).transpose(1, 2).contiguous()  # (E, D, F)
    sd[f"{prefix}.b2"] = _t(e["b2"])
    _put_swiglu(sd, f"{prefix}.shared", s["w1"][0], s["b1"][0], s["wg"][0],
                s["bg"][0], s["w2"][0], s["b2"][0])


def amt_from_jax(params, moe_state=None) -> Dict[str, torch.Tensor]:
    """State dict of a port VideoMusicTransformer from the flax params of a
    JAX VideoMusicTransformer of the same config. Linear_chord's extra input
    row (the appended key) becomes column D of ``linear_chord.weight``.
    ``moe_state``: the model's "moe_state" collection, which a config with
    MoE balancing (V3) has; its ``balance_bias`` vectors become the
    SharedMoE buffers of that name."""
    sd: Dict[str, torch.Tensor] = {}
    sd["embedding_root.weight"] = _t(params["embedding_root"]["embedding"])
    sd["embedding_attr.weight"] = _t(params["embedding_attr"]["embedding"])
    _put_linear(sd, "linear_chord", params["Linear_chord"])
    _put_linear(sd, "linear_vis", params["Linear_vis"])
    _put_norm(sd, "encoder_norm", params["encoder_norm"])
    _put_norm(sd, "decoder_norm", params["decoder_norm"])
    _put_linear(sd, "wout", params["Wout"])
    i = 0
    while f"enc_{i}" in params:
        p, pre = params[f"enc_{i}"], f"encoder_layers.{i}"
        _put_attention(sd, f"{pre}.self_attn", p["self_attn"])
        _put_ffn(sd, f"{pre}.ffn", p["ffn"])
        for n in ("norm1", "norm2"):
            _put_norm(sd, f"{pre}.{n}", p[n])
        i += 1
    i = 0
    while f"dec_{i}" in params:
        p, pre = params[f"dec_{i}"], f"decoder_layers.{i}"
        _put_attention(sd, f"{pre}.self_attn", p["self_attn"])
        _put_attention(sd, f"{pre}.cross_attn", p["cross_attn"])
        _put_ffn(sd, f"{pre}.ffn", p["ffn"])
        for n in ("norm1", "norm2", "norm3"):
            _put_norm(sd, f"{pre}.{n}", p[n])
        i += 1
    for name, state in (moe_state or {}).items():
        kind, i = name.split("_")
        stack = {"enc": "encoder_layers", "dec": "decoder_layers"}[kind]
        if "balance_bias" in state.get("ffn", {}):
            sd[f"{stack}.{i}.ffn.balance_bias"] = _t(
                state["ffn"]["balance_bias"])
    return sd


def load_amt_from_jax_(model: nn.Module, params) -> None:
    """Copy a JAX train state's ``params`` (a numpy tree) into ``model`` in
    place: the tensors keep their device and identity, so an optimizer
    over them stays valid."""
    sd = amt_from_jax(params)
    with torch.no_grad():
        own = model.state_dict()
        if sorted(own) != sorted(sd):
            raise KeyError(f"parameter names differ: "
                           f"{sorted(set(own) ^ set(sd))}")
        for name, t in sd.items():
            own[name].copy_(t)


def _put_mamba(sd, prefix, p):
    _put_linear(sd, f"{prefix}.in_proj", p["in_proj"])
    # (d_conv, 1, ED) "HIO" -> depthwise Conv1d (ED, 1, d_conv)
    sd[f"{prefix}.conv.weight"] = _t(p["conv_kernel"]).permute(2, 1, 0) \
        .contiguous()
    sd[f"{prefix}.conv.bias"] = _t(p["conv_bias"])
    sd[f"{prefix}.x_proj.weight"] = _t(p["x_proj"]["kernel"]).t().contiguous()
    dt_w = _t(p["dt_proj_kernel"])                     # (dt_rank, ED)
    # the JAX block uses the stored kernel shifted by -dt_rank**-0.5
    sd[f"{prefix}.dt_proj.weight"] = (dt_w - dt_w.shape[0] ** -0.5).t() \
        .contiguous()
    sd[f"{prefix}.dt_proj.bias"] = _t(p["dt_proj_bias"])
    sd[f"{prefix}.A_log"] = _t(p["A_log"])
    sd[f"{prefix}.D"] = _t(p["D"])
    _put_linear(sd, f"{prefix}.out_proj", p["out_proj"])


def regression_from_jax(params) -> Dict[str, torch.Tensor]:
    """State dict of a port VideoRegression (bimamba+) from the flax
    params of the JAX VideoRegression of the same config."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("in_proj", "regressor", "classifier"):
        _put_linear(sd, name, params[name])
    i = 0
    while f"layer_{i}" in params["model"]:
        p, pre = params["model"][f"layer_{i}"], f"backbone.layers.{i}"
        for d in ("mamba_forward", "mamba_backward"):
            _put_mamba(sd, f"{pre}.{d}", p[d])
        _put_linear(sd, f"{pre}.ffn.linear1", p["ffn"]["Dense_0"])
        _put_linear(sd, f"{pre}.ffn.linear2", p["ffn"]["Dense_1"])
        for n in ("norm1", "norm2", "norm3"):
            _put_norm(sd, f"{pre}.{n}", p[n])
        i += 1
    return sd


# ---------------------------------------------------------------------------
# random initialisation
# ---------------------------------------------------------------------------

def _normal_(t, std, gen):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def _uniform_(t, lo, hi, gen):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)


def init_weights_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise every parameter from ``gen`` (a CPU generator), in module
    order, with the JAX package's schemes: LeCun-normal dense and expert
    weights, Xavier-uniform attention projections (each of q, k, v and out
    on its own fans), zero biases, unit norms, normal(0.1) differential
    lambdas, and the Mamba dt / A / D initialisers. Returns ``model``."""
    done = set()
    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention):
            D, qk, w = mod.d_model, mod.qk_dim, mod.in_proj.weight
            # (block, fan_out of one projection): q, k and v share their
            # fans unless q and k are 2D wide
            blocks = [(w, D)] if qk == D else [
                (w[:qk], qk), (w[qk:2 * qk], qk), (w[2 * qk:], D)]
            for block, fan_out in blocks + [(mod.out_proj.weight, D)]:
                lim = math.sqrt(6.0 / (D + fan_out))
                _uniform_(block, -lim, lim, gen)
            for lin in (mod.in_proj, mod.out_proj):
                if lin.bias is not None:
                    nn.init.zeros_(lin.bias)
                done.add(id(lin.weight))
            if mod.diff:
                for lam in (mod.lambda_q1, mod.lambda_k1, mod.lambda_q2,
                            mod.lambda_k2):
                    _normal_(lam, 0.1, gen)
        elif isinstance(mod, SharedMoE):
            D, F = mod.w1g.shape[2], mod.w2.shape[2]
            _normal_(mod.w1g, D ** -0.5, gen)
            _normal_(mod.w2, F ** -0.5, gen)
            for b in (mod.b1g, mod.b2):
                nn.init.zeros_(b)
        elif isinstance(mod, MambaBlock):
            cfg = mod.cfg
            R = cfg.resolved_dt_rank
            _uniform_(mod.dt_proj.weight, -R ** -0.5, R ** -0.5, gen)
            dt = torch.exp(torch.rand(cfg.d_inner, generator=gen)
                           * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                           + math.log(cfg.dt_min)).clamp(min=1e-4)
            with torch.no_grad():
                mod.dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                mod.A_log.copy_(torch.log(torch.arange(
                    1, cfg.d_state + 1, dtype=torch.float32)).expand(
                        cfg.d_inner, -1))
                mod.D.fill_(1.0)
            _normal_(mod.conv.weight, cfg.d_conv ** -0.5, gen)
            if mod.conv.bias is not None:
                nn.init.zeros_(mod.conv.bias)
            done.add(id(mod.dt_proj.weight))
        elif isinstance(mod, nn.Linear) and id(mod.weight) not in done:
            _normal_(mod.weight, mod.weight.shape[1] ** -0.5, gen)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            _normal_(mod.weight, mod.weight.shape[1] ** -0.5, gen)
        elif isinstance(mod, LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, RMSNorm):
            nn.init.ones_(mod.weight)
    return model
