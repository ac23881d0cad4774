"""Weights of the port: random initialisation from a seed, and the bridge
from the JAX package's flax param trees.

``amt_from_jax`` / ``regression_from_jax`` take a flax param tree (nested
dicts of arrays, the ``"params"`` collection) and return a float32 state
dict that ``load_state_dict`` takes with ``strict=True``. flax Dense
kernels are (in, out); the port keeps nn.Linear's (out, in). The port also
fuses what the kernels read as one block: attention q|k|v rows into
``in_proj`` (narrower k|v blocks under grouped-query attention), SwiGLU
linear1|gate rows into ``w1g``, and per-expert w1|wg into ``w1g`` (E, 2F,
D) (an MLP expert's w1 alone). Bias-free projections (differential
attention) stay bias-free; RMSNorms carry only ``weight``; KANLinear
keeps the JAX layout.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from .features.clip import CLIP, TextTower, VisionTower
from .features.maxvit import PartitionAttention
from .models.mamba import MambaBlock
from .ops.attention import MultiHeadAttention
from .ops.embeddings import LearnedPE
from .ops.kan import KANLinear
from .ops.moe import MoELayer
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
    if "Er" in p:  # RPR
        sd[f"{prefix}.Er"] = _t(p["Er"])
    if "gqa_norm" in p:
        _put_norm(sd, f"{prefix}.gqa_norm", p["gqa_norm"])
    if "subln" in p:  # differential attention
        for name in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            sd[f"{prefix}.{name}"] = _t(p[name])
        _put_norm(sd, f"{prefix}.subln", p["subln"])


def _put_swiglu(sd, prefix, w1, b1, wg, bg, w2, b2):
    sd[f"{prefix}.w1g.weight"] = torch.cat([_t(w1).t(), _t(wg).t()])
    sd[f"{prefix}.w1g.bias"] = torch.cat([_t(b1), _t(bg)])
    sd[f"{prefix}.linear2.weight"] = _t(w2).t().contiguous()
    sd[f"{prefix}.linear2.bias"] = _t(b2)


def _put_kan(sd, prefix, p):
    sd[f"{prefix}.base_weight"] = _t(p["base_weight"])
    sd[f"{prefix}.spline_weight"] = _t(p["spline_weight"])


def _put_moe(sd, prefix, p):
    """A JAX MoELayer: gate, GLU / MLP expert stacks or KAN experts, and
    the shared expert where there is one."""
    e = p["experts"]
    _put_linear(sd, f"{prefix}.gate", p["gate"])
    if "kan_0" in e:
        for name, kan in e.items():
            _put_kan(sd, f"{prefix}.kan.{name.split('_')[1]}", kan)
        if "shared_expert" in p:
            _put_kan(sd, f"{prefix}.shared", p["shared_expert"]["kan_0"])
        return
    w1g, b1g = _t(e["w1"]), _t(e["b1"])                      # (E, D, G)
    if "wg" in e:  # GLU: [w1 | wg] columns
        w1g = torch.cat([w1g, _t(e["wg"])], dim=2)
        b1g = torch.cat([b1g, _t(e["bg"])], dim=1)
    sd[f"{prefix}.w1g"] = w1g.transpose(1, 2).contiguous()   # (E, G, D)
    sd[f"{prefix}.b1g"] = b1g
    sd[f"{prefix}.w2"] = _t(e["w2"]).transpose(1, 2).contiguous()  # (E, D, F)
    sd[f"{prefix}.b2"] = _t(e["b2"])
    if "shared_expert" not in p:
        return
    s = p["shared_expert"]
    if "wg" in s:
        _put_swiglu(sd, f"{prefix}.shared", s["w1"][0], s["b1"][0],
                    s["wg"][0], s["bg"][0], s["w2"][0], s["b2"][0])
    else:  # a SiLU-MLP shared expert
        sd[f"{prefix}.shared.w1g.weight"] = _t(s["w1"][0]).t().contiguous()
        sd[f"{prefix}.shared.w1g.bias"] = _t(s["b1"][0])
        sd[f"{prefix}.shared.linear2.weight"] = _t(s["w2"][0]).t() \
            .contiguous()
        sd[f"{prefix}.shared.linear2.bias"] = _t(s["b2"][0])


def _put_ffn(sd, prefix, p):
    if "experts" in p:
        _put_moe(sd, prefix, p)
    elif "Dense_0" in p:  # ReLU FFN
        _put_linear(sd, f"{prefix}.linear1", p["Dense_0"])
        _put_linear(sd, f"{prefix}.linear2", p["Dense_1"])
    else:  # SwiGLU
        _put_swiglu(sd, prefix, p["linear1"]["kernel"], p["linear1"]["bias"],
                    p["gate"]["kernel"], p["gate"]["bias"],
                    p["linear2"]["kernel"], p["linear2"]["bias"])


def amt_from_jax(params, moe_state=None) -> Dict[str, torch.Tensor]:
    """State dict of a port VideoMusicTransformer from the flax params of a
    JAX VideoMusicTransformer of the same config, any wiring. Linear_chord's
    extra input row (the appended key) becomes its last column.
    ``moe_state``: the model's "moe_state" collection, which a config with
    MoE balancing (V3) has; its ``balance_bias`` vectors become the
    MoE layers' buffers of that name."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("embedding_root", "embedding_attr", "chord_embedding",
                 "scene_embedding"):
        if name in params:
            sd[f"{name}.weight"] = _t(params[name]["embedding"])
    for name in ("pe_chord", "pe_video"):  # learned positions
        if name in params:
            sd[f"{name}.embedding"] = _t(params[name]["embedding"])
    _put_linear(sd, "linear_chord", params["Linear_chord"])
    _put_linear(sd, "linear_vis", params["Linear_vis"])
    _put_norm(sd, "encoder_norm", params["encoder_norm"])
    _put_norm(sd, "decoder_norm", params["decoder_norm"])
    for name in ("Wout", "Wout_root", "Wout_attr"):
        if name in params:
            _put_linear(sd, name.lower(), params[name])
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
        ffn = state.get("ffn", {})
        if "balance_bias" in ffn:
            sd[f"{stack}.{i}.ffn.balance_bias"] = _t(ffn["balance_bias"])
        for step in MOE_STEPS:
            if step in ffn:
                sd[f"{stack}.{i}.ffn.{step}"] = torch.tensor(
                    int(np.asarray(ffn[step])), dtype=torch.int32)
    return sd


MOE_STEPS = ("sched_step", "temp_step")


def amt_moe_state_to_jax(model: nn.Module) -> Dict:
    """The JAX "moe_state" collection of a port VideoMusicTransformer: per
    MoE layer ("enc_i" / "dec_i") its balancing bias and its schedules'
    steps (int32), numpy arrays; {} without such state."""
    out: Dict = {}
    for kind, stack in (("enc", model.encoder_layers),
                        ("dec", model.decoder_layers)):
        for i, layer in enumerate(stack):
            ffn = layer.ffn
            if not isinstance(ffn, MoELayer):
                continue
            state = {name: np.asarray(ffn.steps[name], np.int32)
                     for name in ffn.steps}
            if getattr(ffn, "balance_bias", None) is not None:
                state["balance_bias"] = ffn.balance_bias.detach().cpu() \
                    .numpy()
            if state:
                out[f"{kind}_{i}"] = {"ffn": state}
    return out


def load_amt_from_jax_(model: nn.Module, params, moe_state=None) -> None:
    """Copy a JAX train state's ``params`` (a numpy tree), and its
    ``moe_state`` where given, into ``model`` in place: the tensors keep
    their device and identity, so an optimizer over them stays valid.
    Without ``moe_state`` the MoE state (balancing biases, schedule steps)
    is left as it is."""
    sd = amt_from_jax(params, moe_state)
    with torch.no_grad():
        own = model.state_dict()
        if moe_state is None:  # MoE state, not params
            own = {k: v for k, v in own.items() if k.rsplit(".", 1)[-1]
                   not in MOE_STEPS + ("balance_bias",)}
        if sorted(own) != sorted(sd):
            raise KeyError(f"parameter names differ: "
                           f"{sorted(set(own) ^ set(sd))}")
        for name, t in sd.items():
            own[name].copy_(t)
    for mod in model.modules():
        if isinstance(mod, MoELayer):
            for name in mod.steps:
                mod.steps[name] = int(getattr(mod, name))


def music_transformer_from_jax(params) -> Dict[str, torch.Tensor]:
    """State dict of a port MusicTransformer from the flax params of the
    JAX MusicTransformer of the same config."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("embedding_root", "embedding_attr"):
        sd[f"{name}.weight"] = _t(params[name]["embedding"])
    _put_linear(sd, "linear_chord", params["Linear_chord"])
    _put_linear(sd, "wout", params["Wout"])
    _put_norm(sd, "final_norm", params["final_norm"])
    i = 0
    while f"layer_{i}" in params:
        p, pre = params[f"layer_{i}"], f"layers.{i}"
        _put_attention(sd, f"{pre}.self_attn", p["self_attn"])
        for n in ("norm1", "norm2", "ff1", "ff2"):
            (_put_norm if n.startswith("norm") else _put_linear)(
                sd, f"{pre}.{n}", p[n])
        i += 1
    return sd


def _put_proj(sd, prefix, p):
    """A flax Dense or, under ``use_kan``, a KANLinear."""
    if "base_weight" in p:
        _put_kan(sd, prefix, p)
    else:
        _put_linear(sd, prefix, p)


def _put_mamba(sd, prefix, p):
    for name in ("in_proj", "x_proj", "out_proj"):
        _put_proj(sd, f"{prefix}.{name}", p[name])
    # (d_conv, 1, ED) "HIO" -> depthwise Conv1d (ED, 1, d_conv)
    sd[f"{prefix}.conv.weight"] = _t(p["conv_kernel"]).permute(2, 1, 0) \
        .contiguous()
    sd[f"{prefix}.conv.bias"] = _t(p["conv_bias"])
    dt_w = _t(p["dt_proj_kernel"])                     # (dt_rank, ED)
    # the JAX block uses the stored kernel shifted by -dt_rank**-0.5
    sd[f"{prefix}.dt_proj.weight"] = (dt_w - dt_w.shape[0] ** -0.5).t() \
        .contiguous()
    sd[f"{prefix}.dt_proj.bias"] = _t(p["dt_proj_bias"])
    sd[f"{prefix}.A_log"] = _t(p["A_log"])
    sd[f"{prefix}.D"] = _t(p["D"])


def _put_residual(sd, prefix, p):
    _put_norm(sd, f"{prefix}.norm", p["norm"])
    _put_mamba(sd, f"{prefix}.mixer", p["mixer"])


def _put_relu_ffn(sd, prefix, p):
    _put_linear(sd, f"{prefix}.linear1", p["Dense_0"])
    _put_linear(sd, f"{prefix}.linear2", p["Dense_1"])


def _put_conv(sd, prefix, p):
    """flax Conv (spatial..., in / groups, out) -> torch (out, in / groups,
    spatial...), and its bias where it has one."""
    k = _t(p["kernel"])
    sd[f"{prefix}.weight"] = k.permute(k.dim() - 1, k.dim() - 2,
                                       *range(k.dim() - 2)).contiguous()
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _put_rnn(sd, prefix, p):
    """The JAX RNNStack's parameters carry torch's own names."""
    for name, a in p.items():
        sd[f"{prefix}.{name}"] = _t(a)


def _put_mingru_block(sd, prefix, m, i):
    for n in ("norm", "ff_norm"):
        sd[f"{prefix}.{n}.gamma"] = _t(m[f"{n}_{i}"]["gamma"])
    g = m[f"mingru_{i}"]
    for n in ("to_hidden_and_gate", "to_out"):
        if n in g:
            _put_linear(sd, f"{prefix}.mingru.{n}", g[n])
    for n in ("ff1", "ff2"):
        _put_linear(sd, f"{prefix}.{n}", m[f"{n}_{i}"])


def regression_from_jax(params) -> Dict[str, torch.Tensor]:
    """State dict of a port VideoRegression from the flax params of the
    JAX VideoRegression of the same config, any of the fourteen
    backbones."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("in_proj", "regressor", "classifier"):
        _put_linear(sd, name, params[name])
    m, i = params["model"], 0
    if "weight_ih_l0" in m:  # RNNStack
        _put_rnn(sd, "backbone.rnn", m)
        return sd
    if "cnn" in m:  # CNNGRU
        _put_conv(sd, "backbone.cnn", m["cnn"])
        _put_rnn(sd, "backbone.gru.rnn", m["gru"])
        return sd
    if "mingru_0" in m:  # _MinGRUBackbone
        while f"mingru_{i}" in m:
            _put_mingru_block(sd, f"backbone.blocks.{i}", m, i)
            i += 1
        return sd
    if "mamba_0" in m:  # MoEMamba
        while f"mamba_{i}" in m:
            _put_residual(sd, f"backbone.mamba.{i}", m[f"mamba_{i}"])
            _put_norm(sd, f"backbone.moe_norm.{i}", m[f"moe_norm_{i}"])
            _put_moe(sd, f"backbone.moe.{i}", m[f"moe_{i}"])
            i += 1
        return sd
    while f"layer_{i}" in m:
        p, pre = m[f"layer_{i}"], f"backbone.layers.{i}"
        i += 1
        if "mixer" in p:  # Mamba
            _put_residual(sd, pre, p)
            continue
        for d in ("mamba_forward", "mamba_backward"):
            _put_mamba(sd, f"{pre}.{d}", p[d])
        for n in ("norm1", "norm2", "norm3", "norm4"):
            if n in p:
                _put_norm(sd, f"{pre}.{n}", p[n])
        if "ffn1" in p:  # the v0 layer
            _put_relu_ffn(sd, f"{pre}.ffn1", p["ffn1"])
            _put_relu_ffn(sd, f"{pre}.ffn2", p["ffn2"])
        elif "experts" in p["ffn"]:
            _put_moe(sd, f"{pre}.ffn", p["ffn"])
        else:
            _put_relu_ffn(sd, f"{pre}.ffn", p["ffn"])
    return sd


def _put_clip_block(sd, prefix, p):
    _put_norm(sd, f"{prefix}.ln1", p["ln1"])
    parts = [_dense(p[name]) for name in ("q_proj", "k_proj", "v_proj")]
    sd[f"{prefix}.qkv.weight"] = torch.cat([w for w, _ in parts])
    sd[f"{prefix}.qkv.bias"] = torch.cat([b for _, b in parts])
    for name in ("out_proj", "fc1", "fc2"):
        _put_linear(sd, f"{prefix}.{name}", p[name])
    _put_norm(sd, f"{prefix}.ln2", p["ln2"])


def clip_from_jax(params) -> Dict[str, torch.Tensor]:
    """State dict of the port's features.clip.CLIP from the flax params of
    the JAX CLIP (both towers and ``logit_scale``): q | k | v into one
    ``qkv``, the patch embedding's (P, P, 3, D) kernel to (D, 3, P, P);
    ``projection`` and the embeddings keep the JAX layout."""
    sd: Dict[str, torch.Tensor] = {"logit_scale": _t(params["logit_scale"])}
    for tower, norms in (("visual", ("ln_pre", "ln_post")),
                         ("text", ("ln_final",))):
        p = params[tower]
        for name in ("position_embedding", "projection", "class_embedding"):
            if name in p:
                sd[f"{tower}.{name}"] = _t(p[name])
        for name in norms:
            _put_norm(sd, f"{tower}.{name}", p[name])
        i = 0
        while f"block_{i}" in p:
            _put_clip_block(sd, f"{tower}.blocks.{i}", p[f"block_{i}"])
            i += 1
    _put_conv(sd, "visual.patch_embed", params["visual"]["patch_embed"])
    sd["text.token_embedding.weight"] = _t(
        params["text"]["token_embedding"]["embedding"])
    return sd


def maxvit_from_jax(params) -> Dict[str, torch.Tensor]:
    """State dict of the port's features.maxvit.MaxViT from the flax params
    of the JAX MaxViT: convolutions (stem, 1x1, depthwise 3x3, SE) to
    torch's (out, in / groups, kh, kw), Dense to (out, in), FoldedBN's
    ``scale`` / ``bias`` as they are, LayerNorms to ``weight`` / ``bias``,
    and each ``rel_bias`` table as it is."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, p):
        if "kernel" in p:
            if np.ndim(p["kernel"]) == 2:
                _put_linear(sd, prefix, p)
            else:
                _put_conv(sd, prefix, p)
        elif "scale" in p and prefix.rsplit(".", 1)[-1].startswith("ln"):
            _put_norm(sd, prefix, p)
        else:
            for name, a in p.items():
                if isinstance(a, dict):
                    put(f"{prefix}.{name}", a)
                else:  # FoldedBN scale / bias, rel_bias
                    sd[f"{prefix}.{name}"] = _t(a)

    for name in ("stem_conv1", "stem_bn", "stem_conv2"):
        put(name, params[name])
    for name, p in params.items():
        if name.startswith("s") and name[1].isdigit():
            put(f"layers.{name}", p)
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
    lambdas, normal(head_dim**-0.5) RPR tables, normal(1) learned
    positions, the KANLinear base (uniform, fan_in / 3 variance) and spline
    (normal(0.1 / grid_size)) weights, and the Mamba dt / A / D
    initialisers; the RNNs' uniform(+-hidden**-0.5), LeCun-normal
    convolutions, and CLIP's / MaxViT's normal(0.02) (text tower 0.01)
    embeddings, projections and relative-position tables. The frozen chord
    table keeps its values. Returns ``model``."""
    done = set()
    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention):
            D, qk, w = mod.d_model, mod.qk_dim, mod.in_proj.weight
            # (block, fan_out of one projection): q, k and v share their
            # fans unless q and k are 2D wide
            kd = mod.k_dim
            blocks = [(w, D)] if qk == kd == mod.v_dim == D else [
                (w[:qk], qk), (w[qk:qk + kd], kd), (w[qk + kd:], mod.v_dim)]
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
            if mod.rpr:
                _normal_(mod.Er, mod.head_dim ** -0.5, gen)
        elif isinstance(mod, MoELayer) and mod.cfg.expert != "kan":
            D, F = mod.w1g.shape[2], mod.w2.shape[2]
            _normal_(mod.w1g, D ** -0.5, gen)
            _normal_(mod.w2, F ** -0.5, gen)
            for b in (mod.b1g, mod.b2):
                nn.init.zeros_(b)
        elif isinstance(mod, KANLinear):
            lim = mod.in_features ** -0.5
            _uniform_(mod.base_weight, -lim, lim, gen)
            _normal_(mod.spline_weight, 0.1 / mod.grid_size, gen)
        elif isinstance(mod, LearnedPE):
            _normal_(mod.embedding, 1.0, gen)
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
            done.update((id(mod.dt_proj.weight), id(mod.conv.weight)))
        elif isinstance(mod, nn.RNNBase):
            lim = mod.hidden_size ** -0.5  # torch's and the JAX stack's
            for t in mod.parameters():
                _uniform_(t, -lim, lim, gen)
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d)) \
                and id(mod.weight) not in done:
            _normal_(mod.weight, mod.weight[0].numel() ** -0.5, gen)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, VisionTower):
            for t in (mod.class_embedding, mod.position_embedding,
                      mod.projection):
                _normal_(t, 0.02, gen)
        elif isinstance(mod, TextTower):
            for t in (mod.position_embedding, mod.projection):
                _normal_(t, 0.01, gen)
        elif isinstance(mod, CLIP):
            nn.init.constant_(mod.logit_scale, math.log(1 / 0.07))
        elif isinstance(mod, PartitionAttention):
            _normal_(mod.rel_bias, 0.02, gen)
        elif isinstance(mod, nn.Linear) and id(mod.weight) not in done:
            _normal_(mod.weight, mod.weight.shape[1] ** -0.5, gen)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding) and mod.weight.requires_grad:
            _normal_(mod.weight, mod.weight.shape[1] ** -0.5, gen)
        elif isinstance(mod, LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, RMSNorm):
            nn.init.ones_(mod.weight)
    return model
