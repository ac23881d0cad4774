"""Reference-checkpoint conversion: torch ``state_dict`` pickles -> flax
params.

The reference saves bare ``model.state_dict()`` pickles
(``train.py:337-341``). These functions map them weight-for-weight onto the
flax trees of this framework so existing trained models carry over:

  * base AMT (``VideoMusicTransformer`` with rpr=True,
    reference model/video_music_transformer.py:910-977 + model/rpr.py) via
    :func:`convert_reference_amt`;
  * the regression models with RNN backbones via
    :func:`convert_reference_regression`.

torch Linear stores (out, in) — flax Dense stores (in, out); packed qkv
``in_proj_weight`` (3D, D) splits into per-projection kernels.

Fork-variant coverage:
  * V1 (``convert_reference_amt_v1``): learned positional embeddings, MoE or
    SharedMoE FFN with GLU/MLP experts per version, optional frozen Word2Vec
    chord table (reference model/video_music_transformer.py:22-140).
  * V2 (``convert_reference_amt_v2``): 3 SwiGLU + 3 SharedMoE, incl. the 2.3
    KAN experts (efficient_kan ``spline_scaler`` folded into the spline
    weights; an adaptively-updated ``grid`` buffer is NOT portable — the
    reference never calls update_grid in the training loop, so grids stay at
    their uniform init).
  * V3 (``convert_reference_amt_v3``): RMSNorm, differential attention
    (lambda vectors + subln), balanced SharedMoE; the balancing ``bias``
    buffer converts separately via :func:`convert_reference_moe_state`
    because it lives in the "moe_state" collection here, not params.

Dead reference parameters (``condition_linear``, the unused ``embedding``
table, RoPE cos/sin caches) are intentionally dropped.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _np(sd, k):
    v = sd[k]
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def _linear(sd, k):
    return {"kernel": _np(sd, k + ".weight").T, "bias": _np(sd, k + ".bias")}


def _norm(sd, k):
    return {"scale": _np(sd, k + ".weight"), "bias": _np(sd, k + ".bias")}


def _mha(sd, prefix, *, er: bool = False) -> Dict[str, Any]:
    """torch MultiheadAttention(RPR) -> our MultiHeadAttention params."""
    w = _np(sd, prefix + ".in_proj_weight")
    b = _np(sd, prefix + ".in_proj_bias")
    D = w.shape[1]
    out = {
        "q_proj": {"kernel": w[:D].T, "bias": b[:D]},
        "k_proj": {"kernel": w[D:2 * D].T, "bias": b[D:2 * D]},
        "v_proj": {"kernel": w[2 * D:].T, "bias": b[2 * D:]},
        "out_proj": _linear(sd, prefix + ".out_proj"),
    }
    if er:
        out["Er"] = _np(sd, prefix + ".Er")
    return out


def convert_transformer_core(sd, n_layers: int, *, prefix: str = "transformer.",
                             rpr_decoder: bool = True) -> Dict[str, Any]:
    """torch ``nn.Transformer`` (+ RPR custom decoder) -> enc_i/dec_i trees."""
    params: Dict[str, Any] = {}
    for i in range(n_layers):
        e = f"{prefix}encoder.layers.{i}."
        params[f"enc_{i}"] = {
            "self_attn": _mha(sd, e + "self_attn"),
            "ffn": {"Dense_0": _linear(sd, e + "linear1"),
                    "Dense_1": _linear(sd, e + "linear2")},
            "norm1": _norm(sd, e + "norm1"),
            "norm2": _norm(sd, e + "norm2"),
        }
        d = f"{prefix}decoder.layers.{i}."
        params[f"dec_{i}"] = {
            "self_attn": _mha(sd, d + "self_attn", er=rpr_decoder),
            "cross_attn": _mha(sd, d + "multihead_attn"),
            "ffn": {"Dense_0": _linear(sd, d + "linear1"),
                    "Dense_1": _linear(sd, d + "linear2")},
            "norm1": _norm(sd, d + "norm1"),
            "norm2": _norm(sd, d + "norm2"),
            "norm3": _norm(sd, d + "norm3"),
        }
    params["encoder_norm"] = _norm(sd, prefix + "encoder.norm")
    params["decoder_norm"] = _norm(sd, prefix + "decoder.norm")
    return params


def convert_reference_amt(sd, n_layers: int = 6) -> Dict[str, Any]:
    """Base AMT state_dict -> VideoMusicTransformer flax params
    (reference: model/video_music_transformer.py:910-977)."""
    params = convert_transformer_core(sd, n_layers)
    params["embedding_root"] = {"embedding": _np(sd, "embedding_root.weight")}
    params["embedding_attr"] = {"embedding": _np(sd, "embedding_attr.weight")}
    params["Linear_chord"] = _linear(sd, "Linear_chord")
    params["Linear_vis"] = _linear(sd, "Linear_vis")
    params["Wout"] = _linear(sd, "Wout")
    if "scene_embedding.weight" in sd:
        params["scene_embedding"] = {
            "embedding": _np(sd, "scene_embedding.weight")}
    return params


def _glu_expert(sd, prefix):
    """GLUExpert Linear trio -> our SwiGLU names (reference moe.py:36-49)."""
    return {"linear1": _linear(sd, prefix + ".linear1"),
            "gate": _linear(sd, prefix + ".gate"),
            "linear2": _linear(sd, prefix + ".linear2")}


def _glu_expert_stack(sd, prefix, n_experts):
    """n GLUExperts -> stacked (E, D, F) arrays (ops/moe.py GLUExpertStack)."""
    w1 = np.stack([_np(sd, f"{prefix}.{e}.linear1.weight").T
                   for e in range(n_experts)])
    b1 = np.stack([_np(sd, f"{prefix}.{e}.linear1.bias")
                   for e in range(n_experts)])
    wg = np.stack([_np(sd, f"{prefix}.{e}.gate.weight").T
                   for e in range(n_experts)])
    bg = np.stack([_np(sd, f"{prefix}.{e}.gate.bias")
                   for e in range(n_experts)])
    w2 = np.stack([_np(sd, f"{prefix}.{e}.linear2.weight").T
                   for e in range(n_experts)])
    b2 = np.stack([_np(sd, f"{prefix}.{e}.linear2.bias")
                   for e in range(n_experts)])
    return {"w1": w1, "b1": b1, "wg": wg, "bg": bg, "w2": w2, "b2": b2}


def _shared_moe(sd, prefix, n_experts=6):
    """SharedMoELayer -> our MoELayer params (reference moe.py:203-302)."""
    out = {"gate": _linear(sd, prefix + ".gate"),
           "experts": _glu_expert_stack(sd, prefix + ".experts", n_experts)}
    if f"{prefix}.shared_expert.linear1.weight" in sd:
        out["shared_expert"] = {
            "w1": _np(sd, f"{prefix}.shared_expert.linear1.weight").T[None],
            "b1": _np(sd, f"{prefix}.shared_expert.linear1.bias")[None],
            "wg": _np(sd, f"{prefix}.shared_expert.gate.weight").T[None],
            "bg": _np(sd, f"{prefix}.shared_expert.gate.bias")[None],
            "w2": _np(sd, f"{prefix}.shared_expert.linear2.weight").T[None],
            "b2": _np(sd, f"{prefix}.shared_expert.linear2.bias")[None],
        }
    return out


def convert_reference_amt_v2(sd, n_layers: int = 6, n_experts: int = 6,
                             expert: str = "glu") -> Dict[str, Any]:
    """V2-family state_dict (3 SwiGLU + 3 SharedMoE layers, reference
    model/video_music_transformer.py:316-437) -> flax params matching
    ``amt_config("2.x")``. Pass expert="kan" for 2.3 (bare KANLinear
    experts; the spline_scaler folds into the spline weights)."""
    params: Dict[str, Any] = {
        "embedding_root": {"embedding": _np(sd, "embedding_root.weight")},
        "embedding_attr": {"embedding": _np(sd, "embedding_attr.weight")},
        "Linear_chord": _linear(sd, "Linear_chord"),
        "Linear_vis": _linear(sd, "Linear_vis"),
    }
    if "Wout.weight" in sd:
        params["Wout"] = _linear(sd, "Wout")
    else:
        params["Wout_root"] = _linear(sd, "Wout_root")
        params["Wout_attr"] = _linear(sd, "Wout_attr")
    if "positional_embedding.weight" in sd:  # version 2.0
        params["pe_chord"] = {
            "embedding": _np(sd, "positional_embedding.weight")}
        params["pe_video"] = {
            "embedding": _np(sd, "positional_embedding_video.weight")}
    rate = min(3, max(0, n_layers - 1))
    for i in range(n_layers):
        e = f"transformer.encoder.layers.{i}."
        enc = {"self_attn": _mha(sd, e + "self_attn"),
               "norm1": _norm(sd, e + "norm1"),
               "norm2": _norm(sd, e + "norm2")}
        enc["ffn"] = (_glu_expert(sd, e + "ff") if i < rate
                      else _moe(sd, e + "ff", n_experts, expert))
        params[f"enc_{i}"] = enc
        d = f"transformer.decoder.layers.{i}."
        dec = {"self_attn": _mha(sd, d + "self_attn"),
               "cross_attn": _mha(sd, d + "cross_attn"),
               "norm1": _norm(sd, d + "norm1"),
               "norm2": _norm(sd, d + "norm2"),
               "norm3": _norm(sd, d + "norm3")}
        dec["ffn"] = (_glu_expert(sd, d + "ff") if i < rate
                      else _moe(sd, d + "ff", n_experts, expert))
        params[f"dec_{i}"] = dec
    params["encoder_norm"] = _norm(sd, "transformer.encoder.norm")
    params["decoder_norm"] = _norm(sd, "transformer.decoder.norm")
    return params


def convert_reference_regression(sd, reg_model: str = "bilstm"
                                 ) -> Dict[str, Any]:
    """VideoRegression state_dict -> flax params for RNN/CNN backbones
    (reference: model/video_regression.py:104-245). RNN weights keep torch's
    (gates*H, in) layout and names (ops/scan.py consumes them directly)."""
    params: Dict[str, Any] = {
        "in_proj": _linear(sd, "in_proj.0"),
        "regressor": _linear(sd, "regressor"),
        "classifier": _linear(sd, "classifier.0"),
    }
    rnn = {}
    for k in sd:
        if k.startswith("model.") and ("weight_" in k or "bias_" in k):
            rnn[k[len("model."):]] = _np(sd, k)
    if reg_model in ("cnngru", "cnnbigru"):
        # Sequential(cnn, silu, dropout) then GRU (reference :86-104)
        params["model"] = {
            "cnn": {"kernel": np.transpose(_np(sd, "model.0.weight"),
                                           (2, 1, 0)),
                    "bias": _np(sd, "model.0.bias")},
            "gru": rnn,
        }
    else:
        params["model"] = rnn
    return params


def _rms(sd, k):
    """RMSNorm (elementwise_affine) -> ops/norms.RMSNorm params."""
    return {"weight": _np(sd, k + ".weight")}


def _mlp_expert_stack(sd, prefix, n_experts):
    """Sequential(Linear D->2D, SiLU, Dropout, Linear 2D->D) experts ->
    stacked MLPExpertStack arrays (reference
    video_music_transformer.py:82-88)."""
    return {
        "w1": np.stack([_np(sd, f"{prefix}.{e}.0.weight").T
                        for e in range(n_experts)]),
        "b1": np.stack([_np(sd, f"{prefix}.{e}.0.bias")
                        for e in range(n_experts)]),
        "w2": np.stack([_np(sd, f"{prefix}.{e}.3.weight").T
                        for e in range(n_experts)]),
        "b2": np.stack([_np(sd, f"{prefix}.{e}.3.bias")
                        for e in range(n_experts)]),
    }


def _kan_linear(sd, prefix):
    """efficient_kan KANLinear -> ops/kan.KANLinear params. The standalone
    spline_scaler (out, in) folds into the spline weights exactly as the
    reference's ``scaled_spline_weight`` property does."""
    base = _np(sd, prefix + ".base_weight").T  # (in, out)
    spline = _np(sd, prefix + ".spline_weight")  # (out, in, coeff)
    if prefix + ".spline_scaler" in sd:
        spline = spline * _np(sd, prefix + ".spline_scaler")[..., None]
    return {"base_weight": base,
            "spline_weight": np.transpose(spline, (1, 2, 0))}


def _kan_expert_stack(sd, prefix, n_experts):
    """n bare KANLinear(d, d) experts -> KANExpertStack submodules
    (reference V2.3 expert, video_music_transformer.py:385-386)."""
    return {f"kan_{e}": _kan_linear(sd, f"{prefix}.{e}")
            for e in range(n_experts)}


_EXPERT_STACKS = {"glu": _glu_expert_stack, "mlp": _mlp_expert_stack,
                  "kan": _kan_expert_stack}


def _moe(sd, prefix, n_experts=6, expert="glu"):
    """MoELayer / SharedMoELayer -> our MoELayer params (reference
    moe.py:150-302). The shared expert is detected from the state_dict; the
    balancing bias buffer is NOT part of params (see
    convert_reference_moe_state)."""
    stack = _EXPERT_STACKS[expert]
    out = {"gate": _linear(sd, prefix + ".gate"),
           "experts": stack(sd, prefix + ".experts", n_experts)}
    shared_probe = {"glu": ".shared_expert.linear1.weight",
                    "mlp": ".shared_expert.0.weight",
                    "kan": ".shared_expert.base_weight"}[expert]
    if prefix + shared_probe in sd:
        if expert == "kan":
            out["shared_expert"] = {
                "kan_0": _kan_linear(sd, prefix + ".shared_expert")}
        else:
            one = {".linear1": ("w1", "b1"), ".gate": ("wg", "bg"),
                   ".linear2": ("w2", "b2")} if expert == "glu" else {
                   ".0": ("w1", "b1"), ".3": ("w2", "b2")}
            out["shared_expert"] = {}
            for tk, (wk, bk) in one.items():
                out["shared_expert"][wk] = _np(
                    sd, f"{prefix}.shared_expert{tk}.weight").T[None]
                out["shared_expert"][bk] = _np(
                    sd, f"{prefix}.shared_expert{tk}.bias")[None]
    return out


def _diff_mha(sd, prefix):
    """DifferentialMultiheadAttention -> our differential attention params
    (reference custom_transformer.py:610-646: bias-free q/k/v/out
    projections with 2x q/k heads, lambda vectors, per-head RMSNorm)."""
    p = prefix + "." if prefix else ""
    out = {name: {"kernel": _np(sd, f"{p}{name}.weight").T}
           for name in ("q_proj", "k_proj", "v_proj", "out_proj")}
    for lam in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
        out[lam] = _np(sd, f"{p}{lam}")
    out["subln"] = _rms(sd, p + "subln")
    return out


def _amt_io_params(sd) -> Dict[str, Any]:
    """The embedding / projection / output heads shared by every variant."""
    params: Dict[str, Any] = {
        "embedding_root": {"embedding": _np(sd, "embedding_root.weight")},
        "embedding_attr": {"embedding": _np(sd, "embedding_attr.weight")},
        "Linear_chord": _linear(sd, "Linear_chord"),
        "Linear_vis": _linear(sd, "Linear_vis"),
    }
    if "Wout.weight" in sd:
        params["Wout"] = _linear(sd, "Wout")
    else:
        params["Wout_root"] = _linear(sd, "Wout_root")
        params["Wout_attr"] = _linear(sd, "Wout_attr")
    if "scene_embedding.weight" in sd:
        params["scene_embedding"] = {
            "embedding": _np(sd, "scene_embedding.weight")}
    if "chord_embedding_model.weight" in sd:
        params["chord_embedding"] = {
            "embedding": _np(sd, "chord_embedding_model.weight")}
    return params


def convert_reference_amt_v1(sd, version: str = "1.1", n_layers: int = 6,
                             n_experts: int = 6) -> Dict[str, Any]:
    """V1-family state_dict -> flax params matching ``amt_config("1.x")``
    (reference model/video_music_transformer.py:22-140): learned positional
    embeddings, MoE FFN everywhere (GLU experts for exactly '1.1'/'1.3',
    SiLU-MLP otherwise; SharedMoE except for 1.0/1.1/1.3.4), shallow-SwiGLU/
    deep-MoE split for 1.3.3/1.3.4. The dead ``condition_linear`` and unused
    ``embedding`` table are dropped."""
    expert = "glu" if version in ("1.1", "1.3") else "mlp"
    params = _amt_io_params(sd)
    params["pe_chord"] = {"embedding": _np(sd, "positional_embedding.weight")}
    params["pe_video"] = {
        "embedding": _np(sd, "positional_embedding_video.weight")}
    split = version in ("1.3.3", "1.3.4")
    rate = min(3, max(0, n_layers - 1))
    for i in range(n_layers):
        shallow = split and i < rate
        e = f"transformer.encoder.layers.{i}."
        params[f"enc_{i}"] = {
            "self_attn": _mha(sd, e + "self_attn"),
            "ffn": (_glu_expert(sd, e + "ff") if shallow
                    else _moe(sd, e + "ff", n_experts, expert)),
            "norm1": _norm(sd, e + "norm1"),
            "norm2": _norm(sd, e + "norm2"),
        }
        d = f"transformer.decoder.layers.{i}."
        params[f"dec_{i}"] = {
            "self_attn": _mha(sd, d + "self_attn"),
            "cross_attn": _mha(sd, d + "cross_attn"),
            "ffn": (_glu_expert(sd, d + "ff") if shallow
                    else _moe(sd, d + "ff", n_experts, expert)),
            "norm1": _norm(sd, d + "norm1"),
            "norm2": _norm(sd, d + "norm2"),
            "norm3": _norm(sd, d + "norm3"),
        }
    params["encoder_norm"] = _norm(sd, "transformer.encoder.norm")
    params["decoder_norm"] = _norm(sd, "transformer.decoder.norm")
    return params


def convert_reference_amt_v3(sd, version: str = "3.1", n_layers: int = 6,
                             n_experts: int = 6) -> Dict[str, Any]:
    """V3-family state_dict -> flax params matching ``amt_config("3.x")``
    (reference model/video_music_transformer.py:611-747): RMSNorm
    everywhere, differential attention (encoder too except 3.0), 3 SwiGLU +
    3 balanced-SharedMoE layers. The balancing bias buffer converts via
    :func:`convert_reference_moe_state`."""
    params = _amt_io_params(sd)
    rate = min(3, max(0, n_layers - 1))
    enc_att = _mha if version == "3.0" else _diff_mha
    for i in range(n_layers):
        e = f"transformer.encoder.layers.{i}."
        params[f"enc_{i}"] = {
            "self_attn": enc_att(sd, e + "self_attn"),
            "ffn": (_glu_expert(sd, e + "ff") if i < rate
                    else _moe(sd, e + "ff", n_experts, "glu")),
            "norm1": _rms(sd, e + "norm1"),
            "norm2": _rms(sd, e + "norm2"),
        }
        d = f"transformer.decoder.layers.{i}."
        params[f"dec_{i}"] = {
            "self_attn": _diff_mha(sd, d + "self_attn"),
            "cross_attn": _diff_mha(sd, d + "cross_attn"),
            "ffn": (_glu_expert(sd, d + "ff") if i < rate
                    else _moe(sd, d + "ff", n_experts, "glu")),
            "norm1": _rms(sd, d + "norm1"),
            "norm2": _rms(sd, d + "norm2"),
            "norm3": _rms(sd, d + "norm3"),
        }
    params["encoder_norm"] = _rms(sd, "transformer.encoder.norm")
    params["decoder_norm"] = _rms(sd, "transformer.decoder.norm")
    return params


def convert_reference_moe_state(sd, n_layers: int = 6) -> Dict[str, Any]:
    """Balancing ``bias`` buffers (reference moe.py:226-229, shape (E, 1))
    -> the "moe_state" collection tree ({enc,dec}_i/ffn/balance_bias (E,))."""
    state: Dict[str, Any] = {}
    for stack, tag in (("encoder", "enc"), ("decoder", "dec")):
        for i in range(n_layers):
            k = f"transformer.{stack}.layers.{i}.ff.bias"
            if k in sd:
                state[f"{tag}_{i}"] = {
                    "ffn": {"balance_bias": _np(sd, k).reshape(-1)}}
    return state
