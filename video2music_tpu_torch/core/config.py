"""Typed configuration tree for every model family in the framework.

The reference configures models through three argparse modules plus
module-level constants (reference: ``utilities/argument_funcs.py``,
``argument_reg_funcs.py``, ``argument_generate_funcs.py``), and encodes
architecture variants as string-dispatched torch module wiring spread over
four ~300-line constructors (reference: ``model/video_music_transformer.py:
22-140,317-437,612-747,910-977``). Here a single dataclass tree captures the
same design space; ``amt_config(version)`` reproduces each version's wiring
as data.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from . import constants as C


@dataclass(frozen=True)
class AttentionConfig:
    """One attention flavor. All variants share one fused kernel path."""

    num_heads: int = 8
    # "vanilla": plain softmax attention.
    # "rpr": adds Shaw/Huang relative-position bias via learned Er table
    #   (reference: model/rpr.py:390-395).
    # "differential": DIFF-Transformer two-softmax attention
    #   (reference: model/custom_transformer.py:610-834).
    kind: str = "vanilla"
    rope: bool = False
    # Number of KV heads for grouped-query attention; None = MHA
    # (reference: model/grouped_query_attention.py:19-170).
    kv_heads: Optional[int] = None
    er_len: int = C.MAX_SEQ_CHORD  # RPR relative-embedding length
    bias: bool = True  # qkv/out projection bias (differential attn uses False)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts feed-forward (reference: model/moe.py:150-302)."""

    n_experts: int = 6
    n_experts_per_token: int = 2
    expert: str = "glu"  # "glu" (SwiGLU) | "mlp" (SiLU MLP, 2*d_model) | "kan"
    shared_expert: bool = False  # SharedMoELayer's always-on expert
    # Aux-loss-free balancing: non-gradient bias on gate logits, updated
    # +- update_rate*(mean(count)-count) per train step
    # (reference: model/moe.py:256-280).
    balancing: bool = False
    balancing_update_rate: float = 0.001
    # Anneal k from n_experts down to n_experts_per_token every update_step
    # train steps (reference: model/moe.py:66-82).
    topk_schedule: bool = False
    topk_update_step: int = 32
    # Expert dispatch strategy for batched (training/eval) calls:
    #   "dense"    — every expert computes every token, one-hot combine
    #                (exact reference math, E/k x expert FLOPs; default);
    #   "capacity" — sort-free capacity-based sparse dispatch: each expert
    #                computes at most ceil(T*k/E * capacity_factor) tokens
    #                (scatter/gather buffers). Cuts expert FLOPs ~E/(k*cf)x
    #                — worth it once d_ff makes the step compute-bound —
    #                but tokens beyond an overflowing expert's capacity are
    #                DROPPED (zero contribution), a documented deviation
    #                from the reference's loop. Single-token decode always
    #                uses the gathered fast path regardless.
    dispatch: str = "dense"
    capacity_factor: float = 1.25
    # Routing-softmax temperature annealing t: min -> max by +step per call
    # (reference TemperatureScheduler, model/moe.py:84-97). Dead in the
    # reference live path (always None, video_music_transformer.py:395,671);
    # ported for completeness. Quirk kept: in SharedMoELayer the scheduler
    # steps during eval too (moe.py:238-240); in plain MoELayer it is
    # training-only (moe.py:174-176).
    temperature_schedule: bool = False
    temperature_min: float = 0.8
    temperature_max: float = 1.1
    temperature_step: float = 0.0005


@dataclass(frozen=True)
class LayerSpec:
    """One transformer layer: an attention flavor + a feed-forward flavor."""

    attn: AttentionConfig = AttentionConfig()
    ffn: str = "relu_mlp"  # "relu_mlp" | "swiglu" | "moe"
    cross_attn: Optional[AttentionConfig] = None  # decoder layers only


@dataclass(frozen=True)
class AMTConfig:
    """Affective Multimodal Transformer (all versions as one config space)."""

    version: Optional[str] = None  # None = original AMT; "1.1".."3.2" = fork variants
    n_layers: int = 6
    num_heads: int = 8
    d_model: int = 512
    d_ff: int = 1024
    dropout: float = 0.1
    max_seq_video: int = C.MAX_SEQ_VIDEO
    max_seq_chord: int = C.MAX_SEQ_CHORD
    total_vf_dim: int = 776  # 768 sem + 1 scene + 1 motion + 6 emotion
    # Positional information: "sinusoidal" (base AMT), "learned" (V1/V2.0),
    # "none" (RoPE handled inside attention for V2.1+/V3).
    pos_encoding: str = "sinusoidal"
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    pre_norm: bool = False
    scene_embed: bool = False  # embed scene offset instead of concatenating
    chord_embed: bool = False  # frozen Word2Vec chord table instead of root+attr
    chord_embed_dim: int = 512
    # Which frozen table backs chord_embed (features/chord2vec.py):
    #   "word2vec"       — the reference's trained table (converted from its
    #                      shipped word2vec_filled.bin), indexed POSITIONALLY
    #                      like the reference does (quirk: its rows are
    #                      frequency-sorted symbols, so ids read misaligned
    #                      embeddings — weight-comparable parity default);
    #   "word2vec_keyed" — same table re-aligned by chord symbol (corrected);
    #   "deterministic"  — the synthetic music-theory table (any dim).
    chord_table: str = "word2vec"
    drop_token_rate: float = 0.0
    separated: bool = False  # IS_SEPERATED: separate root/attr heads
    # Grouped-query attention: number of KV heads for every attention in the
    # model (None = MHA). The reference ships MultiheadGQA as a library
    # module but never wires it into a model
    # (reference: model/grouped_query_attention.py; import-only at
    # video_music_transformer.py:12) — here it is a first-class knob.
    kv_heads: Optional[int] = None
    # Recompute attention probabilities in the backward pass instead of
    # saving the (B, H, L, S) f32 tensors — the train step is HBM-bound on
    # exactly those saves (measured ~5-10% step win + large activation
    # memory cut at B=16 full size). Dropout masks regenerate exactly
    # (deterministic given the rng), so gradients are unchanged.
    remat_attention: bool = False
    # Megatron-style sequence parallelism (no reference counterpart —
    # SURVEY §2.5): when True, encoder/decoder layers constrain the
    # residual stream to (batch over "data", sequence over "model"), so
    # under tensor-parallel weight shardings XLA replaces each TP
    # all-reduce with a reduce-scatter + all-gather pair and the LN /
    # dropout / residual regions compute on sequence shards. Requires
    # tracing under ``jax.sharding.set_mesh(mesh)``; math is unchanged
    # (GSPMD) — tested against the unsharded step.
    sequence_parallel: bool = False
    moe: MoEConfig = MoEConfig()
    encoder_layers: Tuple[LayerSpec, ...] = ()
    decoder_layers: Tuple[LayerSpec, ...] = ()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def _uniform(spec: LayerSpec, n: int) -> Tuple[LayerSpec, ...]:
    return tuple(spec for _ in range(n))


def _shallow_deep(shallow: LayerSpec, deep: LayerSpec, n: int):
    """rate shallow layers then n-rate deep layers. The reference hardcodes
    rate=3 for its 6-layer models (model/video_music_transformer.py:411-419);
    we clamp so shrunken test configs still get at least one deep layer."""
    rate = min(3, max(0, n - 1))
    return tuple(shallow for _ in range(rate)) + tuple(deep for _ in range(n - rate))


def _apply_kv_heads(cfg: AMTConfig) -> AMTConfig:
    if cfg.kv_heads is None:
        return cfg
    fix = lambda a: replace(a, kv_heads=cfg.kv_heads) if a else a
    fix_spec = lambda s: replace(s, attn=fix(s.attn),
                                 cross_attn=fix(s.cross_attn))
    return replace(cfg,
                   encoder_layers=tuple(map(fix_spec, cfg.encoder_layers)),
                   decoder_layers=tuple(map(fix_spec, cfg.decoder_layers)))


def amt_config(version: Optional[str] = None, **overrides) -> AMTConfig:
    """Build the layer wiring for an AMT version string.

    Mirrors the constructor dispatch in the reference
    (model/video_music_transformer.py: base :910-977, V1 :22-140, V2 :317-437,
    V3 :612-747) and train.py:136-168.
    """
    cfg = AMTConfig(version=version)
    # apply overrides that affect wiring before building layer specs
    wiring_fields = {f.name for f in dataclasses.fields(AMTConfig)}
    cfg = replace(cfg, **{k: v for k, v in overrides.items() if k in wiring_fields})
    n = cfg.n_layers

    if version is None:
        # Original AMT: vanilla post-norm encoder; decoder self-attn uses RPR
        # relative bias (reference: model/video_music_transformer.py:956-971).
        enc_attn = AttentionConfig(num_heads=cfg.num_heads)
        dec_self = AttentionConfig(num_heads=cfg.num_heads, kind="rpr",
                                   er_len=cfg.max_seq_chord)
        dec_cross = AttentionConfig(num_heads=cfg.num_heads)
        enc = LayerSpec(attn=enc_attn, ffn="relu_mlp")
        dec = LayerSpec(attn=dec_self, ffn="relu_mlp", cross_attn=dec_cross)
        return _apply_kv_heads(replace(
            cfg, pos_encoding="sinusoidal",
            encoder_layers=_uniform(enc, n),
            decoder_layers=_uniform(dec, n)))

    if version.startswith("1."):
        # V1: custom encoder+decoder, learned pos emb, MoE FFN everywhere
        # (or shallow/deep split for 1.3.3/1.3.4), RoPE only for 1.2.3
        # (reference: model/video_music_transformer.py:77-140).
        rope = version == "1.2.3"
        att = AttentionConfig(num_heads=cfg.num_heads, rope=rope)
        expert = "glu" if version in ("1.1", "1.3") else "mlp"
        shared = version not in ("1.0", "1.1", "1.3.4")
        moe = MoEConfig(expert=expert, shared_expert=shared, balancing=False)
        moe_layer = LayerSpec(attn=att, ffn="moe", cross_attn=att)
        swiglu_layer = LayerSpec(attn=att, ffn="swiglu", cross_attn=att)
        if version in ("1.3.3", "1.3.4"):
            enc_layers = _shallow_deep(replace(swiglu_layer, cross_attn=None),
                                       replace(moe_layer, cross_attn=None), n)
            dec_layers = _shallow_deep(swiglu_layer, moe_layer, n)
        else:
            enc_layers = _uniform(replace(moe_layer, cross_attn=None), n)
            dec_layers = _uniform(moe_layer, n)
        return _apply_kv_heads(replace(
            cfg, pos_encoding="learned", moe=moe,
            encoder_layers=enc_layers, decoder_layers=dec_layers))

    if version.startswith("2."):
        # V2: 3 shallow SwiGLU + 3 deep SharedMoE layers; learned pos emb for
        # 2.0, RoPE for 2.1+; KAN expert for 2.3; top-k scheduler except 2.2
        # (reference: model/video_music_transformer.py:369-437).
        rope = version != "2.0"
        att = AttentionConfig(num_heads=cfg.num_heads, rope=rope)
        moe = MoEConfig(expert=("kan" if version == "2.3" else "glu"),
                        shared_expert=True,
                        balancing=overrides.get("balancing", False),
                        topk_schedule=(version != "2.2"))
        shallow = LayerSpec(attn=att, ffn="swiglu", cross_attn=att)
        deep = LayerSpec(attn=att, ffn="moe", cross_attn=att)
        return _apply_kv_heads(replace(
            cfg, pos_encoding=("learned" if version == "2.0" else "none"),
            moe=moe,
            encoder_layers=_shallow_deep(replace(shallow, cross_attn=None),
                                         replace(deep, cross_attn=None), n),
            decoder_layers=_shallow_deep(shallow, deep, n)))

    if version.startswith("3."):
        # V3: RMSNorm, RoPE, differential attention (everywhere for 3.1/3.2,
        # decoder-only for 3.0), balanced SharedMoE deep layers, pre-norm for
        # 3.2 (reference: model/video_music_transformer.py:655-730).
        vanilla = AttentionConfig(num_heads=cfg.num_heads, rope=True)
        diff = AttentionConfig(num_heads=cfg.num_heads, rope=True,
                               kind="differential", bias=False)
        moe = MoEConfig(expert="glu", shared_expert=True, balancing=True)
        pre_norm = version == "3.2"
        enc_att = vanilla if version == "3.0" else diff
        enc_shallow = LayerSpec(attn=enc_att, ffn="swiglu")
        enc_deep = LayerSpec(attn=enc_att, ffn="moe")
        dec_shallow = LayerSpec(attn=diff, ffn="swiglu", cross_attn=diff)
        dec_deep = LayerSpec(attn=diff, ffn="moe", cross_attn=diff)
        return _apply_kv_heads(replace(
            cfg, pos_encoding="none", norm="rmsnorm",
            pre_norm=pre_norm, moe=moe,
            encoder_layers=_shallow_deep(enc_shallow, enc_deep, n),
            decoder_layers=_shallow_deep(dec_shallow, dec_deep, n)))

    raise ValueError(f"unknown AMT version: {version!r}")


@dataclass(frozen=True)
class MusicTransformerConfig:
    """No-video baseline: encoder-only RPR model over chord tokens
    (reference: model/music_transformer.py:13-171)."""

    n_layers: int = 6
    num_heads: int = 8
    d_model: int = 512
    d_ff: int = 1024
    dropout: float = 0.1
    max_seq_chord: int = C.MAX_SEQ_CHORD
    rpr: bool = True


@dataclass(frozen=True)
class MambaBackboneConfig:
    """Mamba SSM hyperparameters (reference: model/mamba.py:36-75)."""

    d_model: int = 64
    n_layers: int = 2
    d_state: int = 16
    expand_factor: int = 2
    d_conv: int = 4
    dt_rank: Optional[int] = None  # None = ceil(d_model / 16)
    dt_min: float = 0.001
    dt_max: float = 0.1
    dropout: float = 0.0
    rms_norm_eps: float = 1e-5
    bias: bool = False
    conv_bias: bool = True
    use_version: int = 0  # 0: mamba, 1: mamba+ (extra x*(1-sigmoid(z)) branch)

    @property
    def d_inner(self) -> int:
        return self.expand_factor * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank if self.dt_rank is not None else -(-self.d_model // 16)


@dataclass(frozen=True)
class RegressionConfig:
    """VideoRegression: video features -> (note density, loudness) + 40-way
    instrument classifier (reference: model/video_regression.py:104-245)."""

    reg_model: str = "bilstm"  # backbone registry key
    n_layers: int = 2
    d_model: int = 64
    d_hidden: int = 1024
    dropout: float = 0.1
    total_vf_dim: int = 774  # 768 semantic + 6 emotion
    max_seq_video: int = C.MAX_SEQ_VIDEO
    use_kan: bool = False

    BIDIRECTIONAL_RNNS = ("bilstm", "bigru", "cnnbigru")


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (reference: train.py:216-266)."""

    batch_size: int = 32
    epochs: int = 50
    lr: Optional[float] = None  # None = Noam schedule
    ce_smoothing: Optional[float] = 0.1
    optimizer: str = "adamw"  # adam|adamw|radam|radamw|radanw|lion
    auxiliary_loss: bool = False  # add TopK auxiliary losses (train.py:222-229)
    loss_lambda: float = C.LOSS_LAMBDA
    warmup_steps: int = C.SCHEDULER_WARMUP_STEPS
    weight_decay: float = 0.01
    seed: int = 0
    # Mesh axis sizes; data-parallel x model-parallel (1,1 = single chip).
    mesh_shape: Tuple[int, int] = (1, 1)
    # bf16 forward/backward with f32 master weights + f32 optimizer state
    # (losses already reduce in f32). The reference trains pure f32.
    mixed_precision: bool = False
