"""Bidirectional Mamba encoders (counterpart of models/bimamba.py), both
post-norm, the LayerNorms at flax's default eps 1e-6:

  * ``BiMambaEncoderLayer`` (v0, the ``bimamba`` backbone): two branches,
    each with its own Add&Norm and ReLU FFN,
        x_f = norm2(ffn1(f) + f),      f = norm1(fwd(x) + x)
        x_b = norm4(ffn2(x_f) + b),    b = norm3(flip(bwd(flip(x))) + x)
        out = x_f + x_b
    where the backward branch's FFN reads the FORWARD branch's features,
    the reference's quirk that the JAX layer keeps by default;
  * ``BiMambaEncoderLayerV1`` (mamba+ blocks, the ``bimamba+`` and
    ``*moe_bimamba+`` backbones):
        x_f = norm1(fwd(x) + x)
        x_b = norm2(flip(bwd(flip(x))) + x)
        x   = norm3(ffn(x_f + x_b) + (x_f + x_b))
    with a ReLU FFN or, from ``moe_maker``, a MoE layer.
In a training call (a ``generator`` given) each sublayer output (Mamba
branch, FFN) takes a dropout at ``cfg.dropout`` before its residual add,
as the JAX layers' ``drop``, besides the Mamba blocks' and FFNs' own. The
pre-norm (norm_first) form is not ported: no backbone of the regression
uses it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import MambaBackboneConfig

from ..ops.dropout import dropout
from ..ops.norms import LayerNorm
from .layers import ReluFFN
from .mamba import MambaBlock

FLAX_LN_EPS = 1e-6


def _norms(n: int, d_model: int) -> list:
    return [LayerNorm(d_model, FLAX_LN_EPS) for _ in range(n)]


def _flip(x):
    return torch.flip(x, dims=[1])


class BiMambaEncoderLayer(nn.Module):
    def __init__(self, cfg: MambaBackboneConfig, d_ff: int):
        super().__init__()
        self.rate = cfg.dropout
        self.mamba_forward = MambaBlock(cfg)
        self.mamba_backward = MambaBlock(cfg)
        self.ffn1 = ReluFFN(cfg.d_model, d_ff, cfg.dropout)
        self.ffn2 = ReluFFN(cfg.d_model, d_ff, cfg.dropout)
        self.norm1, self.norm2, self.norm3, self.norm4 = _norms(
            4, cfg.d_model)

    def forward(self, x, generator=None):
        g = generator
        d = lambda h: dropout(h, self.rate, g)
        x_f = self.norm1(d(self.mamba_forward(x, g)) + x)
        x_f = self.norm2(d(self.ffn1(x_f, g)) + x_f)
        x_b = self.norm3(d(_flip(self.mamba_backward(_flip(x), g))) + x)
        x_b = self.norm4(d(self.ffn2(x_f, g)) + x_b)
        return x_f + x_b


class BiMambaEncoderLayerV1(nn.Module):
    def __init__(self, cfg: MambaBackboneConfig, d_ff: int, moe_maker=None):
        super().__init__()
        self.rate = cfg.dropout
        self.mamba_forward = MambaBlock(cfg)
        self.mamba_backward = MambaBlock(cfg)
        self.ffn = moe_maker() if moe_maker else ReluFFN(cfg.d_model, d_ff,
                                                         cfg.dropout)
        self.norm1, self.norm2, self.norm3 = _norms(3, cfg.d_model)

    def forward(self, x, generator=None):
        g = generator
        d = lambda h: dropout(h, self.rate, g)
        x_f = self.norm1(d(self.mamba_forward(x, g)) + x)
        x_b = self.norm2(d(_flip(self.mamba_backward(_flip(x), g))) + x)
        x = x_f + x_b
        return self.norm3(d(self.ffn(x, g)) + x)


class BiMambaEncoder(nn.Module):
    """n_layers v0 layers (``cfg.use_version`` 0) or V1 layers."""

    def __init__(self, cfg: MambaBackboneConfig, d_ff: int, n_layers: int,
                 moe_maker=None):
        super().__init__()
        if cfg.use_version == 0:
            make = lambda: BiMambaEncoderLayer(cfg, d_ff)
        else:
            make = lambda: BiMambaEncoderLayerV1(cfg, d_ff, moe_maker)
        self.layers = nn.ModuleList(make() for _ in range(n_layers))

    def forward(self, x, generator=None):
        for layer in self.layers:
            x = layer(x, generator)
        return x
