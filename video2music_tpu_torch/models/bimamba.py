"""Bi-Mamba+ encoder (counterpart of models/bimamba.py:
BiMambaEncoderLayerV1 and BiMambaEncoder), post-norm:

    x_f = norm1(fwd(x) + x)
    x_b = norm2(flip(bwd(flip(x))) + x)
    x   = norm3(ffn(x_f + x_b) + (x_f + x_b))

The LayerNorms use flax's default eps 1e-6. The pre-norm (norm_first) and
MoE-FFN forms, and the v0 BiMambaEncoderLayer, are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..core.config import MambaBackboneConfig

from ..ops.norms import LayerNorm
from .mamba import MambaBlock

FLAX_LN_EPS = 1e-6


class ReluFFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x):
        return self.linear2(F.relu(self.linear1(x)))


class BiMambaEncoderLayerV1(nn.Module):
    def __init__(self, cfg: MambaBackboneConfig, d_ff: int):
        super().__init__()
        self.mamba_forward = MambaBlock(cfg)
        self.mamba_backward = MambaBlock(cfg)
        self.ffn = ReluFFN(cfg.d_model, d_ff)
        self.norm1 = LayerNorm(cfg.d_model, FLAX_LN_EPS)
        self.norm2 = LayerNorm(cfg.d_model, FLAX_LN_EPS)
        self.norm3 = LayerNorm(cfg.d_model, FLAX_LN_EPS)

    def forward(self, x):
        x_f = self.norm1(self.mamba_forward(x) + x)
        x_b = self.mamba_backward(torch.flip(x, dims=[1]))
        x_b = self.norm2(torch.flip(x_b, dims=[1]) + x)
        x = x_f + x_b
        return self.norm3(self.ffn(x) + x)


class BiMambaEncoder(nn.Module):
    def __init__(self, cfg: MambaBackboneConfig, d_ff: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            BiMambaEncoderLayerV1(cfg, d_ff) for _ in range(n_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x
