"""Mamba selective-state-space blocks (counterpart of models/mamba.py):
``MambaBlock``, the ``ResidualBlock`` x + block(RMSNorm(x)), the ``Mamba``
stack of them and ``MoEMamba`` (each layer a residual block, then an
RMSNorm'd residual MoE).

Kept as in the JAX block: depthwise causal conv1d of width d_conv (left pad
d_conv - 1), SiLU, x_proj into (delta, B, C), softplus(dt_proj(delta)),
A = -exp(A_log), the selective scan, and for mamba+ (use_version=1) the
output y * z + xb * (1 - sigmoid(z)) where z is ALREADY silu(z) — the
reference's quirk, kept. ``dt_proj`` holds the effective weight: the JAX
parameter is stored unshifted and shifted by -dt_rank**-0.5 at use
(weights.regression_from_jax applies the shift). With ``use_kan`` the
in / x / out projections are KANLinear layers (no bias). A training call
(a ``generator`` given) adds the block's output dropout at
``cfg.dropout`` and the MoE layers' dropouts.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..core.config import MambaBackboneConfig

from ..ops.dropout import dropout
from ..ops.kan import KANLinear
from ..ops.norms import RMSNorm
from ..ops.scan import selective_scan


class MambaBlock(nn.Module):
    def __init__(self, cfg: MambaBackboneConfig, use_kan: bool = False):
        super().__init__()
        self.cfg = cfg
        ED, R, N = cfg.d_inner, cfg.resolved_dt_rank, cfg.d_state
        if use_kan:
            self.in_proj = KANLinear(cfg.d_model, 2 * ED)
            self.x_proj = KANLinear(ED, R + 2 * N)
            self.out_proj = KANLinear(ED, cfg.d_model)
        else:
            self.in_proj = nn.Linear(cfg.d_model, 2 * ED, bias=cfg.bias)
            self.x_proj = nn.Linear(ED, R + 2 * N, bias=False)
            self.out_proj = nn.Linear(ED, cfg.d_model, bias=cfg.bias)
        self.conv = nn.Conv1d(ED, ED, cfg.d_conv, groups=ED,
                              bias=cfg.conv_bias)
        self.dt_proj = nn.Linear(R, ED)
        self.A_log = nn.Parameter(torch.zeros(ED, N))
        self.D = nn.Parameter(torch.ones(ED))

    def forward(self, x, generator=None):  # (B, L, d_model)
        cfg = self.cfg
        R, N = cfg.resolved_dt_rank, cfg.d_state
        xb, z = self.in_proj(x).chunk(2, dim=-1)
        xb = F.conv1d(F.pad(xb.transpose(1, 2), (cfg.d_conv - 1, 0)),
                      self.conv.weight, self.conv.bias,
                      groups=cfg.d_inner).transpose(1, 2)
        xb = F.silu(xb)
        delta, B, C = self.x_proj(xb).split([R, N, N], dim=-1)
        delta = F.softplus(self.dt_proj(delta))
        A = -torch.exp(self.A_log.float())
        y = selective_scan(xb.contiguous(), delta.contiguous(), A,
                           B.contiguous(), C.contiguous(), self.D)
        z = F.silu(z)
        if cfg.use_version == 1:  # mamba+
            out = y * z + xb * (1.0 - torch.sigmoid(z))
        else:
            out = y * z
        return dropout(self.out_proj(out), cfg.dropout, generator)


class ResidualBlock(nn.Module):
    """x + mixer(norm(x)), the RMSNorm at ``cfg.rms_norm_eps``."""

    def __init__(self, cfg: MambaBackboneConfig, use_kan: bool = False):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, cfg.rms_norm_eps)
        self.mixer = MambaBlock(cfg, use_kan)

    def forward(self, x, generator=None):
        return self.mixer(self.norm(x), generator) + x


class Mamba(nn.Module):
    """n_layers residual Mamba blocks (models/mamba.py:146-160)."""

    def __init__(self, cfg: MambaBackboneConfig, n_layers: int,
                 use_kan: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(ResidualBlock(cfg, use_kan)
                                    for _ in range(n_layers))

    def forward(self, x, generator=None):
        for layer in self.layers:
            x = layer(x, generator)
        return x


class MoEMamba(nn.Module):
    """Per layer a residual Mamba block, then moe(moe_norm(x)) + x
    (models/mamba.py:163-174); ``moe_maker()`` builds each MoE."""

    def __init__(self, cfg: MambaBackboneConfig, n_layers: int,
                 use_kan: bool, moe_maker):
        super().__init__()
        self.mamba = nn.ModuleList(ResidualBlock(cfg, use_kan)
                                   for _ in range(n_layers))
        self.moe_norm = nn.ModuleList(RMSNorm(cfg.d_model, cfg.rms_norm_eps)
                                      for _ in range(n_layers))
        self.moe = nn.ModuleList(moe_maker() for _ in range(n_layers))

    def forward(self, x, generator=None):
        for block, norm, moe in zip(self.mamba, self.moe_norm, self.moe):
            x = block(x, generator)
            x = moe(norm(x), generator) + x
        return x
