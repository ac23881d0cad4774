"""LayerNorm and RMSNorm computed in float32 (counterpart of ops/norms.py:
``make_norm`` "layernorm", flax ``nn.LayerNorm(epsilon=1e-5)``, and
"rmsnorm", its ``RMSNorm(eps=1e-6)``)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

LN_EPS = 1e-5
RMS_EPS = 1e-6     # make_norm("rmsnorm")
SUBLN_EPS = 1e-5   # differential attention's per-head RMSNorm


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics; the output keeps the input dtype.
    ``eps`` defaults to the AMT's 1e-5 (flax's own default, used by the
    bimamba layers, is 1e-6)."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    """x * rsqrt(mean(x^2) + eps) * weight in f32 (the f32 result)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return y * weight.float()


class RMSNorm(nn.Module):
    """RMSNorm (weight only) with f32 statistics; the output keeps the
    input dtype."""

    def __init__(self, dim: int, eps: float = RMS_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps).to(x.dtype)


def make_norm(kind: str, dim: int) -> nn.Module:
    """"layernorm" | "rmsnorm", as the JAX package's factory."""
    if kind == "layernorm":
        return LayerNorm(dim)
    if kind == "rmsnorm":
        return RMSNorm(dim)
    raise ValueError(f"unknown norm kind: {kind!r}")
