"""LayerNorm computed in float32 (counterpart of ops/norms.py's make_norm
"layernorm": flax ``nn.LayerNorm(epsilon=1e-5)``)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

LN_EPS = 1e-5


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
