"""KANLinear, the Kolmogorov-Arnold layer of the V2.3 MoE experts and the
``use_kan`` Mamba projections (counterpart of ops/kan.py): ``silu(x) @
base_weight + B(x) @ spline_weight``, where B(x) are the Cox-de Boor
B-spline bases of order ``spline_order`` on the fixed uniform grid over
``grid_range`` extended by ``spline_order`` knots on each side. The
parameters keep the JAX layout: ``base_weight`` (in, out) and
``spline_weight`` (in, grid_size + spline_order, out). The bases and both
products are computed in float32; the output takes x's dtype.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


class KANLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 grid_size: int = 5, spline_order: int = 3,
                 grid_range=(-1.0, 1.0)):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.grid_size, self.spline_order = grid_size, spline_order
        lo, hi = grid_range
        h = (hi - lo) / grid_size
        knots = np.arange(-spline_order, grid_size + spline_order + 1) * h \
            + lo
        self.register_buffer("grid", torch.from_numpy(
            knots.astype(np.float32)), persistent=False)
        self.base_weight = nn.Parameter(torch.zeros(in_features,
                                                    out_features))
        self.spline_weight = nn.Parameter(torch.zeros(
            in_features, grid_size + spline_order, out_features))

    def b_splines(self, x):
        """x (..., in) -> bases (..., in, grid_size + spline_order), f32."""
        grid = self.grid
        x = x.float()[..., None]
        bases = ((x >= grid[:-1]) & (x < grid[1:])).float()
        for k in range(1, self.spline_order + 1):
            left = (x - grid[:-(k + 1)]) / (grid[k:-1] - grid[:-(k + 1)])
            right = (grid[k + 1:] - x) / (grid[k + 1:] - grid[1:-k])
            bases = left * bases[..., :-1] + right * bases[..., 1:]
        return bases

    def forward(self, x):
        base = F.silu(x.float()) @ self.base_weight.float()
        spline = torch.einsum("...ik,iko->...o", self.b_splines(x),
                              self.spline_weight.float())
        return (base + spline).to(x.dtype)
