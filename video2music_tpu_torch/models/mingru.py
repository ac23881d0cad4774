"""minGRU ("Were RNNs All We Needed?") and the minGRULM stack (counterpart
of models/mingru.py).

Reference: model/minGRU.py (log-space Heinsen scan) and model/minGRULM.py
(RMSNorm + minGRU + FF blocks with an optional causal depthwise conv). The
parallel form runs :func:`..ops.scan.heinsen_log_scan`, a cumsum and a
``torch.logcumsumexp``; no TPU kernel stands behind it. The log-space scan
runs in float32 and its output is cast back to the input's dtype, so a
bfloat16 model keeps a 300-step cumulative sum exact to f32. Flax's
``nn.gelu`` is the tanh approximation, and so is the port's.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.scan import heinsen_log_scan


def g(x):
    """minGRU positivity map (reference minGRU.py:20-21)."""
    return torch.where(x >= 0, x + 0.5, torch.sigmoid(x))


def log_g(x):
    """log of g in a numerically stable split (reference minGRU.py:23-24)."""
    return torch.where(x >= 0, torch.log(F.relu(x) + 0.5), -F.softplus(-x))


class MinGRU(nn.Module):
    def __init__(self, dim: int, expansion_factor: float = 1.0):
        super().__init__()
        dim_inner = int(dim * expansion_factor)
        self.to_hidden_and_gate = nn.Linear(dim, dim_inner * 2, bias=False)
        self.to_out = (nn.Linear(dim_inner, dim, bias=False)
                       if expansion_factor != 1.0 else None)

    def forward(self, x, prev_hidden=None, return_next_hidden=False):
        hidden, gate = self.to_hidden_and_gate(x).float().chunk(2, dim=-1)
        log_coeffs = -F.softplus(gate)                     # log(1 - z)
        log_values = -F.softplus(-gate) + log_g(hidden)    # log z + log g(h)
        if prev_hidden is not None:
            log_values = torch.cat([torch.log(prev_hidden.float()),
                                    log_values], dim=1)
            log_coeffs = F.pad(log_coeffs, (0, 0, 1, 0))
        out = heinsen_log_scan(log_coeffs, log_values)[:, -x.shape[1]:]
        out = out.to(x.dtype)
        next_hidden = out[:, -1:]
        if self.to_out is not None:
            out = self.to_out(out)
        return (out, next_hidden) if return_next_hidden else out


class _LMRMSNorm(nn.Module):
    """minGRULM's norm: F.normalize * sqrt(d) * (gamma + 1), the 1e-12
    inside the rsqrt (reference minGRULM.py:16-23)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        normed = xf * torch.rsqrt(xf.square().sum(-1, keepdim=True) + 1e-12)
        return (normed * self.dim ** 0.5
                * (self.gamma.float() + 1.0)).to(x.dtype)


class CausalDepthwiseConv(nn.Module):
    """Depthwise conv over the past ``kernel_size`` steps (left padding),
    its bias, then a pointwise Dense."""

    def __init__(self, dim: int, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.depthwise = nn.Conv1d(dim, dim, kernel_size, groups=dim)
        self.pointwise = nn.Linear(dim, dim)

    def forward(self, x):                                  # (B, L, dim)
        h = F.pad(x.transpose(1, 2), (self.kernel_size - 1, 0))
        return self.pointwise(self.depthwise(h).transpose(1, 2))


class MinGRULM(nn.Module):
    """RMSNorm + minGRU + FF stack (reference: minGRULM.py:51-139);
    ``total_vf_dim`` is both the input and the logits width."""

    def __init__(self, total_vf_dim: int, dim: int, depth: int,
                 ff_mult: float = 4.0, min_gru_expansion: float = 1.5,
                 conv_kernel_size: int = 3, enable_conv: bool = False):
        super().__init__()
        self.in_proj = nn.Linear(total_vf_dim, dim)
        self.conv = nn.ModuleList(
            CausalDepthwiseConv(dim, conv_kernel_size)
            for _ in range(depth)) if enable_conv else None
        self.blocks = nn.ModuleList(
            _MinGRUBlock(dim, min_gru_expansion, int(dim * ff_mult))
            for _ in range(depth))
        self.final_norm = _LMRMSNorm(dim)
        self.to_logits = nn.Linear(dim, total_vf_dim, bias=False)

    def forward(self, x):
        x = self.in_proj(x)
        for i, block in enumerate(self.blocks):
            if self.conv is not None:
                x = self.conv[i](x) + x
            x = block(x)
        return self.to_logits(self.final_norm(x))


class _MinGRUBlock(nn.Module):
    """norm -> minGRU -> residual; ff_norm -> ff1 -> gelu (tanh) -> ff2 ->
    residual."""

    def __init__(self, dim: int, expansion: float, d_ff: int):
        super().__init__()
        self.norm = _LMRMSNorm(dim)
        self.mingru = MinGRU(dim, expansion)
        self.ff_norm = _LMRMSNorm(dim)
        self.ff1 = nn.Linear(dim, d_ff)
        self.ff2 = nn.Linear(d_ff, dim)

    def forward(self, x):
        x = self.mingru(self.norm(x)) + x
        h = F.gelu(self.ff1(self.ff_norm(x)), approximate="tanh")
        return self.ff2(h) + x
