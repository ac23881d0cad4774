"""Positional information (counterpart of ops/embeddings.py): the
sinusoidal table and ``SinusoidalPE`` (base AMT), the learned
``LearnedPE`` table (V1, V2.0), and the pairwise rotary embedding
(``rope_cache`` / ``apply_rope``, V2.1+ and V3).

The pairing is the torchtune one the JAX package uses: the head dim is
viewed as consecutive pairs (x0, x1) and each pair is rotated by
position * theta_j, i.e. (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin).
It is NOT the rotate-half convention.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from .dropout import dropout


@functools.lru_cache(maxsize=None)
def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) float32 sin/cos table (Vaswani et al.), the JAX
    package's ``sinusoidal_table``."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class SinusoidalPE(nn.Module):
    """x + table[:L] in x's dtype, then the embedding dropout in a training
    call (``generator`` given). No parameters."""

    def __init__(self, d_model: int, max_len: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model, self.max_len = d_model, max_len
        self.dropout_rate = dropout_rate

    def row(self, pos: int, device) -> torch.Tensor:
        """The table's row at ``pos``, float32 (D,)."""
        table = sinusoidal_table(self.max_len, self.d_model)
        return torch.from_numpy(table[pos]).to(device)

    def forward(self, x, generator=None):
        table = sinusoidal_table(self.max_len, self.d_model)[:x.shape[-2]]
        x = x + torch.from_numpy(table).to(device=x.device, dtype=x.dtype)
        return dropout(x, self.dropout_rate, generator)


class LearnedPE(nn.Module):
    """Learned absolute positions ``embedding`` (max_len, D) added to x;
    ``position`` selects one row for the cached decode step (x of length
    1)."""

    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(max_len, d_model))

    def row(self, pos: int, device=None) -> torch.Tensor:
        return self.embedding[pos]

    def forward(self, x, position=None):
        if position is None:
            return x + self.embedding[:x.shape[-2]].to(x.dtype)
        return x + self.embedding[position].to(x.dtype)


@functools.lru_cache(maxsize=None)
def rope_cache(max_len: int, head_dim: int, base: float = 10000.0) -> np.ndarray:
    """(max_len, head_dim/2, 2) float32 cos/sin cache (torchtune layout)."""
    theta = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    idx_theta = np.arange(max_len, dtype=np.float32)[:, None] * theta[None, :]
    return np.stack([np.cos(idx_theta), np.sin(idx_theta)], axis=-1)


def rope_table(max_len: int, head_dim: int, device) -> torch.Tensor:
    """:func:`rope_cache` as a float32 tensor on ``device``."""
    return torch.from_numpy(rope_cache(max_len, head_dim)).to(device)


def apply_rope(x: torch.Tensor, positions=None, max_len: int = 4096):
    """Rotate x (..., L, D) along its sequence axis -2 (head dim last).

    positions: optional int tensor broadcastable to (..., L) of absolute
    positions (the cached decode path); defaults to 0..L-1. Math in f32,
    result in x's dtype.
    """
    head_dim, seq_len = x.shape[-1], x.shape[-2]
    cache = rope_table(max_len, head_dim, x.device)
    cs = cache[:seq_len] if positions is None else cache[positions]
    xs = x.float().reshape(*x.shape[:-1], head_dim // 2, 2)
    cos, sin = cs[..., 0], cs[..., 1]
    x0, x1 = xs[..., 0], xs[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
