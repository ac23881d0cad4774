"""Rotary position embedding, pairwise (counterpart of ops/embeddings.py
``rope_cache`` / ``apply_rope``).

The pairing is the torchtune one the JAX package uses: the head dim is
viewed as consecutive pairs (x0, x1) and each pair is rotated by
position * theta_j, i.e. (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin).
It is NOT the rotate-half convention.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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
