"""Multi-head attention for the AMT 2.2 wiring (counterpart of
ops/attention.py:MultiHeadAttention): vanilla MHA with biases and optional
pairwise RoPE.

Modes, as in the JAX module:
  * "full": dense attention over the sequence (encoder; the decoder's full
    forward with ``causal``) through :func:`flash_attention`, or, in a
    training forward (``generator`` given) with dropout, through
    :func:`flash_attention_dropout` with a seed drawn from the generator
    (ops/attention.py:82-96 of the JAX package);
  * "prime" (cross-attention): project encoder memory to K/V once;
  * "step": one query; self-attention writes its K/V at ``pos`` into the
    caller's cache (in place) and attends over rows <= pos, cross-attention
    reads the primed K/V.
K/V are kept as (B, S, D), heads concatenated along D. Softmax is f32 and
masked logits are -1e9. RPR, differential and grouped-query attention are
not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..core.config import AttentionConfig

from .embeddings import apply_rope
from .flash_attention import NEG_INF, flash_attention
from .flash_attention_dropout import flash_attention_dropout


def not_ported(what: str, queue_item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to video2music_tpu_torch yet "
        f"(ROADMAP.md, {queue_item})")


def dot_product_attention(q, k, v, *, mask=None):
    """q (B, H, L, d), k/v (B, H, S, d); mask True = may attend."""
    logits = torch.einsum("bhld,bhsd->bhls", q.float(), k.float())
    logits = logits * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhls,bhsd->bhld", w, v)


class MultiHeadAttention(nn.Module):
    """``in_proj`` holds the q | k | v rows (3D, D); ``out_proj`` (D, D)."""

    def __init__(self, cfg: AttentionConfig, d_model: int, *,
                 is_cross: bool = False, max_cache_len: int = 300,
                 max_query_len: int = 0, dropout_rate: float = 0.0):
        super().__init__()
        if cfg.kind != "vanilla":
            raise not_ported(f"{cfg.kind!r} attention",
                             "Queue 1, variant wirings")
        if cfg.kv_heads not in (None, cfg.num_heads) or not cfg.bias:
            raise not_ported("grouped-query / bias-free attention",
                             "Queue 1, variant wirings")
        self.num_heads = cfg.num_heads
        self.rope = cfg.rope
        self.d_model = d_model
        self.is_cross = is_cross
        self.dropout_rate = dropout_rate
        self.max_cache_len = max_cache_len
        # RoPE table length for query positions (chord positions for the
        # cross-attention, whose K/V are memory rows); values per position
        # do not depend on the table length
        self.max_query_len = max(max_cache_len, max_query_len)
        self.in_proj = nn.Linear(d_model, 3 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def _heads(self, x):  # (B, L, D) -> (B, H, L, hd)
        B, L, _ = x.shape
        return x.view(B, L, self.num_heads, -1).transpose(1, 2)

    def _merge(self, x):  # (B, H, L, hd) -> (B, L, D)
        B, H, L, hd = x.shape
        return x.transpose(1, 2).reshape(B, L, H * hd)

    def _proj(self, x, part: int):
        D = self.d_model
        return F.linear(x, self.in_proj.weight[part * D:(part + 1) * D],
                        self.in_proj.bias[part * D:(part + 1) * D])

    def _rope(self, x, positions, max_len):  # x (B, L, D)
        if not self.rope:
            return x
        return self._merge(apply_rope(self._heads(x), positions=positions,
                                      max_len=max_len))

    def project_kv(self, x):
        """Memory / sequence -> (k roped at 0..L-1, v), each (B, L, D)."""
        return (self._rope(self._proj(x, 1), None, self.max_cache_len),
                self._proj(x, 2))

    def forward(self, query, key_value=None, *, causal: bool = False,
                mode: str = "full", cache=None, pos: int = 0,
                generator=None):
        """cache: "step" mode only — (k, v) tensors (B, S, D); written in
        place for self-attention, read for cross-attention. generator: a
        torch.Generator on the query's device makes a "full" call a
        training call (attention dropout at ``dropout_rate``)."""
        if mode == "prime":
            return self.project_kv(key_value)
        if mode == "full":
            q = self._rope(self._proj(query, 0), None, self.max_query_len)
            k, v = self.project_kv(key_value if self.is_cross else query)
            q, k, v = (self._heads(t).contiguous() for t in (q, k, v))
            if generator is not None and self.dropout_rate > 0.0:
                # the seed stays on the device: no host sync per call
                seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=query.device, dtype=torch.int32)
                attn = flash_attention_dropout(
                    q, k, v, causal=causal, dropout_rate=self.dropout_rate,
                    seed=seed)
            else:
                attn = flash_attention(q, k, v, causal=causal)
            return self.out_proj(self._merge(attn))
        if mode != "step":
            raise ValueError(f"unknown attention mode {mode!r}")
        positions = torch.tensor([pos], device=query.device)
        q = self._rope(self._proj(query, 0), positions, self.max_query_len)
        k_all, v_all = cache
        mask = None
        if not self.is_cross:
            k_new = self._rope(self._proj(query, 1), positions,
                               self.max_cache_len)
            k_all[:, pos] = k_new[:, 0].to(k_all.dtype)
            v_all[:, pos] = self._proj(query, 2)[:, 0].to(v_all.dtype)
            mask = (torch.arange(k_all.shape[1], device=query.device)
                    <= pos)[None, None, None, :]
        attn = dot_product_attention(self._heads(q), self._heads(k_all),
                                     self._heads(v_all), mask=mask)
        return self.out_proj(self._merge(attn))
