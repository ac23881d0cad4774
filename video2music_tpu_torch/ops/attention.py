"""Multi-head attention (counterpart of ops/attention.py:MultiHeadAttention):
vanilla MHA with or without biases, RPR (the Shaw/Huang relative bias of
ops/rpr.py) and differential attention, each with optional pairwise RoPE
(RPR without it), and grouped-query attention.

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
K/V are kept as (B, S, width), heads concatenated along the width. Softmax
is f32 and masked logits are -1e9.

Differential attention (ops/attention.py:269-284): 2H query/key heads
against H value heads (K is 2D wide, V D wide); query heads 2h and 2h + 1
both read value head h, so the full mode runs :func:`flash_attention` at 2H
heads with V repeated per pair; the outputs combine as
out_2h - lambda * out_2h+1, then the per-head ``subln`` RMSNorm (eps 1e-5)
and the (1 - lambda_init) scale.

RPR (``kind="rpr"``, ops/attention.py:236-243): the learned ``Er``
(er_len, head_dim) table gives the bias q_scaled . Er[er_len - 1 - (l -
j)], added to the scaled logits; the full mode hands it to
:func:`flash_attention` with the causal mask, as the JAX module hands it
to the Pallas kernel (its ``mask`` is None in the full mode), and the step
mode adds the row at ``pos`` on the plain path.

Grouped-query attention (``kv_heads`` < num_heads, :159-176, :286-289):
k and v project to kv_heads heads (2 kv_heads for k of differential
attention), so ``in_proj`` holds q | k | v rows of widths qk_dim | k_dim |
v_dim; each group of consecutive query heads reads one K/V head (K and V
repeated over the group before the attention); the ``gqa_norm``
LayerNorm (eps 1e-6, over the head dim) runs before ``out_proj``. Caches
are k_dim / v_dim wide.

A training call of any kind goes through :func:`flash_attention_dropout`
at the heads the attention runs at: 2H for differential attention (v
repeated per pair, the mask hashed per 2H head as the JAX kernel hashes
it), the full (B, H, L, L) bias for RPR, whose gradient reaches ``Er``
through the kernel's dbias.

Tensor parallelism by whole heads (parallel/shard.py sets ``tp``, the
model group, and cuts the weights): ``in_proj`` keeps this rank's rows of
each of its q / k / v blocks (column-parallel), ``out_proj`` its input
columns (row-parallel); the inputs enter through *f*, the partial output
leaves through *g* (or a reduce-scatter along a sequence-sharded stream)
and the ``out_proj`` bias is added once, after it. The kernels run at the
local heads with the shard's mask origin (batch and head offsets), so the
dropout mask is the unsharded call's. The replicated parameters used per
head (``Er``, the lambdas, ``subln``, ``gqa_norm``) enter through *f* too,
so their gradients sum the ranks' heads.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..core.config import AttentionConfig

from ..parallel.comm import (copy_to, enter, reduce_out, summed_call,
                             whole_out)
from .dropout import batch_span
from .embeddings import apply_rope
from .flash_attention import NEG_INF, flash_attention
from .flash_attention_dropout import flash_attention_dropout
from .norms import SUBLN_EPS, LayerNorm, RMSNorm
from .rpr import rpr_bias_decode, rpr_bias_full

GQA_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


def dot_product_attention(q, k, v, *, bias=None, mask=None):
    """q (B, H, L, d), k/v (B, H, S, d); bias added to the scaled logits;
    mask True = may attend."""
    logits = torch.einsum("bhld,bhsd->bhls", q.float(), k.float())
    logits = logits * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhls,bhsd->bhld", w, v)


def lambda_init_fn(depth: int) -> float:
    """DIFF-Transformer lambda schedule (the JAX package's
    ops/attention.py:lambda_init_fn)."""
    return 0.8 - 0.6 * math.exp(-0.3 * depth)


class MultiHeadAttention(nn.Module):
    """``in_proj`` holds the q | k | v rows (qk_dim + k_dim + v_dim, D),
    where qk_dim is D, or 2D for differential attention, and k_dim / v_dim
    are the same for kv_heads heads; ``out_proj`` (D, D). Both carry biases
    when ``cfg.bias``. Differential attention adds ``lambda_q1/k1/q2/k2``
    (head_dim,) and ``subln`` (an RMSNorm over the head dim); ``depth``
    (the layer index) sets its lambda_init. RPR adds ``Er`` (er_len,
    head_dim), grouped-query attention ``gqa_norm``."""

    def __init__(self, cfg: AttentionConfig, d_model: int, *,
                 is_cross: bool = False, max_cache_len: int = 300,
                 max_query_len: int = 0, dropout_rate: float = 0.0,
                 depth: int = 0):
        super().__init__()
        if cfg.kind not in ("vanilla", "rpr", "differential"):
            raise ValueError(f"unknown attention kind {cfg.kind!r}")
        self.num_heads = cfg.num_heads
        self.head_dim = hd = d_model // cfg.num_heads
        self.diff = cfg.kind == "differential"
        self.rpr = cfg.kind == "rpr"
        self.kv_heads = cfg.kv_heads or cfg.num_heads
        if cfg.num_heads % self.kv_heads:
            raise ValueError(f"kv_heads {self.kv_heads} must divide "
                             f"num_heads {cfg.num_heads}")
        self.qk_heads = 2 * cfg.num_heads if self.diff else cfg.num_heads
        self.k_heads = 2 * self.kv_heads if self.diff else self.kv_heads
        self.qk_dim = self.qk_heads * hd
        self.k_dim, self.v_dim = self.k_heads * hd, self.kv_heads * hd
        self.rope = cfg.rope
        self.d_model = d_model
        self.is_cross = is_cross
        self.dropout_rate = dropout_rate
        self.max_cache_len = max_cache_len
        # RoPE table length for query positions (chord positions for the
        # cross-attention, whose K/V are memory rows); values per position
        # do not depend on the table length
        self.max_query_len = max(max_cache_len, max_query_len)
        self.in_proj = nn.Linear(d_model,
                                 self.qk_dim + self.k_dim + self.v_dim,
                                 bias=cfg.bias)
        self.out_proj = nn.Linear(d_model, d_model, bias=cfg.bias)
        if self.rpr:
            self.Er = nn.Parameter(torch.zeros(cfg.er_len, hd))
        if self.kv_heads != cfg.num_heads:
            self.gqa_norm = LayerNorm(hd, GQA_NORM_EPS)
        else:
            self.gqa_norm = None
        if self.diff:
            hd = self.head_dim
            self.lambda_q1, self.lambda_k1, self.lambda_q2, self.lambda_k2 = (
                nn.Parameter(torch.zeros(hd)) for _ in range(4))
            self.subln = RMSNorm(hd, eps=SUBLN_EPS)
            self.lambda_init = lambda_init_fn(depth)
        # tensor parallelism (parallel/shard.py): the model group and the
        # first local query head in the global grid; the mesh (batch shard)
        self.tp = None
        self.head0 = 0
        self.qk_heads_global = self.qk_heads
        self.mesh = None

    def diff_lambda(self) -> torch.Tensor:
        """The learned scalar lambda, in the parameters' dtype."""
        q1, k1, q2, k2 = (copy_to(p, self.tp) for p in (
            self.lambda_q1, self.lambda_k1, self.lambda_q2, self.lambda_k2))
        return (torch.exp((q1 * k1).sum()) - torch.exp((q2 * k2).sum())
                + self.lambda_init)

    def _drop_origin(self, B: int):
        """The kernel's (b0, h0, global heads) of this shard, or None."""
        if self.mesh is None:
            return None
        return batch_span(self, B)[0], self.head0, self.qk_heads_global

    def _out(self, h, seq=None):
        """out_proj; under TP the row-parallel product summed over the
        model group (reduce-scattered when ``seq``), then the bias."""
        if self.tp is None:
            return whole_out(self.out_proj(h), seq)
        return reduce_out(F.linear(h, self.out_proj.weight), self.tp, seq,
                          self.out_proj.bias)

    def _heads(self, x, n):  # (B, L, n * hd) -> (B, n, L, hd)
        B, L, _ = x.shape
        return x.view(B, L, n, -1).transpose(1, 2)

    def _merge(self, x):  # (B, n, L, hd) -> (B, L, n * hd)
        B, n, L, hd = x.shape
        return x.transpose(1, 2).reshape(B, L, n * hd)

    def _proj(self, x, part: int):
        lo = (0, self.qk_dim, self.qk_dim + self.k_dim)[part]
        hi = lo + (self.qk_dim, self.k_dim, self.v_dim)[part]
        bias = self.in_proj.bias
        return F.linear(x, self.in_proj.weight[lo:hi],
                        None if bias is None else bias[lo:hi])

    def _rope(self, x, positions, max_len):  # x (B, L, n * hd)
        if not self.rope:
            return x
        n = x.shape[-1] // self.head_dim
        return self._merge(apply_rope(self._heads(x, n),
                                      positions=positions, max_len=max_len))

    def _attend(self, q, k, v, **kw):
        """q (B, L, qk_dim), k (B, S, k_dim), v (B, S, v_dim) -> (B, L, D):
        attention over the heads (K / V heads repeated over their groups of
        query heads), the differential pair combine and subln, gqa_norm,
        then out_proj. ``kw``: ``mask`` and ``pos`` for the cached step,
        else the full-mode ``causal`` / ``generator``."""
        q, k, v = (self._heads(t, n).contiguous() for t, n in (
            (q, self.qk_heads), (k, self.k_heads), (v, self.kv_heads)))
        if self.k_heads != self.qk_heads:
            k = k.repeat_interleave(self.qk_heads // self.k_heads, dim=1)
        if self.kv_heads != self.qk_heads:
            v = v.repeat_interleave(self.qk_heads // self.kv_heads, dim=1)
        bias = None
        if self.rpr:
            q_scaled = q * self.head_dim ** -0.5
            er = copy_to(self.Er, self.tp).to(q.dtype)
            bias = (rpr_bias_full(q_scaled, er) if "mask" not in kw else
                    rpr_bias_decode(q_scaled, er, kw["pos"], k.shape[2]))
        if "mask" in kw:
            attn = dot_product_attention(q, k, v, bias=bias, mask=kw["mask"])
        elif kw["generator"] is not None and self.dropout_rate > 0.0:
            # the seed stays on the device: no host sync per call; a
            # differential layer runs the kernel at its 2H heads
            seed = torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=kw["generator"],
                                 device=q.device, dtype=torch.int32)
            attn = flash_attention_dropout(
                q, k, v, bias=bias, causal=kw["causal"],
                dropout_rate=self.dropout_rate, seed=seed,
                origin=self._drop_origin(q.shape[0]))
        else:
            attn = flash_attention(q, k, v, bias=bias, causal=kw["causal"])
        if self.diff:
            B, _, L, hd = attn.shape
            attn = attn.view(B, self.num_heads, 2, L, hd)
            lam = self.diff_lambda().to(attn.dtype)
            attn = summed_call(self.subln, self.tp,
                               attn[:, :, 0] - lam * attn[:, :, 1])
            attn = attn * (1.0 - self.lambda_init)
        if self.gqa_norm is not None:
            attn = summed_call(self.gqa_norm, self.tp, attn)
        return self._out(self._merge(attn), kw.get("seq"))

    def project_kv(self, x):
        """Memory / sequence -> (k roped at 0..L-1, v), (B, L, k_dim) and
        (B, L, v_dim)."""
        return (self._rope(self._proj(x, 1), None, self.max_cache_len),
                self._proj(x, 2))

    def forward(self, query, key_value=None, *, causal: bool = False,
                mode: str = "full", cache=None, pos: int = 0,
                generator=None, seq=None):
        """cache: "step" mode only — (k, v) tensors (B, S, k_dim) and
        (B, S, v_dim); written in place for self-attention, read for
        cross-attention. generator: a torch.Generator on the query's device
        makes a "full" call a training call (attention dropout at
        ``dropout_rate``). seq: the model group when the caller's stream
        is sharded by sequence (the query, this rank's shard, is gathered
        whole; the output leaves as this rank's shard)."""
        if mode == "prime":
            return self.project_kv(key_value)
        if mode == "full":
            query = enter(query, self.tp, seq)
            kv = copy_to(key_value, self.tp) if self.is_cross else query
            q = self._rope(self._proj(query, 0), None, self.max_query_len)
            k, v = self.project_kv(kv)
            return self._attend(q, k, v, causal=causal, generator=generator,
                                seq=seq)
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
        return self._attend(q, k_all, v_all, mask=mask, pos=pos)
