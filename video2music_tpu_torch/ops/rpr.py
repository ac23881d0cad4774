"""Relative position representation (RPR) bias, Shaw et al. attention as
Huang et al. apply it (counterpart of ops/rpr.py). With Er of shape
(er_len, head_dim), query position l attending key position j <= l gets

    bias[l, j] = q[l] . Er[er_len - 1 - (l - j)]

and zero for j > l. The JAX package realises the full form with the pad /
reshape "skew" of q @ Er^T; here both forms index q @ Er^T directly.
"""

from __future__ import annotations

import torch


def rpr_bias_full(q: torch.Tensor, er: torch.Tensor) -> torch.Tensor:
    """(..., L, D) queries + (er_len, D) Er -> (..., L, L) additive bias,
    from the last L rows of Er (L <= er_len)."""
    L, er_len = q.shape[-2], er.shape[0]
    if L > er_len:
        raise ValueError(f"RPR over {L} queries needs er_len >= {L}, "
                         f"got {er_len}")
    qe = torch.einsum("...ld,md->...lm", q, er)          # (..., L, er_len)
    rows = torch.arange(L, device=q.device)[:, None]
    cols = torch.arange(L, device=q.device)[None, :]
    idx = (er_len - 1 - (rows - cols)).clamp(max=er_len - 1)  # (L, L)
    bias = torch.gather(qe, -1, idx.expand(*qe.shape[:-1], L))
    return bias.masked_fill(cols > rows, 0.0)


def rpr_bias_decode(q: torch.Tensor, er: torch.Tensor, pos: int,
                    kv_len: int) -> torch.Tensor:
    """(..., 1, D) query at absolute position ``pos`` -> (..., 1, kv_len)
    bias: slot j gets q . Er[er_len - 1 - (pos - j)] for 0 <= pos - j <
    er_len and zero elsewhere."""
    er_len = er.shape[0]
    qr = torch.einsum("...ld,md->...lm", q, er)          # (..., 1, er_len)
    j = torch.arange(kv_len, device=q.device)
    idx = er_len - 1 - pos + j
    valid = (idx >= 0) & (idx < er_len)
    bias = qr[..., idx.clamp(0, er_len - 1)]
    return bias.masked_fill(~valid, 0.0)
