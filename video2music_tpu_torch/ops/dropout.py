"""flax ``nn.Dropout`` of a training call, drawn from a torch.Generator
(shared by the attention, feed-forward, MoE, position and residual
dropouts of the port's layers)."""

from __future__ import annotations

import torch


def dropout(x, rate: float, generator):
    """Keep each entry with probability 1 - rate (a uniform draw from
    ``generator`` below it), kept entries divided by 1 - rate in x's dtype.
    The identity at eval (``generator`` None) or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
