"""flax ``nn.Dropout`` of a training call, drawn from a torch.Generator
(shared by the attention, feed-forward, MoE, position and residual
dropouts of the port's layers).

A shard of a sharded training step (parallel/) holds a slice of the
tensor the unsharded step drops: some of its batch rows, sequence
positions, feed-forward columns or experts. It passes ``origin``, each
dimension's (offset, global size), draws the whole tensor's uniforms from
its generator (which every rank advances in lock-step) and keeps its
slice, so its mask is the unsharded step's, sliced."""

from __future__ import annotations

import torch


def dropout(x, rate: float, generator, origin=None):
    """Keep each entry with probability 1 - rate (a uniform draw from
    ``generator`` below it), kept entries divided by 1 - rate in x's dtype.
    The identity at eval (``generator`` None) or at rate 0. ``origin``:
    per dimension of x its (offset, global size), or None (x is whole)."""
    if generator is None or rate == 0.0:
        return x
    keep = keep_mask(x.shape, rate, generator, x.device, origin)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def keep_mask(shape, rate: float, generator, device, origin=None):
    """The boolean keep mask of :func:`dropout` for a tensor of ``shape``
    (its slice at ``origin`` of the whole tensor's draw)."""
    if origin is None:
        return torch.rand(shape, generator=generator, device=device) \
            < 1.0 - rate
    u = torch.rand(tuple(g for _, g in origin), generator=generator,
                   device=device)
    u = u[tuple(slice(o, o + n) for (o, _), n in zip(origin, shape))]
    return u < 1.0 - rate


def batch_span(module, B: int):
    """(first row, global rows) of a batch of ``B`` rows in ``module``'s
    call: its mesh's data shard, or (0, B) unsharded."""
    mesh = getattr(module, "mesh", None)
    if mesh is None:
        return 0, B
    return mesh.data.rank * B, mesh.data.size * B
