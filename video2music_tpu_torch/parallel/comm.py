"""The collectives of the port's sharded training, written out (in the JAX
package GSPMD inserts them from the placement of parallel/mesh.py).

Differentiable, as ``torch.autograd.Function``s over one group:
  * Megatron's *f* (:func:`copy_to`): identity forward, all-reduce backward,
    at the entrance of a region whose ranks each compute part of the
    result (heads, feed-forward columns, experts), so the input's gradient
    sums their parts;
  * Megatron's *g* (:func:`reduce_from`): all-reduce forward, identity
    backward, at the exit of such a region (and over "data" for the sums of
    a loss, whose gradient each rank then holds its part of);
  * along the sequence (sequence parallelism): :func:`gather_seq`
    (all-gather forward; backward, this rank's slice of a gradient every
    rank holds whole, or with ``summed`` the reduce-scatter of one whose
    ranks each hold a part: the gather and *f* in one collective, as
    Megatron's sequence-parallel entrance), :func:`split_seq` (this rank's
    slice forward, all-gather backward) and :func:`reduce_scatter_seq`
    (reduce-scatter forward, all-gather backward: *g* and the split in
    one collective);
  * :func:`enter`, a region's entrance: *f* on a whole stream, the summed
    gather on a sequence shard.

Not differentiable: :func:`all_reduce` (counts, metrics),
:func:`all_reduce_coalesced` (the gradients over "data", one flat buffer
per dtype), :func:`all_gather` (checkpoints) and :func:`broadcast`.

A group of one is the identity everywhere. Under a "gloo" group a CUDA
tensor goes through host memory: the group's backend decides it.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """One axis group of a rank: the process group (None for a group of
    one), this rank's index in it, its size, its members' global ranks in
    group order, and the world's backend."""
    pg: Optional[object]
    rank: int
    size: int
    ranks: tuple
    backend: str

    def global_rank(self, index: int) -> int:
        return self.ranks[index]


def _host(t: torch.Tensor, group: Group):
    """(tensor the backend takes, whether it was copied to the host)."""
    if group.backend == "gloo" and t.is_cuda:
        return t.detach().cpu(), True
    return t.detach().contiguous(), False


def all_reduce(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``t`` over the group (a new tensor)."""
    if group.size == 1:
        return t
    buf, moved = _host(t, group)
    if not moved:
        buf = buf.clone()
    dist.all_reduce(buf, group=group.pg)
    return buf.to(t.device) if moved else buf


def all_reduce_coalesced(tensors: Sequence[torch.Tensor],
                         group: Group) -> List[torch.Tensor]:
    """Each tensor's sum over the group, through one flat buffer per
    dtype."""
    if group.size == 1:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]),
                          group)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view_as(tensors[i])
            at += n
    return out


def all_gather(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in group order."""
    if group.size == 1:
        return t
    x = t.movedim(dim, 0)
    buf, moved = _host(x, group)
    out = buf.new_empty((group.size * buf.shape[0],) + tuple(buf.shape[1:]))
    with warnings.catch_warnings():  # renamed in newer torch; both take it
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, buf.contiguous(), group=group.pg)
    out = out.movedim(0, dim)
    return out.to(t.device) if moved else out


def reduce_scatter(t: torch.Tensor, group: Group, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the group's sum."""
    if group.size == 1:
        return t
    x = t.movedim(dim, 0)
    buf, moved = _host(x, group)
    out = buf.new_empty((buf.shape[0] // group.size,) + tuple(buf.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, buf.contiguous(), group=group.pg)
    out = out.movedim(0, dim)
    return out.to(t.device) if moved else out


def broadcast(t: torch.Tensor, group: Group, src: int) -> torch.Tensor:
    """``t`` of the group's member ``src`` (an index in the group) on every
    member (a new tensor)."""
    if group.size == 1:
        return t
    buf, moved = _host(t, group)
    if not moved:
        buf = buf.clone()
    dist.broadcast(buf, src=group.global_rank(src), group=group.pg)
    return buf.to(t.device) if moved else buf


def chunk(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's equal chunk of ``t`` along ``dim``."""
    n = t.shape[dim] // group.size
    return t.narrow(dim, group.rank * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return chunk(g, ctx.group, ctx.dim).contiguous(), None, None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return chunk(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def copy_to(x, group: Optional[Group]):
    """*f*: identity forward, all-reduce backward."""
    return x if group is None or group.size == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group: Optional[Group]):
    """*g*: all-reduce forward, identity backward."""
    if group is None or group.size == 1:
        return x
    return _ReduceFrom.apply(x, group)


def gather_seq(x, group: Group, dim: int = 1, summed: bool = False):
    """All-gather along ``dim``; backward: this rank's slice of the
    gradient, which every rank holds whole, or with ``summed`` (each rank
    holds a part of it) this rank's slice of the group's sum
    (reduce-scatter)."""
    return x if group.size == 1 else _GatherSeq.apply(x, group, dim, summed)


def enter(x, group: Optional[Group], seq: Optional[Group]):
    """The input of a region whose ranks each compute part of the result
    over ``group`` (None: a replicated module, every rank computes it
    whole): on a whole stream *f*; on this rank's sequence shard (``seq``)
    the stream gathered whole, its gradient summed over ``group`` and
    scattered in one collective (or sliced, when the region is
    replicated)."""
    if seq is None:
        return copy_to(x, group)
    return gather_seq(x, seq, summed=group is not None and group.size > 1)


def split_seq(x, group: Group, dim: int = 1):
    """This rank's slice along ``dim``; backward: all-gather."""
    return x if group.size == 1 else _SplitSeq.apply(x, group, dim)


def reduce_scatter_seq(x, group: Group, dim: int = 1):
    """Reduce-scatter along ``dim`` (*g*, then this rank's slice);
    backward: all-gather."""
    return x if group.size == 1 else _ReduceScatterSeq.apply(x, group, dim)


def reduce_out(y, group: Group, seq: Optional[Group], bias=None):
    """A region's partial result summed over ``group``: whole (*g*), or,
    when the stream is sharded by sequence over ``seq``, this rank's
    sequence shard of it (reduce-scatter); then ``bias``, added once (on a
    sequence shard through *f*: each rank adds it to its positions
    only)."""
    y = reduce_from(y, group) if seq is None else reduce_scatter_seq(y, seq)
    return y if bias is None else y + copy_to(bias, seq)


def whole_out(y, seq: Optional[Group]):
    """A result every rank computed whole: as it is, or this rank's
    sequence shard when the stream is sharded over ``seq``."""
    return y if seq is None else split_seq(y, seq)


def summed_call(module, group: Optional[Group], *args):
    """``module(*args)`` with its parameters through *f*: a replicated
    module that sees only this rank's part of the work (its heads, its
    sequence shard) gets gradients summed over ``group``."""
    if group is None or group.size == 1:
        return module(*args)
    from torch.func import functional_call
    params = {n: copy_to(p, group) for n, p in module.named_parameters()}
    return functional_call(module, params, args)
