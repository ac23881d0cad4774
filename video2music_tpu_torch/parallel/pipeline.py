"""GPipe pipeline parallelism over the mesh's "model" group (counterpart of
parallel/pipeline.py, whose schedule is one differentiable ``shard_map``
region with ``ppermute`` between stages; here the schedule and its
mirrored backward are written out).

Stage s of S holds consecutive layers of a homogeneous stack. With M
microbatches the forward takes M + S - 1 ticks: stage s runs microbatch
i at tick s + i, receiving it from stage s - 1 and sending its output to
stage s + 1 (``batch_isend_irecv``); the last stage's outputs are then
broadcast to every stage (the JAX psum over the pipe axis), so the stack's
output is replicated. The backward is the mirrored schedule: each stage
takes its microbatches in reverse, replays the saved stage input (with
``remat``, recomputing the stage forward first, GPipe's activation trade)
and calls ``torch.autograd.backward`` with the gradient received from the
next stage (the last stage: its own), then sends its input's gradient to
the previous stage. The stack input's gradient (stage 0's) and the side
input's (``ride``, e.g. the cross-attention memory, which every stage
reads) are summed over the stages, so upstream replicated work sees the
whole gradient on every rank.

The schedule runs inside one ``torch.autograd.Function``; the stage's
parameters are reached by the replayed graphs, whose backward accumulates
their ``.grad``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from . import comm


def microbatch(tree: Any, n_microbatches: int) -> Any:
    """Split the leading batch axis B into (M, B // M) on every tensor of a
    tensor or a dict of tensors."""

    def split(x):
        b = x.shape[0]
        if b % n_microbatches:
            raise ValueError(
                f"batch {b} not divisible by {n_microbatches} microbatches")
        return x.reshape((n_microbatches, b // n_microbatches)
                         + tuple(x.shape[1:]))

    return ({k: split(v) for k, v in tree.items()} if isinstance(tree, dict)
            else split(tree))


def unmicrobatch(tree: Any) -> Any:
    """Inverse of :func:`microbatch`: merge the leading (M, mb) axes."""

    def merge(x):
        return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

    return ({k: merge(v) for k, v in tree.items()} if isinstance(tree, dict)
            else merge(tree))


def stack_subtrees(tree: Dict[str, Dict[str, torch.Tensor]],
                   names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Stack the named subtrees (dicts of tensors of one structure) into
    one dict of tensors with a leading (len(names), ...) axis."""
    keys = list(tree[names[0]])
    return {k: torch.stack([tree[n][k] for n in names]) for k in keys}


def unstack_subtrees(stacked: Dict[str, torch.Tensor],
                     names: Sequence[str]) -> Dict[str, Dict[str, Any]]:
    """Inverse of :func:`stack_subtrees`: leading-axis slices back into a
    ``{name: subtree}`` dict."""
    return {n: {k: v[j] for k, v in stacked.items()}
            for j, n in enumerate(names)}


def _send(t: torch.Tensor, group: comm.Group, to: int):
    """Start sending ``t``: [(work, the buffer it reads)]."""
    buf, _ = comm._host(t, group)
    buf = buf.contiguous()
    return [(w, buf) for w in dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, buf, group.global_rank(to), group.pg)])]


def _recv(like: torch.Tensor, group: comm.Group, frm: int) -> torch.Tensor:
    host = group.backend == "gloo" and like.is_cuda
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if host else like.device)
    for w in dist.batch_isend_irecv(
            [dist.P2POp(dist.irecv, buf, group.global_rank(frm), group.pg)]):
        w.wait()
    return buf.to(like.device) if host else buf


def _wait(pending):
    for w, _ in pending:
        w.wait()


class _Pipeline(torch.autograd.Function):
    """(stack input (M, mb, ...), ride (M, mb, ...) or None) -> the stack's
    output (M, mb, ...), replicated over the stages."""

    @staticmethod
    def forward(ctx, run, x, ride):
        g, s, S = run.group, run.group.rank, run.group.size
        saved, outs, pending = [], [], []
        for i in range(x.shape[0]):
            inp = x[i] if s == 0 else _recv(x[i], g, s - 1)
            inp = inp.detach().requires_grad_(True)
            r = None if ride is None else \
                ride[i].detach().requires_grad_(True)
            snap = run.snapshot() if run.remat else None
            with torch.set_grad_enabled(not run.remat):
                out = run.stage_fn(inp, r, i)
            saved.append((inp, r, None if run.remat else out, snap))
            if s < S - 1:
                pending += _send(out.detach(), g, s + 1)
            else:
                outs.append(out.detach())
        _wait(pending)
        y = torch.stack(outs) if s == S - 1 else torch.empty_like(x)
        ctx.run, ctx.saved = run, saved
        ctx.has_ride = ride is not None
        return comm.broadcast(y, g, S - 1)

    @staticmethod
    def backward(ctx, gy):
        run, g = ctx.run, ctx.run.group
        s, S = g.rank, g.size
        M = len(ctx.saved)
        gx = torch.zeros((M,) + tuple(ctx.saved[0][0].shape),
                         dtype=gy.dtype, device=gy.device)
        gride = None
        pending = []
        end_state = run.snapshot() if run.remat else None
        for i in reversed(range(M)):
            inp, r, out, snap = ctx.saved[i]
            if run.remat:
                run.restore(snap)
                with torch.enable_grad():
                    out = run.stage_fn(inp, r, i)
            grad = gy[i] if s == S - 1 else _recv(out, g, s + 1)
            torch.autograd.backward(out, grad)
            gi = inp.grad if inp.grad is not None else torch.zeros_like(inp)
            if s > 0:
                pending += _send(gi, g, s - 1)
            else:
                gx[i] = gi
            if r is not None:
                if gride is None:
                    gride = torch.zeros((M,) + tuple(r.shape), dtype=r.dtype,
                                        device=r.device)
                if r.grad is not None:
                    gride[i] = r.grad
        if run.remat:
            run.restore(end_state)
        _wait(pending)
        ctx.saved = None
        gx = comm.all_reduce(gx, g)
        if ctx.has_ride:
            gride = comm.all_reduce(gride, g)
        return None, gx, gride


class _Run:
    def __init__(self, stage_fn, group, remat, snapshot, restore):
        self.stage_fn, self.group, self.remat = stage_fn, group, remat
        self.snapshot = snapshot or (lambda: None)
        self.restore = restore or (lambda snap: None)


def pipeline_apply(stage_fn: Callable, x_mb: torch.Tensor,
                   ride: Optional[torch.Tensor] = None, *, mesh,
                   remat: bool = False, snapshot: Callable = None,
                   restore: Callable = None) -> torch.Tensor:
    """Run this rank's stage of a layer stack as a GPipe pipeline over the
    mesh's model group.

    ``stage_fn(h, ride_i, i) -> h``: this stage's consecutive layers on
    microbatch ``i`` ((mb, ...) in and out, the shape kept). ``x_mb``
    (M, mb, ...): the stack's input, the same on every stage (stage 0
    reads it); ``ride`` (M, mb, ...): a side input every stage reads, or
    None. ``remat``: save only each stage input and recompute the stage in
    the backward; ``snapshot()`` / ``restore(snap)`` then save and reset
    the stage's mutable state (the MoE buffers), so the recompute sees
    each microbatch's state. Returns the (M, mb, ...) output on every
    stage."""
    run = _Run(stage_fn, mesh.model, remat, snapshot, restore)
    return _Pipeline.apply(run, x_mb, ride)
