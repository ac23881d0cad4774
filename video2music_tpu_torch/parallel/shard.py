"""The shard plan of the port's sharded training (counterpart of
``param_shardings`` / ``_tp_spec`` in the JAX package's parallel/mesh.py),
and its application to a model, an optimizer and a checkpoint.

The plan names every parameter that is cut over the "model" axis, with the
dimension it is cut along and the blocks of that dimension (each block cut
evenly, each rank keeping its share of every block); every other
parameter is replicated. The rules are JAX's, mapped onto the port's
fused names:

  * expert stacks (``w1g`` (E, G, D), ``b1g``, ``w2`` (E, D, F), ``b2``)
    split on E where the axis divides E, under every strategy (EP); else,
    under "tp" / "sp", on their inner d_ff (``w1g`` / ``b1g`` by their
    [w1 | wg] blocks, ``w2`` on F; ``b2`` replicated);
  * under "tp" / "sp" (Megatron): attention ``in_proj`` by its q | k | v
    blocks on the output rows (whole heads: rank r keeps heads
    [r H/m, (r+1) H/m) of each block) and ``out_proj`` on its input
    columns; SwiGLU ``w1g`` by its [linear1 | gate] blocks, ReLU ``linear1``
    and SiLU-MLP ``w1g`` on their rows, each ``linear2`` on its input
    columns; the second bias added once, after the reduce;
  * where a split would not give each rank whole heads (``num_heads`` or
    GQA's ``kv_heads`` not divisible by the axis; for differential
    attention whole pairs) or whole columns, the module stays replicated,
    as JAX falls back to replication. The numbers are the same either way.

KAN experts stay replicated (JAX's rule reaches their per-expert KANLinear
weights through the "experts" path and splits their output features; the
port keeps them whole). Under "pp" nothing is cut: the pipeline step
(train/pp.py) gives each stage its layers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from ..ops.attention import MultiHeadAttention
from ..ops.moe import MoELayer, SiLUMLP, SwiGLU
from ..models.layers import ReluFFN
from . import comm

STRATEGIES = ("dp", "tp", "sp", "pp")


@dataclasses.dataclass(frozen=True)
class Split:
    """A parameter cut over the model axis along ``dim``, whose extent is
    the concatenation of ``blocks``; each block is cut evenly."""
    dim: int
    blocks: tuple


def _attention_splits(mod: MultiHeadAttention, m: int) -> Dict[str, Split]:
    if mod.num_heads % m or mod.kv_heads % m:
        return {}
    rows = Split(0, (mod.qk_dim, mod.k_dim, mod.v_dim))
    out = {"in_proj.weight": rows,
           "out_proj.weight": Split(1, (mod.d_model,))}
    if mod.in_proj.bias is not None:
        out["in_proj.bias"] = rows
    return out


def _moe_splits(mod: MoELayer, m: int, tp: bool):
    """(splits, "ep" | "inner" | None) of an MoE layer's expert stacks."""
    if mod.cfg.expert == "kan":
        return {}, None
    E, F = mod.cfg.n_experts, mod.d_ff
    if E % m == 0:
        ep = Split(0, (E,))
        return {n: ep for n in ("w1g", "b1g", "w2", "b2")}, "ep"
    if tp and F % m == 0:
        G = (F, F) if mod.cfg.expert == "glu" else (F,)
        return {"w1g": Split(1, G), "b1g": Split(1, G),
                "w2": Split(2, (F,))}, "inner"
    return {}, None


def _ffn_splits(mod, m: int) -> Dict[str, Split]:
    F = mod.d_ff
    if F % m:
        return {}
    first = "linear1" if isinstance(mod, ReluFFN) else "w1g"
    rows = Split(0, (F, F) if isinstance(mod, SwiGLU) else (F,))
    return {f"{first}.weight": rows, f"{first}.bias": rows,
            "linear2.weight": Split(1, (F,))}


def _module_splits(model: nn.Module, model_size: int, strategy: str):
    """[(module name, module, {local param name: Split}, moe split kind)]
    of the modules that are cut."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown parallel strategy {strategy!r}")
    m = model_size
    tp = strategy in ("tp", "sp")
    out = []
    if m == 1 or strategy == "pp":
        return out
    for name, mod in model.named_modules():
        kind = None
        if isinstance(mod, MoELayer):
            splits, kind = _moe_splits(mod, m, tp)
        elif not tp:
            continue
        elif isinstance(mod, MultiHeadAttention):
            splits = _attention_splits(mod, m)
        elif isinstance(mod, (ReluFFN, SwiGLU, SiLUMLP)):
            splits = _ffn_splits(mod, m)
        else:
            continue
        if splits:
            out.append((name, mod, splits, kind))
    return out


def shard_plan(model: nn.Module, model_size: int,
               strategy: str) -> Dict[str, Split]:
    """{parameter name: Split} of the parameters cut over a model axis of
    ``model_size`` under ``strategy``; the others are replicated."""
    return _plan(_module_splits(model, model_size, strategy))


def take(t: torch.Tensor, split: Split, rank: int, size: int):
    """Rank ``rank``'s share of the whole tensor ``t``."""
    parts = torch.split(t, list(split.blocks), dim=split.dim)
    return torch.cat([comm.chunk(p, comm.Group(None, rank, size, (), ""),
                                 split.dim) for p in parts],
                     dim=split.dim).clone()


def put_together(shares: List[torch.Tensor], split: Split) -> torch.Tensor:
    """The whole tensor from every rank's share (inverse of :func:`take`)."""
    size = len(shares)
    local = [b // size for b in split.blocks]
    pieces = [torch.split(s, local, dim=split.dim) for s in shares]
    return torch.cat([torch.cat([p[j] for p in pieces], dim=split.dim)
                      for j in range(len(local))], dim=split.dim)


def shard_model_(model: nn.Module, mesh, strategy: str) -> Dict[str, Split]:
    """Cut ``model`` (whole, the same on every rank) to this rank's shares
    in place, point its modules at the mesh and set their tensor-parallel
    state. Returns the plan."""
    m, r = mesh.model.size, mesh.model.rank
    cuts = _module_splits(model, m, strategy)
    plan = _plan(cuts)
    for mod in model.modules():
        if hasattr(mod, "mesh"):
            mod.mesh = mesh
    for _, mod, splits, kind in cuts:
        for pname, split in splits.items():
            p = mod.get_parameter(pname)
            p.data = take(p.data, split, r, m)
        mod.tp = mesh.model
        if isinstance(mod, MultiHeadAttention):
            for attr in ("num_heads", "kv_heads", "qk_heads", "k_heads",
                         "qk_dim", "k_dim", "v_dim"):
                setattr(mod, attr, getattr(mod, attr) // m)
            mod.head0 = r * mod.qk_heads
        elif kind == "ep":
            mod.split, mod.n_local = "ep", mod.cfg.n_experts // m
            mod.e0 = r * mod.n_local
        else:  # the inner d_ff of an expert stack or a feed-forward
            mod.split = kind
            mod.d_ff //= m
            mod.ff0 = r * mod.d_ff
    if strategy == "sp":
        if not getattr(model.cfg, "sequence_parallel", False):
            raise ValueError(
                "parallel='sp' needs AMTConfig.sequence_parallel=True")
        model.sp = True
    return plan


def shard_optimizer_(opt, model: nn.Module, plan: Dict[str, Split],
                     mesh) -> None:
    """Cut the optimizer's moments (made for the whole ``model``, in
    ``model.parameters()`` order) to this rank's shares."""
    m, r = mesh.model.size, mesh.model.rank
    for i, (name, _) in enumerate(model.named_parameters()):
        if name in plan:
            for moment in opt.MOMENTS:
                buf = getattr(opt, moment)
                buf[i] = take(buf[i], plan[name], r, m)


def _gather(t: torch.Tensor, split: Optional[Split], group) -> torch.Tensor:
    if split is None:
        return t
    shares = torch.chunk(comm.all_gather(t, group, split.dim), group.size,
                         dim=split.dim)
    return put_together(list(shares), split)


def gather_state_dict(model: nn.Module, plan: Dict[str, Split],
                      mesh) -> Dict[str, torch.Tensor]:
    """The whole model's state dict (the unsharded layout) from every
    rank's shares; collective over the model group."""
    return {k: _gather(v, plan.get(k), mesh.model)
            for k, v in model.state_dict().items()}


def gather_optimizer_state(opt, model: nn.Module, plan: Dict[str, Split],
                           mesh) -> Dict:
    """The optimizer's state dict with whole moments; collective over the
    model group."""
    names = [n for n, _ in model.named_parameters()]
    out = opt.state_dict()
    for moment in opt.MOMENTS:
        out[moment] = [_gather(t, plan.get(n), mesh.model)
                       for n, t in zip(names, getattr(opt, moment))]
    return out


def _plan(cuts) -> Dict[str, Split]:
    return {f"{name}.{p}" if name else p: split
            for name, _, splits, _ in cuts for p, split in splits.items()}


def shard_train_state_(state, mesh, strategy: str) -> Dict[str, Split]:
    """Cut a whole train state (model and optimizer moments, the same on
    every rank) to this rank's shares; returns the plan."""
    plan = shard_plan(state.model, mesh.model.size, strategy)
    shard_optimizer_(state.optimizer, state.model, plan, mesh)
    shard_model_(state.model, mesh, strategy)
    return plan
