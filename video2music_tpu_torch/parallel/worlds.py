"""Check worlds: a rank's part of running sharded train steps beside the
unsharded step (the CPU tests and the card's multi-GPU check start these
ranks through ``parallel.launch.spawn``, and hold rank 0's results to
the step of one process).

``run_world(payload)``: payload["mesh"] (data, model), ["backend"],
["device"], optional ["deterministic"] (torch's deterministic kernels,
as the step the ranks are held to runs) and ["cases"], each case a
dict:
  * ``name``, ``cfg`` (AMTConfig), ``tcfg`` (TrainConfig), ``strategy``
    ("dp" | "tp" | "sp" | "pp"), ``weights`` (a whole state dict, or None
    for the seeded init), ``batches`` (global numpy batch dicts, one a
    step), optional ``microbatches`` and ``remat`` (pp) and
    ``count_emotions`` (after the steps, an eval forward on the first
    batch counting the MoE layers' selections by emotion) and
    ``first_state`` (also return the whole state after the first step);
  * or ``call``: "package.module:function", run with ``args`` on every
    rank (e.g. ``train_amt``, given this world's mesh as ``mesh=`` with
    ``pass_mesh=True``, or another mesh of the same ranks with
    ``pass_mesh=(data, model)``, or a CLI's ``main`` joining this world; a
    train state returned comes back as its step count);
  * or ``probe``: a seed for :func:`probe_collectives`.
Each rank returns {name: {"losses", "state" (rank 0: the whole model's
state dict after the steps, on the CPU), "ms" (each step's wall time),
"launches" (rows 1 and 11's launches over the steps: flash_attention,
flash_attention_dropout_fwd / _bwd), "heads" (the heads a launch runs),
"moe" (``obs.collect_moe_metrics`` after the counting eval, or None),
"moe_state" (this rank's MoE balancing biases and schedule steps),
"digest" (the sum of this rank's parameters, in f64), "expert_counts"
(each step's global (MoE layers, E) counts, where the step reports them)
and "first_state" (rank 0, when asked: the whole state dict after the
first step)}}.
"""

from __future__ import annotations

import importlib
import time

import torch

from ..ops.attention import MultiHeadAttention
from .mesh import create_mesh, shard_batch
from .shard import gather_state_dict, shard_train_state_


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(mesh, case):
    """One train-steps case on this rank (see the module docstring)."""
    from ..data.loader import to_device
    from ..ops import flash_attention_dropout as fad
    from ..ops.flash_attention import flash_attention
    from ..train.pp import make_amt_pp_train_step
    from ..train.step import create_train_state, make_amt_train_step
    cfg, tcfg, strategy = case["cfg"], case["tcfg"], case["strategy"]
    state = create_train_state(cfg, tcfg, device=mesh.device)
    if case.get("weights") is not None:
        state.model.load_state_dict(case["weights"])
    plan = shard_train_state_(state, mesh, strategy)
    if strategy == "pp":
        step = make_amt_pp_train_step(
            cfg, tcfg, mesh, n_microbatches=case.get("microbatches", 4),
            remat=case.get("remat", False))
    else:
        step = make_amt_train_step(tcfg, mesh=mesh)
    counters = {"flash_attention": flash_attention,
                "flash_attention_dropout_fwd": fad.flash_attention_dropout_fwd,
                "flash_attention_dropout_bwd": fad.flash_attention_dropout_bwd}
    launches0 = {k: fn.launches for k, fn in counters.items()}
    losses, ms, counts, first = [], [], [], None
    for i, b in enumerate(case["batches"]):
        local = to_device(shard_batch(mesh, b), mesh.device)
        _sync(mesh.device)
        t0 = time.perf_counter()
        state, m = step(state, local)
        loss = float(m["loss"])
        _sync(mesh.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if "expert_counts" in m:
            counts.append(m["expert_counts"].cpu())
        if i == 0 and case.get("first_state"):
            first = _whole_on_main(state, plan, mesh)
    launches = {k: fn.launches - launches0[k] for k, fn in counters.items()}
    moe = None
    if case.get("count_emotions"):  # an eval forward counting emotions
        from ..obs.logging import collect_moe_metrics, reset_moe_metrics
        from ..train.step import MODEL_INPUTS
        local = to_device(shard_batch(mesh, case["batches"][0]),
                          mesh.device)
        reset_moe_metrics(state.model)
        with torch.no_grad():
            state.model(*(local[k] for k in MODEL_INPUTS),
                        count_emotions=True)
        moe = collect_moe_metrics(state.model)
    heads = sorted({mod.qk_heads for mod in state.model.modules()
                    if isinstance(mod, MultiHeadAttention)})
    moe_state = {n: b.cpu() for n, b in state.model.named_buffers()
                 if n.endswith(("balance_bias", "_step"))}
    digest = float(sum(p.detach().double().sum()
                       for p in state.model.parameters()))
    return {"losses": losses, "ms": ms, "launches": launches, "moe": moe,
            "heads": heads, "moe_state": moe_state, "digest": digest,
            "expert_counts": counts, "first_state": first,
            "state": _whole_on_main(state, plan, mesh)}


def _whole_on_main(state, plan, mesh):
    """The whole model's state dict on the CPU on rank 0 (None on the
    others); collective."""
    whole = gather_state_dict(state.model, plan, mesh)
    if not mesh.is_main:
        return None
    return {k: v.detach().to("cpu", copy=True) for k, v in whole.items()}


def probe_collectives(mesh, seed: int = 0):
    """Each differentiable collective of parallel/comm.py over the model
    group, forward and backward, on inputs and upstream gradients seeded
    by (seed, rank): {name: (input, output, upstream gradient, input
    gradient)} as numpy arrays, for the caller to hold to their
    definitions."""
    from . import comm
    g = mesh.model
    out = {}
    for name, fn in (("copy_to", lambda x: comm.copy_to(x, g)),
                     ("reduce_from", lambda x: comm.reduce_from(x, g)),
                     ("gather_seq", lambda x: comm.gather_seq(x, g)),
                     ("gather_seq_summed",
                      lambda x: comm.gather_seq(x, g, summed=True)),
                     ("split_seq", lambda x: comm.split_seq(x, g)),
                     ("reduce_scatter_seq",
                      lambda x: comm.reduce_scatter_seq(x, g))):
        gen = torch.Generator().manual_seed(seed * 1000 + mesh.rank)
        x = torch.randn(2, 4 * g.size, 3, generator=gen, requires_grad=True)
        y = fn(x)
        up = torch.randn(y.shape, generator=gen)
        y.backward(up)
        out[name] = tuple(t.detach().numpy() for t in (x, y, up, x.grad))
    return out


def run_world(payload):
    if payload.get("deterministic"):
        # CUDA's embedding backward adds with atomics: its rounding, and
        # through a router's near-tie an expert's whole update, changes
        # from run to run unless torch picks its deterministic kernels
        torch.use_deterministic_algorithms(True, warn_only=True)
    mesh = create_mesh(tuple(payload["mesh"]),
                       backend=payload.get("backend", "gloo"),
                       device=payload.get("device"))
    out = {}
    for case in payload["cases"]:
        if "call" in case:
            module, name = case["call"].split(":")
            fn = getattr(importlib.import_module(module), name)
            kwargs = dict(case.get("kwargs", {}))
            if case.get("pass_mesh"):
                kwargs["mesh"] = mesh if case["pass_mesh"] is True else \
                    create_mesh(tuple(case["pass_mesh"]),
                                backend=mesh.backend, device=mesh.device)
            result = fn(*case.get("args", ()), **kwargs)
            if hasattr(result, "model"):  # a train state: its step count
                result = {"step": result.step}
        elif "probe" in case:
            result = probe_collectives(mesh, case["probe"])
        else:
            result = run_steps(mesh, case)
        out[case["name"]] = result
    return out
