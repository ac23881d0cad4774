"""Pipeline-parallel AMT train step, dp x pp over a ("data", "model") mesh
(counterpart of train/pp.py): the same training semantics as
``make_amt_train_step`` with the encoder and decoder layer stacks run as
GPipe pipelines over the "model" group (parallel/pipeline.py) while the
batch stays split over "data".

Stacks split into HOMOGENEOUS SEGMENTS of consecutive identical layer
specs, each pipelined on its own: the base AMT is one segment of n
layers; the V2 family's 3 shallow SwiGLU + 3 deep SharedMoE split is two,
each of whose length the stage count must divide (a model axis of 3 or 1
for the 6-layer models). Stage s runs layers [s k, (s+1) k) of each
segment. Differential attention (depth-dependent lambda_init) and
separated heads are rejected, as in JAX.

Every rank holds the whole model; the embeddings, the final norms and the
head run on every stage (replicated), the layers on their stage only.
The cross-attention memory reaches every decoder stage (the encoder's
output is broadcast from its last stage, ``finalize_encoder`` runs on
every rank) and its gradient, summed over the decoder stages, flows back
into the encoder's last stage. Every rank then updates the whole model,
as the JAX step updates its replicated tree: a layer's gradient is summed
over "model" (its stage's, the others adding zeros), and each stack MoE
layer's state is summed the same way after the step, so every rank's
model, moments and MoE state stay current for an eval or a checkpoint.

MoE state (balancing bias, the schedules' steps) is STAGE-LOCAL and steps
once per microbatch, as M small-batch forwards; the balancing update
uses the microbatch's counts summed over "data" (the JAX step's psum of
the bias delta). Each microbatch and layer draws its dropout from its own
generator (seeded from one draw of the step generator), so a pipelined
step equals the single-device step exactly at dropout 0 and in
distribution otherwise.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn
from torch.func import functional_call

from ..core.config import AMTConfig, TrainConfig
from ..parallel import comm
from ..parallel.pipeline import microbatch, pipeline_apply, unmicrobatch
from .step import amt_loss, data_sum, maybe_bf16_batch


def _segments(specs):
    """Split a layer-spec tuple into (spec, [layer indices]) runs of
    consecutive identical specs."""
    segs = []
    for i, spec in enumerate(specs):
        if segs and segs[-1][0] == spec:
            segs[-1][1].append(i)
        else:
            segs.append((spec, [i]))
    return segs


def _check_pipelineable(cfg: AMTConfig, n_stages: int) -> None:
    for name, specs in (("encoder", cfg.encoder_layers),
                        ("decoder", cfg.decoder_layers)):
        for spec, idxs in _segments(specs):
            if spec.attn.kind == "differential":
                raise ValueError(
                    "differential attention is depth-dependent "
                    "(lambda_init) — stages are not homogeneous; use TP/EP")
            if len(idxs) % n_stages:
                raise ValueError(
                    f"{name} segment of {len(idxs)} identical layers not "
                    f"divisible by {n_stages} pipeline stages (the V2 "
                    "3 shallow + 3 deep split pipelines on a model axis "
                    "of 3 or 1)")


class _Method(nn.Module):
    """``model.<name>(*args)`` as a forward, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, name, *args, **kwargs):
        return getattr(self.model, name)(*args, **kwargs)


class PipelineStep:
    """``step(state, batch) -> (state, metrics)`` of a pipelined AMT
    (metrics: loss, loss_chord, loss_emotion)."""

    def __init__(self, cfg: AMTConfig, tcfg: TrainConfig, mesh,
                 n_microbatches: int = 4, drop_loss: bool = False,
                 remat: bool = False):
        if cfg.separated:
            raise ValueError("separated heads not supported in the pp step")
        S = mesh.model.size
        _check_pipelineable(cfg, S)
        self.tcfg, self.mesh, self.M = tcfg, mesh, n_microbatches
        self.drop_loss, self.remat = drop_loss, remat
        self.reduce = data_sum(mesh)
        s = mesh.model.rank
        # per stack: [(segment index, my layers)]
        self.stacks = {}
        for stack, specs in (("encoder_layers", cfg.encoder_layers),
                             ("decoder_layers", cfg.decoder_layers)):
            segs = []
            for si, (_, idxs) in enumerate(_segments(specs)):
                k = len(idxs) // S
                segs.append((si, idxs[s * k:(s + 1) * k]))
            self.stacks[stack] = segs
        self.mine = {f"{stack}.{li}" for stack, segs in self.stacks.items()
                     for _, layers in segs for li in layers}

    @staticmethod
    def _in_stacks(name: str) -> bool:
        return name.split(".")[0] in ("encoder_layers", "decoder_layers")

    # -- the forward ------------------------------------------------------
    def _params(self, module: nn.Module):
        """The module's forward parameters: the masters, or bf16 casts of
        them under mixed precision (made per call, so a replayed or
        recomputed stage has its own graph to the masters)."""
        if not self.tcfg.mixed_precision:
            return None
        return {n: p.to(torch.bfloat16) for n, p in module.named_parameters()}

    def _call(self, module, *args, **kwargs):
        params = self._params(module)
        if params is None:
            return module(*args, **kwargs)
        return functional_call(module, params, args, kwargs, strict=False)

    def _stage_fn(self, layers: nn.ModuleList, mine: List[int], tag: int,
                  seed: int, device):
        def run(h, ride, i):
            for li in mine:
                gen = torch.Generator(device=device).manual_seed(
                    (seed * 1000003 + tag * 10007 + li * 101 + i) % (2 ** 62))
                args = (h,) if ride is None else (h, ride)
                h = self._call(layers[li], *args, generator=gen)
            return h
        return run

    def _moe_state(self, layers, mine):
        ffns = [layers[li].ffn for li in mine
                if hasattr(layers[li].ffn, "steps")]

        def snapshot():
            return [(dict(f.steps), None if not hasattr(f, "balance_bias")
                     else f.balance_bias.clone()) for f in ffns]

        def restore(snap):
            for f, (steps, bias) in zip(ffns, snap):
                for name, v in steps.items():
                    f.set_step(name, v)
                if bias is not None:
                    f.balance_bias.copy_(bias)
        return snapshot, restore

    def _run_stack(self, model, stack, h, ride, seed, tag):
        layers = getattr(model, stack)
        for si, mine in self.stacks[stack]:
            snapshot, restore = self._moe_state(layers, mine)
            fn = self._stage_fn(layers, mine, tag * 16 + si, seed, h.device)
            h_mb = pipeline_apply(
                fn, microbatch(h, self.M),
                None if ride is None else microbatch(ride, self.M),
                mesh=self.mesh, remat=self.remat, snapshot=snapshot,
                restore=restore)
            h = unmicrobatch(h_mb)
        return h

    def __call__(self, state, batch: Dict):
        model = state.model
        gen = state.generator
        outer = _Method(model)
        b = maybe_bf16_batch(batch, self.tcfg)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                 device=gen.device))
        for p in model.parameters():
            p.grad = None
        vf = self._call(outer, "embed_video_input", b["semantic"],
                        b["scene_offset"], b["motion"], b["emotion"],
                        generator=gen)
        xf = self._call(outer, "embed_decoder_input", b["x"], b["x_root"],
                        b["x_attr"], b["key"], generator=gen)
        vf = self._run_stack(model, "encoder_layers", vf, None, seed, 1)
        memory = self._call(outer, "finalize_encoder", vf)
        out = self._run_stack(model, "decoder_layers", xf, memory, seed, 2)
        logits = self._call(outer, "head", out)
        total, (lc, le) = amt_loss(logits, batch, self.tcfg,
                                   gen if self.drop_loss else None,
                                   self.reduce)
        total.backward()
        self._update(state)
        state.step += 1
        return state, {"loss": total.detach(), "loss_chord": lc.detach(),
                       "loss_emotion": le.detach()}

    # -- the update ---------------------------------------------------------
    def _update(self, state):
        """Step the optimizer on the whole model, on every rank alike: the
        layers' gradients summed over "model" (the stages that do not run
        a layer add zeros), the replicated parameters' whole on every
        stage, all of them summed over "data". Then each stack MoE
        layer's state from the stage that ran it."""
        named = list(state.model.named_parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in named]
        layers = [i for i, (n, _) in enumerate(named) if self._in_stacks(n)]
        summed = comm.all_reduce_coalesced([grads[i] for i in layers],
                                           self.mesh.model)
        for i, g in zip(layers, summed):
            grads[i] = g
        state.optimizer.step(comm.all_reduce_coalesced(grads, self.mesh.data))
        for _, p in named:
            p.grad = None
        self._share_moe_state(state.model)

    def _share_moe_state(self, model) -> None:
        """Each stack MoE layer's balancing bias and schedule steps from
        the stage that runs it, on every stage: one sum over "model" to
        which the other stages add zeros."""
        ffns = [(layer.ffn, f"{stack}.{li}" in self.mine)
                for stack in self.stacks
                for li, layer in enumerate(getattr(model, stack))
                if hasattr(layer.ffn, "steps")]
        bufs = [(b, mine) for ffn, mine in ffns
                for b in ffn.buffers(recurse=False)]
        summed = comm.all_reduce_coalesced(
            [b if mine else torch.zeros_like(b) for b, mine in bufs],
            self.mesh.model)
        for (b, _), v in zip(bufs, summed):
            b.copy_(v)
        for ffn, _ in ffns:
            for name in ffn.steps:
                ffn.steps[name] = int(getattr(ffn, name))


def make_amt_pp_train_step(cfg: AMTConfig, tcfg: TrainConfig, mesh,
                           n_microbatches: int = 4, drop_loss: bool = False,
                           remat: bool = False) -> PipelineStep:
    """The pipelined train step of an AMT of ``cfg`` on ``mesh`` (stages
    over its model group); raises ValueError for a wiring the pipeline
    cannot split (see the module docstring)."""
    return PipelineStep(cfg, tcfg, mesh, n_microbatches, drop_loss, remat)

