"""Train and eval steps of the three model families (counterpart of
train/step.py): the AMT (every wiring of ``amt_config``, with the 159-way
head or the separated root / attr heads), the video regression (any of the
fourteen backbones) and the no-video MusicTransformer.

Losses (the JAX package's):
  * AMT: total = lambda * CE(chord logits, tgt) + (1 - lambda) * BCE(chord
    logits, tgt_emotion), lambda = TrainConfig.loss_lambda (0.4), with
    label smoothing ``ce_smoothing`` and the ignore index CHORD_PAD, the
    optional TopK auxiliary pair, and the optional ``drop_loss`` branch
    selection; separated heads: CE(root) + CE(attr), no emotion term
    (loss_chord is the total, loss_emotion -1);
  * regression: SmoothL1 of the (note_density, loudness) prediction, in
    that order, plus the BCE of the instrument probabilities;
  * MusicTransformer: the chord CE alone.

Mixed precision has the JAX semantics (``_maybe_bf16``,
``_maybe_bf16_batch``), by an explicit cast and not ``torch.autocast``:
the f32 master parameters and the float inputs are cast to bf16 for the
forward and backward (the cast is differentiable, so the gradients reach
the master parameters in f32), targets stay f32 and losses reduce in f32;
the optimizer's moments are f32. The step updates the state in place; a
frozen parameter (the AMT's chord table) takes a zero gradient and the
optimizer's update like every other, as under optax. The MoE layers'
state (balancing biases, the schedules' steps) lives in the modules and
moves in the training forward.

Every entry point runs on CUDA unless the caller passes ``device="cpu"``,
and raises without CUDA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn
from torch.func import functional_call

from ..core import constants as C
from ..core.config import (AMTConfig, MusicTransformerConfig,
                           RegressionConfig, TrainConfig)
from ..models import MusicTransformer, VideoMusicTransformer, VideoRegression
from ..ops.losses import bce, bce_with_logits, combined_chord_loss, smooth_l1
from ..weights import init_weights_
from . import metrics as M
from .optim import make_optimizer

# targets stay f32 under mixed precision — losses reduce in f32
F32_TARGET_KEYS = frozenset({
    "tgt", "tgt_root", "tgt_attr", "tgt_emotion", "tgt_emotion_prob",
    "note_density", "loudness", "instrument"})
MODEL_INPUTS = ("x", "x_root", "x_attr", "semantic", "key", "scene_offset",
                "motion", "emotion")
REGRESSION_INPUTS = ("semantic", "scene_offset", "motion", "emotion")
MUSIC_TRANSFORMER_INPUTS = ("x", "x_root", "x_attr", "key")


def resolve_device(device=None) -> torch.device:
    """``device`` or CUDA; CUDA without a card raises (no silent CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available (torch.cuda.is_available() is False); "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


@dataclass
class TrainState:
    """step: updates taken; model: the f32 master weights (a
    VideoMusicTransformer, VideoRegression or MusicTransformer); optimizer:
    its moments over ``model.parameters()``; generator: every dropout's
    draws (on the model's device)."""
    step: int
    model: nn.Module
    optimizer: object
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def build_model(cfg) -> nn.Module:
    """The model of a config: AMTConfig, RegressionConfig or
    MusicTransformerConfig."""
    if isinstance(cfg, AMTConfig):
        return VideoMusicTransformer(cfg)
    if isinstance(cfg, RegressionConfig):
        return VideoRegression(cfg)
    if isinstance(cfg, MusicTransformerConfig):
        return MusicTransformer(cfg)
    raise TypeError(f"no model for a {type(cfg).__name__}")


def create_train_state(cfg, tcfg: TrainConfig, *, device=None,
                       init_steps: int = 0) -> TrainState:
    """A seeded model of ``cfg`` (any of the three families; weights from a
    CPU generator seeded ``tcfg.seed``, as the port's ``init_weights_``),
    its optimizer, and a step generator seeded the same on ``device``."""
    dev = resolve_device(device)
    model = build_model(cfg)
    init_weights_(model, torch.Generator().manual_seed(tcfg.seed))
    model.to(dev)
    opt = make_optimizer(tcfg, model.parameters(), cfg.d_model, init_steps)
    gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
    return TrainState(step=0, model=model, optimizer=opt, generator=gen)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def maybe_bf16_batch(batch: Dict, tcfg: TrainConfig) -> Dict:
    """Float inputs in bf16 under mixed precision; targets kept."""
    if not tcfg.mixed_precision:
        return batch
    return {k: v if k in F32_TARGET_KEYS else _bf16(v)
            for k, v in batch.items()}


def _chord_loss(logits, tgt, tcfg: TrainConfig, vocab: int, pad: int):
    return combined_chord_loss(
        logits, tgt, vocab_size=vocab, ignore_index=pad,
        label_smoothing=(tcfg.ce_smoothing or 0.0),
        auxiliary=tcfg.auxiliary_loss)


def amt_loss(logits, batch, tcfg: TrainConfig, generator=None):
    """(total, (loss_chord, loss_emotion)); with a ``generator`` the
    drop_loss selection: p < 0.6 combined, p < 0.8 chord only, else
    emotion only (one uniform draw, on the device)."""
    loss_chord = _chord_loss(logits, batch["tgt"], tcfg, C.CHORD_SIZE,
                             C.CHORD_PAD)
    loss_emotion = bce_with_logits(logits, batch["tgt_emotion"].float())
    lam = tcfg.loss_lambda
    combined = lam * loss_chord + (1.0 - lam) * loss_emotion
    if generator is None:
        return combined, (loss_chord, loss_emotion)
    p = torch.rand((), generator=generator, device=logits.device)
    total = torch.where(p < 0.6, combined,
                        torch.where(p < 0.8, loss_chord, loss_emotion))
    return total, (loss_chord, loss_emotion)


def amt_separated_loss(logits_root, logits_attr, batch, tcfg: TrainConfig):
    """Separated heads: CE(root) + CE(attr), no emotion term."""
    return (_chord_loss(logits_root, batch["tgt_root"], tcfg,
                        C.CHORD_ROOT_SIZE, C.CHORD_ROOT_PAD)
            + _chord_loss(logits_attr, batch["tgt_attr"], tcfg,
                          C.CHORD_ATTR_SIZE, C.CHORD_ATTR_PAD))


def regression_loss(ln_nd, inst, batch):
    """(SmoothL1((note_density, loudness)) + BCE(instrument), (reg, bce));
    the targets stacked in that order, as the reference's cat."""
    target = torch.stack([batch["note_density"], batch["loudness"]], dim=-1)
    reg = smooth_l1(ln_nd, target.float())
    cls = bce(inst, batch["instrument"].float())
    return reg + cls, (reg, cls)


def _model_args(batch, keys=MODEL_INPUTS):
    return tuple(batch[k] for k in keys)


def _forward_backward(state: TrainState, tcfg: TrainConfig, batch: Dict,
                      keys, kwargs, loss_fn):
    """One training forward of ``state.model`` on ``batch[keys]`` (bf16
    parameters and inputs under mixed precision) with ``kwargs``, the loss
    ``loss_fn(out) -> (total, aux)``, its gradients and one optimizer
    update, in place. Returns aux."""
    model = state.model
    params = dict(model.named_parameters())
    fwd = ({n: p.to(torch.bfloat16) for n, p in params.items()}
           if tcfg.mixed_precision else params)
    out = functional_call(model, fwd,
                          _model_args(maybe_bf16_batch(batch, tcfg), keys),
                          kwargs, strict=False)
    total, aux = loss_fn(out)
    trainable = [p for p in params.values() if p.requires_grad]
    grads = iter(torch.autograd.grad(total, trainable))
    state.optimizer.step([next(grads) if p.requires_grad
                          else torch.zeros_like(p)
                          for p in params.values()])
    state.step += 1
    return aux


def make_amt_train_step(tcfg: TrainConfig, drop_loss: bool = False):
    """``train_step(state, batch) -> (state, metrics)``: one forward and
    backward (bf16 under mixed precision) and one optimizer update, in
    place. metrics: loss, loss_chord, loss_emotion (f32 scalars on the
    device) and the MoE layers' expert_counts (n, E) and maxvio (n,).
    Separated heads optimise their loss; loss_chord is then the total and
    loss_emotion -1."""

    def train_step(state: TrainState, batch: Dict):
        model = state.model

        def loss_fn(logits):
            if model.cfg.separated:
                total = amt_separated_loss(*logits, batch, tcfg)
                return total, (total, total, torch.full_like(total, -1.0))
            total, (lc, le) = amt_loss(
                logits, batch, tcfg, state.generator if drop_loss else None)
            return total, (total, lc, le)

        total, lc, le = _forward_backward(
            state, tcfg, batch, MODEL_INPUTS,
            {"deterministic": False, "generator": state.generator}, loss_fn)
        metrics = {"loss": total.detach(), "loss_chord": lc.detach(),
                   "loss_emotion": le.detach()}
        metrics.update(model.moe_metrics())
        return state, metrics

    return train_step


def make_amt_eval_step(tcfg: TrainConfig):
    """``eval_step(model, batch) -> metrics``: the f32 eval forward, the
    loss terms, accuracy, hits@1/3/5 and correspondence; separated heads
    score through the root x attr reconstruction."""

    @torch.no_grad()
    def eval_step(model, batch: Dict):
        logits = model(*_model_args(batch))
        if model.cfg.separated:
            total = amt_separated_loss(*logits, batch, tcfg)
            lc, le = total, torch.full_like(total, -1.0)
            logits = torch.log(M.root_attr_to_chord_logits(*logits) + 1e-20)
        else:
            total, (lc, le) = amt_loss(logits, batch, tcfg)
        tgt = batch["tgt"]
        return {
            "loss": total, "loss_chord": lc, "loss_emotion": le,
            "accuracy": M.compute_vevo_accuracy(logits, tgt),
            "hits@1": M.compute_hits_k(logits, tgt, 1),
            "hits@3": M.compute_hits_k(logits, tgt, 3),
            "hits@5": M.compute_hits_k(logits, tgt, 5),
            "correspondence": M.compute_vevo_correspondence(
                logits, tgt, batch["tgt_emotion"],
                batch["tgt_emotion_prob"]),
        }

    return eval_step


def make_regression_train_step(tcfg: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)`` of a regression
    state: metrics loss, loss_reg, loss_bce."""

    def train_step(state: TrainState, batch: Dict):
        def loss_fn(out):
            total, (reg, cls) = regression_loss(*out, batch)
            return total, (reg, cls)

        reg, cls = _forward_backward(
            state, tcfg, batch, REGRESSION_INPUTS,
            {"generator": state.generator}, loss_fn)
        return state, {"loss": (reg + cls).detach(), "loss_reg": reg.detach(),
                       "loss_bce": cls.detach()}

    return train_step


def make_regression_eval_step():
    """``eval_step(model, batch) -> metrics``: the loss terms and the
    per-batch sums of ``metrics.regression_eval``."""

    @torch.no_grad()
    def eval_step(model, batch: Dict):
        ln_nd, inst = model(*_model_args(batch, REGRESSION_INPUTS))
        total, (reg, cls) = regression_loss(ln_nd, inst, batch)
        out = M.regression_eval(ln_nd, batch["note_density"],
                                batch["loudness"], inst, batch["instrument"])
        out.update({"loss": total, "loss_reg": reg, "loss_bce": cls})
        return out

    return eval_step


def _mt_loss(logits, batch, tcfg):
    return _chord_loss(logits, batch["tgt"], tcfg, C.CHORD_SIZE, C.CHORD_PAD)


def make_music_transformer_train_step(tcfg: TrainConfig):
    """``train_step(state, batch) -> (state, {"loss"})`` of a
    MusicTransformer state: the chord CE alone."""

    def train_step(state: TrainState, batch: Dict):
        def loss_fn(logits):
            loss = _mt_loss(logits, batch, tcfg)
            return loss, loss

        loss = _forward_backward(
            state, tcfg, batch, MUSIC_TRANSFORMER_INPUTS,
            {"deterministic": False, "generator": state.generator}, loss_fn)
        return state, {"loss": loss.detach()}

    return train_step


def make_music_transformer_eval_step(tcfg: TrainConfig):
    """``eval_step(model, batch) -> metrics``: loss, accuracy and
    hits@1/3/5."""

    @torch.no_grad()
    def eval_step(model, batch: Dict):
        logits = model(*_model_args(batch, MUSIC_TRANSFORMER_INPUTS))
        tgt = batch["tgt"]
        return {"loss": _mt_loss(logits, batch, tcfg),
                "accuracy": M.compute_vevo_accuracy(logits, tgt),
                "hits@1": M.compute_hits_k(logits, tgt, 1),
                "hits@3": M.compute_hits_k(logits, tgt, 3),
                "hits@5": M.compute_hits_k(logits, tgt, 5)}

    return eval_step
