"""Train and eval steps of AMT 2.2 (counterpart of train/step.py).

AMT loss (the JAX package's ``amt_loss``):
    total = lambda * CE(chord logits, tgt) + (1 - lambda) * BCE(chord
            logits, tgt_emotion),  lambda = TrainConfig.loss_lambda (0.4)
with label smoothing ``ce_smoothing`` and the ignore index CHORD_PAD, the
optional TopK auxiliary pair, and the optional ``drop_loss`` branch
selection.

Mixed precision has the JAX semantics (``_maybe_bf16``,
``_maybe_bf16_batch``), by an explicit cast and not ``torch.autocast``:
the f32 master parameters and the float inputs are cast to bf16 for the
forward and backward (the cast is differentiable, so the gradients reach
the master parameters in f32), targets stay f32 and losses reduce in f32;
the optimizer's moments are f32. The step updates the state in place.

Every entry point runs on CUDA unless the caller passes ``device="cpu"``,
and raises without CUDA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch.func import functional_call

from ..core import constants as C
from ..core.config import AMTConfig, TrainConfig
from ..models.amt import VideoMusicTransformer
from ..ops.losses import bce_with_logits, combined_chord_loss
from ..weights import init_weights_
from . import metrics as M
from .optim import Adam, make_optimizer

# targets stay f32 under mixed precision — losses reduce in f32
F32_TARGET_KEYS = frozenset({
    "tgt", "tgt_root", "tgt_attr", "tgt_emotion", "tgt_emotion_prob",
    "note_density", "loudness", "instrument"})
MODEL_INPUTS = ("x", "x_root", "x_attr", "semantic", "key", "scene_offset",
                "motion", "emotion")


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
    """step: updates taken; model: the f32 master weights; optimizer: its
    moments over ``model.parameters()``; generator: every dropout's draws
    (on the model's device)."""
    step: int
    model: VideoMusicTransformer
    optimizer: Adam
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(cfg: AMTConfig, tcfg: TrainConfig, *, device=None,
                       init_steps: int = 0) -> TrainState:
    """A seeded AMT (``tcfg.seed``: weights from a CPU generator, as the
    port's ``init_weights_``), its optimizer, and a step generator seeded
    the same on ``device``."""
    dev = resolve_device(device)
    model = VideoMusicTransformer(cfg)
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


def amt_loss(logits, batch, tcfg: TrainConfig, generator=None):
    """(total, (loss_chord, loss_emotion)); with a ``generator`` the
    drop_loss selection: p < 0.6 combined, p < 0.8 chord only, else
    emotion only (one uniform draw, on the device)."""
    loss_chord = combined_chord_loss(
        logits, batch["tgt"], vocab_size=C.CHORD_SIZE,
        ignore_index=C.CHORD_PAD, label_smoothing=(tcfg.ce_smoothing or 0.0),
        auxiliary=tcfg.auxiliary_loss)
    loss_emotion = bce_with_logits(logits, batch["tgt_emotion"].float())
    lam = tcfg.loss_lambda
    combined = lam * loss_chord + (1.0 - lam) * loss_emotion
    if generator is None:
        return combined, (loss_chord, loss_emotion)
    p = torch.rand((), generator=generator, device=logits.device)
    total = torch.where(p < 0.6, combined,
                        torch.where(p < 0.8, loss_chord, loss_emotion))
    return total, (loss_chord, loss_emotion)


def _model_args(batch):
    return tuple(batch[k] for k in MODEL_INPUTS)


def make_amt_train_step(tcfg: TrainConfig, drop_loss: bool = False):
    """``train_step(state, batch) -> (state, metrics)``: one forward and
    backward (bf16 under mixed precision) and one optimizer update, in
    place. metrics: loss, loss_chord, loss_emotion (f32 scalars on the
    device) and the MoE layers' expert_counts (n, E) and maxvio (n,)."""

    def train_step(state: TrainState, batch: Dict):
        model = state.model
        params = dict(model.named_parameters())
        fwd = ({n: p.to(torch.bfloat16) for n, p in params.items()}
               if tcfg.mixed_precision else params)
        logits = functional_call(
            model, fwd, _model_args(maybe_bf16_batch(batch, tcfg)),
            {"deterministic": False, "generator": state.generator},
            strict=False)
        total, (lc, le) = amt_loss(
            logits, batch, tcfg, state.generator if drop_loss else None)
        state.optimizer.step(torch.autograd.grad(total,
                                                 list(params.values())))
        state.step += 1
        metrics = {"loss": total.detach(), "loss_chord": lc.detach(),
                   "loss_emotion": le.detach()}
        metrics.update(model.moe_metrics())
        return state, metrics

    return train_step


def make_amt_eval_step(tcfg: TrainConfig):
    """``eval_step(model, batch) -> metrics``: the f32 eval forward, the
    loss terms, accuracy, hits@1/3/5 and correspondence."""

    @torch.no_grad()
    def eval_step(model, batch: Dict):
        logits = model(*_model_args(batch))
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
