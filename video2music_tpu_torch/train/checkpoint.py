"""Checkpoints of the port's train states in its own ``torch.save`` format
(counterpart of train/checkpoint.py, whose orbax format needs JAX; a
rewriter of those into this format is ROADMAP.md Queue 1 item 1).

A checkpoint is one file: the model's state dict (f32 master weights and
MoE buffers, the MoE schedules' steps among them), the model's class and
config, the optimizer's moments and count, the step, and the generator's
state, so a restore resumes exactly. Any of the three model families
(VideoMusicTransformer, VideoRegression, MusicTransformer) saves alike.
``load_weights`` reads the weights alone (the JAX package's
``load_params``), as the pipeline does.

A sharded state (parallel/) is saved as the single-device file: its
parameters, moments and MoE buffers are gathered whole (collectively,
every rank calls) and rank 0 alone writes; a restore loads the whole
state, which the caller then cuts for whatever mesh it runs on.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import torch

from .step import TrainState

ORBAX_HINT = (
    "the port reads only its own checkpoints (train/checkpoint.py "
    "save_checkpoint, as train_amt / train_regression / "
    "train_music_transformer write them); a JAX package orbax checkpoint "
    "needs the orbax rewriter still to be written (ROADMAP.md, Queue 1 "
    "item 1)")


def save_checkpoint(path: str, state: TrainState, mesh=None,
                    plan=None) -> None:
    """Write ``path`` (a file; its directory is made), atomically. On a
    mesh, every rank calls it with the state's shard ``plan``: the shares
    are gathered and rank 0 writes the whole state."""
    model = state.model
    if mesh is None:
        weights, opt = model.state_dict(), state.optimizer.state_dict()
    else:
        from ..parallel.shard import (gather_optimizer_state,
                                      gather_state_dict)
        weights = gather_state_dict(model, plan or {}, mesh)
        opt = gather_optimizer_state(state.optimizer, model, plan or {},
                                     mesh)
        if not mesh.is_main:
            return
    tree = {"model": weights,
            "model_class": type(model).__name__,
            "config": dataclasses.asdict(model.cfg),
            "optimizer": opt, "step": state.step,
            "generator": state.generator.get_state()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def _read(path: str, map_location) -> Dict:
    if not os.path.isfile(path):
        raise ValueError(f"{path!r} is not a port checkpoint file: "
                         f"{ORBAX_HINT}")
    try:
        tree = torch.load(path, map_location=map_location, weights_only=True)
    except Exception as e:  # not a torch.save file
        raise ValueError(f"{path!r} is not a port checkpoint: {ORBAX_HINT}"
                         ) from e
    if not isinstance(tree, dict) or "model" not in tree:
        raise ValueError(f"{path!r} holds no model state: {ORBAX_HINT}")
    return tree


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load ``path`` into ``state`` in place (tensors keep their device):
    weights, optimizer, step and generator. Returns the state."""
    tree = _read(path, state.device)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    state.generator.set_state(tree["generator"].cpu())
    return state


def load_weights(path: str, model_class: str = None) -> Dict:
    """The model state dict of the checkpoint at ``path``, on the CPU.
    ``model_class`` (e.g. "VideoMusicTransformer") must match the class the
    checkpoint was written from. A path that is not a port checkpoint
    raises ValueError."""
    tree = _read(path, "cpu")
    saved = tree.get("model_class")
    if model_class is not None and saved != model_class:
        raise ValueError(f"{path!r} holds a {saved}, not a {model_class}")
    return tree["model"]
