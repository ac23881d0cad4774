"""Checkpoints of the port's train state in its own ``torch.save`` format
(counterpart of train/checkpoint.py, whose orbax format needs JAX; reading
those is ROADMAP.md Queue 1 item 1).

A checkpoint is one file: the model's state dict (f32 master weights and
MoE buffers), the optimizer's moments and count, the step, and the
generator's state, so a restore resumes exactly.
"""

from __future__ import annotations

import os

import torch

from .step import TrainState


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write ``path`` (a file; its directory is made), atomically."""
    tree = {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "step": state.step,
            "generator": state.generator.get_state()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load ``path`` into ``state`` in place (tensors keep their device):
    weights, optimizer, step and generator. Returns the state."""
    tree = torch.load(path, map_location=state.device, weights_only=True)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    state.generator.set_state(tree["generator"].cpu())
    return state
