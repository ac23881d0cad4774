"""Optimizers and the LR schedule of the port (counterpart of
train/optim.py), written out so that an update is the JAX package's optax
update to the last rounding:

  * ``make_optimizer`` takes ``"adam"`` and ``"adamw"`` with betas
    (C.ADAM_BETA_1, C.ADAM_BETA_2) = (0.9, 0.98) and eps C.ADAM_EPSILON;
  * ``"adamw"`` is ``optax.adamw``: decoupled weight decay 1e-4 (optax's
    default, not torch's 1e-2; ``TrainConfig.weight_decay`` is not read,
    as in the JAX package), applied to every parameter, added to the Adam
    direction before the learning rate scales it;
  * the Noam schedule gives lr 0 at the first update (the count before the
    update is 0), and ``init_steps`` offsets it.

Moments are f32 and the update runs on f32 master weights in place. The
other optimizers of the JAX package (radam, radamw, radanw, lion) are not
ported (ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from ..core import constants as C
from ..core.config import TrainConfig
from ..ops.attention import not_ported


def noam_schedule(d_model: int, warmup_steps: int = C.SCHEDULER_WARMUP_STEPS,
                  init_steps: int = 0):
    """lr(count) = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5) with
    step = count + init_steps, in float32 as the JAX schedule computes it
    (lr 0 at count 0)."""
    inv_dim = d_model ** -0.5
    inv_warm = warmup_steps ** -1.5

    def schedule(count: int) -> float:
        step = np.float32(count) + np.float32(init_steps)
        warm = np.float32(inv_dim * inv_warm) * step
        rsqrt = np.float32(1) / np.sqrt(np.maximum(step, np.float32(1)))
        decay = np.float32(inv_dim) * rsqrt
        return float(warm if step <= warmup_steps else np.float32(decay))

    return schedule


class Adam:
    """optax.adam / optax.adamw over a list of f32 parameters: moments mu,
    nu (f32, zeros), a step count; ``step(grads)`` updates the parameters
    in place:

        mu = (1-b1) g + b1 mu;  nu = (1-b2) g*g + b2 nu
        u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        u = u + wd * p   (adamw);  p = p - lr(t-1) * u
    """

    def __init__(self, params: Iterable[torch.Tensor], lr, *,
                 b1: float = C.ADAM_BETA_1, b2: float = C.ADAM_BETA_2,
                 eps: float = C.ADAM_EPSILON, weight_decay: float = 0.0):
        self.params = list(params)
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> None:
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        # bias corrections in float32, as optax computes decay ** count
        t = np.float32(self.count)
        bc1 = float(np.float32(1) - np.power(np.float32(self.b1), t))
        bc2 = float(np.float32(1) - np.power(np.float32(self.b2), t))
        b1, b2 = self.b1, self.b2
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.float()
            mu.copy_(g * (1 - b1) + mu * b1)
            nu.copy_(g * g * (1 - b2) + nu * b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + p * self.weight_decay
            p.add_(u * -lr)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)


OPTAX_ADAMW_WEIGHT_DECAY = 1e-4


def make_optimizer(tcfg: TrainConfig, params, d_model: int,
                   init_steps: int = 0) -> Adam:
    """The optimizer of ``tcfg`` over ``params``; the Noam schedule when
    ``tcfg.lr`` is None, else the fixed lr."""
    lr = (noam_schedule(d_model, tcfg.warmup_steps, init_steps)
          if tcfg.lr is None else tcfg.lr)
    name = tcfg.optimizer.lower()
    if name == "adam":
        return Adam(params, lr)
    if name == "adamw":
        return Adam(params, lr, weight_decay=OPTAX_ADAMW_WEIGHT_DECAY)
    if name in ("radam", "radamw", "radanw", "lion"):
        raise not_ported(f"the {name!r} optimizer", "Queue 1 item 10")
    raise ValueError(f"unknown optimizer {tcfg.optimizer!r}")
