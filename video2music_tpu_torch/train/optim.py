"""Optimizers and the LR schedule of the port (counterpart of
train/optim.py), written out so that an update is the JAX package's optax
update to the last rounding:

  * ``make_optimizer`` takes ``"adam"``, ``"adamw"``, ``"radam"``,
    ``"radamw"``, ``"radanw"`` and ``"lion"``, with betas
    (C.ADAM_BETA_1, C.ADAM_BETA_2) = (0.9, 0.98) and eps C.ADAM_EPSILON
    for the Adam family;
  * ``"adamw"`` is ``optax.adamw``: decoupled weight decay 1e-4 (optax's
    default, not torch's 1e-2; ``TrainConfig.weight_decay`` is not read,
    as in the JAX package), applied to every parameter, added to the Adam
    direction before the learning rate scales it;
  * ``"radam"`` is ``optax.radam`` (the rectified step where rho_t >= 5,
    the bias-corrected momentum alone before), ``"radamw"`` the same plus
    weight decay 0.01 added before the learning rate;
  * ``"radanw"`` is the JAX package's RAdanW: RAdam rectification plus the
    Adan gradient-difference branch, betas (0.9, 0.98, 0.92, 0.99), weight
    decay 0.01 scaled by the learning rate;
  * ``"lion"`` is ``optax.lion`` at lr / 4 (also under the Noam schedule),
    betas (0.95, 0.98), weight decay 1.0;
  * the Noam schedule gives lr 0 at the first update (the count before the
    update is 0), and ``init_steps`` offsets it.

Moments are f32 and the update runs on f32 master weights in place; the
scalars (bias corrections, the rectification) are float32 as optax
computes them.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from ..core import constants as C
from ..core.config import TrainConfig


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


def _f32(x) -> np.float32:
    return np.float32(x)


def _pow(b: float, t: int) -> float:
    """b ** t in float32 (optax's ``decay ** count``)."""
    return float(np.power(_f32(b), _f32(t)))


class _Optimizer:
    """Moment buffers (f32 zeros like each parameter, named in
    ``MOMENTS``) over a list of f32 parameters and a step count;
    ``step(grads)`` updates the parameters in place with lr(count before
    the update)."""

    MOMENTS: tuple = ()

    def __init__(self, params: Iterable[torch.Tensor], lr, *,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.lr = lr
        self.weight_decay = weight_decay
        self.count = 0
        for name in self.MOMENTS:
            setattr(self, name, [torch.zeros_like(p) for p in self.params])

    def _next_lr(self) -> float:
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        return lr

    def state_dict(self) -> Dict:
        out = {"count": self.count}
        out.update({name: getattr(self, name) for name in self.MOMENTS})
        return out

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for name in self.MOMENTS:
            for dst, src in zip(getattr(self, name), state[name]):
                dst.copy_(src)


class Adam(_Optimizer):
    """optax.adam / optax.adamw: moments mu, nu;

        mu = (1-b1) g + b1 mu;  nu = (1-b2) g*g + b2 nu
        u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        u = u + wd * p   (adamw);  p = p - lr(t-1) * u
    """

    MOMENTS = ("mu", "nu")

    def __init__(self, params, lr, *, b1: float = C.ADAM_BETA_1,
                 b2: float = C.ADAM_BETA_2, eps: float = C.ADAM_EPSILON,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay=weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps

    @torch.no_grad()
    def step(self, grads) -> None:
        lr = self._next_lr()
        # bias corrections in float32, as optax computes decay ** count
        bc1 = float(_f32(1) - _f32(_pow(self.b1, self.count)))
        bc2 = float(_f32(1) - _f32(_pow(self.b2, self.count)))
        b1, b2 = self.b1, self.b2
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.float()
            mu.copy_(g * (1 - b1) + mu * b1)
            nu.copy_(g * g * (1 - b2) + nu * b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + p * self.weight_decay
            p.add_(u * -lr)


class RAdam(_Optimizer):
    """optax.radam (and, with ``weight_decay``, the JAX package's radamw:
    scale_by_radam, add_decayed_weights, the learning rate): moments as
    Adam's; with rho_inf = 2 / (1 - b2) - 1 and rho_t = rho_inf - 2 t b2^t
    / (1 - b2^t),

        u = r * mu_hat / (sqrt(nu_hat) + eps)   where rho_t >= 5,
        u = mu_hat                              before,
        r = sqrt((rho_t-4)(rho_t-2) rho_inf / ((rho_inf-4)(rho_inf-2) rho_t))
        p = p - lr(t-1) * (u + wd * p)
    """

    MOMENTS = ("mu", "nu")

    def __init__(self, params, lr, *, b1: float = C.ADAM_BETA_1,
                 b2: float = C.ADAM_BETA_2, eps: float = C.ADAM_EPSILON,
                 weight_decay: float = 0.0, threshold: float = 5.0):
        super().__init__(params, lr, weight_decay=weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.threshold = threshold

    @torch.no_grad()
    def step(self, grads) -> None:
        lr = self._next_lr()
        t = self.count
        b1, b2 = self.b1, self.b2
        bc1 = float(_f32(1.0) - _f32(_pow(b1, t)))
        b2t = _f32(_pow(b2, t))
        bc2 = float(_f32(1.0) - b2t)
        ro_inf = _f32(2.0 / (1.0 - b2) - 1.0)
        ro = ro_inf - _f32(2) * _f32(t) * b2t / (_f32(1) - b2t)
        rect = ro >= self.threshold
        r = float(np.sqrt((ro - _f32(4)) * (ro - _f32(2)) * ro_inf
                          / ((ro_inf - _f32(4)) * (ro_inf - _f32(2)) * ro))
                  ) if rect else 0.0
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.float()
            mu.copy_(g * (1 - b1) + mu * b1)
            nu.copy_(g * g * (1 - b2) + nu * b2)
            u = mu / bc1
            if rect:
                u = r * u / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + p * self.weight_decay
            p.add_(u * -lr)


class RAdanW(_Optimizer):
    """The JAX package's ``radanw`` (train/optim.py:57-133): RAdam's
    rectified Adam term plus Adan's gradient-difference term and weight
    decay, all scaled by lr(t-1):

        m = m + (1-b1)(g - m);  v = b2 v + (1-b2) g^2
        diff = g - g_prev (0 at the first step)
        d = b3 d + (1-b3) diff;  n = b4 n + (1-b4) (g + (1-b3) diff)^2
        p += -lr wd p - lr rect adaptive m / bc1 - (1-b3) lr d / (sqrt(n)
             + eps)
    with adaptive = sqrt(bc2) / (sqrt(v) + eps) and rect the RAdam factor
    where rho_t > 5, both 1 before.
    """

    MOMENTS = ("exp_avg", "exp_avg_sq", "exp_diff", "exp_diff_sq",
               "prev_grad")

    def __init__(self, params, lr, *, betas=(C.ADAM_BETA_1, C.ADAM_BETA_2,
                                             0.92, 0.99),
                 eps: float = C.ADAM_EPSILON, weight_decay: float = 0.01):
        super().__init__(params, lr, weight_decay=weight_decay)
        self.betas, self.eps = tuple(betas), eps

    @torch.no_grad()
    def step(self, grads) -> None:
        lr = _f32(self._next_lr())
        t = self.count
        b1, b2, b3, b4 = self.betas
        step = _f32(t)
        bc1 = _f32(1.0) - _f32(_pow(b1, t))
        b2t = _f32(_pow(b2, t))
        bc2 = _f32(1.0) - b2t
        rho_inf = _f32(2.0 / (1.0 - b2) - 1.0)
        rho_t = rho_inf - _f32(2.0) * step * b2t / bc2
        rect = np.sqrt(np.abs(
            (rho_t - _f32(4)) * (rho_t - _f32(2)) * rho_inf
            / ((rho_inf - _f32(4)) * (rho_inf - _f32(2))
               * np.maximum(rho_t, _f32(1e-6)))))
        use_rect = rho_t > _f32(5.0)
        rect = float(rect) if use_rect else 1.0
        sqrt_bc2 = float(np.sqrt(bc2))
        first = t == 1
        adam_scale = float(-lr * _f32(rect))
        adan_scale = float(-_f32(1 - b3) * lr)
        decay = float(-lr * _f32(self.weight_decay))
        for (p, g, m, v, d, n, prev) in zip(
                self.params, grads, self.exp_avg, self.exp_avg_sq,
                self.exp_diff, self.exp_diff_sq, self.prev_grad):
            g = g.float()
            diff = torch.zeros_like(g) if first else g - prev
            m.copy_(m + (1 - b1) * (g - m))
            v.copy_(b2 * v + (1 - b2) * g * g)
            d.copy_(b3 * d + (1 - b3) * diff)
            n.copy_(b4 * n + (1 - b4) * (g + (1 - b3) * diff) ** 2)
            if use_rect:
                adam = adam_scale * (sqrt_bc2 / (torch.sqrt(v) + self.eps)) \
                    * (m / float(bc1))
            else:
                adam = adam_scale * (m / float(bc1))
            adan = adan_scale * d / (torch.sqrt(n) + self.eps)
            p.add_(decay * p + adam + adan)
            prev.copy_(g)


class Lion(_Optimizer):
    """optax.lion (scale_by_lion, add_decayed_weights, the learning rate):

        u = sign((1-b1) g + b1 mu) + wd * p;  mu = (1-b2) g + b2 mu
        p = p - lr(t-1) * u
    """

    MOMENTS = ("mu",)

    def __init__(self, params, lr, *, b1: float = 0.95, b2: float = 0.98,
                 weight_decay: float = 1.0):
        super().__init__(params, lr, weight_decay=weight_decay)
        self.b1, self.b2 = b1, b2

    @torch.no_grad()
    def step(self, grads) -> None:
        lr = self._next_lr()
        b1, b2 = self.b1, self.b2
        for p, g, mu in zip(self.params, grads, self.mu):
            g = g.float()
            u = torch.sign((1.0 - b1) * g + b1 * mu)
            mu.copy_((1 - b2) * g + b2 * mu)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * -lr)


OPTAX_ADAMW_WEIGHT_DECAY = 1e-4
RADAM_WEIGHT_DECAY = 0.01
LION_BETAS, LION_WEIGHT_DECAY = (0.95, 0.98), 1.0
OPTIMIZERS = ("adam", "adamw", "radam", "radamw", "radanw", "lion")


def make_optimizer(tcfg: TrainConfig, params, d_model: int,
                   init_steps: int = 0) -> _Optimizer:
    """The optimizer of ``tcfg`` over ``params``; the Noam schedule when
    ``tcfg.lr`` is None, else the fixed lr."""
    lr = (noam_schedule(d_model, tcfg.warmup_steps, init_steps)
          if tcfg.lr is None else tcfg.lr)
    name = tcfg.optimizer.lower()
    if name == "adam":
        return Adam(params, lr)
    if name == "adamw":
        return Adam(params, lr, weight_decay=OPTAX_ADAMW_WEIGHT_DECAY)
    if name == "radam":
        return RAdam(params, lr)
    if name == "radamw":
        return RAdam(params, lr, weight_decay=RADAM_WEIGHT_DECAY)
    if name == "radanw":
        return RAdanW(params, lr)
    if name == "lion":
        quarter = ((lambda c: float(np.float32(lr(c)) / np.float32(4.0)))
                   if callable(lr) else lr / 4.0)
        return Lion(params, quarter, b1=LION_BETAS[0], b2=LION_BETAS[1],
                    weight_decay=LION_WEIGHT_DECAY)
    raise ValueError(f"unknown optimizer {tcfg.optimizer!r}")
