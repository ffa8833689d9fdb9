"""Optimizer and LR schedules of the trainer (counterpart of
``frameino_tpu/training/optim.py``, which builds them from optax).

``make_optimizer`` returns an ``Optimizer`` over a dict of named tensors
that does what the JAX package's optax chain does, in the same order and
in the parameters' dtype:

    MultiSteps(every k)                  # gradient_accumulation_steps > 1
      apply_if_finite(max_consecutive)   # skip_nonfinite_updates
        clip_by_global_norm(max_norm)
        adamw(schedule, b1, b2, eps, weight_decay)   # adam: wd 0

- the schedules are optax's: ``constant_with_warmup`` is
  ``linear_schedule(0, lr, warmup)``, so the first update has lr 0 (and a
  warmup of 0 steps holds lr at 0, as optax does);
- the clip is ``g * max_norm / norm`` only when ``norm >= max_norm``,
  computed as optax does, ``(g / norm) * max_norm`` in g's dtype;
- weight decay applies to every parameter (``optax.adamw`` with no mask);
- the learning rate is rounded to the parameter dtype before it scales
  the update, as ``scale_by_schedule`` does.

Reference recipe: ``train_code/train_wan_motion_FrameINO.py:401-487`` and
``config/train_wan_motion_FrameINO.yaml`` (lr 3e-5, betas (0.9, 0.999),
weight_decay 1e-4, eps 1e-10, constant_with_warmup 100, clip 1.0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

NOT_PORTED = ("optimizer {!r} is not ported yet: adafactor and prodigy are "
              "ROADMAP.md queue 1, item 6")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer: str = "adamw"
    learning_rate: float = 3e-5
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 1e-4
    epsilon: float = 1e-10
    lr_scheduler: str = "constant_with_warmup"
    lr_warmup_steps: int = 100
    max_train_steps: int = 10000
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    skip_nonfinite_updates: bool = False
    max_consecutive_nonfinite: int = 10


def _linear(init: float, end: float, steps: int):
    if steps <= 0:
        return lambda count: init

    def sched(count):
        frac = 1.0 - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))
    return sched


def make_schedule(cfg: OptimizerConfig):
    """count (updates applied so far) -> learning rate, as optax's."""
    lr, warmup = cfg.learning_rate, cfg.lr_warmup_steps
    if cfg.lr_scheduler == "constant_with_warmup":
        return _linear(0.0, lr, warmup)
    if cfg.lr_scheduler == "constant":
        return lambda count: lr
    if cfg.lr_scheduler == "cosine":
        decay = cfg.max_train_steps - warmup
        if decay <= 0:
            raise ValueError("cosine needs max_train_steps > lr_warmup_steps")
        warm = _linear(0.0, lr, warmup)

        def sched(count):
            if count < warmup:
                return warm(count)
            c = min(float(count - warmup), float(decay))
            return float(np.float32(lr) * np.float32(
                0.5 * (1 + math.cos(math.pi * c / decay))))
        return sched
    raise ValueError(cfg.lr_scheduler)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (a device
    scalar; ``optax.global_norm``)."""
    tensors = list(tensors)
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32).square()
          for t in tensors]
    return torch.stack(sq).sum().sqrt()


class Optimizer:
    """The optax chain above over ``{name: tensor}``; ``step`` updates the
    parameters in place. ``state_dict`` / ``load_state_dict`` carry every
    counter and moment (for ``core/checkpoint.py``)."""

    def __init__(self, cfg: OptimizerConfig, params: Dict[str, torch.Tensor]):
        if cfg.optimizer not in ("adamw", "adam"):
            if cfg.optimizer in ("adafactor", "prodigy"):
                raise NotImplementedError(NOT_PORTED.format(cfg.optimizer))
            raise ValueError(f"unsupported optimizer {cfg.optimizer}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.weight_decay = cfg.weight_decay if cfg.optimizer == "adamw" \
            else 0.0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0               # adam and schedule count
        self.notfinite_count = 0     # apply_if_finite
        self.total_notfinite = 0
        self.mini_step = 0           # MultiSteps
        self.gradient_step = 0
        self.acc = ({n: torch.zeros_like(p) for n, p in params.items()}
                    if cfg.gradient_accumulation_steps > 1 else None)

    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> bool:
        """One optax ``update`` + ``apply_updates``; returns whether the
        parameters changed."""
        k = self.cfg.gradient_accumulation_steps
        if k > 1:
            n = self.mini_step
            for name, g in grads.items():
                acc = self.acc[name]
                acc.copy_(acc + (g - acc) / (n + 1))
            self.mini_step = (n + 1) % k
            if n != k - 1:
                return False
            self.gradient_step += 1
            grads = self.acc
        applied = self._guarded_update(params, grads)
        if k > 1:
            for acc in self.acc.values():
                acc.zero_()
        return applied

    def _guarded_update(self, params, grads) -> bool:
        if not self.cfg.skip_nonfinite_updates:
            self._clipped_adamw(params, grads)
            return True
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in grads.values()]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += 0 if finite else 1
        if finite or self.notfinite_count > self.cfg.max_consecutive_nonfinite:
            self._clipped_adamw(params, grads)
            return True
        return False

    def _clipped_adamw(self, params, grads):
        cfg = self.cfg
        b1, b2 = cfg.beta1, cfg.beta2
        g_norm = global_norm(grads.values())
        keep = g_norm < cfg.max_grad_norm
        count_inc = self.count + 1
        # 1 - decay**count in fp32, then in each moment's dtype
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count_inc))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count_inc))
        lr = -self.schedule(self.count)
        wd = self.weight_decay
        for name, p in params.items():
            g = grads[name]
            g = torch.where(keep, g,
                            (g / g_norm.to(g.dtype)) * cfg.max_grad_norm)
            mu = (1 - b1) * g + b1 * self.mu[name]
            nu = (1 - b2) * g ** 2 + b2 * self.nu[name]
            self.mu[name].copy_(mu)
            self.nu[name].copy_(nu)
            mu_hat = mu / torch.tensor(bc1, dtype=mu.dtype)
            nu_hat = nu / torch.tensor(bc2, dtype=nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + cfg.epsilon)
            if wd:
                u = u + wd * p
            u = torch.tensor(lr, dtype=u.dtype) * u
            p.copy_(p + u)
        self.count = count_inc

    def state_dict(self) -> dict:
        sd = {"count": self.count, "notfinite_count": self.notfinite_count,
              "total_notfinite": self.total_notfinite,
              "mini_step": self.mini_step,
              "gradient_step": self.gradient_step,
              "mu": self.mu, "nu": self.nu}
        if self.acc is not None:
            sd["acc"] = self.acc
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        for key in ("count", "notfinite_count", "total_notfinite",
                    "mini_step", "gradient_step"):
            setattr(self, key, int(sd[key]))
        for key in ("mu", "nu", "acc"):
            mine = getattr(self, key)
            if mine is None:
                continue
            for name, t in mine.items():
                t.copy_(sd[key][name])


def make_optimizer(cfg: OptimizerConfig,
                   params: Dict[str, torch.Tensor]) -> Optimizer:
    return Optimizer(cfg, params)
