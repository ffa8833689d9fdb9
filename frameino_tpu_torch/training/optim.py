"""Optimizer and LR schedules of the trainer (counterpart of
``frameino_tpu/training/optim.py``, which builds them from optax).

``make_optimizer`` returns an ``Optimizer`` over a dict of named tensors
that does what the JAX package's optax chain does, in the same order and
in the parameters' dtype:

    MultiSteps(every k)                  # gradient_accumulation_steps > 1
      apply_if_finite(max_consecutive)   # skip_nonfinite_updates
        clip_by_global_norm(max_norm)
        the rule:
          adamw(schedule, b1, b2, eps, weight_decay)   # adam: wd 0
          adafactor(schedule)                          # optax's defaults
          contrib.prodigy(lr, (b1, b2), eps, weight_decay)

- the schedules are optax's: ``constant_with_warmup`` is
  ``linear_schedule(0, lr, warmup)``, so the first update has lr 0 (and a
  warmup of 0 steps holds lr at 0, as optax does);
- the clip is ``g * max_norm / norm`` only when ``norm >= max_norm``,
  computed as optax does, ``(g / norm) * max_norm`` in g's dtype;
- weight decay applies to every parameter (``optax.adamw`` with no mask);
- the learning rate is rounded to the parameter dtype before it scales
  the update, as ``scale_by_schedule`` does;
- adafactor is optax's chain: ``scale_by_factored_rms`` (decay 0.8, eps
  1e-30; a tensor with two dims of at least 128 keeps row and column
  statistics over its two largest dims, any other tensor a full one),
  ``clip_by_block_rms(1)``, the schedule, ``scale_by_param_block_rms``
  (1e-3), a sign flip;
- prodigy takes the configured learning rate as its multiplier (no
  schedule, as the JAX package passes it), ``estim_lr0`` 1e-6, and keeps
  four states the size of the parameters (two moments, the gradient sum
  and the initial parameters).

On shards (a ``mesh`` and the parameters' ``cuts``, as
``parallel.sharding`` lays them out; JAX runs optax on sharded arrays and
GSPMD completes every reduction) the state is made on the rank's slices
and each reduction over a whole tensor is completed over the ranks:

- the global norm (the clip's and the reported ``grad_norm``) sums the
  squares of the elements the rank owns (``Cut.owned``: a tensor
  replicated over an axis counts on that axis's first rank only) and
  all-reduces the sum over the mesh;
- adafactor's factored dims are the whole shape's; its row and column
  means and the rms of the update and of the parameter are sums
  all-reduced over the ranks that cut the reduced dims, divided by the
  whole length;
- prodigy's numerator and denominator are sums over owned elements,
  all-reduced over the mesh;
- ``apply_if_finite`` agrees on every rank (an all-reduce of the count of
  non-finite gradients), so that no rank skips alone;
- AdamW, the moments and ``MultiSteps`` are elementwise.

Reference recipe: ``train_code/train_wan_motion_FrameINO.py:401-487`` and
``config/train_wan_motion_FrameINO.yaml`` (lr 3e-5, betas (0.9, 0.999),
weight_decay 1e-4, eps 1e-10, constant_with_warmup 100, clip 1.0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

RULES = {"adamw": ("mu", "nu"), "adam": ("mu", "nu"),
         "adafactor": ("v_row", "v_col", "v"),
         "prodigy": ("exp_avg", "exp_avg_sq", "grad_sum", "params0")}


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


def _owned_sum(values, cuts, mesh) -> torch.Tensor:
    """The fp32 sum over the mesh of per-tensor fp32 sums ``values``
    ({name: scalar}), each counted on the ranks that own it."""
    total = torch.stack([v for n, v in values.items()
                         if cuts[n].owned(mesh)] or
                        [torch.zeros((), device=next(iter(
                            values.values())).device)]).sum()
    dist.all_reduce(total, group=mesh.group)
    return total


def sharded_global_norm(grads: Dict[str, torch.Tensor], cuts, mesh
                        ) -> torch.Tensor:
    """``global_norm`` of the whole tensors whose slices on this rank are
    ``grads``: every element counted once over the mesh."""
    return _owned_sum({n: torch.linalg.vector_norm(
        g, dtype=torch.float32).square() for n, g in grads.items()},
        cuts, mesh).sqrt()


class Optimizer:
    """The optax chain above over ``{name: tensor}``; ``step`` updates the
    parameters in place. ``state_dict`` / ``load_state_dict`` carry every
    counter and state tensor (for ``core/checkpoint.py``). With ``mesh``
    and ``cuts`` ({name: ``parallel.sharding.Cut``}) the tensors are the
    rank's slices and every reduction is completed over the mesh (module
    docstring)."""

    def __init__(self, cfg: OptimizerConfig, params: Dict[str, torch.Tensor],
                 cuts: Optional[dict] = None, mesh=None):
        if cfg.optimizer not in RULES:
            raise ValueError(f"unsupported optimizer {cfg.optimizer}")
        if (mesh is None) != (cuts is None):
            raise ValueError("a mesh and the parameters' cuts go together")
        self.cuts = cuts
        self.mesh = mesh
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.weight_decay = cfg.weight_decay if cfg.optimizer == "adamw" \
            else 0.0
        self.slots = RULES[cfg.optimizer]
        # each tensor's whole shape (the rank holds a slice under a mesh)
        self.shapes = {n: tuple(p.shape if cuts is None else cuts[n].shape)
                       for n, p in params.items()}
        for slot in self.slots:
            setattr(self, slot, {n: self._init_slot(slot, p, n)
                                 for n, p in params.items()})
        self.estim_lr = self.numerator_weighted = None
        if cfg.optimizer == "prodigy":
            # scalars in the lowest parameter dtype, on the parameters'
            # device
            dtype = min((p.dtype for p in params.values()),
                        key=lambda d: torch.finfo(d).bits)
            dev = next(iter(params.values())).device
            self.estim_lr = torch.tensor(PRODIGY_ESTIM_LR0, dtype=dtype,
                                         device=dev)
            self.numerator_weighted = torch.zeros((), dtype=dtype,
                                                  device=dev)
        self.count = 0               # the rule's and the schedule's count
        self.notfinite_count = 0     # apply_if_finite
        self.total_notfinite = 0
        self.mini_step = 0           # MultiSteps
        self.gradient_step = 0
        self.acc = ({n: torch.zeros_like(p) for n, p in params.items()}
                    if cfg.gradient_accumulation_steps > 1 else None)

    def _complete(self, name: str, s: torch.Tensor, dims) -> torch.Tensor:
        """A partial sum ``s`` over the param dims ``dims`` of tensor
        ``name``, completed over the ranks that cut those dims."""
        if self.mesh is None:
            return s
        c, m = self.cuts[name], self.mesh
        for d, group, n in ((c.fsdp_dim, m.fsdp_group, m.fsdp),
                            (c.tp_dim, m.tp_group, m.tp)):
            if d is not None and d in dims and n > 1:
                s = s.contiguous()
                dist.all_reduce(s, group=group)
        return s

    def _mean(self, name: str, x: torch.Tensor, dims=None,
              keepdim: bool = False, x_dims=None) -> torch.Tensor:
        """The mean of ``x`` over its dims ``x_dims`` (all when None),
        which are the param dims ``dims`` of tensor ``name``, over the
        whole tensor."""
        x_dims = dims if x_dims is None else x_dims
        if self.mesh is None:
            return (x.mean() if x_dims is None
                    else x.mean(x_dims, keepdim=keepdim))
        shape = self.shapes[name]
        pdims = tuple(range(len(shape))) if dims is None else tuple(dims)
        s = x.sum() if x_dims is None else x.sum(x_dims, keepdim=keepdim)
        return self._complete(name, s, pdims) / math.prod(
            shape[d] for d in pdims)

    def slot_cut(self, slot: str, name: str):
        """How state tensor ``slot`` of parameter ``name`` is laid out over
        the mesh (a ``parallel.sharding.Cut``): the parameter's, or for
        adafactor's factored rows and columns the parameter's without the
        reduced dim; an empty placeholder is whole."""
        from frameino_tpu_torch.parallel.sharding import Cut
        c = self.cuts[name]
        t = getattr(self, slot)[name]
        if t.numel() == 0:
            return Cut(tuple(t.shape))
        if slot in ("v_row", "v_col"):
            d1, d0 = factored_dims(c.shape)
            drop = d0 if slot == "v_row" else d1

            def keep(d):
                return None if d is None or d == drop else d - (d > drop)
            return Cut(tuple(n for i, n in enumerate(c.shape) if i != drop),
                       keep(c.tp_dim), keep(c.fsdp_dim))
        return c

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradients (fp32 device scalar)."""
        if self.mesh is None:
            return global_norm(grads.values())
        return sharded_global_norm(grads, self.cuts, self.mesh)

    def _init_slot(self, slot: str, p: torch.Tensor,
                   name: str) -> torch.Tensor:
        if slot == "params0":
            return p.detach().clone()
        if slot in ("v_row", "v_col", "v"):
            dims = factored_dims(self.shapes[name])
            if slot == "v":
                return torch.zeros_like(p) if dims is None else \
                    p.new_zeros(0)
            if dims is None:
                return p.new_zeros(0)
            d1, d0 = dims
            drop = d0 if slot == "v_row" else d1
            return p.new_zeros([n for i, n in enumerate(p.shape)
                                if i != drop])
        return torch.zeros_like(p)

    def lr(self) -> float:
        """The learning rate of the next update (prodigy: its multiplier)."""
        if self.cfg.optimizer == "prodigy":
            return self.cfg.learning_rate
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
        if self.cfg.skip_nonfinite_updates:
            bad = torch.stack([~torch.isfinite(g).all()
                               for g in grads.values()]).sum().float()
            if self.mesh is not None:
                # every rank skips, or none
                dist.all_reduce(bad, group=self.mesh.group)
            finite = bool(bad == 0)
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += 0 if finite else 1
            if not finite and (self.notfinite_count
                               <= self.cfg.max_consecutive_nonfinite):
                return False
        clip = self._clip(grads)
        if self.cfg.optimizer == "adafactor":
            self._adafactor(params, grads, clip)
        elif self.cfg.optimizer == "prodigy":
            self._prodigy(params, grads, clip)
        else:
            self._adamw(params, grads, clip)
        self.count += 1
        return True

    def _clip(self, grads):
        """clip_by_global_norm, applied to one gradient at a time."""
        max_norm = self.cfg.max_grad_norm
        g_norm = self.global_norm(grads)
        keep = g_norm < max_norm

        def clip(g):
            return torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm)
        return clip

    def _adamw(self, params, grads, clip):
        cfg = self.cfg
        b1, b2 = cfg.beta1, cfg.beta2
        count_inc = self.count + 1
        # 1 - decay**count in fp32, then in each moment's dtype
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count_inc))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count_inc))
        lr = -self.schedule(self.count)
        wd = self.weight_decay
        for name, p in params.items():
            g = clip(grads[name])
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

    def _adafactor(self, params, grads, clip):
        t = np.float32(self.count + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-ADAFACTOR_DECAY))
        keep = float(np.float32(1.0) - np.float32(decay))
        lr = self.schedule(self.count)
        for name, p in params.items():
            g = clip(grads[name])
            g2 = g * g + ADAFACTOR_EPS
            dims = factored_dims(self.shapes[name])
            if dims is not None:
                d1, d0 = dims
                v_row = (decay * self.v_row[name]
                         + keep * self._mean(name, g2, (d0,)))
                v_col = (decay * self.v_col[name]
                         + keep * self._mean(name, g2, (d1,)))
                self.v_row[name].copy_(v_row)
                self.v_col[name].copy_(v_col)
                reduced = d1 - 1 if d1 > d0 else d1
                row = (v_row / self._mean(name, v_row, (d1,), keepdim=True,
                                          x_dims=(reduced,))) ** -0.5
                u = g * row.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            else:
                v = decay * self.v[name] + keep * g2
                self.v[name].copy_(v)
                u = g * v ** -0.5
            rms_u = torch.sqrt(self._mean(name, u * u))
            u = u / torch.clamp(rms_u / ADAFACTOR_CLIP, min=1.0)
            u = torch.tensor(lr, dtype=u.dtype) * u
            u = u * _at_least(torch.sqrt(self._mean(name, p * p)),
                              ADAFACTOR_MIN_SCALE)
            p.copy_(p + -u)

    def _prodigy(self, params, grads, clip):
        cfg = self.cfg
        b1, b2 = cfg.beta1, cfg.beta2
        b3 = b2 ** 0.5
        count_inc = np.float32(self.count + 1)
        bc = float(np.sqrt(np.float32(1) - np.float32(b2) ** count_inc)
                   / (np.float32(1) - np.float32(b1) ** count_inc))
        estim_lr = self.estim_lr
        dlr = (estim_lr * cfg.learning_rate * bc).to(estim_lr.dtype)
        numerator = torch.zeros((), dtype=torch.float32,
                                device=estim_lr.device)
        denominator = torch.zeros_like(numerator)
        nums, dens = {}, {}
        for name, p in params.items():
            g = clip(grads[name])
            nums[name] = torch.sum((g * (self.params0[name] - p)).float())
            dg = estim_lr * g
            self.exp_avg[name].mul_(b1).add_((1 - b1) * dg)
            self.exp_avg_sq[name].mul_(b2).add_((1 - b2) * dg * dg)
            s = self.grad_sum[name]
            s.copy_(b3 * s + dlr * dg / PRODIGY_ESTIM_LR0)
            dens[name] = s.abs().float().sum()
        if self.mesh is None:
            for name in params:
                numerator += nums[name]
                denominator += dens[name]
        else:
            numerator = _owned_sum(nums, self.cuts, self.mesh)
            denominator = _owned_sum(dens, self.cuts, self.mesh)
        self.numerator_weighted = (
            b3 * self.numerator_weighted
            + (estim_lr / PRODIGY_ESTIM_LR0) * dlr * numerator
        ).to(estim_lr.dtype)
        estimate = self.numerator_weighted / denominator
        self.estim_lr = torch.maximum(estim_lr, estimate.to(estim_lr.dtype))
        wd = cfg.weight_decay
        for name, p in params.items():
            u = -wd * dlr * p - dlr * self.exp_avg[name] / (
                torch.sqrt(self.exp_avg_sq[name]) + self.estim_lr * cfg.epsilon)
            p.copy_(p + u)

    def state_dict(self) -> dict:
        sd = {"rule": self.cfg.optimizer, "count": self.count,
              "notfinite_count": self.notfinite_count,
              "total_notfinite": self.total_notfinite,
              "mini_step": self.mini_step,
              "gradient_step": self.gradient_step}
        for slot in self.slots:
            sd[slot] = getattr(self, slot)
        if self.estim_lr is not None:
            sd["estim_lr"] = self.estim_lr
            sd["numerator_weighted"] = self.numerator_weighted
        if self.acc is not None:
            sd["acc"] = self.acc
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        rule = sd.get("rule", "adamw")        # states saved before rules
        if RULES[rule] != self.slots:
            raise ValueError(f"the optimizer state is {rule!r}'s, not "
                             f"{self.cfg.optimizer!r}'s")
        for key in ("count", "notfinite_count", "total_notfinite",
                    "mini_step", "gradient_step"):
            setattr(self, key, int(sd[key]))
        for key in (*self.slots, "acc"):
            mine = getattr(self, key)
            if mine is None:
                continue
            for name, t in mine.items():
                t.copy_(sd[key][name])
        if self.estim_lr is not None:
            self.estim_lr = sd["estim_lr"].to(self.estim_lr.dtype).clone()
            self.numerator_weighted = sd["numerator_weighted"].to(
                self.numerator_weighted.dtype).clone()


# optax.adafactor's defaults, as the JAX package calls it
ADAFACTOR_DECAY, ADAFACTOR_EPS, ADAFACTOR_CLIP = 0.8, 1e-30, 1.0
ADAFACTOR_MIN_DIM, ADAFACTOR_MIN_SCALE = 128, 1e-3
# optax.contrib.prodigy's
PRODIGY_ESTIM_LR0 = 1e-6


def factored_dims(shape):
    """(second largest dim, largest dim) when both are at least
    ADAFACTOR_MIN_DIM, else None (optax's ``_factored_dims``)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _at_least(rms, min_rms: float):
    """max(rms, min_rms), as optax's ``safe_root_mean_squares``."""
    return torch.where(rms <= min_rms, torch.tensor(min_rms, dtype=rms.dtype,
                                                    device=rms.device), rms)


def make_optimizer(cfg: OptimizerConfig, params: Dict[str, torch.Tensor],
                   cuts: Optional[dict] = None, mesh=None) -> Optimizer:
    return Optimizer(cfg, params, cuts, mesh)
