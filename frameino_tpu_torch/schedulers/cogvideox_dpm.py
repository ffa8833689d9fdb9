"""CogVideoX DPM-Solver++(2M) step with v-prediction (counterpart of
``frameino_tpu/schedulers/cogvideox_dpm.py``).

diffusers' ``CogVideoXDPMScheduler``, deterministic path (eta 0): the
previous step's x0 estimate is carried through the loop, a negative
``t_back`` marks the first step (first order). It shares the
alphas_cumprod table of ``schedulers/ddim.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from frameino_tpu_torch.schedulers.ddim import (DDIMConfig, alpha_at,
                                                pred_x0_and_eps)


def _lamb(alpha_prod: np.float32) -> np.float32:
    with np.errstate(divide="ignore"):
        return np.log(np.sqrt(alpha_prod)
                      / np.sqrt(np.float32(1.0) - alpha_prod))


def dpm_step_pair(cfg: DDIMConfig, ac: np.ndarray, sample, model_output,
                  t: int, t_back: Optional[int], old_x0,
                  num_inference_steps: int):
    """One DPM-Solver++(2M) step. Returns (prev_sample, x0_estimate).
    Second order only with a previous estimate (``t_back`` >= 0) and not
    on the final step; the final step's first-order update returns x0."""
    one = np.float32(1.0)
    x = sample.float()
    prev_t = t - cfg.num_train_timesteps // num_inference_steps
    alpha_t = alpha_at(cfg, ac, t)
    alpha_prev = alpha_at(cfg, ac, prev_t)
    x0, _ = pred_x0_and_eps(cfg, x, model_output.float(), alpha_t)
    lam = _lamb(alpha_t)
    h = _lamb(alpha_prev) - lam
    mult0 = np.sqrt(one - alpha_prev) / np.sqrt(one - alpha_t)
    mult1 = np.sqrt(alpha_prev) * np.expm1(-h)
    denoised = x0
    if (t_back is not None and old_x0 is not None and t_back >= 0
            and prev_t >= 0):
        r = (lam - _lamb(alpha_at(cfg, ac, t_back))) / h
        c = one / (np.float32(2.0) * (r if r != 0 else one))
        denoised = float(one + c) * x0 - float(c) * old_x0.float()
    prev = float(mult0) * x - float(mult1) * denoised
    return prev.to(sample.dtype), x0
