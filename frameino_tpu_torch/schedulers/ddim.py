"""CogVideoX DDIM scheduler with v-prediction (counterpart of
``frameino_tpu/schedulers/ddim.py``; the tables are numpy copies, as that
module imports jax).

diffusers' ``CogVideoXDDIMScheduler`` as the CogVideoX-5B checkpoints
configure it: scaled-linear betas 0.00085 -> 0.012, SNR shift,
zero-terminal-SNR rescale, "trailing" timesteps, v-prediction, eta 0.
alphas_cumprod is built in float64 and used in fp32, as the JAX loop bakes
it in; the per-step scalars are fp32 on the host, the update is an fp32
tensor expression. ``ddim_add_noise`` and ``get_velocity`` are the
trainer's, on a table of fp32 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    snr_shift_scale: float = 1.0
    rescale_betas_zero_snr: bool = True
    set_alpha_to_one: bool = True
    timestep_spacing: str = "trailing"
    prediction_type: str = "v_prediction"


def ddim_alphas_cumprod(cfg: DDIMConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end,
                            cfg.num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(cfg.beta_schedule)
    ac = np.cumprod(1.0 - betas)
    ac = ac / (cfg.snr_shift_scale + (1 - cfg.snr_shift_scale) * ac)
    if cfg.rescale_betas_zero_snr:
        s = np.sqrt(ac)
        s0, sT = s[0], s[-1]
        ac = ((s - sT) * s0 / (s0 - sT)) ** 2
    return ac.astype(np.float64)


def inference_timesteps(cfg: DDIMConfig, num_inference_steps: int
                        ) -> np.ndarray:
    """Descending int64 timesteps; 'trailing': (N, N - step, ...) - 1."""
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "trailing":
        t = np.round(np.arange(n, 0, -n / num_inference_steps)) - 1
        return t.astype(np.int64)
    if cfg.timestep_spacing == "linspace":
        return np.linspace(0, n - 1, num_inference_steps)[::-1].round() \
            .astype(np.int64)
    step = n // num_inference_steps
    return (np.arange(num_inference_steps) * step).round()[::-1] \
        .astype(np.int64)


def alpha_at(cfg: DDIMConfig, ac: np.ndarray, t: int) -> np.float32:
    """alphas_cumprod[t] in fp32; t < 0 -> the final alpha (1 with
    set_alpha_to_one)."""
    if t >= 0:
        return np.float32(ac[t])
    return np.float32(1.0 if cfg.set_alpha_to_one else ac[0])


def pred_x0_and_eps(cfg: DDIMConfig, sample, model_output,
                    alpha_prod_t: np.float32):
    """Model output -> (x0, eps) in fp32."""
    one = np.float32(1.0)
    a = float(np.sqrt(alpha_prod_t))
    b = float(np.sqrt(one - alpha_prod_t))
    if cfg.prediction_type == "v_prediction":
        return a * sample - b * model_output, a * model_output + b * sample
    if cfg.prediction_type == "epsilon":
        return (sample - b * model_output) / a, model_output
    raise ValueError(cfg.prediction_type)


def ddim_step(cfg: DDIMConfig, ac: np.ndarray, sample, model_output, t: int,
              num_inference_steps: int):
    """CogVideoXDDIMScheduler.step with eta 0: prev = a_t * x + b_t * x0.
    ``ac``: the fp32 alphas_cumprod table."""
    prev_t = t - cfg.num_train_timesteps // num_inference_steps
    alpha_t = alpha_at(cfg, ac, t)
    alpha_prev = alpha_at(cfg, ac, prev_t)
    x = sample.float()
    x0, _ = pred_x0_and_eps(cfg, x, model_output.float(), alpha_t)
    one = np.float32(1.0)
    a_t = np.sqrt((one - alpha_prev) / (one - alpha_t))
    b_t = np.sqrt(alpha_prev) - np.sqrt(alpha_t) * a_t
    return (float(a_t) * x + float(b_t) * x0).to(sample.dtype)


def _coefs(ac, x0, t):
    """(sqrt(ac[t]), sqrt(1 - ac[t])) for ``ac`` an fp32 tensor table and t
    [B] int, shaped to broadcast over x0's trailing dims."""
    shape = (-1,) + (1,) * (x0.ndim - 1)
    a_t = ac[t.to(ac.device)]
    return torch.sqrt(a_t).reshape(shape), torch.sqrt(1.0 - a_t).reshape(shape)


def ddim_add_noise(ac, x0, noise, t):
    """sqrt(ac_t) x0 + sqrt(1 - ac_t) noise (the training noising)."""
    a, b = _coefs(ac, x0, t)
    return a * x0 + b * noise


def get_velocity(ac, x0, noise, t):
    """v = sqrt(ac_t) noise - sqrt(1 - ac_t) x0 (diffusers get_velocity)."""
    a, b = _coefs(ac, x0, t)
    return a * noise - b * x0
