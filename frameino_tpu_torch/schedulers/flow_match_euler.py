"""FlowMatch Euler discrete scheduler (counterpart of
``frameino_tpu/schedulers/flow_match_euler.py``).

The sigma tables are numpy copies of the JAX module's (that module imports
jax). Conventions (flow matching, x_0 = clean, x_1 = noise):
    x_sigma = (1 - sigma) * x0 + sigma * eps
    Euler step: x_next = x + (sigma_next - sigma) * v_pred
    timestep value fed to the DiT = sigma * num_train_timesteps
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerConfig:
    num_train_timesteps: int = 1000
    shift: float = 5.0
    use_dynamic_shifting: bool = False
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096


def _shift_sigmas(cfg: FlowMatchEulerConfig, sigmas: np.ndarray,
                  mu: float | None = None) -> np.ndarray:
    if cfg.use_dynamic_shifting:
        if mu is None:
            raise ValueError("dynamic shifting requires mu")
        return np.exp(mu) / (np.exp(mu) + (1 / sigmas - 1))
    return cfg.shift * sigmas / (1 + (cfg.shift - 1) * sigmas)


def dynamic_mu(cfg: FlowMatchEulerConfig, image_seq_len: int) -> float:
    """diffusers calculate_shift: linear mu(seq_len)."""
    m = (cfg.max_shift - cfg.base_shift) / (cfg.max_image_seq_len - cfg.base_image_seq_len)
    b = cfg.base_shift - m * cfg.base_image_seq_len
    return image_seq_len * m + b


def flow_match_sigmas(cfg: FlowMatchEulerConfig) -> np.ndarray:
    """Training sigma table, index i == training timestep index.

    sigmas[i] corresponds to timestep (i+1)/N shifted; descending i=0 is
    t=N (pure noise) ... matching the diffusers constructor's
    ``timesteps = linspace(1, N, N)[::-1]``.
    """
    t = np.linspace(1, cfg.num_train_timesteps, cfg.num_train_timesteps,
                    dtype=np.float64)[::-1].copy()
    sigmas = t / cfg.num_train_timesteps
    sigmas = _shift_sigmas(cfg, sigmas)
    return sigmas.astype(np.float32)


def inference_sigmas(cfg: FlowMatchEulerConfig, num_inference_steps: int,
                     mu: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(sigmas[steps+1] incl. trailing 0, timesteps[steps]).

    Matches diffusers set_timesteps: linspace from sigma_max*N down to
    sigma_min*N over `steps`, /N, shifted, with a trailing 0 sigma.
    """
    base = np.linspace(1, cfg.num_train_timesteps, cfg.num_train_timesteps,
                       dtype=np.float64)[::-1] / cfg.num_train_timesteps
    sigma_max, sigma_min = float(base[0]), float(base[-1])
    t = np.linspace(sigma_max * cfg.num_train_timesteps,
                    sigma_min * cfg.num_train_timesteps,
                    num_inference_steps, dtype=np.float64)
    sigmas = t / cfg.num_train_timesteps
    sigmas = _shift_sigmas(cfg, sigmas, mu)
    timesteps = (sigmas * cfg.num_train_timesteps).astype(np.float32)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return sigmas, timesteps


def euler_step(latents, model_output, sigma, sigma_next):
    """One FlowMatch Euler step (diffusers ``step``), fp32 math. ``sigma``
    and ``sigma_next`` are fp32 scalars; their difference is taken in fp32
    as on the JAX side."""
    dt = float(np.float32(sigma_next) - np.float32(sigma))
    out = latents.float() + dt * model_output.float()
    return out.to(latents.dtype)
