"""CogVideoX FrameINO trainer: the v-prediction train step (counterpart of
``frameino_tpu/training/cog_trainer.py``).

Reference hot loop ``train_code/train_cogvideox_motion_FrameINO.py:
995-1135``, reproduced as the JAX package does:
  1. frozen-VAE encodes: posterior SAMPLES times ``scaling_factor``,
     frame-first [B, F, z, h, w]; the masked first frame and the ID
     reference get log-normal augment noise sigma = exp(N(-3, 0.5)) before
     their encodes; the first-frame latent is zero-padded over time;
  2. uniform integer timesteps, DDIM noising;
  3. the clean ID latent appended to the NOISY stream on the frame axis,
     zero frames appended to the first-frame and trajectory streams, then
     the channel concat [noisy(+ID), first frame, trajectory];
  4. RoPE of the video grid plus a copy of the first frame's block for the
     ID tokens;
  5. the v-prediction turned into x0 = sqrt(a) noisy - sqrt(1 - a) pred,
     loss = the batch mean of the SNR-weighted MSE 1 / (1 - a) (x0_pred -
     x0)^2.

The step shares ``TrainState``, ``init_train_state``, the optimizer and
``optimizer_step`` with the Wan trainer (``training/trainer.py``). Its
random draws come from a ``torch.Generator`` seeded from (seed, step), or
from a dict of named tensors (``CogDraws``): the parity tests hand in the
draws JAX takes from ``split(fold_in(key, step), 2)`` and ``split(k_enc,
8)``. The encodes run in the encode dtype (``vae_encode_accum_dtype``, or
the compute dtype when it is None), as the Wan trainer's do.

Under a dp x fsdp x tp ``mesh`` (sp = 1; JAX's ``make_cog_train_step(
mesh=)``) the step is the Wan trainer's sharded one: each rank draws the
global batch's timesteps and noise, runs its examples
(``trainer.rank_examples``) and weights its local mean, and
``optimizer_step`` completes the gradients and the loss over the mesh. A
batch that carries its latents (``video_latents``, ``first_frame_latent``,
``traj_latents``, ``id_latent``) skips the encodes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from frameino_tpu_torch.models import cogvideox_dit
from frameino_tpu_torch.models.cogvideox_vae import (CogVideoXVAE,
                                                     sample_posterior)
from frameino_tpu_torch.ops.conv import narrow_conv_dtype
from frameino_tpu_torch.schedulers.ddim import (DDIMConfig, ddim_add_noise,
                                                ddim_alphas_cumprod)
from frameino_tpu_torch.training.optim import OptimizerConfig
from frameino_tpu_torch.training.trainer import (TrainState, optimizer_step,
                                                 rank_examples,
                                                 step_generator)

@dataclasses.dataclass(frozen=True)
class CogTrainerConfig:
    scheduler: DDIMConfig = DDIMConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    use_frame_in: bool = True
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    augment_noise: bool = True
    # the frozen-VAE encode's dtype; None follows compute_dtype
    vae_encode_accum_dtype: Optional[torch.dtype] = None

    @property
    def encode_dtype(self) -> torch.dtype:
        return self.vae_encode_accum_dtype or self.compute_dtype


class CogDraws:
    """A step's random draws by name: ``given[name]`` when the dict holds
    it, else the next draw of ``generator`` (fp32 normals, int64 integers;
    made on the generator's device, then moved)."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 given: Optional[Dict[str, torch.Tensor]] = None):
        if generator is None and given is None:
            raise ValueError("CogDraws needs a generator or given draws")
        self.generator = generator
        self.given = given or {}

    def _take(self, name, device):
        if name in self.given:
            return self.given[name].to(device)
        if self.generator is None:
            raise KeyError(f"draw {name!r} was not given")
        return None

    def normal(self, name: str, shape, device) -> torch.Tensor:
        got = self._take(name, device)
        if got is None:
            got = torch.randn(shape, generator=self.generator,
                              device=self.generator.device,
                              dtype=torch.float32).to(device)
        if tuple(got.shape) != tuple(shape):
            raise ValueError(f"draw {name!r}: shape {tuple(got.shape)}, "
                             f"expected {tuple(shape)}")
        return got.float()

    def randint(self, name: str, high: int, shape, device) -> torch.Tensor:
        got = self._take(name, device)
        if got is None:
            got = torch.randint(0, high, shape, generator=self.generator,
                                device=self.generator.device).to(device)
        return got.long()


def _augment(draws: CogDraws, tag: str, x):
    """x + N(0, 1) * sigma, sigma = exp(-3 + 0.5 N(0, 1)), one sigma per
    call (reference :462-466)."""
    n = draws.normal(f"aug_{tag}_sigma", (1,), x.device)
    sigma = torch.exp(-3.0 + 0.5 * n)
    return x + draws.normal(f"aug_{tag}_noise", x.shape, x.device) * sigma


@torch.no_grad()
def encode_training_batch(cfg: CogTrainerConfig, vae: CogVideoXVAE,
                          batch: Dict[str, torch.Tensor], draws: CogDraws):
    """Frozen-VAE encodes, frame-first latents * scaling_factor, fp32.

    batch: video_tensor / traj_tensor [B, F, 3, H, W], first_frame_tensor
    [B, 3, H, W], ID_tensor [B, 3, H, W] or [B, N, 3, H, W] (its first
    frame) or None. Returns (video, first frame zero-padded over time,
    trajectory, ID or None) latents."""
    p = next(vae.parameters())
    sf = vae.cfg.scaling_factor

    def enc(v_cf, name):
        # JAX's conv_accum_dtype(encode dtype) rule (ops/conv.conv_dtype)
        with narrow_conv_dtype(cfg.encode_dtype):
            moments = vae.encode_moments(v_cf.to(p.device), cfg.encode_dtype)
            mean_shape = (moments.shape[0], moments.shape[1] // 2,
                          *moments.shape[2:])
            z = sample_posterior(
                moments, noise=draws.normal(name, mean_shape, p.device),
                scale=sf)
        return z.permute(0, 2, 1, 3, 4)

    video_latents = enc(batch["video_tensor"].permute(0, 2, 1, 3, 4),
                        "post_video")
    traj_latents = enc(batch["traj_tensor"].permute(0, 2, 1, 3, 4),
                       "post_traj")
    first = batch["first_frame_tensor"][:, :, None].to(p.device,
                                                       torch.float32)
    if cfg.augment_noise:
        first = _augment(draws, "first", first)
    first_lat = enc(first, "post_first")                     # [B,1,z,h,w]
    pad = first_lat.new_zeros((first_lat.shape[0],
                               video_latents.shape[1] - 1,
                               *first_lat.shape[2:]))
    first_frame_latent = torch.cat([first_lat, pad], dim=1)

    id_latent = None
    if cfg.use_frame_in and batch.get("ID_tensor") is not None:
        idf = batch["ID_tensor"]
        if idf.ndim == 5:                                    # [B,N,C,H,W]
            idf = idf[:, 0]
        idf = idf[:, :, None].to(p.device, torch.float32)
        if cfg.augment_noise:
            idf = _augment(draws, "id", idf)
        id_latent = enc(idf, "post_id")                      # [B,1,z,h,w]
    return video_latents, first_frame_latent, traj_latents, id_latent


def cog_vpred_loss(model: cogvideox_dit.CogVideoXDiT, cfg: CogTrainerConfig,
                   video_latents, first_frame_latent, traj_latents,
                   id_latent, prompt_embeds, draws: CogDraws,
                   batch_size: Optional[int] = None) -> torch.Tensor:
    """The SNR-weighted x0 loss of the v-prediction (reference
    :1017-1129), a scalar fp32 tensor under autograd. The draws are the
    global batch's, of ``batch_size`` examples (the latents' count by
    default); under a mesh the latents are the global batch's or this
    rank's examples, and the value is the rank's weighted local mean
    (``trainer.wan_fm_loss``)."""
    dev = video_latents.device
    Bg = batch_size or video_latents.shape[0]
    mesh = getattr(model, "mesh", None)
    sl, weight, (video_latents, first_frame_latent, traj_latents,
                 id_latent, prompt_embeds) = rank_examples(
        model, Bg, (video_latents, first_frame_latent, traj_latents,
                    id_latent, prompt_embeds))
    B, F, _, h, w = video_latents.shape
    ac = torch.tensor(ddim_alphas_cumprod(cfg.scheduler), dtype=torch.float32,
                      device=dev)
    t = draws.randint("t", cfg.scheduler.num_train_timesteps, (Bg,), dev)[sl]
    noise = draws.normal("noise", (Bg,) + tuple(video_latents.shape[1:]),
                         dev)[sl]
    x0 = video_latents.float()
    noisy = ddim_add_noise(ac, x0, noise, t)

    if id_latent is not None:
        model_in = torch.cat([noisy, id_latent], dim=1)
        pad = torch.zeros_like(id_latent)
        ff = torch.cat([first_frame_latent, pad], dim=1)
        tj = torch.cat([traj_latents, pad], dim=1)
    else:
        model_in, ff, tj = noisy, first_frame_latent, traj_latents
    model_in = torch.cat([model_in, ff, tj], dim=2)

    rope = cogvideox_dit.cogvideox_rope(
        model.cfg, F, h, w, duplicate_first_frame_for_id=id_latent is not None,
        device=dev)
    pred = model(model_in.to(cfg.compute_dtype),
                 prompt_embeds.to(dev, cfg.compute_dtype), t.float(), rope,
                 differentiable=True, remat=cfg.remat)
    pred = pred.float()[:, :F]

    # v-output -> x0 prediction (get_velocity(model_output, noisy, t))
    a_t = ac[t].reshape(B, 1, 1, 1, 1)
    x0_pred = torch.sqrt(a_t) * noisy - torch.sqrt(1.0 - a_t) * pred
    weights = 1.0 / (1.0 - a_t)
    per_example = torch.mean(
        (weights * torch.square(x0_pred - x0)).reshape(B, -1), dim=1)
    loss = torch.mean(per_example)
    return loss if mesh is None else loss * weight


def cog_train_step(state: TrainState, vae: CogVideoXVAE,
                   cfg: CogTrainerConfig, batch: Dict[str, torch.Tensor],
                   seed: int = 0,
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   batch_size: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """One optimizer step: the encodes, loss and gradients, clip + the
    optimizer. ``draws`` replace the step generator's, by name: the
    encodes' ``post_video``, ``post_traj``, ``aug_first_sigma``,
    ``aug_first_noise``, ``post_first``, ``aug_id_sigma``,
    ``aug_id_noise``, ``post_id`` (a generator makes them in this order),
    then the loss's ``t`` and ``noise`` (the global batch's: ``batch_size``
    examples, by default the batch's own count; under a mesh the batch is
    the global one or this rank's examples). A batch with
    ``video_latents`` skips the encodes (``vae`` may be None). Returns
    {"loss", "grad_norm"} as device scalars (grad_norm before
    clipping)."""
    model = state.model
    dev = model.proj_out.weight.device
    gen = None if draws is not None else step_generator(seed, state.step, dev)
    d = CogDraws(gen, draws)
    if "video_latents" in batch:
        enc = tuple(None if batch.get(k) is None else batch[k].to(dev)
                    for k in ("video_latents", "first_frame_latent",
                              "traj_latents", "id_latent"))
    else:
        with record_function("vae_encode"):
            enc = encode_training_batch(cfg, vae, batch, d)
    return optimizer_step(state, lambda: cog_vpred_loss(
        model, cfg, *enc, batch["prompt_embeds"], d, batch_size))
