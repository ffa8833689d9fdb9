"""CogVideoX FrameINO image-to-video pipeline (counterpart of
``frameino_tpu/pipelines/cogvideox_i2v.py``).

The condition algebra is the JAX module's:

- every condition (the canvas first frame, the trajectory video, the ID
  frame) encodes through the tiled streaming VAE walk, takes a posterior
  sample and is scaled by ``scaling_factor``; the first-frame latent is
  zero-padded over time; latents are frame-first [B, F, z, h, w];
- CFG runs as batch 2 (uncond first); the ID latent is appended on the
  frame axis with zeros added to the image and trajectory streams, then
  the streams are concatenated on channels (noisy, image, trajectory ->
  48 at full width) and the ID predictions are dropped;
- the 3D RoPE tables are computed once, frame 0's block duplicated for
  the ID frame; guidance follows the dynamic (cosine-ramped) schedule;
- DDIM or DPM-Solver++ steps, the DPM x0 estimate carried through the
  loop with t_back = -1 marking the first step.

The JAX ``lax.scan`` over steps is a Python loop here. Every
``decode_mode`` takes the tiled streaming walk (JAX's default; peak memory
one chunk of one tile). JAX's "full" mode maps to it too: the segmented
full-sequence decode runs out of an 80 GB card at 480x736x49 (PERF.md);
``CogVideoXVAE.decode`` stays as the tests' reference.

Under a dp x fsdp x tp x sp ``mesh`` (``core/meshes.py``; the DiT cuts the
batch, the heads and the tokens) one process runs per rank and every rank
calls the pipeline with the same arguments, as every JAX process calls the
jitted program. The VAE encodes and decodes on the mesh's rank 0 only (the
other ranks may pass ``vae=None``); rank 0 broadcasts the condition
latents and the initial noise, every rank runs the denoise loop on the
sharded DiT, and a checksum of the final latents must agree on every
process. Rank 0 returns the video and the other ranks return None
(``output_type="latent"``: every rank returns the latents).

Not ported: ``offload_dit``/``offload_vae`` and ``vae_offload`` (sized for
a 16 GB chip), ``steps_per_program`` (a TPU watchdog workaround) and the
int8 DiT under tp > 1 or fsdp > 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from frameino_tpu_torch.core.meshes import Mesh
from frameino_tpu_torch.models import cogvideox_vae_streaming as VS
from frameino_tpu_torch.models import quant
from frameino_tpu_torch.models.cogvideox_dit import (CogVideoXDiT,
                                                     cogvideox_rope)
from frameino_tpu_torch.models.cogvideox_vae import CogVideoXVAE
from frameino_tpu_torch.ops.conv import narrow_conv_dtype
from frameino_tpu_torch.parallel.multihost import (
    assert_same_across_processes, broadcast_from_rank0)
from frameino_tpu_torch.pipelines.wan_i2v import (INT8_FSDP_NOT_PORTED,
                                                 INT8_TP_NOT_PORTED)
from frameino_tpu_torch.schedulers.cogvideox_dpm import dpm_step_pair
from frameino_tpu_torch.schedulers.ddim import (DDIMConfig,
                                                ddim_alphas_cumprod,
                                                ddim_step,
                                                inference_timesteps)


@dataclasses.dataclass(frozen=True)
class CogPipelineConfig:
    scheduler: DDIMConfig = DDIMConfig()
    scheduler_type: str = "ddim"            # 'ddim' | 'dpm'
    use_dynamic_cfg: bool = True


def dynamic_cfg_scales(guidance_scale: float, timesteps: np.ndarray,
                       num_inference_steps: int) -> np.ndarray:
    """Cosine-ramped guidance per step (the reference formula, raw
    timesteps 0..999 included)."""
    return np.array([
        1.0 + guidance_scale * (
            (1 - math.cos(math.pi * ((num_inference_steps - float(t))
                                     / num_inference_steps) ** 5.0)) / 2)
        for t in timesteps], dtype=np.float32)


def prepare_conditions(vae: CogVideoXVAE, image, traj_video, id_frame,
                       num_latent_frames: int,
                       generator: Optional[torch.Generator] = None):
    """image [B, 3, H, W], traj_video [B, 3, T, H, W] or None, id_frame
    [B, 3, H, W] or None, in [-1, 1] -> (image_latents [B, F, z, h, w]
    zero-padded after frame 0, traj_latents or None, id_latent
    [B, 1, z, h, w] or None), fp32, scaled by ``scaling_factor``. A bf16
    VAE encodes under ``conv_dtype(bf16)``, as JAX's under
    ``conv_accum_dtype``."""
    sf = vae.cfg.scaling_factor

    def enc(v):
        with narrow_conv_dtype(vae.dtype):
            z = VS.streaming_encode(vae, v, generator, scale=sf)
        return z.permute(0, 2, 1, 3, 4)

    img = enc(image[:, :, None])
    pad = torch.zeros((img.shape[0], num_latent_frames - 1, *img.shape[2:]),
                      dtype=img.dtype, device=img.device)
    image_latents = torch.cat([img, pad], dim=1)
    traj_latents = enc(traj_video) if traj_video is not None else None
    id_latent = enc(id_frame[:, :, None]) if id_frame is not None else None
    return image_latents, traj_latents, id_latent


def decode_latents(vae: CogVideoXVAE, latents):
    """Frame-first latents [B, F, z, h, w] -> video [B, 3, T, H, W] in
    [-1, 1], fp32: the tiled streaming decode, under ``conv_dtype(bf16)``
    for a bf16 VAE, as JAX's ``__call__``."""
    z = latents.permute(0, 2, 1, 3, 4) / vae.cfg.scaling_factor
    with narrow_conv_dtype(vae.dtype):
        video = VS.tiled_streaming_decode(vae, z)
    return video.float().clamp_(-1.0, 1.0)


def denoise(dit: CogVideoXDiT, sched_cfg: DDIMConfig, latents,
            image_latents, traj_latents, id_latent, context, neg_context,
            rope, timesteps: np.ndarray, timesteps_back: np.ndarray,
            guidance_scales: np.ndarray, num_inference_steps: int,
            scheduler_type: str = "ddim"):
    """CFG denoise loop over frame-first latents [B, F, z, h, w] (fp32);
    returns the final latents."""
    if scheduler_type not in ("ddim", "dpm"):
        raise ValueError(f"scheduler_type must be 'ddim' or 'dpm', got "
                         f"{scheduler_type!r}")
    B, F = latents.shape[:2]
    ac = ddim_alphas_cumprod(sched_cfg).astype(np.float32)
    context_2b = torch.cat([neg_context, context], dim=0)

    # the condition streams are constant over the loop
    img = torch.cat([image_latents, image_latents], dim=0)
    trj = (torch.cat([traj_latents, traj_latents], dim=0)
           if traj_latents is not None else None)
    idl = None
    if id_latent is not None:
        idl = torch.cat([id_latent, id_latent], dim=0)
        zpad = torch.zeros_like(idl)
        img = torch.cat([img, zpad], dim=1)
        if trj is not None:
            trj = torch.cat([trj, zpad], dim=1)
    streams = [img] + ([trj] if trj is not None else [])

    old_x0 = torch.zeros_like(latents)
    for t, t_back, g in zip(timesteps, timesteps_back, guidance_scales):
        x = torch.cat([latents, latents], dim=0)
        if idl is not None:
            x = torch.cat([x, idl], dim=1)                # frame axis
        x_in = torch.cat([x] + streams, dim=2)           # channel axis
        ts = torch.full((2 * B,), float(t), dtype=torch.float32,
                        device=latents.device)
        pred = dit(x_in, context_2b, ts, rope)[:, :F]    # drop ID frames
        uncond, cond = pred.chunk(2, dim=0)
        noise_pred = uncond + float(g) * (cond - uncond)
        if scheduler_type == "dpm":
            latents, old_x0 = dpm_step_pair(
                sched_cfg, ac, latents, noise_pred, int(t), int(t_back),
                old_x0, num_inference_steps)
        else:
            latents = ddim_step(sched_cfg, ac, latents, noise_pred, int(t),
                                num_inference_steps)
    return latents


class CogVideoXImageToVideoPipeline:
    """Masked-canvas image, trajectory video, optional ID frame and prompt
    embeddings -> video (reference ``__call__`` contract,
    ``pipeline_cogvideox_i2v_motion_FrameINO.py:604-959``).

    The DiT runs in its weights' dtype and the VAE in its own; inputs are
    moved to the DiT's device. ``quantize="int8"`` swaps the DiT's block
    matmuls for int8 w8a8 layers, in place
    (``models/quant.quantize_dit_int8``).

    ``mesh``: serve over a dp x fsdp x tp x sp process mesh (module
    docstring). The DiT must be built on it (``CogVideoXDiT(cfg, mesh=mesh)``);
    ``vae`` may be None on every rank but the mesh's rank 0.
    """

    def __init__(self, dit: CogVideoXDiT, vae: Optional[CogVideoXVAE],
                 pipe_cfg: CogPipelineConfig = CogPipelineConfig(),
                 text_encoder_fn=None, quantize: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize={quantize!r}")
        if getattr(dit, "mesh", None) != mesh:
            raise ValueError("the DiT must be built on the pipeline's mesh")
        if quantize == "int8" and mesh is not None and mesh.tp > 1:
            raise NotImplementedError(INT8_TP_NOT_PORTED)
        if quantize == "int8" and mesh is not None and mesh.fsdp > 1:
            raise NotImplementedError(INT8_FSDP_NOT_PORTED)
        if vae is None and (mesh is None or mesh.rank == 0):
            raise ValueError("the VAE is needed on the mesh's rank 0 (or "
                             "without a mesh)")
        if quantize == "int8":
            quant.quantize_dit_int8(dit)
        self.dit = dit
        self.vae = vae
        self.pipe_cfg = pipe_cfg
        self.text_encoder_fn = text_encoder_fn
        self.mesh = mesh

    @property
    def dit_cfg(self):
        return self.dit.cfg

    @property
    def vae_cfg(self):
        return self.vae.cfg

    @property
    def device(self) -> torch.device:
        return self.dit.proj_out.weight.device

    @torch.no_grad()
    def __call__(self, image, prompt_embeds=None, negative_prompt_embeds=None,
                 traj_tensor=None, id_tensor=None, height: int = 480,
                 width: int = 720, num_frames: int = 49,
                 num_inference_steps: int = 50, guidance_scale: float = 6.0,
                 generator: Optional[torch.Generator] = None, latents=None,
                 output_type: str = "np", decode_mode: str = "streaming"):
        dev = self.device
        # the VAE runs here: without a mesh, or on the mesh's rank 0
        encoder = self.mesh is None or self.mesh.rank == 0
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        if prompt_embeds is None:
            raise ValueError("need prompt_embeds: the pipeline takes the "
                             "T5 encoder's output, as JAX's does (encode "
                             "the prompt with models/t5_encoder.py)")
        prompt_embeds = prompt_embeds.to(dev, torch.float32)
        if negative_prompt_embeds is None:
            negative_prompt_embeds = torch.zeros_like(prompt_embeds)
        negative_prompt_embeds = negative_prompt_embeds.to(dev, torch.float32)

        conds = [None] * 4
        if encoder:
            conds = self._noise_and_conditions(
                image, traj_tensor, id_tensor, prompt_embeds.shape[0],
                height, width, num_frames, generator, latents)
        if self.mesh is not None:
            conds = broadcast_from_rank0(conds, dev, group=self.mesh.group)
        latents, image_latents, traj_latents, id_latent = conds
        F, _, h, w = latents.shape[1:]
        rope = cogvideox_rope(self.dit_cfg, F, h, w,
                              duplicate_first_frame_for_id=id_latent
                              is not None, device=dev)

        sched = self.pipe_cfg.scheduler
        ts = inference_timesteps(sched, num_inference_steps)
        ts_back = np.concatenate([[-1], ts[:-1]])
        if self.pipe_cfg.use_dynamic_cfg:
            g = dynamic_cfg_scales(guidance_scale, ts, num_inference_steps)
        else:
            g = np.full(len(ts), guidance_scale, np.float32)
        latents = denoise(self.dit, sched, latents, image_latents,
                          traj_latents, id_latent, prompt_embeds,
                          negative_prompt_embeds, rope, ts, ts_back, g,
                          num_inference_steps, self.pipe_cfg.scheduler_type)
        if self.mesh is not None:
            assert_same_across_processes(float(latents.double().sum()),
                                         group=self.mesh.group)
        if output_type == "latent":
            return latents
        if not encoder:
            return None
        video = decode_latents(self.vae, latents)
        return video.cpu().numpy() if output_type == "np" else video

    def _noise_and_conditions(self, image, traj_tensor, id_tensor, B: int,
                              height: int, width: int, num_frames: int,
                              generator, latents):
        """[the initial noise (``latents``, or drawn from ``generator``),
        image_latents, traj_latents or None, id_latent or None], fp32 on
        the DiT's device (the VAE's work)."""
        dev = self.device
        vae_cfg = self.vae_cfg
        F = (num_frames - 1) // vae_cfg.temporal_compression_ratio + 1
        h = height // vae_cfg.spatial_compression_ratio
        w = width // vae_cfg.spatial_compression_ratio
        shape = (B, F, vae_cfg.latent_channels, h, w)
        if latents is None:
            latents = torch.randn(shape, generator=generator,
                                  device=generator.device,
                                  dtype=torch.float32)
        latents = latents.to(dev, torch.float32)

        if traj_tensor is not None and traj_tensor.ndim == 4:
            traj_tensor = traj_tensor.permute(1, 0, 2, 3)[None]
        if id_tensor is not None:
            # [3, H, W], [B, 3, H, W] or the Wan-style [B, 3, N, H, W]
            if id_tensor.ndim == 3:
                id_tensor = id_tensor[None]
            elif id_tensor.ndim == 5:
                id_tensor = id_tensor[:, :, 0]

        def f32(x):
            return None if x is None else x.to(dev, torch.float32)

        return [latents, *prepare_conditions(
            self.vae, f32(image), f32(traj_tensor), f32(id_tensor), F,
            generator)]
