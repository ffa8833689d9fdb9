"""Wan image-to-video pipelines, the Wan2.2 FrameINO expand path and the
Wan2.1 I2V path (counterpart of ``frameino_tpu/pipelines/wan_i2v.py``).

The Wan2.2 condition algebra (``expand_timesteps``, the default) is the
JAX module's: VAE condition encodes of the canvas first frame, the
trajectory video and each ID frame; per-step blend of the clean
first-frame condition; per-token timesteps with two values (0 on the
condition frame, t elsewhere) passed as a mask; ID latents appended on the
frame axis and trajectory latents on channels; ID predictions dropped;
final re-blend. The JAX ``lax.scan`` over steps is a Python loop here,
with the text K/V computed once per segment.

Wan2.1 (``expand_timesteps=False``): the clip [image, zeros] (or [image,
zeros, last_image]) is encoded whole and concatenated on channels with a
temporal condition mask (``prepare_conditions_wan21``); the DiT takes
scalar timesteps and, with an ``image_encoder`` (the CLIP tower of
``models/clip_vision.py``), the image's CLIP states through its image-KV
branch, the text and image K/V computed once per segment
(``denoise_segment_wan21``). Its encodes walk the clip in 8-frame chunks
(``streaming_encode_moments``, equal to the full-sequence encode that JAX
runs): the full form of an 81-frame 480x832 clip holds 12 GB fp32
tensors. The two-expert and ID-frame paths are the expand path's only.

Under a dp x fsdp x tp x sp ``mesh`` (``core/meshes.py``; the DiT cuts the
batch, the heads and the tokens) one process runs per rank
and every rank calls the pipeline with the same arguments, as every JAX
process calls the jitted program. The VAE encodes and decodes on the
mesh's rank 0 only (the other ranks may pass ``vae=None``), as JAX's
single controller runs it once; rank 0 broadcasts the condition latents
and the initial noise; the denoise loop runs the sharded DiTs on every
rank, and a checksum of the final latents must agree on every process.
Rank 0 returns the video and the other ranks return None
(``output_type="latent"``: every rank returns the latents).

The decode modes are the JAX pipeline's: "full" (``WanVAE.decode``),
"streaming", "tiled" and "hybrid" (``models/wan_vae_streaming.py``,
``models/wan_vae_tiling.py``); the server asks for "hybrid" as JAX's does.

Not ported: the int8 DiT under tp > 1 or fsdp > 1 and the Wan2.1 path under
a mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from frameino_tpu_torch.core.meshes import Mesh
from frameino_tpu_torch.models import quant, wan_vae
from frameino_tpu_torch.models.wan_dit import WanDiT
from frameino_tpu_torch.models.wan_vae_streaming import (
    streaming_decode, streaming_encode_moments)
from frameino_tpu_torch.models.wan_vae_tiling import (hybrid_decode,
                                                      hybrid_encode,
                                                      tiled_decode)
from frameino_tpu_torch.parallel.multihost import (
    assert_same_across_processes, broadcast_from_rank0)
from frameino_tpu_torch.schedulers.flow_match_euler import (
    FlowMatchEulerConfig, euler_step, inference_sigmas)

DECODE_MODES = ("full", "streaming", "tiled", "hybrid")
INT8_TP_NOT_PORTED = (
    "quantize='int8' under tp > 1 is not ported: the row-parallel layers' "
    "activation quantizer needs the row amax all-reduced over tp before "
    "K7 (ROADMAP.md queue 1, item 12.5)")
INT8_FSDP_NOT_PORTED = (
    "quantize='int8' under fsdp > 1 is not ported: the weight quantizer "
    "takes whole weights (ROADMAP.md queue 1, item 12.5)")
WAN21_MESH_NOT_PORTED = (
    "the Wan2.1 path (expand_timesteps=False) under a mesh is not ported "
    "(ROADMAP.md queue 1, item 12.7)")
# pixel frames a step of the Wan2.1 condition encodes (1, then this many)
WAN21_ENCODE_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class WanPipelineConfig:
    expand_timesteps: bool = True          # Wan2.2 TI2V path
    boundary_ratio: Optional[float] = None
    scheduler: FlowMatchEulerConfig = FlowMatchEulerConfig()


def latent_shape(vae_cfg: wan_vae.WanVAEConfig, batch: int, num_frames: int,
                 height: int, width: int) -> Tuple[int, ...]:
    f = (num_frames - 1) // vae_cfg.scale_factor_temporal + 1
    return (batch, vae_cfg.z_dim, f,
            height // vae_cfg.scale_factor_spatial,
            width // vae_cfg.scale_factor_spatial)


def round_num_frames(num_frames: int, temporal: int = 4) -> int:
    """Frame rounding to 4N+1 (reference ``:707-712``)."""
    if num_frames % temporal != 1:
        num_frames = num_frames // temporal * temporal + 1
    return max(num_frames, 1)


def prepare_conditions(vae: wan_vae.WanVAE, image, traj_video, id_frames):
    """VAE-encode the FrameINO conditions (posterior mode), normalized.

    image [B, 3, H, W] in [-1, 1]; traj_video [B, 3, T, H, W] or None;
    id_frames [B, 3, N, H, W] or None. Returns (condition [B, z, 1, h, w],
    traj_latents [B, z, f(+N), h, w] or None, id_latents [B, z, N, h, w]
    or None). A trajectory clip of more than 9 frames at 256 x 256 or
    more takes the hybrid encode (tiles of 256 px at a stride of 192, each
    streamed 16 frames at a time), as the JAX package's does: its blended
    seams differ from the full-sequence encode.
    """
    cfg = vae.cfg

    def enc(v):
        return wan_vae.normalize_latents(cfg, vae.encode(v))

    def enc_clip(v):
        T, Hp, Wp = v.shape[2:]
        if T <= 9 or Hp < 256 or Wp < 256:
            return enc(v)
        moments = hybrid_encode(vae, v, tile_min=256, tile_stride=192,
                                chunk_pixel_frames=16)
        return wan_vae.normalize_latents(cfg, moments[:, :cfg.z_dim])

    condition = enc(image[:, :, None])
    traj_latents = enc_clip(traj_video) if traj_video is not None else None
    id_latents = None
    if id_frames is not None and id_frames.shape[2] > 0:
        # each ID frame is encoded as its own single-frame clip
        id_latents = torch.cat([enc(id_frames[:, :, i:i + 1])
                                for i in range(id_frames.shape[2])], dim=2)
        if traj_latents is not None:
            traj_latents = torch.cat(
                [traj_latents, torch.zeros_like(id_latents)], dim=2)
    return condition, traj_latents, id_latents


def prepare_conditions_wan21(vae: wan_vae.WanVAE, image, num_frames: int,
                             traj_video=None, last_image=None):
    """Wan2.1 I2V conditioning: encode [image, zeros x (F - 1)] (or [image,
    zeros x (F - 2), last_image]) as one clip, then concatenate on channels
    the temporal condition mask: 1 on the given frames, frame 0 repeated
    into the VAE's temporal stride, so ``scale_factor_temporal`` mask
    channels a latent frame.

    image / last_image [B, 3, H, W] in [-1, 1]; traj_video [B, 3, T, H, W]
    or None. Returns (condition [B, tscale + z, f, h, w], traj_latents
    [B, z, f', h, w] or None), posterior mode, normalized."""
    cfg = vae.cfg
    B, C, H, W = image.shape
    tscale = cfg.scale_factor_temporal

    def enc(v):
        moments = streaming_encode_moments(
            vae, v, chunk_pixel_frames=WAN21_ENCODE_CHUNK)
        return wan_vae.normalize_latents(cfg, moments[:, :cfg.z_dim])

    n_zero = num_frames - (1 if last_image is None else 2)
    frames = [image[:, :, None], image.new_zeros((B, C, n_zero, H, W))]
    if last_image is not None:
        frames.append(last_image[:, :, None])
    latent_condition = enc(torch.cat(frames, dim=2))
    lh, lw = latent_condition.shape[3:]

    mask = torch.ones((B, 1, num_frames, lh, lw), dtype=torch.float32,
                      device=image.device)
    mask[:, :, 1:None if last_image is None else -1] = 0.0
    mask = torch.cat([mask[:, :, :1].repeat_interleave(tscale, dim=2),
                      mask[:, :, 1:]], dim=2)
    mask = mask.reshape(B, -1, tscale, lh, lw).transpose(1, 2)
    condition = torch.cat([mask, latent_condition], dim=1)
    traj_latents = enc(traj_video) if traj_video is not None else None
    return condition, traj_latents


def denoise_segment_wan21(dit: WanDiT, latents, condition, traj_latents,
                          context_2b, image_embeds, sigmas: np.ndarray,
                          sigmas_next: np.ndarray, timesteps: np.ndarray,
                          guidance_scale: float):
    """Wan2.1 denoise: channel-concatenated conditions, scalar timesteps,
    batch-stacked CFG (the image embeds for both halves), the text and
    image K/V projected once for the segment, Euler steps.

    latents [B, z, f, h, w] fp32; context_2b [2B, L, text_dim] (cond;
    uncond); image_embeds [B, 257, image_dim] or None."""
    B = latents.shape[0]
    do_cfg = guidance_scale > 1.0
    if do_cfg:
        img2 = None if image_embeds is None else torch.cat(
            [image_embeds, image_embeds], dim=0)
        kv = dit.precompute_text_kv(context_2b, img2)
    else:
        kv = dit.precompute_text_kv(context_2b[:B], image_embeds)
    for sigma, sigma_next, t in zip(sigmas, sigmas_next, timesteps):
        latent_in = torch.cat([latents, condition], dim=1)
        if traj_latents is not None:
            latent_in = torch.cat([latent_in, traj_latents], dim=1)
        t_b = torch.full((B,), float(t), dtype=torch.float32,
                         device=latents.device)
        if do_cfg:
            pred = dit(torch.cat([latent_in, latent_in], dim=0),
                       torch.cat([t_b, t_b], dim=0), text_kv=kv)
            pred_cond, pred_uncond = pred.chunk(2, dim=0)
            noise_pred = pred_uncond + guidance_scale * (pred_cond
                                                         - pred_uncond)
        else:
            noise_pred = dit(latent_in, t_b, text_kv=kv)
        latents = euler_step(latents, noise_pred, sigma, sigma_next)
    return latents


def build_first_frame_mask(num_latent_frames: int, latent_h: int,
                           latent_w: int, device=None):
    """[1, 1, F, h, w]: 0 on frame 0 (clean condition), 1 elsewhere."""
    mask = torch.ones((1, 1, num_latent_frames, latent_h, latent_w),
                      dtype=torch.float32, device=device)
    mask[:, :, 0] = 0.0
    return mask


def _per_token_timesteps(mask_adjust, t, patch_hw: int = 2):
    """(mask[0,0][:, ::p, ::p] * t).flatten() (reference ``:832-843``)."""
    return (mask_adjust[0, 0][:, ::patch_hw, ::patch_hw] * t).reshape(-1)


def denoise_segment(dit: WanDiT, latents, condition, traj_latents,
                    id_latents, first_frame_mask, context_2b,
                    sigmas: np.ndarray, sigmas_next: np.ndarray,
                    timesteps: np.ndarray, guidance_scale: float,
                    cfg_sequential: bool = False):
    """Run one expert over its timestep segment.

    latents [B, z, F, h, w] fp32; context_2b [2B, L, text_dim] (cond;
    uncond); sigmas/sigmas_next/timesteps: fp32 numpy arrays of this
    segment. ``cfg_sequential`` runs cond and uncond as two batch-B
    forwards instead of one batch-2B forward (half the activations).
    """
    B = latents.shape[0]
    num_gen_frames = latents.shape[2]
    lat_h, lat_w = latents.shape[3], latents.shape[4]
    do_cfg = guidance_scale > 1.0
    dev = latents.device

    mask_adjust = first_frame_mask
    if id_latents is not None:
        id_pad = torch.ones((1, 1, id_latents.shape[2], lat_h, lat_w),
                            dtype=torch.float32, device=dev)
        mask_adjust = torch.cat([first_frame_mask, id_pad], dim=2)
    ts_mask = _per_token_timesteps(mask_adjust, 1.0,
                                   patch_hw=dit.cfg.patch_size[1])
    ts_mask_b = ts_mask[None].expand(B, -1)

    # text K/V are constant over the segment: project them once
    if do_cfg:
        kv = dit.precompute_text_kv(context_2b)
        if cfg_sequential:
            kv_cond = [(k[:B], v[:B]) for k, v in kv]
            kv_uncond = [(k[B:], v[B:]) for k, v in kv]
    else:
        kv = dit.precompute_text_kv(context_2b[:B])

    for sigma, sigma_next, t in zip(sigmas, sigmas_next, timesteps):
        latent_in = (1.0 - first_frame_mask) * condition \
            + first_frame_mask * latents
        if id_latents is not None:
            latent_in = torch.cat([latent_in, id_latents], dim=2)
        if traj_latents is not None:
            latent_in = torch.cat([latent_in, traj_latents], dim=1)
        t_b = torch.full((B,), float(t), dtype=torch.float32, device=dev)

        if do_cfg and cfg_sequential:
            pred_cond = dit(latent_in, t_b, timestep_mask=ts_mask_b,
                            text_kv=kv_cond)
            pred_uncond = dit(latent_in, t_b, timestep_mask=ts_mask_b,
                              text_kv=kv_uncond)
            noise_pred = pred_uncond + guidance_scale * (pred_cond
                                                         - pred_uncond)
        elif do_cfg:
            pred = dit(torch.cat([latent_in, latent_in], dim=0),
                       torch.cat([t_b, t_b], dim=0),
                       timestep_mask=torch.cat([ts_mask_b, ts_mask_b], 0),
                       text_kv=kv)
            pred_cond, pred_uncond = pred.chunk(2, dim=0)
            noise_pred = pred_uncond + guidance_scale * (pred_cond
                                                         - pred_uncond)
        else:
            noise_pred = dit(latent_in, t_b, timestep_mask=ts_mask_b,
                             text_kv=kv)

        noise_pred = noise_pred[:, :, :num_gen_frames]   # drop ID frames
        latents = euler_step(latents, noise_pred, sigma, sigma_next)
    return latents


def denoise(dit: WanDiT, latents, condition, traj_latents, id_latents,
            first_frame_mask, context, neg_context, sigmas: np.ndarray,
            timesteps: np.ndarray, guidance_scale: float = 5.0,
            dit_2: Optional[WanDiT] = None,
            guidance_scale_2: Optional[float] = None, split_idx: int = 0,
            cfg_mode: str = "batch"):
    """Full CFG denoise loop; sigmas [steps+1], timesteps [steps] (numpy
    fp32). ``split_idx`` > 0 routes steps [0, split_idx) to ``dit`` (high
    noise) and the rest to ``dit_2`` (low noise): the two-expert path."""
    if cfg_mode not in ("batch", "sequential"):
        raise ValueError(f"cfg_mode must be 'batch' or 'sequential', got "
                         f"{cfg_mode!r}")
    context_2b = torch.cat([context, neg_context], dim=0)

    def seg(model, lat, lo, hi, gs):
        return denoise_segment(
            model, lat, condition, traj_latents, id_latents,
            first_frame_mask, context_2b, sigmas[lo:hi],
            sigmas[lo + 1:hi + 1], timesteps[lo:hi], gs,
            cfg_sequential=cfg_mode == "sequential")

    n = len(timesteps)
    if split_idx and dit_2 is not None:
        latents = seg(dit, latents, 0, split_idx, guidance_scale)
        latents = seg(dit_2, latents, split_idx, n,
                      guidance_scale_2 or guidance_scale)
    else:
        latents = seg(dit, latents, 0, n, guidance_scale)
    # final re-blend (reference :912-913)
    return (1.0 - first_frame_mask) * condition + first_frame_mask * latents


class _StageClock:
    """Seconds of each stage of one pipeline call, read on the host after
    the device has finished the stage's work (``laps`` by stage name)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.laps = {}
        # on the card: the device's peak GiB at each lap since the caller
        # last reset it (a running maximum)
        self.peaks_gib = {}
        self.t = self._now()

    def _now(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def lap(self, name: str):
        now = self._now()
        self.laps[name] = now - self.t
        self.t = now
        if self.cuda:
            self.peaks_gib[name] = torch.cuda.max_memory_allocated() / 2**30


class WanImageToVideoPipeline:
    """Masked-canvas image, trajectory video, optional ID frames and prompt
    embeddings -> video (reference ``__call__`` contract,
    ``pipeline_wan_i2v_motion_FrameINO.py:581-936``); with
    ``WanPipelineConfig(expand_timesteps=False)`` the Wan2.1 I2V path
    (``image_embeds`` or ``image_encoder(image)`` for a DiT with an image
    branch, ``last_image`` for first + last frame conditioning).

    The DiT runs in its weights' dtype and the VAE in fp32; inputs are
    moved to the DiT's device. ``quantize="int8"`` swaps the block matmuls
    of ``dit`` and ``dit_2`` for int8 w8a8 layers, in place
    (``models/quant.quantize_dit_int8``); ``quantize_vae`` swaps the VAE's
    resblock and resampler convs for w8a8 ones (``models/quant.
    quantize_wan_vae_int8``; K14 on the card), in either branch.

    ``mesh``: serve over a dp x fsdp x tp x sp process mesh (module
    docstring). Both experts must be built on it (``WanDiT(cfg,
    mesh=mesh)``, sharded by the same rules); ``vae`` may be None on every
    rank but the mesh's rank 0.
    """

    def __init__(self, dit: WanDiT, vae: Optional[wan_vae.WanVAE],
                 pipe_cfg: WanPipelineConfig = WanPipelineConfig(),
                 text_encoder_fn=None, image_encoder=None,
                 dit_2: Optional[WanDiT] = None,
                 quantize: Optional[str] = None, quantize_vae: bool = False,
                 mesh: Optional[Mesh] = None):
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize={quantize!r}")
        if any(m is not None and m.mesh != mesh for m in (dit, dit_2)):
            raise ValueError("dit and dit_2 must be built on the pipeline's "
                             "mesh")
        if quantize == "int8" and mesh is not None and mesh.tp > 1:
            raise NotImplementedError(INT8_TP_NOT_PORTED)
        if quantize == "int8" and mesh is not None and mesh.fsdp > 1:
            raise NotImplementedError(INT8_FSDP_NOT_PORTED)
        if not pipe_cfg.expand_timesteps and (mesh is not None
                                              or dit_2 is not None):
            raise NotImplementedError(
                WAN21_MESH_NOT_PORTED if mesh is not None else
                "two experts are the expand path's only (the JAX pipeline's "
                "Wan2.1 branch runs one DiT)")
        if vae is None and (mesh is None or mesh.rank == 0):
            raise ValueError("the VAE is needed on the mesh's rank 0 (or "
                             "without a mesh)")
        if quantize_vae and vae is not None:
            quant.quantize_wan_vae_int8(vae)
        if quantize == "int8":
            quant.quantize_dit_int8(dit)
            if dit_2 is not None and dit_2 is not dit:
                quant.quantize_dit_int8(dit_2)
        self.dit = dit
        self.dit_2 = dit_2
        self.vae = vae
        self.pipe_cfg = pipe_cfg
        self.text_encoder_fn = text_encoder_fn
        # images [B, 3, H, W] in [-1, 1] -> CLIP states [B, 257, image_dim]
        # (clip_vision.make_image_encoder), for a DiT with an image branch
        self.image_encoder = image_encoder
        self.mesh = mesh
        # seconds of each stage of the last call (text encode, image encode,
        # VAE encodes, denoise, decode), the device synchronized at each
        # end; on the card the peak GiB at each stage's end (a running
        # maximum since the caller last reset the device's peak)
        self.timings = {}
        self.peaks_gib = {}

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
                 prompt: Optional[str] = None,
                 negative_prompt: Optional[str] = None,
                 traj_tensor=None, id_tensor=None, height: int = 704,
                 width: int = 1280, num_frames: int = 81,
                 num_inference_steps: int = 50, guidance_scale: float = 5.0,
                 guidance_scale_2: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, latents=None,
                 image_embeds=None, last_image=None,
                 output_type: str = "np", decode_mode: str = "full",
                 cfg_mode: str = "batch"):
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode must be one of {DECODE_MODES}, "
                             f"got {decode_mode!r}")
        dev = self.device
        # the VAE runs here: without a mesh, or on the mesh's rank 0
        encoder = self.mesh is None or self.mesh.rank == 0
        clock = _StageClock(dev)

        if prompt_embeds is None:
            if self.text_encoder_fn is None:
                raise ValueError("need prompt_embeds or a text_encoder_fn")
            prompt_embeds = self.text_encoder_fn([prompt])
            negative_prompt_embeds = self.text_encoder_fn(
                [negative_prompt or ""])
        prompt_embeds = prompt_embeds.to(dev)
        if negative_prompt_embeds is None:
            negative_prompt_embeds = torch.zeros_like(prompt_embeds)
        negative_prompt_embeds = negative_prompt_embeds.to(dev)
        clock.lap("text_encode_s")

        sched = self.pipe_cfg.scheduler
        sigmas, timesteps = inference_sigmas(sched, num_inference_steps)
        if not self.pipe_cfg.expand_timesteps:
            if id_tensor is not None:
                raise ValueError("ID frames are the expand path's only (the "
                                 "JAX pipeline's Wan2.1 branch takes none)")
            video = self._wan21(
                clock, image, prompt_embeds, negative_prompt_embeds,
                traj_tensor, image_embeds, last_image, num_frames, height,
                width, generator, latents, sigmas, timesteps,
                float(guidance_scale), output_type, decode_mode)
            self.timings, self.peaks_gib = clock.laps, clock.peaks_gib
            return video
        conds = [None] * 4
        if encoder:
            conds = self._noise_and_conditions(
                image, traj_tensor, id_tensor, prompt_embeds.shape[0],
                num_frames, height, width, generator, latents)
        clock.lap("vae_encode_s")
        if self.mesh is not None:
            conds = broadcast_from_rank0(conds, dev, group=self.mesh.group)
        latents, condition, traj_latents, id_latents = conds
        mask = build_first_frame_mask(*latents.shape[2:], device=dev)

        split_idx = 0
        if self.pipe_cfg.boundary_ratio is not None \
                and self.dit_2 is not None:
            boundary_t = self.pipe_cfg.boundary_ratio \
                * sched.num_train_timesteps
            split_idx = int(np.sum(timesteps >= boundary_t))
        latents = denoise(
            self.dit, latents, condition, traj_latents, id_latents, mask,
            prompt_embeds, negative_prompt_embeds, sigmas, timesteps,
            guidance_scale=float(guidance_scale), dit_2=self.dit_2,
            guidance_scale_2=(None if guidance_scale_2 is None
                              else float(guidance_scale_2)),
            split_idx=split_idx, cfg_mode=cfg_mode)
        clock.lap("denoise_s")
        self.timings, self.peaks_gib = clock.laps, clock.peaks_gib
        if self.mesh is not None:
            assert_same_across_processes(float(latents.double().sum()),
                                         group=self.mesh.group)
        if not encoder and output_type != "latent":
            return None
        return self._output(clock, latents, output_type, decode_mode)

    def _output(self, clock, latents, output_type: str, decode_mode: str):
        """The latents, or their decode (a tensor, or numpy for "np")."""
        if output_type == "latent":
            return latents
        z = wan_vae.denormalize_latents(self.vae_cfg, latents)
        video = self._decode(z, decode_mode)
        del z
        clock.lap("decode_s")
        if output_type == "np":
            return video.cpu().numpy()
        return video

    def _wan21(self, clock, image, prompt_embeds, negative_prompt_embeds,
               traj_tensor, image_embeds, last_image, num_frames, height,
               width, generator, latents, sigmas, timesteps, guidance_scale,
               output_type, decode_mode):
        """The Wan2.1 I2V call: CLIP states of ``image`` (unless given),
        mask + latent channel conditions, scalar-timestep denoise."""
        dev = self.device
        image = image.to(dev, torch.float32)
        if image_embeds is None and self.image_encoder is not None \
                and self.dit_cfg.image_dim is not None:
            image_embeds = self.image_encoder(image)
            clock.lap("image_encode_s")
        if image_embeds is not None:
            image_embeds = image_embeds.to(dev)
        num_frames = round_num_frames(num_frames,
                                      self.vae_cfg.scale_factor_temporal)
        latents = self._initial_noise(prompt_embeds.shape[0], num_frames,
                                      height, width, generator, latents)
        if traj_tensor is not None and traj_tensor.ndim == 4:
            traj_tensor = traj_tensor.permute(1, 0, 2, 3)[None]
        condition, traj_latents = prepare_conditions_wan21(
            self.vae, image, num_frames,
            None if traj_tensor is None else traj_tensor.to(dev,
                                                            torch.float32),
            None if last_image is None else last_image.to(dev,
                                                          torch.float32))
        clock.lap("vae_encode_s")
        latents = denoise_segment_wan21(
            self.dit, latents, condition, traj_latents,
            torch.cat([prompt_embeds, negative_prompt_embeds], dim=0),
            image_embeds, sigmas[:-1], sigmas[1:], timesteps, guidance_scale)
        clock.lap("denoise_s")
        return self._output(clock, latents, output_type, decode_mode)

    def _decode(self, z, decode_mode: str):
        """The JAX pipeline's decode modes (``frameino_tpu/pipelines/
        wan_i2v.py:586-598``), each with its module's defaults."""
        if decode_mode == "streaming":
            return streaming_decode(self.vae, z)
        if decode_mode == "tiled":
            return tiled_decode(self.vae, z)
        if decode_mode == "hybrid":
            return hybrid_decode(self.vae, z)
        return self.vae.decode(z)

    def _initial_noise(self, batch, num_frames, height, width, generator,
                       latents):
        """``latents`` on the DiT's device in fp32, or a draw of the latent
        shape from ``generator`` (default: seed 0 on the DiT's device)."""
        dev = self.device
        if latents is None:
            shape = latent_shape(self.vae_cfg, batch, num_frames, height,
                                 width)
            if generator is None:
                generator = torch.Generator(dev).manual_seed(0)
            latents = torch.randn(shape, generator=generator,
                                  device=generator.device,
                                  dtype=torch.float32)
        return latents.to(dev, torch.float32)

    def _noise_and_conditions(self, image, traj_tensor, id_tensor, batch,
                              num_frames, height, width, generator, latents):
        """The initial noise (drawn from ``generator`` unless ``latents``
        is given) and the VAE-encoded conditions, on the DiT's device."""
        dev = self.device
        num_frames = round_num_frames(num_frames,
                                      self.vae_cfg.scale_factor_temporal)
        latents = self._initial_noise(batch, num_frames, height, width,
                                      generator, latents)

        # traj arrives [F, C, H, W] as the dataset emits it
        if traj_tensor is not None and traj_tensor.ndim == 4:
            traj_tensor = traj_tensor.permute(1, 0, 2, 3)[None]
        if id_tensor is not None and id_tensor.ndim == 4:
            id_tensor = id_tensor[None]

        def f32(x):
            return None if x is None else x.to(dev, torch.float32)

        return [latents, *prepare_conditions(
            self.vae, f32(image), f32(traj_tensor), f32(id_tensor))]

