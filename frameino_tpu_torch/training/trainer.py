"""Wan FrameINO Stage-2 trainer: the flow-matching train step (counterpart
of ``frameino_tpu/training/trainer.py``).

Reference hot loop ``train_code/train_wan_motion_FrameINO.py:1128-1253``,
reproduced as the JAX package does:
  1. frozen-VAE encodes of video / masked first frame / trajectory / ID,
     posterior mode, latents_mean/std normalization, one encode at a time;
  2. first-frame substitution into BOTH x0 and the noisy input;
  3. scalar timesteps per example (stratified indices into the training
     sigma table), FM noising ``(1 - sigma) x0 + sigma eps``;
  4. ID frame appended on the frame axis with zero trajectory channels,
     trajectory latents on the channel axis;
  5. the DiT forward in the compute dtype (differentiable, K6, optional
     remat), ID predictions dropped, fp32 MSE against ``eps - x0``;
  6. global-norm clip + AdamW (``training/optim.py``).

The JAX step is one jit program with the step folded into its key
(``fold_in(key, step)``); here each step draws its timestep indices and
then its noise from a ``torch.Generator`` seeded from (seed, step), or
takes them as arguments (the parity tests feed in JAX's draws).

Under a dp x fsdp x tp ``mesh`` (sp = 1; JAX's ``make_train_step(mesh=)``
from ``make_sharded_train_state``) one process runs per rank:

- ``init_train_state(model, cfg, mesh=)`` shards the parameters first and
  makes the optimizer state on the shards (ZeRO-3);
- every rank draws the GLOBAL batch's timestep indices (stratified over
  ``dp_size``, the mesh's dp) and noise, exactly what one process draws,
  and keeps its examples (``parallel.sharding.batch_slice``: the dp
  slice, then the fsdp rank's part where fsdp divides it, else the dp
  slice whole on every fsdp rank);
- the loss is the mean over the global batch: each rank's local mean
  weighted by its share of the batch, all-reduced over the batch group;
- the fsdp-cut parameters' gradients arrive reduce-scattered over fsdp by
  the gather's backward and are summed over dp; the others are summed
  over the batch group (``reduce_gradients``); the weights make both the
  gradient of the global mean;
- the clip, the update and ``grad_norm`` run on the shards
  (``training/optim.py``).

The VAE encodes follow JAX's rule: a clip of more than one frame is
encoded in chunks of 1 + ``vae_encode_chunk_frames`` pixel frames
(``models/wan_vae_streaming.encode_moments_inline``), and every encode runs
under ``ops/conv.conv_dtype`` of the encode dtype (``vae_encode_accum_dtype``,
or the compute dtype when it is None): bf16 convolutions at full width, as
the reference encodes inside its bf16 autocast.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from frameino_tpu_torch.models import wan_vae
from frameino_tpu_torch.models.wan_dit import WanDiT
from frameino_tpu_torch.schedulers.flow_match_euler import (
    FlowMatchEulerConfig, flow_match_sigmas)
from frameino_tpu_torch.training.noise_sampler import \
    stratified_timestep_indices
from frameino_tpu_torch.core.meshes import Mesh
from frameino_tpu_torch.parallel.sharding import batch_slice, shard_model
from frameino_tpu_torch.training.optim import (Optimizer, OptimizerConfig,
                                               global_norm, make_optimizer)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    scheduler: FlowMatchEulerConfig = FlowMatchEulerConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    train_sampling_steps: int = 1000
    use_frame_in: bool = True
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # the frozen-VAE encode's conv dtype; None follows compute_dtype
    vae_encode_accum_dtype: Optional[torch.dtype] = None
    # pixel frames a chunk of the encode after the first frame; None or 0
    # encodes the full sequence at once
    vae_encode_chunk_frames: Optional[int] = 8

    @property
    def encode_dtype(self) -> torch.dtype:
        return self.vae_encode_accum_dtype or self.compute_dtype


@dataclasses.dataclass
class TrainState:
    """A DiT (``WanDiT`` or ``CogVideoXDiT``), its optimizer and the count
    of steps taken."""
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        """The tensors the optimizer updates: every parameter, and the
        buffers the model's ``trained_buffers`` names."""
        return trained_tensors(self.model)


def trained_tensors(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    out = dict(model.named_parameters())
    if hasattr(model, "trained_buffers"):
        out.update(model.trained_buffers())
    return out


def init_train_state(model: torch.nn.Module, opt_cfg: OptimizerConfig,
                     mesh: Optional[Mesh] = None) -> TrainState:
    """The train state of ``model``; with a ``mesh``, the model's rank
    slices (a whole model is cut first, ``parallel.sharding.shard_model``)
    and the optimizer state made on them (JAX's
    ``make_sharded_train_state``)."""
    if mesh is not None and getattr(model, "mesh", None) is None:
        model = shard_model(model, mesh)
    mesh = getattr(model, "mesh", None)
    model.train()
    tensors = trained_tensors(model)
    for t in tensors.values():
        t.requires_grad_(True)
    cuts = None if mesh is None else {n: model.cuts[n] for n in tensors}
    return TrainState(model=model, optimizer=make_optimizer(
        opt_cfg, tensors, cuts, mesh))


@torch.no_grad()
def encode_training_batch(vae: wan_vae.WanVAE, batch: Dict[str, torch.Tensor],
                          cfg: TrainerConfig = TrainerConfig()
                          ) -> Tuple[torch.Tensor, ...]:
    """Frozen-VAE encodes (reference :507-657, posterior mode and
    normalization) on the VAE's device, one at a time, by JAX's rule (the
    module docstring).

    batch tensors, reference dataset layout:
      video_tensor       [B, F, C, H, W] in [-1, 1]
      first_frame_tensor [B, C, H, W]    masked unbounded canvas
      traj_tensor        [B, F, C, H, W]
      ID_tensor          [B, N_id, C, H, W] (optional)
    Returns (video, first frame, trajectory, ID or None) latents, fp32.
    """
    from frameino_tpu_torch.models import wan_vae_streaming
    from frameino_tpu_torch.ops.conv import conv_dtype
    p = next(vae.parameters())
    chunk = cfg.vae_encode_chunk_frames

    def enc(x):
        x = x.to(p.device, p.dtype)
        with conv_dtype(cfg.encode_dtype):
            if x.shape[2] > 1 and chunk:
                z = wan_vae_streaming.encode_moments_inline(
                    vae, x, chunk_pixel_frames=chunk)[:, :vae.cfg.z_dim]
            else:
                z = vae.encode(x)
        # the latents' dtype, as JAX normalizes them, then fp32
        return wan_vae.normalize_latents(vae.cfg, z).float()

    video_latents = enc(batch["video_tensor"].permute(0, 2, 1, 3, 4))
    first_frame_latent = enc(batch["first_frame_tensor"][:, :, None])
    traj_latents = enc(batch["traj_tensor"].permute(0, 2, 1, 3, 4))
    id_latents = None
    if batch.get("ID_tensor") is not None:
        idt = batch["ID_tensor"].permute(0, 2, 1, 3, 4)       # B,C,N,H,W
        id_latents = torch.cat([enc(idt[:, :, i:i + 1])
                                for i in range(idt.shape[2])], dim=2)
    return video_latents, first_frame_latent, traj_latents, id_latents


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator: seeded from (seed, step), as the JAX step
    folds the step into its key."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1,
                                                                np.uint64)[0])
    return torch.Generator(device).manual_seed(s & (2 ** 63 - 1))


def rank_examples(model, batch_size: int, tensors):
    """This rank's examples of a global batch of ``batch_size``: (their
    slice, the weight of their mean in the global mean, ``tensors`` cut
    to them). ``tensors`` (None kept) hold the global batch or already
    only the rank's examples. Without a mesh: the whole batch, weight 1."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return slice(0, batch_size), 1.0, list(tensors)
    sl, repeats = batch_slice(mesh, batch_size)
    n = next(t for t in tensors if t is not None).shape[0]
    if n == batch_size and (sl.start, sl.stop) != (0, batch_size):
        tensors = [None if t is None else t[sl] for t in tensors]
    elif n != sl.stop - sl.start:
        raise ValueError(f"{n} examples are neither the global batch of "
                         f"{batch_size} nor this rank's {sl}")
    return sl, (sl.stop - sl.start) / (batch_size * repeats), list(tensors)


def global_mean(loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch's mean loss from this rank's weighted local mean
    ``loss`` (``wan_fm_loss``), summed over the batch group; a detached
    value, for the metrics."""
    total = loss.detach().float().reshape(1)
    if mesh.batch > 1:
        dist.all_reduce(total, group=mesh.batch_group)
    return total[0]


def wan_fm_loss(model: WanDiT, cfg: TrainerConfig, video_latents,
                first_frame_latent, traj_latents, id_latents, prompt_embeds,
                generator: Optional[torch.Generator] = None, *,
                idx: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                dp_size: Optional[int] = None,
                batch_size: Optional[int] = None) -> torch.Tensor:
    """Flow-matching loss (reference :1185-1237), a scalar fp32 tensor
    under autograd. Timestep indices and noise come from ``generator``
    unless both are given; the indices are stratified over ``dp_size``
    ranks (the mesh's dp by default, 1 without a mesh), as JAX's
    ``dp_size``. The draws (given or made) are the global batch's, of
    ``batch_size`` examples (by default the latents' own count).

    Under a mesh the model runs this rank's examples
    (``rank_examples``): the latents and embeddings are the global
    batch's, or already only this rank's examples (fewer than
    ``batch_size``); the value is their mean times the rank's weight in
    the global mean: summed over the batch group it is the global mean,
    and so are the gradients once ``reduce_gradients`` has summed them."""
    dev = video_latents.device
    B = batch_size or video_latents.shape[0]
    mesh = getattr(model, "mesh", None)
    if dp_size is None:
        dp_size = 1 if mesh is None else mesh.dp
    sl, weight, (video_latents, first_frame_latent, traj_latents,
                 id_latents, prompt_embeds) = rank_examples(
        model, B, (video_latents, first_frame_latent, traj_latents,
                   id_latents, prompt_embeds))
    num_gen_frames = video_latents.shape[2]
    sigmas_table = torch.from_numpy(flow_match_sigmas(cfg.scheduler)).to(dev)
    timesteps_table = sigmas_table * cfg.scheduler.num_train_timesteps

    # first-frame substitution into x0 (reference :1155)
    x0 = torch.cat([first_frame_latent, video_latents[:, :, 1:]], dim=2)
    if idx is None or noise is None:
        # indices, then noise, from the step's generator, for the global
        # batch
        idx = stratified_timestep_indices(generator, B,
                                          cfg.train_sampling_steps,
                                          world_size=dp_size)
        noise = torch.randn((B,) + tuple(x0.shape[1:]), generator=generator,
                            device=generator.device, dtype=torch.float32)
    idx = idx[sl].to(dev)
    noise = noise[sl].to(dev, torch.float32)
    timesteps = timesteps_table[idx]                       # [B] scalar ts
    sigma = sigmas_table[idx].reshape(-1, 1, 1, 1, 1)
    noisy = (1.0 - sigma) * x0 + sigma * noise
    # clean first frame in the model input (reference :1198)
    noisy = torch.cat([first_frame_latent, noisy[:, :, 1:]], dim=2)

    if id_latents is not None:
        model_in = torch.cat([noisy, id_latents], dim=2)
        traj_in = torch.cat([traj_latents, torch.zeros_like(id_latents)],
                            dim=2)
    else:
        model_in, traj_in = noisy, traj_latents
    model_in = torch.cat([model_in, traj_in], dim=1).to(cfg.compute_dtype)

    pred = model(model_in, timesteps,
                 prompt_embeds.to(dev, cfg.compute_dtype),
                 differentiable=True, remat=cfg.remat)
    pred = pred[:, :, :num_gen_frames]
    target = noise - x0
    loss = torch.mean(torch.square(pred.float() - target))
    return loss if mesh is None else loss * weight


def _all_reduce_flat(tensors, group) -> None:
    """Sum each tensor of ``tensors`` over ``group`` in place, one
    all-reduce a dtype (the tensors joined into one flat buffer)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def reduce_gradients(grads: Dict[str, torch.Tensor], cuts, mesh) -> None:
    """Complete, in place, the sharded step's gradients: an fsdp-cut
    tensor's (already summed over fsdp by the gather's backward) summed
    over dp, any other's over the batch group (dp x fsdp). tp ranks hold
    whole gradients of what they replicate (``copy_to_tp``)."""
    fsdp_cut = [g for n, g in grads.items() if cuts[n].fsdp_dim is not None]
    whole = [g for n, g in grads.items() if cuts[n].fsdp_dim is None]
    if mesh.dp > 1 and fsdp_cut:
        _all_reduce_flat(fsdp_cut, mesh.dp_group)
    if mesh.batch > 1 and whole:
        _all_reduce_flat(whole, mesh.batch_group)


def optimizer_step(state: TrainState, loss_fn) -> Dict[str, torch.Tensor]:
    """The step both trainers share: ``loss_fn()`` (a scalar under
    autograd), its gradients, then the optimizer (clip + the update rule)
    on every parameter, each under a ``torch.profiler`` range ("forward",
    "backward", "optimizer"; the encodes run under "vae_encode"). Returns
    {"loss", "grad_norm"} as device scalars (grad_norm before clipping).

    Under a mesh ``loss_fn`` returns the rank's weighted local mean
    (``wan_fm_loss``): the gradients are completed by
    ``reduce_gradients`` before the optimizer, and the loss reported is
    the global mean."""
    params = state.params()
    mesh = getattr(state.optimizer, "mesh", None)
    for p in params.values():
        p.grad = None
    with record_function("forward"):
        loss = loss_fn()
    with record_function("backward"):
        loss.backward()
    with record_function("optimizer"):
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if mesh is not None:
            reduce_gradients(grads, state.optimizer.cuts, mesh)
            loss = global_mean(loss, mesh)
        grad_norm = (state.optimizer.global_norm(grads) if mesh is not None
                     else global_norm(grads.values()))
        state.optimizer.step(params, grads)
    for p in params.values():
        p.grad = None
    del grads
    state.step += 1
    return {"loss": loss.detach(), "grad_norm": grad_norm}


def train_step(state: TrainState, vae: Optional[wan_vae.WanVAE],
               cfg: TrainerConfig, batch: Dict[str, torch.Tensor], seed: int,
               draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               dp_size: Optional[int] = None,
               batch_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step: encode (unless the batch carries ``*_latents``),
    loss and gradients, clip + AdamW. ``draws`` = (indices, noise) replaces
    the step generator's; ``dp_size`` stratifies its indices (the mesh's
    dp by default). Returns {"loss", "grad_norm"} as device scalars
    (grad_norm before clipping). Under a mesh the batch is the global one
    or this rank's examples of it (``batch_size``: the global batch's
    count); every rank returns the same numbers."""
    model = state.model
    dev = model.proj_out.weight.device
    if "video_latents" in batch:
        enc = tuple(None if batch.get(k) is None else batch[k].to(dev)
                    for k in ("video_latents", "first_frame_latent",
                              "traj_latents", "id_latents"))
    else:
        with record_function("vae_encode"):
            enc = encode_training_batch(vae, batch, cfg)
    gen = None if draws is not None else step_generator(seed, state.step, dev)
    idx, noise = draws if draws is not None else (None, None)
    return optimizer_step(state, lambda: wan_fm_loss(
        model, cfg, *enc, batch["prompt_embeds"], gen, idx=idx, noise=noise,
        dp_size=dp_size, batch_size=batch_size))
