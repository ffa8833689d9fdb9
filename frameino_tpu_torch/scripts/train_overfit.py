"""Tiny-DiT overfit-one-clip convergence run (counterpart of
``scripts/train_overfit_tpu.py``).

A tiny Wan DiT (3 heads of 128, 4 blocks, ffn 1536) and a small causal Wan
VAE memorize ONE synthetic 17x64x64 clip (a square entering along a
diagonal; 2,560 DiT tokens with the ID frame, 16 text tokens) through the
port's train step (``training/trainer.py``: frozen-VAE encodes under JAX's
bf16 rule, first-frame substitution, ID frame-concat and trajectory
channel-concat, bf16 compute, global-norm clip + AdamW with 20 warm-up
steps and no weight decay), then the port's sampling path
(``pipelines/wan_i2v.denoise``, 38 FlowMatch-Euler steps at guidance 1.0)
must reproduce the clip from noise. Gates, JAX's: the probe loss (fixed
sigma 0.7, fixed noise) falls more than 5x, latent PSNR > 20 dB, pixel PSNR
after the VAE decode > 25 dB.

``--state_dtype`` picks the training state:
- ``fp32``: JAX's recipe, fp32 parameters and moments with bf16 compute
  (``MasterCopies``: the optimizer steps fp32 copies of the bf16 model);
- ``bf16``: what the port trains with at full width, bf16 parameters and
  moments.

The frozen VAE is deterministic, so its encodes run once (JAX repeats them
inside every step). Draws come from ``torch.Generator``s seeded as JAX's
keys are numbered (VAE 0, DiT 1, prompt 7, starting noise 9, probe noise
123, steps 42); the numbers differ from JAX's.

    python -m frameino_tpu_torch.scripts.train_overfit [--device cpu]
        [--state_dtype fp32|bf16] [--steps 800] [--lr 1e-3]
        [--lr_scheduler constant_with_warmup|cosine] [--sample_steps 38]
        [--out build/train_convergence_<state_dtype>.json]

Exit code 0 when every gate passes, 1 otherwise; the JSON report goes to
``--out``. On the CPU only a small clip is affordable
(``main(argv, shape=(F, H, W))``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from frameino_tpu_torch.models import wan_dit, wan_vae
from frameino_tpu_torch.ops.attention import launch_counts
from frameino_tpu_torch.pipelines import wan_i2v as P
from frameino_tpu_torch.schedulers.flow_match_euler import (
    FlowMatchEulerConfig, inference_sigmas)
from frameino_tpu_torch.scripts import pick_device
from frameino_tpu_torch.training.optim import (OptimizerConfig,
                                               make_optimizer)
from frameino_tpu_torch.training.trainer import (TrainerConfig, TrainState,
                                                 encode_training_batch,
                                                 init_train_state,
                                                 trained_tensors, train_step)

VAE_CFG = wan_vae.WanVAEConfig(
    base_dim=16, z_dim=8, dim_mult=(1, 2), num_res_blocks=1,
    temperal_downsample=(True,), is_residual=False, patch_size=None,
    scale_factor_temporal=2, scale_factor_spatial=2,
    latents_mean=tuple([0.0] * 8), latents_std=tuple([1.0] * 8))
# Stage-2 input channels: z (noisy / ID on the frame axis) + z (trajectory)
DIT_CFG = wan_dit.WanDiTConfig(
    num_attention_heads=3, attention_head_dim=128, in_channels=16,
    out_channels=8, text_dim=64, freq_dim=64, ffn_dim=1536, num_layers=4)
SHAPE = (17, 64, 64)            # frames, height, width
TEXT_TOKENS = 16
PROBE_SIGMA = 0.7
PROBE_EVERY = 50
STEP_SEED = 42                  # the train steps' generators, JAX's key(42)
GATES = {"probe_reduction>5x": 5.0, "latent_psnr>20dB": 20.0,
         "pixel_psnr>25dB": 25.0}
STATE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def synthetic_clip(shape=SHAPE) -> Tuple[np.ndarray, np.ndarray]:
    """A white square entering along a diagonal over a fixed gradient, and
    its dot-track raster: (video, trajectory), each [F, 3, H, W] fp32."""
    F, H, W = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    bg = np.stack([yy / H, xx / W, 0.5 * np.ones_like(yy)], 0) * 0.6 - 0.5
    frames = []
    for f in range(F):
        img = bg.copy()
        cy = int(-8 + (H - 8) * f / (F - 1))
        cx = int(-8 + (W - 8) * f / (F - 1))
        y0, y1 = max(0, cy), min(H, cy + 16)
        x0, x1 = max(0, cx), min(W, cx + 16)
        img[:, y0:y1, x0:x1] = 0.9
        frames.append(img)
    video = np.stack(frames, 0)
    traj = np.full((F, 3, H, W), -1.0, np.float32)
    for f in range(F):
        cy = int(np.clip(-8 + (H - 8) * f / (F - 1) + 8, 2, H - 3))
        cx = int(np.clip(-8 + (W - 8) * f / (F - 1) + 8, 2, W - 3))
        traj[f, 0, cy - 2:cy + 3, cx - 2:cx + 3] = 1.0
    return video, traj


def psnr(a, b, peak: float) -> float:
    mse = float(np.mean((np.asarray(a, np.float32)
                         - np.asarray(b, np.float32)) ** 2))
    return float(10.0 * np.log10(peak ** 2 / max(mse, 1e-12)))


def make_batch(video: np.ndarray, traj: np.ndarray, prompt_embeds,
               device) -> Dict[str, torch.Tensor]:
    """The trainer's batch of the one clip (the reference dataset layout)."""
    v = torch.from_numpy(video).to(device)
    return {"video_tensor": v[None], "first_frame_tensor": v[0][None],
            "traj_tensor": torch.from_numpy(traj).to(device)[None],
            "ID_tensor": v[-1][None, None],
            "prompt_embeds": prompt_embeds.to(device)}


def make_probe(model, x0, traj_latents, id_latents, prompt_embeds,
               noise) -> Callable[[], torch.Tensor]:
    """The deterministic convergence probe: fixed noise at sigma 0.7, the
    train loss's input built from the fp32 encodes, the DiT in bf16. Its
    target is a fixed function of a fixed input, so memorization drives it
    towards 0 (the train loss keeps the floor of its low-sigma strata).
    Returns a function of no arguments giving the loss (a device
    scalar)."""
    s = PROBE_SIGMA
    noisy = (1.0 - s) * x0 + s * noise
    noisy = torch.cat([x0[:, :, :1], noisy[:, :, 1:]], dim=2)
    model_in = torch.cat([noisy, id_latents], dim=2)
    traj_in = torch.cat([traj_latents, torch.zeros_like(id_latents)], dim=2)
    model_in = torch.cat([model_in, traj_in], dim=1).to(torch.bfloat16)
    timesteps = torch.full((x0.shape[0],), 700.0, device=x0.device)
    target = noise - x0
    text = prompt_embeds.to(torch.bfloat16)
    num_gen = x0.shape[2]

    def probe():
        pred = model(model_in, timesteps, text)
        return torch.mean(torch.square(pred[:, :, :num_gen].float()
                                       - target))
    return probe


class MasterCopies:
    """JAX's recipe (fp32 state, bf16 compute) around the trainer's
    optimizer: it updates fp32 copies of the model's tensors with the
    gradients converted to fp32 (the gradient with respect to an fp32
    parameter of a bf16 forward), then the model takes their bf16
    rounding, the weights its next forward computes with."""

    def __init__(self, ocfg: OptimizerConfig,
                 tensors: Dict[str, torch.Tensor]):
        self.master = {n: t.detach().float().clone()
                       for n, t in tensors.items()}
        self.optimizer = make_optimizer(ocfg, self.master)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> bool:
        applied = self.optimizer.step(
            self.master, {n: g.float() for n, g in grads.items()})
        for n, p in params.items():
            p.copy_(self.master[n])
        return applied


def init_state(model, ocfg: OptimizerConfig, state_dtype: torch.dtype,
               compute_dtype: torch.dtype) -> TrainState:
    """The trainer's state of ``model`` with its parameters and moments in
    ``state_dtype``: the model itself in that dtype, or, where the forward
    computes in another, the model in ``compute_dtype`` stepped through
    ``MasterCopies``."""
    model.to(state_dtype)
    if state_dtype == compute_dtype:
        return init_train_state(model, ocfg)
    master = MasterCopies(ocfg, trained_tensors(model))
    state = init_train_state(model.to(compute_dtype), ocfg)
    state.optimizer = master
    return state


def train(state, tcfg: TrainerConfig, latents: Dict[str, torch.Tensor],
          steps: int, probe, draws: Optional[Callable[[int], Tuple]] = None,
          log=None) -> Dict:
    """``steps`` train steps on the encoded batch, the probe at every 50th
    and the last. ``draws(i)`` = (timestep indices, noise) replaces step
    i's generator. Returns {"loss_hist", "loss_curve", "probe_curve",
    "train_s"}; device scalars are fetched every 50 steps only."""
    hist: List[torch.Tensor] = []
    losses, probes = [], []
    t0 = time.time()
    for i in range(steps):
        m = train_step(state, None, tcfg, latents, STEP_SEED,
                       draws=None if draws is None else draws(i))
        hist.append(m["loss"])
        if i % PROBE_EVERY == 0 or i == steps - 1:
            losses.append([i, float(m["loss"])])
            probes.append([i, float(probe())])
            if log:
                log(f"# step {i}: loss {losses[-1][1]:.5f} probe "
                    f"{probes[-1][1]:.5f}")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"loss_hist": torch.stack(hist).float().cpu().numpy(),
            "loss_curve": losses, "probe_curve": probes,
            "train_s": time.time() - t0}


@torch.no_grad()
def sample(model, vae, batch, latents0, sample_steps: int):
    """The memorized clip from ``latents0`` through the sampling path: the
    conditions' VAE encodes, then ``sample_steps`` FlowMatch-Euler steps at
    guidance 1.0; returns the final latents [1, z, f, h, w] fp32."""
    condition, traj_latents, id_latents = P.prepare_conditions(
        vae, batch["first_frame_tensor"],
        batch["traj_tensor"].permute(0, 2, 1, 3, 4),
        batch["ID_tensor"].permute(0, 2, 1, 3, 4))
    mask = P.build_first_frame_mask(*latents0.shape[2:],
                                    device=latents0.device)
    sig, ts = inference_sigmas(FlowMatchEulerConfig(), sample_steps)
    text = batch["prompt_embeds"].to(torch.bfloat16)
    return P.denoise(model, latents0, condition, traj_latents, id_latents,
                     mask, text, torch.zeros_like(text), sig, ts,
                     guidance_scale=1.0)


@torch.no_grad()
def memorization_psnr(vae, final, x0) -> Tuple[float, float]:
    """(latent PSNR of the generated frames after the first over the
    target's range, pixel PSNR of the two decodes at peak 2)."""
    lat_range = float(x0.max() - x0.min())
    latent = psnr(final[:, :, 1:].cpu(), x0[:, :, 1:].cpu(), lat_range)
    dec_gen = vae.decode(wan_vae.denormalize_latents(vae.cfg, final))
    dec_tgt = vae.decode(wan_vae.denormalize_latents(vae.cfg, x0))
    return latent, psnr(dec_gen.cpu(), dec_tgt.cpu(), 2.0)


def gates(probe_reduction: float, latent_psnr: float,
          pixel_psnr: float) -> Dict[str, bool]:
    values = (probe_reduction, latent_psnr, pixel_psnr)
    return {k: bool(v > limit) for (k, limit), v in zip(GATES.items(),
                                                         values)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--state_dtype", choices=sorted(STATE_DTYPES),
                   default="fp32")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_scheduler", default="constant_with_warmup",
                   choices=["constant_with_warmup", "cosine"],
                   help="cosine decays to 0 by --steps, so the sampled clip "
                        "comes from the converged model")
    p.add_argument("--sample_steps", type=int, default=38)
    p.add_argument("--out", default=None,
                   help="the JSON report (default build/"
                        "train_convergence_<state_dtype>.json)")
    return p.parse_args(argv)


def run(args, shape=SHAPE, log=None) -> Dict:
    """The whole run; returns the report (``main`` writes it), with the
    kernel launches the run made (``launches``; all 0 on the CPU, where
    the plain versions run)."""
    device = pick_device(args.device)
    before = launch_counts()

    def gen(n):
        return torch.Generator(device).manual_seed(n)
    video, traj = synthetic_clip(shape)
    prompt = torch.randn((1, TEXT_TOKENS, DIT_CFG.text_dim),
                         generator=gen(7), device=device)
    batch = make_batch(video, traj, prompt, device)
    vae = wan_vae.init_wan_vae(VAE_CFG, gen(0)).eval()
    model = wan_dit.init_wan_dit(DIT_CFG, gen(1))
    ocfg = OptimizerConfig(learning_rate=args.lr, lr_warmup_steps=20,
                           lr_scheduler=args.lr_scheduler,
                           max_train_steps=args.steps, weight_decay=0.0)
    tcfg = TrainerConfig(optimizer=ocfg, remat=False)
    state = init_state(model, ocfg, STATE_DTYPES[args.state_dtype],
                       tcfg.compute_dtype)

    # the latents the trainer regresses against (JAX's in-step encodes),
    # and the fp32 encodes of the probe's input and the PSNR target
    enc = encode_training_batch(vae, batch, tcfg)
    latents = dict(zip(("video_latents", "first_frame_latent",
                        "traj_latents", "id_latents"), enc),
                   prompt_embeds=prompt)
    video_lat, ff_lat, traj_lat, id_lat = encode_training_batch(
        vae, batch, TrainerConfig(compute_dtype=torch.float32))
    x0 = torch.cat([ff_lat, video_lat[:, :, 1:]], dim=2)
    noise = torch.randn(x0.shape, generator=gen(123), device=device)
    probe = make_probe(model, x0, traj_lat, id_lat, prompt, noise)

    out = train(state, tcfg, latents, args.steps, probe, log=log)
    latents0 = torch.randn(P.latent_shape(VAE_CFG, 1, *shape),
                           generator=gen(9), device=device)
    final = sample(model, vae, batch, latents0, args.sample_steps)
    latent_psnr, pixel_psnr = memorization_psnr(vae, final, x0)

    hist = out.pop("loss_hist")
    probe_first, probe_last = out["probe_curve"][0][1], \
        out["probe_curve"][-1][1]
    reduction = probe_first / max(probe_last, 1e-9)
    g = gates(reduction, latent_psnr, pixel_psnr)
    finite = bool(np.isfinite(hist).all() and np.isfinite(
        [reduction, latent_psnr, pixel_psnr]).all())
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    after = launch_counts()
    return {
        "metric": "wan_stage2_overfit_convergence", "device": name,
        "state_dtype": args.state_dtype, "steps": args.steps,
        "shape": list(shape), "lr": args.lr,
        "lr_scheduler": args.lr_scheduler,
        "sample_steps": args.sample_steps, "train_s": out["train_s"],
        "loss_curve": out["loss_curve"],
        "loss_curve_mean50": [[i, float(hist[i:i + 50].mean())]
                              for i in range(0, args.steps, 50)],
        "probe_curve": out["probe_curve"],
        "final_loss": out["loss_curve"][-1][1],
        "final_probe_loss": probe_last, "probe_reduction": reduction,
        "latent_psnr_db": latent_psnr,
        "pixel_psnr_db_vs_vae_roundtrip": pixel_psnr,
        "launches": {k: after[k] - before[k] for k in after},
        "finite": finite, "gates": g, "ok": finite and all(g.values())}


def main(argv=None, shape=SHAPE) -> int:
    args = parse_args(argv)
    report = run(args, shape, log=lambda s: print(s, file=sys.stderr))
    path = args.out or os.path.join(
        "build", f"train_convergence_{args.state_dtype}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("loss_curve", "loss_curve_mean50",
                                   "probe_curve")}), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
