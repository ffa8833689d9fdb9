"""Serving entry point of the PyTorch port: build a FrameINO pipeline
(Wan2.2 or CogVideoX) and start the HTTP API.

    python -m frameino_tpu_torch.serve --smoke                # tiny, CPU
    python -m frameino_tpu_torch.serve --random_init          # 5B, CUDA
    python -m frameino_tpu_torch.serve --family cogvideox --smoke
    python -m frameino_tpu_torch.serve --family cogvideox --random_init
    python -m frameino_tpu_torch.serve --random_init --quantize int8

``--random_init`` serves the family's 5B FrameINO model at full width with
weights drawn from seed 0: Wan2.2-TI2V-5B-motion (bf16 DiT, fp32 VAE) or
CogVideoX-5B-I2V-FrameINO (bf16 DiT, bf16 VAE). ``--quantize int8`` serves
the DiT's block matmuls as int8 w8a8 (either family). Outputs are noise, for
latency and memory measurement of the real serving path. Requests carry
``prompt_embeds_b64`` (the UMT5 and T5 encoders are not ported yet):
[512, 4096] for Wan, [226, 4096] for CogVideoX.
"""

from __future__ import annotations

import argparse

import torch

NOT_PORTED = {
    "text_encoder": "--text_encoder: the UMT5 text encoder is ROADMAP.md "
                    "queue 1, item 1; send prompt_embeds_b64 instead",
    "checkpoint": "loading released checkpoints is ROADMAP.md queue 1, "
                  "item 7; use --smoke or --random_init",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--smoke", action="store_true",
                      help="tiny random models on the CPU")
    mode.add_argument("--random_init", action="store_true",
                      help="the family's full-width 5B FrameINO model with "
                           "seeded random weights on CUDA (outputs are "
                           "noise)")
    p.add_argument("--family", choices=["wan", "cogvideox"], default="wan")
    p.add_argument("--text_encoder", default=None)
    p.add_argument("--quantize", choices=["int8"], default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8188)
    p.add_argument("--bucket_grid", type=int, default=64,
                   help="round request H/W up to this grid (multiple of "
                        "32); 0 keeps the x32 canvas rule only")
    p.add_argument("--frame_grid", type=int, default=None,
                   help="optional frame-count lattice (multiple of the VAE "
                        "temporal ratio)")
    return p.parse_args(argv)


def smoke_configs():
    """The tiny Wan configs the CPU smoke server and tests use."""
    from frameino_tpu_torch.models import wan_dit, wan_vae
    vae_cfg = wan_vae.WanVAEConfig(
        base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
        temperal_downsample=(True,), is_residual=False,
        scale_factor_temporal=2, scale_factor_spatial=2,
        latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4)
    dit_cfg = wan_dit.tiny_config(in_channels=8, out_channels=4)
    return dit_cfg, vae_cfg


def configure_cuda_numerics():
    """The port's numerics on CUDA, set explicitly rather than inherited:
    fp32 matmuls in full fp32 (no TF32), bf16 GEMMs reduce in fp32, and
    cuDNN convolutions of the fp32 Wan VAE in TF32, PyTorch's default
    (the bf16 CogVideoX VAE's accumulate in fp32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = True


def build_pipeline(*, smoke: bool, random_init: bool, family: str = "wan",
                   text_encoder=None, quantize=None):
    """The port's FrameINO pipeline of ``family`` with random weights from
    seed 0, its DiT quantized when ``quantize="int8"``."""
    if text_encoder:
        raise NotImplementedError(NOT_PORTED["text_encoder"])
    if family not in ("wan", "cogvideox"):
        raise ValueError(f"family must be 'wan' or 'cogvideox', got "
                         f"{family!r}")
    if not (smoke or random_init):
        raise NotImplementedError(NOT_PORTED["checkpoint"])
    if smoke:
        device, dit_dtype = torch.device("cpu"), torch.float32
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("--random_init serves on CUDA; no CUDA "
                               "device is available")
        configure_cuda_numerics()
        device, dit_dtype = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device).manual_seed(0)
    if family == "cogvideox":
        from frameino_tpu_torch.models import cogvideox_dit, cogvideox_vae
        from frameino_tpu_torch.pipelines.cogvideox_i2v import (
            CogPipelineConfig, CogVideoXImageToVideoPipeline)
        if smoke:
            dit_cfg = cogvideox_dit.tiny_config()
            vae_cfg = cogvideox_vae.tiny_vae_config()
        else:
            dit_cfg = cogvideox_dit.COGVIDEOX_5B_I2V_FRAMEINO
            vae_cfg = cogvideox_vae.COGVIDEOX_VAE_CONFIG
        dit = cogvideox_dit.init_cogvideox_dit(dit_cfg, gen, dtype=dit_dtype)
        # the VAE in the DiT's dtype, as the JAX server keeps it for this
        # family (bf16 at full width)
        vae = cogvideox_vae.init_cogvideox_vae(vae_cfg, gen, dtype=dit_dtype)
        return CogVideoXImageToVideoPipeline(dit, vae, CogPipelineConfig(),
                                             quantize=quantize)
    from frameino_tpu_torch.models import wan_dit, wan_vae
    from frameino_tpu_torch.pipelines.wan_i2v import (WanImageToVideoPipeline,
                                                      WanPipelineConfig)
    if smoke:
        dit_cfg, vae_cfg = smoke_configs()
    else:
        dit_cfg = wan_dit.WAN22_TI2V_5B_MOTION
        vae_cfg = wan_vae.WAN22_VAE_CONFIG
    dit = wan_dit.init_wan_dit(dit_cfg, gen, dtype=dit_dtype)
    vae = wan_vae.init_wan_vae(vae_cfg, gen)
    return WanImageToVideoPipeline(dit, vae, WanPipelineConfig(),
                                   quantize=quantize)


def main(argv=None):
    args = parse_args(argv)
    from frameino_tpu_torch.app.server import PipelineServer
    pipe = build_pipeline(smoke=args.smoke, random_init=args.random_init,
                          family=args.family,
                          text_encoder=args.text_encoder,
                          quantize=args.quantize)
    if args.random_init:
        print("WARNING: --random_init serves RANDOM weights; outputs are "
              "noise")
    server = PipelineServer(pipe, bucket_grid=args.bucket_grid,
                            frame_grid=args.frame_grid)
    server.serve(args.host, args.port)


if __name__ == "__main__":
    main()
