"""Training entry point of the PyTorch port: CogVideoX FrameINO Stage 2
(counterpart of ``scripts/train_cogvideox_motion_frameino.py``).

    python -m frameino_tpu_torch.train_cogvideox --config_path <yaml> \
        [--smoke] [--stage1] [--surgery] [--profile_dir DIR]

The config YAML is the JAX CLI's (``configs/train_cogvideox_motion_
frameino.yaml``): dataset and sampler, prompt embeddings from a
precomputed cache (zeros without one), the v-prediction train step
(``training/cog_trainer.py``), checkpoints with resume from the latest;
the loop and the data are ``train.py``'s (``training/cli.py``). Every
optimizer key of the config is read; the JAX CLI reads only
learning_rate, lr_warmup_steps and max_grad_norm (ROADMAP queue 3).

``--smoke`` trains the tiny models on the CPU in fp32. Without it the
full-width CogVideoX-5B-I2V-FrameINO DiT (``--stage1``: the motion DiT, no
ID branch) trains on one CUDA card from seeded random weights, or from the
checkpoint directory ``pretrained_transformer_path`` names
(``models/pretrained.from_pretrained``), with bf16 parameters, gradients
and optimizer state as ``train.py`` keeps them, beside the bf16 CogVideoX
VAE. ``--surgery`` widens the DiT's patch embedding by the trajectory
latent channels with zeros first (the pretrained model, or the seeded one
built that much narrower). ``--profile_dir DIR`` writes a
``torch.profiler`` trace of step 2 there. It runs on one process, as
the JAX CLI does: a config with a ``mesh:`` key is refused rather than
dropped.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from frameino_tpu_torch.training import cli


# JAX's CogVideoX CLI passes no mesh to its step
# (scripts/train_cogvideox_motion_frameino.py), so this entry trains on one
# process; its step runs under a mesh (training/cog_trainer.py)
MESH_REFUSED = ("train_cogvideox trains on one process, as the JAX CLI "
                "does: remove the config's mesh: (and --backend); the "
                "sharded CogVideoX step is training/cog_trainer."
                "cog_train_step on a mesh")


def parse_args(argv=None):
    p = cli.parser(__doc__.splitlines()[0])
    p.add_argument("--surgery", action="store_true",
                   help="widen the patch embedding by the trajectory "
                        "channels first")
    return p.parse_args(argv)


def build_dit(dit_cfg, traj_channels: int, pretrained, surgery: bool,
              seed: int, device, dtype):
    """The DiT to train: the checkpoint directory's weights, or seeded
    random ones; with ``surgery`` made ``traj_channels`` input channels
    narrower and widened back with zeros."""
    from frameino_tpu_torch.models import cogvideox_dit
    from frameino_tpu_torch.models.pretrained import from_pretrained
    from frameino_tpu_torch.training.surgery import cogvideox_stage1_surgery
    base_cfg = dataclasses.replace(
        dit_cfg, in_channels=dit_cfg.in_channels - traj_channels) \
        if surgery else dit_cfg
    if pretrained:
        _, loaded = from_pretrained(pretrained, device=device, dtype=dtype)
        sd = loaded.state_dict()
        del loaded
    else:
        sd = cogvideox_dit.init_cogvideox_dit(
            base_cfg, torch.Generator(device).manual_seed(seed),
            dtype=dtype).state_dict()
    if surgery:
        sd = cogvideox_stage1_surgery(sd, dit_cfg.in_channels)
    model = cogvideox_dit.CogVideoXDiT(dit_cfg, device="meta", dtype=dtype)
    model.load_state_dict(sd, assign=True)
    return model


def main(argv=None, dit_cfg=None) -> dict:
    """Train per the config; ``dit_cfg`` overrides the DiT config (the
    tests and the card's smoke run cut its depth). Returns a summary: the
    steps run, each logged step's loss and grad_norm, and the checkpoint
    resumed."""
    args = parse_args(argv)
    from frameino_tpu_torch.core.config import load_config
    from frameino_tpu_torch.models import cogvideox_dit, cogvideox_vae
    from frameino_tpu_torch.serve import configure_cuda_numerics
    from frameino_tpu_torch.training.cog_trainer import (CogTrainerConfig,
                                                         cog_train_step)
    from frameino_tpu_torch.training.trainer import init_train_state

    config = load_config(args.config_path)
    if config.get("mesh") or args.backend:
        raise ValueError(MESH_REFUSED)
    pretrained = cli.pretrained_path(config)
    if args.smoke:
        vae_cfg = cogvideox_vae.tiny_vae_config()
        dit_cfg = dit_cfg or cogvideox_dit.tiny_config()
        device, dtype = torch.device("cpu"), torch.float32
    else:
        cli.require_cuda()
        configure_cuda_numerics()
        vae_cfg = cogvideox_vae.COGVIDEOX_VAE_CONFIG
        dit_cfg = dit_cfg or (cogvideox_dit.COGVIDEOX_5B_I2V_MOTION
                              if args.stage1 else
                              cogvideox_dit.COGVIDEOX_5B_I2V_FRAMEINO)
        device, dtype = torch.device("cuda"), torch.bfloat16

    opt_cfg = cli.optimizer_config(config, 1e-5)
    tcfg = CogTrainerConfig(optimizer=opt_cfg, use_frame_in=not args.stage1,
                            compute_dtype=dtype,
                            remat=bool(config.get("gradient_checkpointing",
                                                  True)))
    seed = int(config.get("seed") or 0)
    model = build_dit(dit_cfg, vae_cfg.latent_channels, pretrained,
                      args.surgery, seed, device, dtype)
    # the VAE in the encode dtype: its convs run in it
    vae = cogvideox_vae.init_cogvideox_vae(
        vae_cfg, torch.Generator(device).manual_seed(seed + 1),
        dtype=tcfg.encode_dtype)
    vae.requires_grad_(False)
    state = init_train_state(model, opt_cfg)

    output_dir = os.path.join(config.get("output_folder", "checkpoints"),
                              config.get("experiment_name", "cog_fino"))
    start_meta, resumed = cli.resume(config, state, output_dir)
    dataset, sampler = cli.train_data(config, seed)
    embed_prompts = cli.prompt_embedder(
        config, int(config.get("max_text_seq_length", 226)),
        dit_cfg.text_embed_dim)

    def make_batch(batch_idx):
        return cli.collate([dataset[i] for i in batch_idx], embed_prompts,
                           with_id=not args.stage1)

    history = cli.train_loop(
        config, state, output_dir, sampler, make_batch,
        lambda batch: cog_train_step(state, vae, tcfg, batch, seed),
        start_meta, log_every=1 if args.smoke else 10,
        profile_dir=args.profile_dir)
    return {"step": state.step, "history": history, "resumed_from": resumed,
            "output_dir": output_dir, "optimizer": state.optimizer.cfg}


if __name__ == "__main__":
    main()
