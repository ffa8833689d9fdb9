"""Training entry point of the PyTorch port: Wan2.2 FrameINO Stage 2
(counterpart of ``scripts/train_wan_motion_frameino.py``).

    python -m frameino_tpu_torch.train --config_path <yaml> --smoke  # CPU
    python -m frameino_tpu_torch.train --config_path <yaml>          # CUDA
    torchrun --nproc_per_node N -m frameino_tpu_torch.train \
        --config_path <yaml> [--backend gloo]                  # a mesh

The config YAML is the JAX CLI's: dataset and sampler, frozen VAE,
prompt embeddings from a precomputed cache (zeros without one), the train
step, periodic validation through the full pipeline, checkpoints with
resume from the latest (``training/cli.py``, shared with
``train_cogvideox.py``). ``--smoke`` trains the tiny models on the CPU in
fp32. Without it the full-width Wan2.2-TI2V-5B-motion DiT trains on one
CUDA card from seeded random weights (or from the DiT safetensors that
``pretrained_transformer_path`` names, loaded into the YAML's config),
with bf16 parameters, gradients and Adam moments (fp32 master weights, the
reference's recipe, need ~80 GB for a 5B model and do not fit one card
beside the activations) and the fp32 VAE, whose encodes run in bf16 as
JAX's do. ``--stage1`` is the motion-only recipe (no ID branch);
``--profile_dir DIR`` writes a ``torch.profiler`` trace of step 2 there.

Under ``torchrun`` (``WORLD_SIZE`` set) the processes form a dp x fsdp x
tp mesh as JAX's CLI forms its device mesh (``training/cli.mesh_config``:
the YAML's ``mesh:`` where its product is the world size, else JAX's
default) over NCCL with a card a rank, or over gloo with ``--backend
gloo`` (several ranks on one card; ``--smoke`` ranks on the CPU). Every
rank seeds the same whole DiT and keeps its slice, with the optimizer
state made on the slices (``training/trainer.init_train_state(mesh=)``);
the global batch is ``train_batch_size`` x dp, each process collates and
encodes only its rank's examples of it, and only the mesh's rank 0
writes logs, validation and checkpoints (gathered whole,
``core/checkpoint.py``). One process without ``torchrun`` trains as
before, without a mesh.
"""

from __future__ import annotations

import os

import torch

from frameino_tpu_torch.training import cli


def parse_args(argv=None):
    p = cli.parser(__doc__.splitlines()[0])
    p.add_argument("--debug", action="store_true",
                   help="accepted and unused, as by the JAX CLI")
    return p.parse_args(argv)


def main(argv=None, dit_cfg=None) -> dict:
    """Train per the config; ``dit_cfg`` overrides the DiT config (the
    smoke run and tests cut its depth). Returns a summary: the steps run,
    each logged step's loss and grad_norm, and the checkpoint resumed."""
    args = parse_args(argv)
    from frameino_tpu_torch.core.config import filter_kwargs, load_config
    from frameino_tpu_torch.data.frameino_dataset import FrameINODataset
    from frameino_tpu_torch.models import wan_dit, wan_vae
    from frameino_tpu_torch.parallel import multihost
    from frameino_tpu_torch.schedulers.flow_match_euler import \
        FlowMatchEulerConfig
    from frameino_tpu_torch.serve import configure_cuda_numerics, smoke_configs
    from frameino_tpu_torch.training.trainer import (TrainerConfig,
                                                     init_train_state,
                                                     train_step)

    config = load_config(args.config_path)
    pretrained = cli.pretrained_path(config)
    mesh = cli.start_mesh(config, args)
    writer = mesh is None or mesh.rank == 0

    # --- models ----------------------------------------------------------
    if args.smoke:
        # the tiny models of the JAX CLI's --smoke (the serve smoke's)
        smoke_dit, vae_cfg = smoke_configs()
        dit_cfg = dit_cfg or smoke_dit
        device, dtype = torch.device("cpu"), torch.float32
    else:
        cli.require_cuda()
        configure_cuda_numerics()
        dit_cfg = dit_cfg or wan_dit.WAN22_TI2V_5B_MOTION
        vae_cfg = wan_vae.WAN22_VAE_CONFIG
        device = torch.device("cuda", torch.cuda.current_device())
        dtype = torch.bfloat16

    sched_cfg = FlowMatchEulerConfig(**filter_kwargs(
        FlowMatchEulerConfig, config.get("noise_scheduler_kwargs", {})))
    # every optimizer key is read here, unlike the JAX CLI (the shipped
    # config accumulates 2 micro-batches an update)
    opt_cfg = cli.optimizer_config(config, 3e-5)
    tcfg = TrainerConfig(scheduler=sched_cfg, optimizer=opt_cfg,
                         use_frame_in=not args.stage1, compute_dtype=dtype,
                         remat=bool(config.get("gradient_checkpointing",
                                               True)))

    seed = int(config.get("seed") or 0)
    if pretrained:
        # the DiT's safetensors into the model of the YAML's config, as
        # the JAX CLI loads them (no surgery)
        from frameino_tpu_torch.models.weights import load_safetensors_dir
        model = wan_dit.WanDiT(dit_cfg, device="meta", dtype=dtype)
        model.load_state_dict(
            {k: v.to(device, dtype) for k, v in
             load_safetensors_dir(pretrained).items()}, assign=True)
    else:
        model = wan_dit.init_wan_dit(
            dit_cfg, torch.Generator(device).manual_seed(seed), dtype=dtype)
    vae = wan_vae.init_wan_vae(
        vae_cfg, torch.Generator(device).manual_seed(seed + 1))
    vae.requires_grad_(False)
    state = init_train_state(model, opt_cfg, mesh=mesh)
    del model

    output_dir = os.path.join(config.get("output_folder", "checkpoints"),
                              config.get("experiment_name", "wan_fino"))
    start_meta, resumed = cli.resume(config, state, output_dir)

    # --- data ------------------------------------------------------------
    dataset, sampler = cli.train_data(config, seed,
                                      1 if mesh is None else mesh.dp)
    embed_prompts = cli.prompt_embedder(
        config, int(config.get("max_text_seq_length", 512)),
        dit_cfg.text_dim)

    val_every = int(config.get("validation_step", 0) or 0)
    first_iter_val = bool(config.get("first_iter_validation", False))
    val_dataset = None
    if val_every or first_iter_val:
        val_dataset = FrameINODataset(
            cli.dataset_config(config), config["download_folder_path"],
            config.get("validation_csv_relative_path",
                       config["train_csv_relative_path"]),
            config.get("validation_video_relative_path",
                       config["train_video_relative_path"]),
            config.get("validation_ID_relative_path",
                       config["train_ID_relative_path"]),
            strict_validation_match=True, seed=0)

    def run_validation(step_no):
        from frameino_tpu_torch.pipelines.wan_i2v import (
            WanImageToVideoPipeline, WanPipelineConfig)
        from frameino_tpu_torch.training.validation import log_validation
        pipe = WanImageToVideoPipeline(state.model, vae,
                                       WanPipelineConfig(scheduler=sched_cfg),
                                       mesh=mesh)
        out = log_validation(
            pipe, val_dataset, embed_prompts, step_no, output_dir,
            num_inference_steps=int(config.get("num_inference_steps", 38)))
        if out is not None:
            print(f"validation artifacts -> {out}")

    def after_step(step_no):
        if val_every and step_no % val_every == 0 and val_dataset is not None:
            run_validation(step_no)

    def make_batch(batch_idx):
        # runs on prefetch threads (cv2/numpy release the GIL); under a
        # mesh only this rank's examples of the global batch
        mine = multihost.local_batch({"idx": list(batch_idx)}, mesh,
                                     sampler.batch_size)["idx"]
        return cli.collate([dataset[i] for i in mine], embed_prompts,
                           with_id=not args.stage1)

    def take_step(batch):
        return train_step(state, vae, tcfg, batch, seed,
                          batch_size=sampler.batch_size)

    if first_iter_val and val_dataset is not None and state.step == 0:
        run_validation(0)
    history = cli.train_loop(
        config, state, output_dir, sampler, make_batch, take_step,
        start_meta, log_every=1 if args.smoke else 10,
        profile_dir=args.profile_dir, after_step=after_step, writer=writer)
    return {"step": state.step, "history": history, "resumed_from": resumed,
            "output_dir": output_dir, "mesh": mesh}


if __name__ == "__main__":
    main()
