"""Training entry point of the PyTorch port: Wan2.2 FrameINO Stage 2
(counterpart of ``scripts/train_wan_motion_frameino.py``).

    python -m frameino_tpu_torch.train --config_path <yaml> --smoke  # CPU
    python -m frameino_tpu_torch.train --config_path <yaml>          # CUDA

The config YAML is the JAX CLI's: dataset and sampler, frozen VAE,
prompt embeddings from a precomputed cache (zeros without one), the train
step, periodic validation through the full pipeline, checkpoints with
resume from the latest. ``--smoke`` trains the tiny models on the CPU in
fp32. Without it the full-width Wan2.2-TI2V-5B-motion DiT trains on one
CUDA card from seeded random weights (or from the DiT safetensors that
``pretrained_transformer_path`` names, loaded into the YAML's config),
with bf16 parameters, gradients and Adam moments (fp32 master weights, the
reference's recipe, need ~80 GB for a 5B model and do not fit one card
beside the activations) and the fp32 VAE. ``--stage1`` is the motion-only recipe (no ID branch).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config_path", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="tiny models on the CPU, fp32")
    p.add_argument("--stage1", action="store_true",
                   help="motion-only recipe, no ID branch")
    return p.parse_args(argv)


def collate(items, embed_prompts, with_id: bool = True) -> dict:
    """Dataset items -> the trainer's batch of CPU tensors (ID frames
    [B, 1, C, H, W], or None without the ID branch)."""
    import numpy as np

    def stack(key):
        return torch.from_numpy(np.stack([i[key] for i in items]))
    return {"video_tensor": stack("video_tensor"),
            "first_frame_tensor": stack("first_frame_tensor"),
            "traj_tensor": stack("traj_tensor"),
            "ID_tensor": stack("ID_tensor")[:, None] if with_id else None,
            "prompt_embeds": embed_prompts([i["text_prompt"]
                                            for i in items])}


def main(argv=None, dit_cfg=None) -> dict:
    """Train per the config; ``dit_cfg`` overrides the DiT config (the
    smoke run and tests cut its depth). Returns a summary: the steps run,
    each logged step's loss and grad_norm, and the checkpoint resumed."""
    args = parse_args(argv)
    from frameino_tpu_torch.core.checkpoint import (latest_checkpoint,
                                                    restore_checkpoint,
                                                    save_checkpoint)
    from frameino_tpu_torch.core.config import filter_kwargs, load_config
    from frameino_tpu_torch.core.metrics_logger import MetricsLogger
    from frameino_tpu_torch.data.frameino_dataset import (
        FrameINODataset, FrameINODatasetConfig)
    from frameino_tpu_torch.data.prefetch import BatchPrefetcher
    from frameino_tpu_torch.data.sampler import (MixedBatchSampler,
                                                 ResumableEpochIterator)
    from frameino_tpu_torch.models import wan_dit, wan_vae
    from frameino_tpu_torch.schedulers.flow_match_euler import \
        FlowMatchEulerConfig
    from frameino_tpu_torch.serve import configure_cuda_numerics, smoke_configs
    from frameino_tpu_torch.training.optim import OptimizerConfig
    from frameino_tpu_torch.training.trainer import (TrainerConfig,
                                                     init_train_state,
                                                     train_step)

    config = load_config(args.config_path)
    pretrained = config.get("pretrained_transformer_path")
    if pretrained and not os.path.exists(str(pretrained)):
        # JAX trains from random weights without a word here
        raise FileNotFoundError(f"pretrained_transformer_path {pretrained!r} "
                                f"does not exist")

    # --- models ----------------------------------------------------------
    if args.smoke:
        # the tiny models of the JAX CLI's --smoke (the serve smoke's)
        smoke_dit, vae_cfg = smoke_configs()
        dit_cfg = dit_cfg or smoke_dit
        device, dtype = torch.device("cpu"), torch.float32
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("training without --smoke runs on CUDA; no "
                               "CUDA device is available")
        configure_cuda_numerics()
        dit_cfg = dit_cfg or wan_dit.WAN22_TI2V_5B_MOTION
        vae_cfg = wan_vae.WAN22_VAE_CONFIG
        device, dtype = torch.device("cuda"), torch.bfloat16

    sched_cfg = FlowMatchEulerConfig(**filter_kwargs(
        FlowMatchEulerConfig, config.get("noise_scheduler_kwargs", {})))
    opt_cfg = OptimizerConfig(
        learning_rate=float(config.get("learning_rate", 3e-5)),
        beta1=float(config.get("adam_beta1", 0.9)),
        beta2=float(config.get("adam_beta2", 0.999)),
        weight_decay=float(config.get("adam_weight_decay", 1e-4)),
        epsilon=float(config.get("adam_epsilon", 1e-10)),
        lr_scheduler=config.get("lr_scheduler", "constant_with_warmup"),
        lr_warmup_steps=int(config.get("lr_warmup_steps", 100)),
        max_train_steps=int(config.get("max_train_steps", 1000)),
        # read here, unlike the JAX CLI, which leaves them at their defaults
        # (the shipped config accumulates 2 micro-batches an update)
        optimizer=str(config.get("optimizer", "adamw")),
        max_grad_norm=float(config.get("max_grad_norm", 1.0)),
        gradient_accumulation_steps=int(
            config.get("gradient_accumulation_steps", 1)))
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
             load_safetensors_dir(str(pretrained)).items()}, assign=True)
    else:
        model = wan_dit.init_wan_dit(
            dit_cfg, torch.Generator(device).manual_seed(seed), dtype=dtype)
    vae = wan_vae.init_wan_vae(
        vae_cfg, torch.Generator(device).manual_seed(seed + 1))
    vae.requires_grad_(False)
    state = init_train_state(model, opt_cfg)

    # --- resume ----------------------------------------------------------
    output_dir = os.path.join(config.get("output_folder", "checkpoints"),
                              config.get("experiment_name", "wan_fino"))
    start_meta, resumed = {}, None
    if config.get("resume_from_checkpoint") == "latest":
        resumed = latest_checkpoint(output_dir)
        if resumed:
            state, start_meta = restore_checkpoint(resumed, state)
            print(f"resumed from {resumed} at step {state.step}")

    # --- data ------------------------------------------------------------
    ds_cfg = FrameINODatasetConfig(**filter_kwargs(FrameINODatasetConfig,
                                                   config))
    root = config["download_folder_path"]
    dataset = FrameINODataset(ds_cfg, root, config["train_csv_relative_path"],
                              config["train_video_relative_path"],
                              config["train_ID_relative_path"],
                              seed=config.get("seed"))
    batch_size = int(config.get("train_batch_size", 1))
    sampler = MixedBatchSampler([len(dataset)], batch_size, seed=seed)
    if len(sampler) == 0:
        raise ValueError(f"dataset of {len(dataset)} samples yields no "
                         f"batches at batch size {batch_size}")

    # text embeddings: a precomputed cache when configured, else zeros
    text_dim = dit_cfg.text_dim
    max_text = int(config.get("max_text_seq_length", 512))
    cache_dir = config.get("prompt_embeds_cache")
    if cache_dir and not os.path.isdir(str(cache_dir)):
        raise FileNotFoundError(f"prompt_embeds_cache configured but not a "
                                f"directory: {cache_dir!r}")
    if cache_dir:
        from frameino_tpu_torch.data.prompt_cache import PromptEmbeddingCache
        pcache = PromptEmbeddingCache(str(cache_dir), max_text, text_dim)
        strict = not bool(config.get("prompt_cache_allow_misses", False))

        def embed_prompts(prompts):
            return torch.from_numpy(pcache.batch(prompts, strict=strict))
    else:
        def embed_prompts(prompts):
            return torch.zeros((len(prompts), max_text, text_dim))

    max_steps = int(config.get("max_train_steps", 1000))
    ckpt_every = int(config.get("checkpointing_steps", 2000))
    val_every = int(config.get("validation_step", 0) or 0)
    first_iter_val = bool(config.get("first_iter_validation", False))
    log_every = 1 if args.smoke else 10

    val_dataset = None
    if val_every or first_iter_val:
        val_dataset = FrameINODataset(
            ds_cfg, root,
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
                                       WanPipelineConfig(scheduler=sched_cfg))
        out = log_validation(
            pipe, val_dataset, embed_prompts, step_no, output_dir,
            num_inference_steps=int(config.get("num_inference_steps", 38)))
        print(f"validation artifacts -> {out}")

    def make_batch(batch_idx):
        # runs on prefetch threads (cv2/numpy release the GIL)
        return collate([dataset[i] for i in batch_idx], embed_prompts,
                       with_id=not args.stage1)

    mlog = MetricsLogger(output_dir)
    t0 = time.time()
    history = []
    if first_iter_val and val_dataset is not None and state.step == 0:
        run_validation(0)
    num_workers = int(config.get("dataloader_num_workers", 2))
    data_iter = ResumableEpochIterator(sampler, start_meta)
    while state.step < max_steps:
        for batch in BatchPrefetcher(make_batch, data_iter.epoch(state.step),
                                     num_workers=num_workers):
            lr = state.optimizer.lr()
            metrics = train_step(state, vae, tcfg, batch, seed)
            data_iter.advance()
            step_count = state.step
            if step_count % log_every == 0:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                mlog.log(step_count, {"loss": loss, "grad_norm": gn,
                                      "lr": lr})
                history.append({"step": step_count, "loss": loss,
                                "grad_norm": gn, "lr": lr})
                print(f"step {step_count} loss {loss:.4f} grad_norm "
                      f"{gn:.3f} lr {lr:.3g} ({time.time() - t0:.1f}s)")
            if val_every and step_count % val_every == 0 and \
                    val_dataset is not None:
                run_validation(step_count)
            if step_count % ckpt_every == 0:
                save_checkpoint(output_dir, step_count, state,
                                metadata=data_iter.meta(),
                                total_limit=config.get(
                                    "checkpoints_total_limit"))
            if step_count >= max_steps:
                break
        else:
            data_iter.end_epoch()

    save_checkpoint(output_dir, state.step, state,
                    metadata={"final": True, **data_iter.meta()},
                    total_limit=config.get("checkpoints_total_limit"))
    mlog.close()
    print(f"done at step {state.step}")
    return {"step": state.step, "history": history, "resumed_from": resumed,
            "output_dir": output_dir}


if __name__ == "__main__":
    main()
