"""What the two training entry points share (``train.py`` for Wan2.2,
``train_cogvideox.py`` for CogVideoX): the arguments, the optimizer keys
of the config, the process mesh (``train.py`` under ``torchrun``), the
dataset and its batches with their prompt embeddings, and the loop of
steps with logging, checkpoints and resume.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config_path", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="tiny models on the CPU, fp32")
    p.add_argument("--stage1", action="store_true",
                   help="motion-only recipe, no ID branch")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of step 2 here")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="collectives under torchrun: nccl (one card a "
                        "rank, the default) or gloo (several ranks on one "
                        "card, or --smoke on the CPU)")
    return p


def mesh_config(config, world_size: int, smoke: bool):
    """JAX's choice of mesh (``scripts/train_wan_motion_frameino.py``)
    with the world size in the place of the device count: the config's
    ``mesh:`` where its product is the world size; else dp 2 x fsdp n/2
    where 4 divides n (not under ``--smoke``); dp 2 x fsdp 2 x tp 2 under
    ``--smoke`` where 8 divides n; else dp n."""
    from frameino_tpu_torch.core.meshes import MeshConfig
    mesh = config.get("mesh")
    if mesh and int(np.prod([int(v) for v in mesh.values()])) == world_size:
        return MeshConfig(**{k: int(v) for k, v in mesh.items()})
    if world_size % 4 == 0 and not smoke:
        return MeshConfig(dp=2, fsdp=world_size // 2)
    if smoke and world_size % 8 == 0:
        return MeshConfig(dp=2, fsdp=2, tp=2)
    return MeshConfig(dp=world_size)


def start_mesh(config, args):
    """Under ``torchrun`` (``WORLD_SIZE`` set): join the processes
    (``parallel.multihost.initialize_from_env``, NCCL with a card a rank
    unless ``--backend gloo``) and lay out ``mesh_config``'s mesh. None
    for one process started without ``torchrun``."""
    if "WORLD_SIZE" not in os.environ:
        return None
    from frameino_tpu_torch.core.meshes import make_mesh
    from frameino_tpu_torch.parallel import multihost
    backend = args.backend or ("gloo" if args.smoke else None)
    env = multihost.initialize_from_env(backend)
    mesh = make_mesh(mesh_config(config, env["world_size"], args.smoke))
    if mesh.rank == 0:
        print(f"mesh {mesh.cfg} over {env['world_size']} processes "
              f"({backend or 'nccl'})")
    return mesh


def require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("training without --smoke runs on CUDA; no CUDA "
                           "device is available")


def pretrained_path(config) -> Optional[str]:
    """``pretrained_transformer_path``, which must exist when given (the
    JAX CLIs train from random weights without a word)."""
    path = config.get("pretrained_transformer_path")
    if path and not os.path.exists(str(path)):
        raise FileNotFoundError(f"pretrained_transformer_path {path!r} does "
                                f"not exist")
    return str(path) if path else None


def optimizer_config(config, default_lr: float):
    """Every optimizer key of the config. The JAX CLIs read fewer (Wan:
    the Adam keys and the schedule; CogVideoX: learning_rate,
    lr_warmup_steps and max_grad_norm) and leave the rest at their
    defaults; the port reads them all (ROADMAP queue 3)."""
    from frameino_tpu_torch.training.optim import OptimizerConfig
    return OptimizerConfig(
        learning_rate=float(config.get("learning_rate", default_lr)),
        beta1=float(config.get("adam_beta1", 0.9)),
        beta2=float(config.get("adam_beta2", 0.999)),
        weight_decay=float(config.get("adam_weight_decay", 1e-4)),
        epsilon=float(config.get("adam_epsilon", 1e-10)),
        lr_scheduler=config.get("lr_scheduler", "constant_with_warmup"),
        lr_warmup_steps=int(config.get("lr_warmup_steps", 100)),
        max_train_steps=int(config.get("max_train_steps", 1000)),
        optimizer=str(config.get("optimizer", "adamw")),
        max_grad_norm=float(config.get("max_grad_norm", 1.0)),
        gradient_accumulation_steps=int(
            config.get("gradient_accumulation_steps", 1)))


def collate(items, embed_prompts, with_id: bool = True) -> dict:
    """Dataset items -> the trainers' batch of CPU tensors (ID frames
    [B, 1, C, H, W], or None without the ID branch)."""
    def stack(key):
        return torch.from_numpy(np.stack([i[key] for i in items]))
    return {"video_tensor": stack("video_tensor"),
            "first_frame_tensor": stack("first_frame_tensor"),
            "traj_tensor": stack("traj_tensor"),
            "ID_tensor": stack("ID_tensor")[:, None] if with_id else None,
            "prompt_embeds": embed_prompts([i["text_prompt"]
                                            for i in items])}


def prompt_embedder(config, max_text: int, text_dim: int):
    """prompts -> [B, max_text, text_dim] fp32: from the precomputed cache
    of ``prompt_embeds_cache`` when configured, else zeros."""
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
        return embed_prompts

    def zeros(prompts):
        return torch.zeros((len(prompts), max_text, text_dim))
    return zeros


def dataset_config(config):
    from frameino_tpu_torch.core.config import filter_kwargs
    from frameino_tpu_torch.data.frameino_dataset import FrameINODatasetConfig
    return FrameINODatasetConfig(**filter_kwargs(FrameINODatasetConfig,
                                                 config))


def train_data(config, seed: int, dp: int = 1):
    """The config's training dataset and its batch sampler, whose batches
    are the global ones: ``train_batch_size`` x ``dp`` examples, as JAX's
    CLI takes them."""
    from frameino_tpu_torch.data.frameino_dataset import FrameINODataset
    from frameino_tpu_torch.data.sampler import MixedBatchSampler
    dataset = FrameINODataset(dataset_config(config),
                              config["download_folder_path"],
                              config["train_csv_relative_path"],
                              config["train_video_relative_path"],
                              config["train_ID_relative_path"],
                              seed=config.get("seed"))
    batch_size = int(config.get("train_batch_size", 1)) * dp
    sampler = MixedBatchSampler([len(dataset)], batch_size, seed=seed)
    if len(sampler) == 0:
        raise ValueError(f"dataset of {len(dataset)} samples yields no "
                         f"batches at global batch size {batch_size} "
                         f"(dp={dp})")
    return dataset, sampler


def resume(config, state, output_dir: str):
    """Restore the latest checkpoint under ``output_dir`` into ``state``
    when the config says ``resume_from_checkpoint: latest``. Returns
    (the checkpoint's metadata, its path or None)."""
    from frameino_tpu_torch.core.checkpoint import (latest_checkpoint,
                                                    restore_checkpoint)
    if config.get("resume_from_checkpoint") != "latest":
        return {}, None
    path = latest_checkpoint(output_dir)
    if not path:
        return {}, None
    _, meta = restore_checkpoint(path, state)
    print(f"resumed from {path} at step {state.step}")
    return meta, path


def train_loop(config, state, output_dir: str, sampler, make_batch,
               take_step: Callable, start_meta: dict, log_every: int,
               profile_dir: Optional[str] = None,
               after_step: Optional[Callable] = None,
               writer: bool = True) -> list:
    """Steps until ``max_train_steps``: batches from ``make_batch`` on
    prefetch threads, ``take_step(batch)`` -> metrics, a log line and a
    metrics row every ``log_every`` steps, checkpoints every
    ``checkpointing_steps`` and at the end (with the data iterator's
    position, so a resumed run takes the batches an uninterrupted one
    would); step 2 under ``core/metrics_logger.maybe_profile``. Returns the
    logged rows. Under a mesh every rank runs the loop (the checkpoints
    gather over it) and only the ``writer`` (the mesh's rank 0) logs and
    profiles."""
    from frameino_tpu_torch.core.checkpoint import save_checkpoint
    from frameino_tpu_torch.core.metrics_logger import (MetricsLogger,
                                                        maybe_profile)
    from frameino_tpu_torch.data.prefetch import BatchPrefetcher
    from frameino_tpu_torch.data.sampler import ResumableEpochIterator
    max_steps = int(config.get("max_train_steps", 1000))
    ckpt_every = int(config.get("checkpointing_steps", 2000))
    limit = config.get("checkpoints_total_limit")
    mlog = MetricsLogger(output_dir) if writer else None
    t0 = time.time()
    history = []
    num_workers = int(config.get("dataloader_num_workers", 2))
    data_iter = ResumableEpochIterator(sampler, start_meta)
    while state.step < max_steps:
        for batch in BatchPrefetcher(make_batch, data_iter.epoch(state.step),
                                     num_workers=num_workers):
            lr = state.optimizer.lr()
            with maybe_profile(profile_dir if state.step == 2 and writer
                               else None):
                metrics = take_step(batch)
            data_iter.advance()
            step_count = state.step
            if step_count % log_every == 0:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                history.append({"step": step_count, "loss": loss,
                                "grad_norm": gn, "lr": lr})
                if writer:
                    mlog.log(step_count, {"loss": loss, "grad_norm": gn,
                                          "lr": lr})
                    print(f"step {step_count} loss {loss:.4f} grad_norm "
                          f"{gn:.3f} lr {lr:.3g} ({time.time() - t0:.1f}s)")
            if after_step is not None:
                after_step(step_count)
            if step_count % ckpt_every == 0:
                save_checkpoint(output_dir, step_count, state,
                                metadata=data_iter.meta(), total_limit=limit)
            if step_count >= max_steps:
                break
        else:
            data_iter.end_epoch()
    save_checkpoint(output_dir, state.step, state,
                    metadata={"final": True, **data_iter.meta()},
                    total_limit=limit)
    if writer:
        mlog.close()
        print(f"done at step {state.step}")
    return history
