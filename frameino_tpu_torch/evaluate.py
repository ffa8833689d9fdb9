"""FrameINO mass evaluation: generate every instance of the validation set
with a FrameINO pipeline, write the per-instance artifacts, then score them
(counterpart of ``scripts/run_frameino_mass_evaluation.py``; the flags are
its own).

    python -m frameino_tpu_torch.evaluate --config_path CONFIG \\
        --output_dir results/FrameIn --mode frame_in|frame_out \\
        [--family wan|cogvideox] [--smoke] [--device cpu|cuda] \\
        [--backends naive|default|random] [--evaluate-only]

The pipeline is ``serve.build_pipeline``'s: the tiny models on the CPU
under ``--smoke``, the config's ``pretrained_transformer_path`` and
``pretrained_vae_path`` directories when both exist, else seeded random
weights at full width. Prompt embeddings are zeros, as in JAX. Wan decodes
"hybrid" at full width and "full" under ``--smoke``; CogVideoX takes its
tiled streaming walk and the DPM scheduler. The artifact layout is JAX's,
so ``--evaluate-only`` scores either package's output.

Differences from the JAX script: ``--backends random`` (the perception
models at released widths on seeded random weights, on ``--device``)
stands for JAX's ``jax-random``; ``--qwen_checkpoint`` judges with the
port's Qwen2.5-VL (bf16, on ``--device``); ``--quantize_vae`` raises (not
ported); the denoise loop is Python, so
JAX's ``steps_per_program`` has no counterpart. On CUDA the script also
prints ``GENERATION_PEAK_GIB`` per instance and ``SCORING_PEAK_GIB`` per
perception backend.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--mode", choices=["frame_in", "frame_out"],
                   default="frame_in")
    p.add_argument("--family", choices=["wan", "cogvideox"], default="wan")
    p.add_argument("--smoke", action="store_true",
                   help="the tiny models on the CPU")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; --smoke defaults to cpu")
    p.add_argument("--evaluate-only", action="store_true")
    p.add_argument("--num_instances", type=int, default=None)
    p.add_argument("--backends", choices=["naive", "default", "random"],
                   default="naive",
                   help="'random' = the perception models at released "
                        "widths on RANDOM weights: timing only, the scores "
                        "are meaningless")
    p.add_argument("--cotracker_checkpoint", default=None)
    p.add_argument("--sam2_checkpoint", default=None)
    p.add_argument("--dinov2_checkpoint", default=None)
    p.add_argument("--qwen_checkpoint", default=None,
                   help="a Qwen2.5-VL checkpoint directory: the port's "
                        "judge (models/qwen_vl.py) with --backends default")
    p.add_argument("--schema", choices=["new", "old"], default="new",
                   help="CSV schema: 'old' = the paper-v1.0 contract")
    p.add_argument("--quantize", choices=["int8"], default=None)
    p.add_argument("--quantize_vae", action="store_true",
                   help="the int8 Wan VAE; not ported")
    return p.parse_args(argv)


def _device(args) -> torch.device:
    if args.device is not None:
        return torch.device(args.device)
    return torch.device("cpu" if args.smoke else "cuda")


def build_pipeline(args, config: Dict, device: torch.device):
    """``serve.build_pipeline`` for the family: from the config's checkpoint
    directories when both exist, else seeded random weights (tiny under
    ``--smoke``)."""
    from frameino_tpu_torch import serve
    if args.quantize_vae:
        raise SystemExit("--quantize_vae: the int8 Wan VAE is not ported "
                         "(ROADMAP queue 1 item 13)")
    tp = config.get("pretrained_transformer_path")
    vp = config.get("pretrained_vae_path")
    dirs = [p for p in (tp, vp) if p and os.path.exists(str(p))]
    if len(dirs) == 1:
        raise SystemExit("pretrained_transformer_path and "
                         "pretrained_vae_path: give both or neither")
    kw = dict(family=args.family, quantize=args.quantize, device=device)
    if dirs:
        pipe = serve.build_pipeline(transformer=str(tp), vae=str(vp), **kw)
    else:
        pipe = serve.build_pipeline(smoke=args.smoke,
                                    random_init=not args.smoke, **kw)
    if args.family == "cogvideox":
        from frameino_tpu_torch.pipelines.cogvideox_i2v import \
            CogPipelineConfig
        pipe.pipe_cfg = CogPipelineConfig(scheduler_type="dpm")
    return pipe


def build_dataset(args, config: Dict, is_frame_in: bool):
    """The validation set, deterministic (``strict_validation_match``), every
    tracked point kept unless the config thins them."""
    eval_defaults = dict(config)
    eval_defaults.setdefault("point_keep_ratio_regular", 1.0)
    eval_defaults.setdefault("point_keep_ratio_ID", 1.0)
    common = dict(FrameOut_only=not is_frame_in,
                  one_point_one_obj=not is_frame_in,
                  strict_validation_match=True, seed=0)
    root = config["download_folder_path"]
    if args.schema == "old":
        from frameino_tpu_torch.data.frameino_dataset_old import \
            FrameINODatasetOld
        old_cfg = {
            "dataset_folder_path": os.path.join(
                root, config["validation_video_relative_path"]),
            "ID_folder_path": os.path.join(
                root, config["validation_ID_relative_path"]),
            "height": eval_defaults.get("target_height", 480),
            "width": eval_defaults.get("target_width", 720),
            "preset_decode_fps": eval_defaults.get("preset_decode_fps", 16),
            "train_frame_num": eval_defaults.get("train_frame_num_range",
                                                 [49, 49])[0],
            "dot_radius": eval_defaults.get("dot_radius", 6),
            "point_keep_ratio_regular":
                eval_defaults["point_keep_ratio_regular"],
            "point_keep_ratio_ID": eval_defaults["point_keep_ratio_ID"],
        }
        return FrameINODatasetOld(
            old_cfg, os.path.join(root,
                                  config["validation_csv_relative_path"]),
            **common)
    from frameino_tpu_torch.core.config import filter_kwargs
    from frameino_tpu_torch.data.frameino_dataset import (
        FrameINODataset, FrameINODatasetConfig)
    ds_cfg = FrameINODatasetConfig(**filter_kwargs(FrameINODatasetConfig,
                                                   eval_defaults))
    return FrameINODataset(ds_cfg, root,
                           config["validation_csv_relative_path"],
                           config["validation_video_relative_path"],
                           config["validation_ID_relative_path"], **common)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gib(device: torch.device) -> float:
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def generate(args, config: Dict, pipe, dataset, device: torch.device,
             latents_for: Optional[Callable] = None):
    """Generate and write every instance; returns (seconds, peak GiB or
    None) per instance. ``latents_for(idx)`` may give an instance's initial
    latents (else the pipeline draws them from a generator seeded with the
    instance index)."""
    from frameino_tpu_torch.evaluation.artifacts import \
        write_instance_artifacts
    n = min(args.num_instances or len(dataset), len(dataset))
    steps = int(config.get("num_inference_steps", 50))
    dit_cfg = pipe.dit.cfg
    text_dim = getattr(dit_cfg, "text_dim",
                       getattr(dit_cfg, "text_embed_dim", None))
    text_len = int(config.get("max_text_seq_length", 512))
    times, peaks = [], []
    for idx in range(n):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        item = dataset[idx]
        F, _, H, W = item["video_tensor"].shape
        id_np = item.get("ID_tensor", item.get("main_reference_tensor"))
        kw = {}
        if args.family == "wan":
            kw["decode_mode"] = "full" if args.smoke else "hybrid"
        video = pipe(
            torch.from_numpy(np.asarray(item["first_frame_tensor"]))[None],
            prompt_embeds=torch.zeros(1, text_len, text_dim),
            traj_tensor=torch.from_numpy(np.asarray(item["traj_tensor"])),
            id_tensor=torch.from_numpy(np.asarray(id_np))[None, :, None],
            height=H, width=W, num_frames=F, num_inference_steps=steps,
            guidance_scale=float(config.get("guidance_scale", 5.0)),
            generator=torch.Generator(device).manual_seed(idx),
            latents=latents_for(idx) if latents_for else None, **kw)
        video = np.asarray(video)
        if not np.isfinite(video).all():
            raise FloatingPointError(f"instance {idx}: non-finite frames")
        gen = ((video[0].transpose(1, 2, 3, 0) + 1) / 2 * 255
               ).clip(0, 255).astype(np.uint8)
        write_instance_artifacts(
            args.output_dir, idx, item["video_gt_np"][:gen.shape[0]], gen,
            item["processed_meta_data"], item["text_prompt"],
            main_reference=item.get("ID_np", item.get("main_reference_np")))
        _sync(device)
        times.append(round(time.time() - t0, 2))
        peaks.append(round(_gib(device), 2) if device.type == "cuda"
                     else None)
        print(f"instance {idx} written ({gen.shape}) in {times[-1]:.1f}s",
              flush=True)
    return times, peaks


def _track_peaks(backends: Dict[str, Callable], device: torch.device,
                 peaks: Dict[str, float]) -> Dict[str, Callable]:
    """The backends, each recording its largest CUDA peak into ``peaks``."""
    def wrap(name, fn):
        def call(*a, **kw):
            torch.cuda.reset_peak_memory_stats(device)
            out = fn(*a, **kw)
            peaks[name] = max(peaks.get(name, 0.0), round(_gib(device), 2))
            return out
        return call
    return {k: wrap(k, v) for k, v in backends.items()}


def load_backends(args, device: torch.device) -> Dict[str, Callable]:
    from frameino_tpu_torch.evaluation import perception
    if args.backends == "naive":
        return perception.naive_backends()
    if args.backends == "random":
        print("WARNING: --backends random uses RANDOM weights; metric "
              "VALUES below are meaningless (timing only)", flush=True)
        return perception.random_init_backends(device=str(device))
    return perception.load_default_backends(
        device=str(device), cotracker_checkpoint=args.cotracker_checkpoint,
        dinov2_checkpoint=args.dinov2_checkpoint,
        sam2_checkpoint=args.sam2_checkpoint,
        qwen_checkpoint=args.qwen_checkpoint)


def main(argv=None, latents_for: Optional[Callable] = None,
         pipeline=None) -> Dict:
    """Run the script; returns {"results": the scores as results.json
    holds them, "generation_s", "generation_peak_gib" (per instance),
    "scoring_peak_gib" (per backend; CUDA only)}. ``pipeline``: one built
    beforehand (a caller that runs several modes), else
    ``build_pipeline``'s; ``latents_for``: see ``generate``."""
    from frameino_tpu_torch.core.config import load_config
    from frameino_tpu_torch.evaluation import (FRAME_IN_METRICS,
                                               FRAME_OUT_METRICS,
                                               mass_evaluation)
    args = parse_args(argv)
    config = load_config(args.config_path)
    is_frame_in = args.mode == "frame_in"
    device = _device(args)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu (or --smoke)")
        from frameino_tpu_torch import serve
        serve.configure_cuda_numerics()

    times, peaks = [], []
    if not args.evaluate_only:
        pipe = pipeline or build_pipeline(args, config, device)
        dataset = build_dataset(args, config, is_frame_in)
        times, peaks = generate(args, config, pipe, dataset, device,
                                latents_for)
        # the first instance carries the kernel builds and warm-up
        print("GENERATION_TIMES: " + json.dumps(times), flush=True)
        if device.type == "cuda":
            print("GENERATION_PEAK_GIB: " + json.dumps(peaks), flush=True)
        del pipe
        if device.type == "cuda":
            torch.cuda.empty_cache()

    metrics = FRAME_IN_METRICS if is_frame_in else FRAME_OUT_METRICS
    scoring_peaks: Dict[str, float] = {}
    backends = load_backends(args, device)
    if device.type == "cuda" and args.backends != "naive":
        # the naive backends run on the host
        backends = _track_peaks(backends, device, scoring_peaks)
    results = mass_evaluation(
        args.output_dir, metrics, backends,
        test_num_frames=49 if is_frame_in else 14, is_frame_in=is_frame_in,
        store_json_path=os.path.join(args.output_dir, "results.json"))
    if scoring_peaks:
        print("SCORING_PEAK_GIB: " + json.dumps(scoring_peaks), flush=True)
    print("results:", results, flush=True)
    return {"results": results, "generation_s": times,
            "generation_peak_gib": peaks, "scoring_peak_gib": scoring_peaks}


if __name__ == "__main__":
    main()
