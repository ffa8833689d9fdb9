"""In-training validation: run the full pipeline on one validation sample
(counterpart of ``frameino_tpu/training/validation.py``).

Reference ``train_code/train_wan_motion_FrameINO.py:165-299``
(log_validation): every ``validation_step`` steps the full FrameINO
inference pipeline runs on one validation sample and the condition
visualizations and the generated video are written out;
``first_iter_validation: true`` exercises the whole stack at step 0. The
sample is ``sample_offset % len(dataset)``; under a mesh every rank runs
the pipeline and the mesh's rank 0, which alone gets the video, writes.
"""

from __future__ import annotations

import os
from typing import Callable

import cv2
import numpy as np
import torch

from frameino_tpu_torch.data.video_io import write_video


def log_validation(pipeline, dataset, embed_prompts: Callable,
                   step: int, output_folder: str,
                   num_inference_steps: int = 38,
                   guidance_scale: float = 5.0,
                   sample_offset: int = 0) -> str:
    """Generate one validation video and its condition dumps with the
    port's ``WanImageToVideoPipeline``; returns the directory (None on a
    mesh rank that gets no video)."""
    item = dataset[sample_offset % len(dataset)]
    out_dir = os.path.join(output_folder, f"validation_step{step}")

    F, _, H, W = item["video_tensor"].shape
    video = pipeline(
        torch.from_numpy(item["first_frame_tensor"])[None],
        prompt_embeds=embed_prompts([item["text_prompt"]]),
        traj_tensor=torch.from_numpy(item["traj_tensor"]),
        id_tensor=torch.from_numpy(item["ID_tensor"])[None, :, None],
        height=H, width=W, num_frames=F,
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale,
        generator=torch.Generator(pipeline.device).manual_seed(step))
    if video is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    gen = ((video[0].transpose(1, 2, 3, 0) + 1) / 2 * 255
           ).clip(0, 255).astype(np.uint8)

    write_video(os.path.join(out_dir, "generated.mp4"), gen)
    write_video(os.path.join(out_dir, "gt.mp4"), item["video_gt_np"])
    write_video(os.path.join(out_dir, "traj_condition.mp4"),
                item["traj_imgs_np"])
    if item.get("merge_frames") is not None:
        write_video(os.path.join(out_dir, "merged_conditions.mp4"),
                    item["merge_frames"])
    cv2.imwrite(os.path.join(out_dir, "first_frame_canvas.png"),
                cv2.cvtColor(item["first_frame_np"], cv2.COLOR_RGB2BGR))
    cv2.imwrite(os.path.join(out_dir, "id_reference.png"),
                cv2.cvtColor(item["ID_np"], cv2.COLOR_RGB2BGR))
    with open(os.path.join(out_dir, "prompt.txt"), "w") as f:
        f.write(item["text_prompt"])
    return out_dir
