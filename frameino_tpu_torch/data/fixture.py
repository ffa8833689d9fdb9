"""A synthetic FrameINO dataset in the training CSV layout, for smoke runs
of the trainer and of mass evaluation: one random-pixel mp4, one ID crop,
and rows that track one point across the clip (the layout of the JAX
package's CLI smoke test); ``write_eval_config`` points an evaluation
config at it as the validation set.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np
import yaml
from PIL import Image

from frameino_tpu_torch.data.video_io import write_video

CSV_HEADER = ["video_path", "height", "width", "valid_duration",
              "Panoptic_Segmentation", "Structured_Text_Prompt",
              "Track_Traj", "Obj_Info", "ID_info"]


def write_fixture_dataset(root: str, height: int, width: int, frames: int,
                          rows: int = 2, seed: int = 0,
                          start=(2.0, 5.0), track=None, box=None,
                          id_hw=None) -> str:
    """Write ``csvs/``, ``videos/`` and ``ids/`` under ``root/data``;
    returns that data directory. The tracked point starts at ``start``
    (x, y) and moves right and down, unless ``track`` gives its [[x, y]]
    for each frame; frame-out evaluation keeps only points that start
    inside the region box (by default ``width // 10`` .. ``width - width //
    10``, likewise in height; ``box`` replaces it). The ID crop is
    ``id_hw`` (default height // 2 x height // 3)."""
    data = os.path.join(root, "data")
    for d in ("csvs", "videos", "ids"):
        os.makedirs(os.path.join(data, d), exist_ok=True)
    rs = np.random.RandomState(seed)
    write_video(os.path.join(data, "videos", "v0.mp4"),
                rs.randint(0, 255, (frames, height, width, 3)
                           ).astype(np.uint8), fps=12)
    id_h, id_w = id_hw or (height // 2, height // 3)
    Image.fromarray(rs.randint(0, 255, (id_h, id_w, 3)
                               ).astype(np.uint8)).save(
        os.path.join(data, "ids", "obj0.png"))
    # one point moving right and down (inside the frame throughout from
    # the default start)
    if track is None:
        track = [[[start[0] + (width - 4) * t / frames,
                   start[1] + (height - 10) * t / frames]]
                 for t in range(frames)]
    if box is None:
        box = [[500, [width // 10, height // 20],
                [width - width // 10, height - height // 20]]]
    with open(os.path.join(data, "csvs", "d.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for _ in range(rows):
            w.writerow(["v0.mp4", height, width, json.dumps([0, frames]),
                        json.dumps([[]]), json.dumps(["toy moves"]),
                        json.dumps([[track]]),
                        json.dumps([[["person", 0]]]),
                        json.dumps([[[[[0, 0, 9, 9], "obj0.png", []],
                                      box]]])])
    return data


def write_eval_config(path: str, data: str, height: int, width: int,
                      frames: int, steps: int = 2, **extra) -> str:
    """An evaluation config (YAML) whose validation set is the fixture
    dataset ``data`` (``write_fixture_dataset``'s return), clips of
    ``frames`` frames at ``height`` x ``width``, ``steps`` denoising steps;
    ``extra`` keys are added as they are. Returns ``path``."""
    cfg = {
        "download_folder_path": os.path.abspath(data),
        "validation_csv_relative_path": "csvs",
        "validation_video_relative_path": "videos",
        "validation_ID_relative_path": "ids",
        "target_height": height, "target_width": width,
        "sample_accelerate_factor": 1,
        "train_frame_num_range": [frames, frames],
        "min_train_frame_num": frames,
        "dot_radius": 7, "num_inference_steps": steps,
        "guidance_scale": 5.0, **extra}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path
