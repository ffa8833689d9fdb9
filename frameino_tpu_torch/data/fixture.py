"""A synthetic FrameINO dataset in the training CSV layout, for smoke runs
of the trainer: one random-pixel mp4, one ID crop, and rows that track one
point across the clip (the layout of the JAX package's CLI smoke test).
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np
from PIL import Image

from frameino_tpu_torch.data.video_io import write_video

CSV_HEADER = ["video_path", "height", "width", "valid_duration",
              "Panoptic_Segmentation", "Structured_Text_Prompt",
              "Track_Traj", "Obj_Info", "ID_info"]


def write_fixture_dataset(root: str, height: int, width: int, frames: int,
                          rows: int = 2, seed: int = 0) -> str:
    """Write ``csvs/``, ``videos/`` and ``ids/`` under ``root/data``;
    returns that data directory."""
    data = os.path.join(root, "data")
    for d in ("csvs", "videos", "ids"):
        os.makedirs(os.path.join(data, d), exist_ok=True)
    rs = np.random.RandomState(seed)
    write_video(os.path.join(data, "videos", "v0.mp4"),
                rs.randint(0, 255, (frames, height, width, 3)
                           ).astype(np.uint8), fps=12)
    Image.fromarray(rs.randint(0, 255, (height // 2, height // 3, 3)
                               ).astype(np.uint8)).save(
        os.path.join(data, "ids", "obj0.png"))
    # one point moving right and down, inside the frame throughout
    track = [[[2 + (width - 4) * t / frames, 5 + (height - 10) * t / frames]]
             for t in range(frames)]
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
