"""Per-instance evaluation artifact contract (the port's own copy of
``frameino_tpu/evaluation/artifacts.py``: the same files, byte for byte
in the PNGs, pickle and prompt, so either package reads the other's).

Reproduces the directory layout the reference benchmark drivers emit and
the evaluators consume (``test_code/run_cogvideox_FrameIn_mass_
evaluation.py:133-238``): for each ``instanceN/``:

    gt_frame{i}.png, gt_padded_frame{i}.png      ground-truth frames
    gen_frame{i}.png, gen_padded_frame{i}.png    generated frames
    Main_Reference.png                           ID reference image
    processed_meta_data.pkl                      tracks/region metadata
    prompt.txt                                   text prompt
    gen_video.mp4 / gt_video.mp4                 clips

"padded" frames are the full unbounded canvas; plain frames are the
region-box crop.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import cv2
import numpy as np

from frameino_tpu_torch.data.video_io import write_video


def _imwrite_rgb(path: str, img: np.ndarray) -> None:
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def write_instance_artifacts(root: str, instance_idx: int,
                             gt_frames: np.ndarray,
                             gen_frames: np.ndarray,
                             processed_meta_data: Dict,
                             prompt: str,
                             main_reference: Optional[np.ndarray] = None,
                             fps: int = 12) -> str:
    """gt/gen frames: [F, H, W, 3] uint8 full-canvas (padded) frames."""
    path = os.path.join(root, f"instance{instance_idx}")
    os.makedirs(path, exist_ok=True)

    (tlx, tly), (brx, bry) = processed_meta_data["resized_mask_region_box"]
    for i, frame in enumerate(gt_frames):
        _imwrite_rgb(os.path.join(path, f"gt_padded_frame{i}.png"), frame)
        _imwrite_rgb(os.path.join(path, f"gt_frame{i}.png"),
                     frame[tly:bry, tlx:brx])
    for i, frame in enumerate(gen_frames):
        _imwrite_rgb(os.path.join(path, f"gen_padded_frame{i}.png"), frame)
        _imwrite_rgb(os.path.join(path, f"gen_frame{i}.png"),
                     frame[tly:bry, tlx:brx])
    if main_reference is not None:
        _imwrite_rgb(os.path.join(path, "Main_Reference.png"),
                     main_reference)
    with open(os.path.join(path, "processed_meta_data.pkl"), "wb") as f:
        pickle.dump(processed_meta_data, f)
    with open(os.path.join(path, "prompt.txt"), "w") as f:
        f.write(prompt)
    write_video(os.path.join(path, "gt_video.mp4"), gt_frames, fps)
    write_video(os.path.join(path, "gen_video.mp4"), gen_frames, fps)
    return path


def read_instance_frames(instance_path: str, kind: str, indices,
                         resize_hw=None) -> np.ndarray:
    """Read gt/gen [padded] frames by index list; RGB uint8."""
    out = []
    for i in indices:
        p = os.path.join(instance_path, f"{kind}{i}.png")
        img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        if resize_hw is not None:
            img = cv2.resize(img, (resize_hw[1], resize_hw[0]))
        out.append(img)
    return np.stack(out)


def read_meta(instance_path: str) -> Dict:
    with open(os.path.join(instance_path, "processed_meta_data.pkl"),
              "rb") as f:
        return pickle.load(f)
