"""Video decode/encode via OpenCV (the port's own copy of
``frameino_tpu/data/video_io.py``).

The reference shells out to ffmpeg for raw RGB decode at a target
resolution (``data_loader/video_dataset_motion_FrameINO.py:329-336``);
this environment has no ffmpeg binary, so decoding goes through
cv2.VideoCapture with the same contract: RGB uint8 frames resized to
(target_width, target_height).
"""

from __future__ import annotations

from typing import Optional, Tuple

import cv2
import numpy as np


def decode_video(path: str, target_width: Optional[int] = None,
                 target_height: Optional[int] = None) -> np.ndarray:
    """[F, H, W, 3] RGB uint8; optionally resized."""
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if target_width is not None:
            frame = cv2.resize(frame, (target_width, target_height))
        frames.append(frame)
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def write_video(path: str, frames: np.ndarray, fps: int = 12) -> None:
    """frames [F, H, W, 3] RGB uint8 -> mp4."""
    h, w = frames.shape[1:3]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    out.release()
