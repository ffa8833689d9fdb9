"""Request-condition helpers of the serving API (the port's own copy of
``tracks_to_traj_tensor`` and ``prepare_id_reference`` from
``frameino_tpu/app/core.py``).

- trajectory capture: per-object click polylines, arc-length-uniform
  resampling to the frame count (reference ``app.py:487-501``),
  rasterized with the SAME function as training (``app.py:616-620``
  parity);
- ID reference: segmentation-masked object background-zeroed,
  aspect-resized and zero-padded to the canvas; black placeholder when
  absent (``app.py:642-692``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import cv2
import numpy as np

from frameino_tpu_torch.data.traj import (rasterize_trajectories,
                                          resample_track_by_length)


def prepare_id_reference(image: np.ndarray, mask: Optional[np.ndarray],
                         canvas_height: int, canvas_width: int
                         ) -> np.ndarray:
    """Background-zeroed, aspect-resized + zero-padded ID reference
    (reference ``app.py:642-692``); black placeholder when image None."""
    if image is None:
        return np.zeros((canvas_height, canvas_width, 3), np.uint8)
    obj = image.copy()
    if mask is not None:
        obj = obj * (mask[..., None] > 0)
    rh, rw = obj.shape[:2]
    scale_h = canvas_height / max(rh, rw)
    scale_w = canvas_width / max(rh, rw)
    obj = cv2.resize(obj.astype(np.uint8),
                     (int(rw * scale_w), int(rh * scale_h)),
                     interpolation=cv2.INTER_AREA)
    ph1 = (canvas_height - obj.shape[0]) // 2
    ph2 = canvas_height - obj.shape[0] - ph1
    pw1 = (canvas_width - obj.shape[1]) // 2
    pw2 = canvas_width - obj.shape[1] - pw1
    return np.pad(obj, ((ph1, ph2), (pw1, pw2), (0, 0)))


def tracks_to_traj_tensor(polylines: Sequence[Sequence[Tuple[float, float]]],
                          num_frames: int, canvas_height: int,
                          canvas_width: int, dot_radius: int = 7
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Click polylines (one per object) -> rasterized trajectory video
    using the training rasterizer (train/infer parity,
    ``app.py:599-620``). Returns (traj [-1,1] [F,3,H,W], uint8)."""
    resampled = [resample_track_by_length(p, num_frames) for p in polylines]
    full_tracks = [[[tuple(resampled[obj][t])] for obj in
                    range(len(resampled))] for t in range(num_frames)]
    traj, raw, _ = rasterize_trajectories(
        full_tracks, canvas_height, canvas_width, dot_radius,
        canvas_width, canvas_height)
    return traj, raw
