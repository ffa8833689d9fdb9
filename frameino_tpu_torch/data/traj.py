"""Trajectory rasterization — numpy parity with the reference (the
port's own copy of ``frameino_tpu/data/traj.py``).

Reference ``data_loader/video_dataset_motion_FrameINO.py:126-213``
(``prepare_traj_tensor``): per frame, colored squares are painted at
each tracked point on a white canvas at the ORIGINAL resolution (dot
radius scaled by height/384), resized to the target resolution with
cubic interpolation, then dilated with a 45x45 isotropic bivariate
Gaussian (sigma 3). The [-1, 1] tensor feeds the VAE; the raw uint8
frames feed validation visualizations. Also the demo's arc-length
trajectory resampler (reference ``app.py:487-501``).
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

from frameino_tpu_torch.utils.optical_flow import bivariate_gaussian

# Fixed palette (reference :33-37): 9 deterministic colors then random.
ALL_COLOR_CODES: List[Tuple[int, int, int]] = [
    (255, 0, 0), (255, 255, 0), (0, 255, 0), (0, 255, 255),
    (255, 0, 255), (0, 0, 255), (128, 128, 128), (64, 224, 208),
    (233, 150, 122),
]
_rng = random.Random(1234)
for _ in range(100):
    ALL_COLOR_CODES.append((_rng.randint(0, 255), _rng.randint(0, 255),
                            _rng.randint(0, 255)))

_BLUR_KERNEL = bivariate_gaussian(45, 3, 3, 0, isotropic=True)

# The isotropic bivariate Gaussian is exactly rank-1 (outer product of
# two 1D Gaussians), so the reference's full 45x45 filter2D
# (``data_loader/video_dataset_motion_FrameINO.py:200``) factors into
# two 45-tap separable passes — identical numerics to fp rounding
# (measured max |diff| 7.6e-5 on a [0,255] canvas), 1.5x faster.
_U, _S, _VT = np.linalg.svd(_BLUR_KERNEL)
assert _S[1] / _S[0] < 1e-10, "blur kernel is not rank-1"
_KY = (_U[:, 0] * np.sqrt(_S[0])).astype(np.float32)
_KX = (_VT[0] * np.sqrt(_S[0])).astype(np.float32)
if _KY.sum() < 0:                      # SVD sign ambiguity
    _KY, _KX = -_KY, -_KX
# blur can only change pixels within the kernel radius (22) of painted
# content; with this margin around the painted bbox, an ROI-limited blur
# is EXACT: every pixel <= bbox+22 sees its full true neighborhood
# inside the ROI, and the ROI's outer ring recomputes to white.
_BLUR_MARGIN = 44 + 4                  # + cubic-resize ringing support


def _blur_dilate(canvas: np.ndarray, bbox) -> np.ndarray:
    """Separable 45x45 Gaussian dilation, restricted to the painted
    bbox (target-resolution coords) + margin. ``bbox=None`` means an
    untouched white canvas: the normalized kernel maps it to itself."""
    if bbox is None:
        return canvas
    h, w = canvas.shape[:2]
    x0, y0, x1, y1 = bbox
    y0 = max(0, y0 - _BLUR_MARGIN)
    y1 = min(h, y1 + _BLUR_MARGIN)
    x0 = max(0, x0 - _BLUR_MARGIN)
    x1 = min(w, x1 + _BLUR_MARGIN)
    canvas[y0:y1, x0:x1] = cv2.sepFilter2D(canvas[y0:y1, x0:x1], -1,
                                           _KX, _KY)
    return canvas


def rasterize_trajectories(full_pred_tracks: Sequence[Sequence[Sequence]],
                           original_height: int, original_width: int,
                           dot_radius: int,
                           target_width: int, target_height: int,
                           selected_frames: Optional[np.ndarray] = None,
                           region_box=None):
    """tracks[frame][object][point] = (x, y) -> rasterized video.

    Returns (traj_float [-1,1] np.float32 [F,3,H,W], traj_uint8
    [F,H,W,3], merge_frames or None).
    """
    colors = ALL_COLOR_CODES[:len(full_pred_tracks[0])]
    radius = int(dot_radius * original_height / 384)

    sx = target_width / original_width
    sy = target_height / original_height
    traj_frames = []
    merge_frames = [] if selected_frames is not None else None
    for t, obj_points in enumerate(full_pred_tracks):
        canvas = np.full((original_height, original_width, 3), 255.0,
                         np.float32)
        bbox = None                    # painted extent, original coords
        for obj_idx, points in enumerate(obj_points):
            color = colors[obj_idx]
            for (x, y) in points:
                if x < 0 or x >= original_width or y < 0 or \
                        y >= original_height:
                    continue
                y0 = min(original_height, max(0, int(y) - radius))
                y1 = min(original_height, max(0, int(y) + radius))
                x0 = min(original_width, max(0, int(x) - radius))
                x1 = min(original_width, max(0, int(x) + radius))
                canvas[y0:y1, x0:x1] = color
                bbox = (x0, y0, x1, y1) if bbox is None else (
                    min(bbox[0], x0), min(bbox[1], y0),
                    max(bbox[2], x1), max(bbox[3], y1))
        canvas = cv2.resize(canvas, (target_width, target_height),
                            interpolation=cv2.INTER_CUBIC)
        if bbox is not None:           # scale painted extent to target
            bbox = (int(bbox[0] * sx), int(bbox[1] * sy),
                    int(bbox[2] * sx) + 1, int(bbox[3] * sy) + 1)
        canvas = _blur_dilate(canvas, bbox).astype(np.uint8)
        traj_frames.append(canvas)

        if merge_frames is not None:
            frame = selected_frames[t].copy()
            if region_box is not None:
                (tx, ty), (bx, by) = region_box
                frame = cv2.rectangle(frame, (tx, ty), (bx, by),
                                      (255, 0, 0), 5)
            frame[canvas < 250] = canvas[canvas < 250]
            merge_frames.append(frame)

    traj_uint8 = np.stack(traj_frames)
    traj_float = traj_uint8.astype(np.float32) / 255.0 * 2.0 - 1.0
    traj_float = traj_float.transpose(0, 3, 1, 2)          # [F, C, H, W]
    merged = np.stack(merge_frames) if merge_frames is not None else None
    return traj_float, traj_uint8, merged


def resample_track_by_length(points: Sequence[Tuple[float, float]],
                             num_samples: int) -> np.ndarray:
    """Arc-length-uniform polyline resampling (reference app.py:487-501):
    clicked waypoints -> one point per output frame."""
    pts = np.asarray(points, np.float64)
    if len(pts) == 1:
        return np.repeat(pts, num_samples, axis=0)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    if total == 0:
        return np.repeat(pts[:1], num_samples, axis=0)
    targets = np.linspace(0.0, total, num_samples)
    out = np.empty((num_samples, 2))
    out[:, 0] = np.interp(targets, cum, pts[:, 0])
    out[:, 1] = np.interp(targets, cum, pts[:, 1])
    return out
