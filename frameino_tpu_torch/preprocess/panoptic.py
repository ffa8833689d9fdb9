"""Step 4: panoptic segmentation -> per-object sampled points (the port's
own copy of ``frameino_tpu/preprocess/panoptic.py``).

Reference ``preprocess/filter_panoptic_multi.py`` + vendored OneFormer:
panoptic masks on sampled frames, then per-object point sampling that
becomes the ``Obj_Info`` / ``Panoptic_Segmentation`` CSV columns. The
panoptic model is pluggable (``preprocess/panoptic_oneformer.py`` wraps
the port's OneFormer); the point-sampling and CSV logic is fully
implemented.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def sample_points_from_mask(mask: np.ndarray, num_points: int = 10,
                            rng: Optional[np.random.Generator] = None
                            ) -> List[Tuple[int, int]]:
    """Uniformly sample (x, y) points inside a binary object mask."""
    rng = rng or np.random.default_rng(0)
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return []
    idx = rng.choice(len(xs), size=min(num_points, len(xs)), replace=False)
    return [(int(xs[i]), int(ys[i])) for i in idx]


def run_panoptic_step(frames: np.ndarray,
                      panoptic_model: Callable,
                      frame_idx: int = 0,
                      num_points: int = 10,
                      min_area: int = 64,
                      rng: Optional[np.random.Generator] = None):
    """panoptic_model(frame) -> list of (label: str, mask: [H, W] bool).

    Returns (Obj_Info, Panoptic_Segmentation) column payloads in the
    reference's JSON-list-per-panoptic-choice format."""
    segments = panoptic_model(frames[frame_idx])
    obj_info, seg_points = [], []
    for label, mask in segments:
        if int(mask.sum()) < min_area:
            continue
        pts = sample_points_from_mask(mask, num_points, rng)
        if not pts:
            continue
        obj_info.append([label, frame_idx])
        seg_points.append(pts)
    return [obj_info], [seg_points]


def connected_component_panoptic(frame: np.ndarray,
                                 threshold: int = 128):
    """Cheap baseline 'panoptic' model: bright/dark connected components.
    Lets the pipeline run without OneFormer."""
    import cv2
    gray = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
    binary = (gray > threshold).astype(np.uint8)
    n, labels = cv2.connectedComponents(binary)
    out = []
    for i in range(1, n):
        out.append((f"region_{i}", labels == i))
    return out


def motion_segmenter(frames: np.ndarray, motion_thresh: float = 1.5,
                     stride: int = 4, min_area: int = 32):
    """Moving-object instance segmentation from camera-compensated
    optical flow — the right classical stand-in for OneFormer in THIS
    pipeline, whose purpose is finding objects that move independently
    (the Frame-In/Out candidates; reference
    ``filter_panoptic_multi.py`` + ``track_regular_motion_cycle.py``).

    Chained adjacent-frame LK flow of a pixel grid from frame 0 to
    ~T/4; the dominant RANSAC homography over the tracked grid is the
    camera motion, and points disagreeing with it are independent
    movers, grouped into connected components. Returns
    [(label, mask_bool_hw), ...] on frame 0.
    """
    import cv2
    T, H, W = frames.shape[:3]
    t1 = min(T - 1, max(1, T // 4))
    gray = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY)
            for f in frames[:t1 + 1]]

    ys, xs = np.mgrid[stride // 2:H:stride, stride // 2:W:stride]
    p0 = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    # chain ADJACENT-frame LK WITHOUT pyramids: per-step motion is
    # small (<= half the 15px window), and any pyramid level sends
    # points near changed regions into false basins on
    # weakly-structured backgrounds (measured: a static point 20px from
    # a moving object jumps 13px at maxLevel>=1, exact at maxLevel=0)
    lk = dict(winSize=(15, 15), maxLevel=0,
              criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                        30, 0.01))
    cur = p0.reshape(-1, 1, 2)
    ok = np.ones((len(p0),), bool)
    for t in range(t1):
        nxt, st, _ = cv2.calcOpticalFlowPyrLK(gray[t], gray[t + 1], cur,
                                              None, **lk)
        ok &= st.reshape(-1).astype(bool)
        cur = np.where(ok[:, None, None], nxt, cur)
    p1 = cur.reshape(-1, 2)

    # camera motion = the dominant RANSAC homography over OUR tracked
    # grid (background points dominate); independent movers are the
    # points whose end position disagrees with it
    if ok.sum() >= 8:
        Hm, _ = cv2.findHomography(p0[ok].reshape(-1, 1, 2),
                                   p1[ok].reshape(-1, 1, 2),
                                   cv2.RANSAC, 2.0)
        if Hm is None:
            Hm = np.eye(3)
    else:
        Hm = np.eye(3)
    hom_pts = cv2.perspectiveTransform(p0.reshape(-1, 1, 2),
                                       Hm.astype(np.float64)).reshape(-1, 2)
    residual = np.linalg.norm(p1 - hom_pts, axis=-1)
    moving = ok & (residual > motion_thresh)

    grid = np.zeros(xs.shape, np.uint8)
    grid.ravel()[moving] = 1
    # close gaps on the coarse grid, then lift to pixel resolution
    grid = cv2.morphologyEx(grid, cv2.MORPH_CLOSE,
                            np.ones((3, 3), np.uint8))
    full = cv2.resize(grid, (W, H), interpolation=cv2.INTER_NEAREST)
    n, labels = cv2.connectedComponents(full)
    out = []
    for i in range(1, n):
        mask = labels == i
        if int(mask.sum()) >= min_area:
            out.append((f"moving_{i}", mask))
    return out
