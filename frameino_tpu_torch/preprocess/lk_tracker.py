"""Pyramidal Lucas-Kanade point tracker with forward-backward cycle
consistency (the port's own copy of ``frameino_tpu/preprocess/
lk_tracker.py``; the naive evaluation tracker runs it).

Reference ``preprocess/track_regular_motion_cycle.py`` tracks panoptic
points with CoTracker3 forward THEN backward and keeps points whose
cycle closes (``:319-345``). CoTracker weights cannot ship with the
framework; this tracker implements the same forward/backward-cycle
protocol on classical pyramidal LK flow (cv2.calcOpticalFlowPyrLK), so
the curation chain produces real motion signal offline. A CoTracker3
adapter remains available in ``evaluation/perception.py``
for parity when torch.hub weights are reachable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import cv2
import numpy as np

_LK_PARAMS = dict(winSize=(21, 21), maxLevel=3,
                  criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                            30, 0.01))


def _gray(frames: np.ndarray):
    return [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames]


def lk_track(frames: np.ndarray, queries: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Track ``queries`` [N, 2] (x, y on frame 0) through ``frames``
    [T, H, W, 3] uint8. Returns (tracks [T, N, 2], status [T, N] bool).

    Lost points (LK status 0 or out of bounds) carry their last position
    with status False — matching the dataset contract that every frame
    lists every point.
    """
    gray = _gray(frames)
    T = len(gray)
    H, W = gray[0].shape
    pts = np.asarray(queries, np.float32).reshape(-1, 1, 2)
    N = len(pts)
    alive = np.ones((N,), bool)
    tracks = np.zeros((T, N, 2), np.float32)
    status = np.zeros((T, N), bool)
    tracks[0] = pts[:, 0]
    status[0] = True
    for t in range(1, T):
        nxt, st, _ = cv2.calcOpticalFlowPyrLK(gray[t - 1], gray[t], pts,
                                              None, **_LK_PARAMS)
        st = st.reshape(-1).astype(bool)
        inb = ((nxt[:, 0, 0] >= 0) & (nxt[:, 0, 0] < W)
               & (nxt[:, 0, 1] >= 0) & (nxt[:, 0, 1] < H))
        alive = alive & st & inb
        pts = np.where(alive[:, None, None], nxt, pts)
        tracks[t] = pts[:, 0]
        status[t] = alive
    return tracks, status


def lk_track_cycle(frames: np.ndarray, queries: np.ndarray,
                   cycle_thresh: float = 3.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Forward + backward tracking with cycle-consistency filtering
    (the reference's cycle protocol, ``track_regular_motion_cycle.py``).

    Returns (tracks [T, N, 2], visibility [T, N] bool) where a point is
    visible only if tracking it forward to frame t and back to frame 0
    lands within ``cycle_thresh`` pixels of its start.
    """
    fwd, fwd_ok = lk_track(frames, queries)
    T = len(frames)
    vis = fwd_ok.copy()
    # backward pass from each point's final position
    bwd, bwd_ok = lk_track(frames[::-1].copy(), fwd[-1])
    back_at_0 = bwd[-1]                      # position back on frame 0
    cycle_err = np.linalg.norm(back_at_0 - np.asarray(queries, np.float32),
                               axis=-1)
    consistent = (cycle_err <= cycle_thresh) & bwd_ok[-1]
    vis &= consistent[None, :]
    return fwd, vis


def make_lk_tracker(cycle_thresh: Optional[float] = 3.0):
    """Callable matching the ``tracker(frames, queries) -> [T, N, 2]``
    contract of ``preprocess/motion_tracking.track_step`` and the
    evaluation backends."""
    def track(frames: np.ndarray, queries: np.ndarray) -> np.ndarray:
        if cycle_thresh is None:
            return lk_track(frames, queries)[0]
        return lk_track_cycle(frames, queries, cycle_thresh)[0]

    return track
