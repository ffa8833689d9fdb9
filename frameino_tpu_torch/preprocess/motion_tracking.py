"""Step 7: point tracking + motion-magnitude filtering (the port's own
copy of ``frameino_tpu/preprocess/motion_tracking.py``).

Reference ``preprocess/track_regular_motion_cycle.py`` (CoTracker3
forward+backward tracks of the panoptic points -> ``Track_Traj``) and
``make_delete_lists_motion.py`` (prune static clips). The tracker is
pluggable (reference loads CoTracker3 via torch.hub; the evaluation
package's ``naive_tracker`` works offline); the filtering math is
implemented.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


def track_step(frames: np.ndarray, obj_points: Sequence[Sequence],
               tracker: Callable) -> List[List[List[List[float]]]]:
    """tracker(frames, queries [N,2]) -> [T, N, 2]. Returns
    ``Track_Traj``-shaped payload: per object, per frame, point list."""
    out = []
    for pts in obj_points:
        tracks = np.asarray(tracker(frames, np.asarray(pts, np.float32)))
        out.append([[list(map(float, p)) for p in frame_pts]
                    for frame_pts in tracks])
    return out


def motion_magnitude(tracks: np.ndarray) -> float:
    """Mean total displacement per point over the clip."""
    t = np.asarray(tracks, np.float64)          # [T, N, 2]
    step = np.linalg.norm(np.diff(t, axis=0), axis=-1)
    return float(step.sum(axis=0).mean())


def motion_magnitude_filter(track_traj, min_magnitude: float = 5.0):
    """Keep objects whose mean point displacement exceeds the threshold
    (prunes static clips like make_delete_lists_motion.py)."""
    kept = []
    for obj_tracks in track_traj:
        if motion_magnitude(np.asarray(obj_tracks)) >= min_magnitude:
            kept.append(obj_tracks)
    return kept
