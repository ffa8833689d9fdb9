"""Step 2: shot-boundary scoring + valid-duration pruning (the port's own
copy of ``frameino_tpu/preprocess/scene_cut.py``).

Reference ``preprocess/scoring_scene_cut_autoshot.py`` scores every
frame with AutoShot (TransNetV2 supernet) and
``make_delete_lists_scene_cut.py`` converts the scores into a per-clip
``valid_duration`` (the longest cut-free span). The scorer here is
pluggable: pass an AutoShot-like callable for parity, or use the
built-in frame-difference baseline.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


def frame_difference_scores(frames: np.ndarray) -> np.ndarray:
    """[F, H, W, 3] -> [F] cut scores in [0, 1] (cheap baseline):
    normalized mean absolute inter-frame difference."""
    f = frames.astype(np.float32)
    d = np.abs(np.diff(f, axis=0)).mean(axis=(1, 2, 3))
    d = d / (d.max() + 1e-6)
    return np.concatenate([[0.0], d])


def histogram_cut_scores(frames: np.ndarray, bins: int = 8) -> np.ndarray:
    """Shot-boundary scores from HSV histogram distance with adaptive
    (median + MAD) normalization — the classical real detector standing
    in for AutoShot's learned supernet (reference
    ``auxiliary/AutoShot.py:70``; weights are not shippable). A hard cut
    produces a histogram-correlation collapse that local motion does
    not, so this separates cuts from motion far better than raw frame
    difference.

    Returns [F] scores in [0, 1]; score[0] = 0.
    """
    import cv2
    hists = []
    for f in frames:
        hsv = cv2.cvtColor(f, cv2.COLOR_RGB2HSV)
        # full 3D HSV histogram: V included so pure-luminance cuts
        # register (H-S alone is blind to brightness changes)
        h = cv2.calcHist([hsv], [0, 1, 2], None, [bins, bins, bins],
                         [0, 180, 0, 256, 0, 256])
        hists.append(cv2.normalize(h, None).flatten())
    d = np.array([0.0] + [
        1.0 - float(cv2.compareHist(hists[i - 1], hists[i],
                                    cv2.HISTCMP_CORREL))
        for i in range(1, len(hists))])
    # adaptive scale: a cut is an outlier vs the clip's own motion level
    med = np.median(d[1:]) if len(d) > 1 else 0.0
    mad = np.median(np.abs(d[1:] - med)) + 1e-6
    z = (d - med) / (6.0 * mad)
    return np.clip(z, 0.0, 1.0)


def score_scene_cuts(frames: np.ndarray,
                     model: Optional[Callable] = None) -> np.ndarray:
    scorer = model or histogram_cut_scores
    return np.asarray(scorer(frames))


def longest_clean_span(scores: np.ndarray,
                       threshold: float = 0.5) -> Tuple[int, int]:
    """Longest [start, end) span with no score >= threshold — the
    ``valid_duration`` the dataset consumes."""
    cuts = [0] + [i for i, s in enumerate(scores) if s >= threshold] \
        + [len(scores)]
    best = (0, 0)
    for a, b in zip(cuts[:-1], cuts[1:]):
        start = a if a == 0 else a + 0      # span starts at the cut frame
        if b - start > best[1] - best[0]:
            best = (start, b)
    return best
