"""FrameINO metric cores (pure numpy; the port's own copy of
``frameino_tpu/evaluation/metrics.py``, numbers equal).

The numeric definitions of the four paper metrics, factored out of the
perception models so they are unit-testable and backend-agnostic:

- INO_TrajError (reference ``evaluation/evaluate_INO_Traj.py:194-216``):
  CoTracker tracks the GT first-frame query points in both generated and
  GT padded videos (rescaled so the region box maps to 256x384); score =
  mean over frames of mean per-point Euclidean distance between tracks.
- INO_VSeg_MAE (``evaluate_INO_VSeg_MAE.py:249-272``): |#gen-mask pixels
  - #gt-mask pixels| inside the region box / region target area, meaned
  over frames then videos.
- Relative_DINO (``evaluate_INO_DINO.py:160-197``): per-video mean of
  clamped cosine similarity of each frame crop to the ID reference;
  score = |gen - gt| / gt.
- INO_VLM (``evaluate_INO_VLM.py:36-49``): yes/no success rate.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def region_scaled_canvas(canvas_height: int, canvas_width: int,
                         region_box, region_target_height: int = 256,
                         region_target_width: int = 384
                         ) -> Tuple[int, int, float, float]:
    """Scale the canvas so the region box becomes region_target size
    (reference ``evaluate_INO_Traj.py:126-134``). Returns
    (scaled_h, scaled_w, scale_h, scale_w)."""
    (tlx, tly), (brx, bry) = region_box
    scale_w = region_target_width / (brx - tlx)
    scale_h = region_target_height / (bry - tly)
    return (int(canvas_height * scale_h), int(canvas_width * scale_w),
            scale_h, scale_w)


def traj_error_from_tracks(pred_tracks: np.ndarray,
                           gt_tracks: np.ndarray) -> float:
    """[T, N, 2] int/float tracks -> mean-over-frames of mean point
    distance."""
    pred = np.asarray(pred_tracks, np.float64)
    gt = np.asarray(gt_tracks, np.float64)
    assert pred.shape == gt.shape
    d = np.linalg.norm(pred - gt, axis=-1)       # [T, N]
    return float(d.mean(axis=1).mean())


def vseg_mae_from_masks(gen_masks: np.ndarray, gt_masks: np.ndarray,
                        scaled_region_box,
                        region_target_height: int = 256,
                        region_target_width: int = 384) -> float:
    """[T, H, W] binary masks -> mean in-region area-MAE ratio."""
    (tlx, tly), (brx, bry) = scaled_region_box
    scores = []
    for g, t in zip(gen_masks, gt_masks):
        ng = int(np.sum(g[tly:bry, tlx:brx]))
        nt = int(np.sum(t[tly:bry, tlx:brx]))
        scores.append(abs(ng - nt) / (region_target_height *
                                      region_target_width))
    return float(np.mean(scores))


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def relative_dino_from_sims(gen_sims: Sequence[float],
                            gt_sims: Sequence[float]) -> float:
    """Per-video |mean(gen) - mean(gt)| / mean(gt); sims pre-clamped to
    >= 0 like the reference (``max(0.0, cos)``)."""
    gen = float(np.mean([max(0.0, s) for s in gen_sims]))
    gt = float(np.mean([max(0.0, s) for s in gt_sims]))
    if gt == 0:
        raise ZeroDivisionError("GT similarity is zero for this video")
    return abs(gen - gt) / gt


def vlm_success_rate(answers: Sequence[str]) -> float:
    """Yes/No judge answers -> success rate."""
    hits = [1.0 if str(a).strip().lower().startswith("yes") else 0.0
            for a in answers]
    return float(np.mean(hits)) if hits else 0.0
