"""Mass evaluation dispatcher over instanceN/ artifact directories (the
port's own copy of ``frameino_tpu/evaluation/mass_evaluation.py``).

Reference ``evaluation/mass_evaluation.py``: runs the chosen metrics
over a results directory and writes ``results.json``. FrameIn scores all
four metrics; FrameOut omits Relative_DINO (``:78-80``); canonical test
frames: 49 FrameIn / 14 FrameOut; region normalized to 256x384.

Perception backends (point tracker / video segmenter / image embedder /
VLM judge) are injected as callables so the heavy external models
(CoTracker3, SAM2, DINOv2, Qwen2.5-VL — reference loads them via
torch.hub/HF) are swappable; ``perception.load_default_backends`` builds
the real ones when their weights are available.

One deliberate difference from the JAX module: an instance whose
``gen_padded_frame``, ``gt_padded_frame``, ``gen_frame`` and ``gt_frame``
PNG counts differ raises a ``ValueError`` that names it. JAX counts each
kind on its own and would pick different frame indices for the generated
and the ground-truth clips. Equal counts score exactly as JAX does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from frameino_tpu_torch.evaluation.artifacts import read_instance_frames, read_meta
from frameino_tpu_torch.evaluation.metrics import (cosine_similarity,
                                             region_scaled_canvas,
                                             relative_dino_from_sims,
                                             traj_error_from_tracks,
                                             vlm_success_rate,
                                             vseg_mae_from_masks)

FRAME_IN_METRICS = ("INO_TrajError", "INO_VSeg_MAE", "Relative_DINO",
                    "INO_VLM")
FRAME_OUT_METRICS = ("INO_TrajError", "INO_VSeg_MAE", "INO_VLM")


def _instances(root: str) -> List[str]:
    out = []
    i = 0
    while os.path.isdir(os.path.join(root, f"instance{i}")):
        out.append(os.path.join(root, f"instance{i}"))
        i += 1
    return out


FRAME_KINDS = ("gen_padded_frame", "gt_padded_frame", "gen_frame",
               "gt_frame")


def _frame_count(path: str, kind: str) -> int:
    # prefix match is unambiguous: "gt_frame" never prefixes
    # "gt_padded_frame" and vice versa
    return len([f for f in os.listdir(path)
                if f.startswith(kind) and f.endswith(".png")])


def check_frame_counts(root: str) -> None:
    """Every instance holds as many frames of each kind; raises a
    ValueError naming the first that does not."""
    for inst in _instances(root):
        counts = {k: _frame_count(inst, k) for k in FRAME_KINDS}
        if len(set(counts.values())) > 1:
            raise ValueError(f"{inst}: frame counts differ between kinds "
                             f"{counts}; the generated and ground-truth "
                             f"clips would be sampled at different frames")


def _frame_indices(path: str, kind: str, test_num_frames: int):
    n = _frame_count(path, kind)
    return np.linspace(0, n - 1, min(test_num_frames, n)).astype(int)


def eval_traj_error(root: str, tracker: Callable,
                    region_h=256, region_w=384,
                    test_num_frames: int = 49) -> float:
    """tracker(frames [T,H,W,3] uint8, queries [N,2] xy-on-frame0) ->
    tracks [T,N,2]."""
    scores = []
    for inst in _instances(root):
        meta = read_meta(inst)
        tracks0 = meta["full_pred_tracks"][0][0]
        if len(tracks0) == 0:
            continue
        import cv2
        sample = cv2.imread(os.path.join(inst, "gt_padded_frame0.png"))
        ch, cw = sample.shape[:2]
        sh, sw, scale_h, scale_w = region_scaled_canvas(
            ch, cw, meta["resized_mask_region_box"], region_h, region_w)
        ow, oh = meta["original_width"], meta["original_height"]
        queries = np.array([[int(sw * x / ow), int(sh * y / oh)]
                            for (x, y) in tracks0], np.float32)
        gi = _frame_indices(inst, "gen_padded_frame", test_num_frames)
        ti = _frame_indices(inst, "gt_padded_frame", test_num_frames)
        gen = read_instance_frames(inst, "gen_padded_frame", gi, (sh, sw))
        gt = read_instance_frames(inst, "gt_padded_frame", ti, (sh, sw))
        pred_tracks = tracker(gen, queries)
        gt_tracks = tracker(gt, queries)
        scores.append(traj_error_from_tracks(pred_tracks, gt_tracks))
    return float(np.mean(scores))


def eval_vseg_mae(root: str, segmenter: Callable,
                  region_h=256, region_w=384,
                  test_num_frames: int = 49) -> float:
    """segmenter(frames, first_frame_points [N,2]) -> masks [T,H,W]."""
    scores = []
    for inst in _instances(root):
        meta = read_meta(inst)
        pts0 = meta["full_pred_tracks"][0][0]
        if len(pts0) == 0:
            continue
        import cv2
        sample = cv2.imread(os.path.join(inst, "gt_padded_frame0.png"))
        ch, cw = sample.shape[:2]
        sh, sw, scale_h, scale_w = region_scaled_canvas(
            ch, cw, meta["resized_mask_region_box"], region_h, region_w)
        (tlx, tly), (brx, bry) = meta["resized_mask_region_box"]
        # the region box scales together with the canvas
        box = ((int(tlx * scale_w), int(tly * scale_h)),
               (int(brx * scale_w), int(bry * scale_h)))
        ow, oh = meta["original_width"], meta["original_height"]
        queries = np.array([[int(sw * x / ow), int(sh * y / oh)]
                            for (x, y) in pts0], np.float32)
        gi = _frame_indices(inst, "gen_padded_frame", test_num_frames)
        ti = _frame_indices(inst, "gt_padded_frame", test_num_frames)
        gen = read_instance_frames(inst, "gen_padded_frame", gi, (sh, sw))
        gt = read_instance_frames(inst, "gt_padded_frame", ti, (sh, sw))
        gen_masks = segmenter(gen, queries)
        gt_masks = segmenter(gt, queries)
        scores.append(vseg_mae_from_masks(gen_masks, gt_masks, box,
                                          region_h, region_w))
    return float(np.mean(scores))


def eval_relative_dino(root: str, embedder: Callable,
                       test_num_frames: int = 49) -> float:
    """embedder(image [H,W,3] uint8) -> feature vector."""
    scores = []
    for inst in _instances(root):
        ref_path = os.path.join(inst, "Main_Reference.png")
        if not os.path.exists(ref_path):
            continue
        import cv2
        ref = cv2.cvtColor(cv2.imread(ref_path), cv2.COLOR_BGR2RGB)
        ref_feat = embedder(ref)
        gi = _frame_indices(inst, "gen_frame", test_num_frames)
        ti = _frame_indices(inst, "gt_frame", test_num_frames)
        gen = read_instance_frames(inst, "gen_frame", gi)
        gt = read_instance_frames(inst, "gt_frame", ti)
        gen_sims = [max(0.0, cosine_similarity(ref_feat, embedder(f)))
                    for f in gen]
        gt_sims = [max(0.0, cosine_similarity(ref_feat, embedder(f)))
                   for f in gt]
        try:
            scores.append(relative_dino_from_sims(gen_sims, gt_sims))
        except ZeroDivisionError:
            continue
    return float(np.mean(scores))


def eval_vlm(root: str, judge: Callable, is_frame_in: bool,
             test_num_frames: int = 14) -> float:
    """judge(frames, prompt, is_frame_in) -> 'Yes'/'No'."""
    answers = []
    for inst in _instances(root):
        with open(os.path.join(inst, "prompt.txt")) as f:
            prompt = f.read()
        gi = _frame_indices(inst, "gen_padded_frame", test_num_frames)
        gen = read_instance_frames(inst, "gen_padded_frame", gi)
        answers.append(judge(gen, prompt, is_frame_in))
    return vlm_success_rate(answers)


def mass_evaluation(data_parent_path: str,
                    evaluation_metrics: Sequence[str],
                    backends: Dict[str, Callable],
                    common_target_height: int = 256,
                    common_target_width: int = 384,
                    test_num_frames: int = 49,
                    is_frame_in: Optional[bool] = None,
                    store_json_path: str = "results.json") -> Dict:
    assert is_frame_in is not None
    check_frame_counts(data_parent_path)
    results = {}
    timings = {}
    n_inst = len(_instances(data_parent_path))
    for metric in evaluation_metrics:
        t0 = time.time()
        if metric == "INO_TrajError":
            results[metric] = eval_traj_error(
                data_parent_path, backends["tracker"],
                common_target_height, common_target_width, test_num_frames)
        elif metric == "INO_VSeg_MAE":
            results[metric] = eval_vseg_mae(
                data_parent_path, backends["segmenter"],
                common_target_height, common_target_width, test_num_frames)
        elif metric == "Relative_DINO":
            results[metric] = eval_relative_dino(
                data_parent_path, backends["embedder"], test_num_frames)
        elif metric == "INO_VLM":
            results[metric] = eval_vlm(data_parent_path, backends["judge"],
                                       is_frame_in)
        else:
            raise NotImplementedError(metric)
        timings[metric] = round(time.time() - t0, 2)
    # per-metric wall seconds (totals, not per instance) — the mass-eval
    # wall-clock benchmark reads these; ref pays hours of GPU per run
    # (reference evaluation/mass_evaluation.py:20-63)
    results["_timings_s"] = timings
    results["_num_instances"] = n_inst
    if os.path.exists(store_json_path):
        os.remove(store_json_path)
    with open(store_json_path, "w") as f:
        json.dump(results, f, indent=4)
    return results
