"""Step 5: camera-pose estimation + pruning (the port's own copy of
``frameino_tpu/preprocess/camera_pose.py``; reference
``preprocess/track_camera_pose_spatracker2.py`` +
``make_delete_lists_camera.py``).

The reference runs SpaTrackV2/VGGT to get per-frame camera extrinsics
``{rotation [T,3,3], translation [T,3], focal_x/y [T]}``
(``track_camera_pose_spatracker2.py:35-64``), scores each clip with
``compute_pose_error`` (geodesic rotation deg + translation distance +
focal drift, averaged over adjacent frames,
``make_delete_lists_camera.py:24-110``), then deletes the top fraction
of each ranking (delete_ranges ``rotation/translation [0.6,1.0]``,
``focal [0.85,1.0]``).

Those learned 3D trackers are multi-GB and pluggable here; the built-in
estimator is a **two-view geometry** stand-in: pyramidal-LK grid flow →
essential matrix + ``cv2.recoverPose`` per adjacent pair, which — unlike
a 2D homography — actually splits rotation from translation and detects
parallax (VERDICT r2 missing #4). The scoring/pruning math is identical
for both sources, so SpaTrackV2 output drops in unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Reference scoring math (drop-in for SpaTrackV2 camera_info dicts)
# ---------------------------------------------------------------------------

def compute_pose_error(R1: np.ndarray, t1: np.ndarray, prev_focal: float,
                       R2: np.ndarray, t2: np.ndarray, cur_focal: float
                       ) -> Tuple[float, float, float]:
    """Pairwise pose error, reference semantics
    (``make_delete_lists_camera.py:24-58``): euclidean translation
    distance, geodesic rotation angle in degrees, |focal drift|."""
    translation_error = float(np.linalg.norm(
        np.asarray(t1, np.float64) - np.asarray(t2, np.float64)))
    R_diff = np.asarray(R1, np.float64).T @ np.asarray(R2, np.float64)
    c = np.clip((np.trace(R_diff) - 1.0) / 2.0, -1.0, 1.0)
    rotation_error_deg = float(np.degrees(np.arccos(c)))
    focal_difference = abs(float(cur_focal) - float(prev_focal))
    return translation_error, rotation_error_deg, focal_difference


def calculate_camera_motion(camera_info: Dict) -> Tuple[float, float, float]:
    """Average (rotation_deg, translation, focal_change) over adjacent
    frames (``make_delete_lists_camera.py:62-110``). ``camera_info`` is
    the SpaTrackV2 output dict: rotation [T,3,3], translation [T,3],
    focal_x/y [T] (geometric-mean combined, reference ``:70``)."""
    Rs = camera_info["rotation"]
    ts = camera_info["translation"]
    fx, fy = camera_info["focal_x"], camera_info["focal_y"]
    focal = [math.sqrt(fx[i] * fy[i]) for i in range(len(fx))]
    tot_r = tot_t = tot_f = 0.0
    for i in range(1, len(Rs)):
        te, re, fe = compute_pose_error(Rs[i - 1], ts[i - 1], focal[i - 1],
                                        Rs[i], ts[i], focal[i])
        tot_t += te
        tot_r += re
        tot_f += fe
    n = max(len(Rs) - 1, 1)
    return tot_r / n, tot_t / n, tot_f / n


def percentile_delete_set(scores: Sequence[Tuple[float, str]],
                          delete_range: Tuple[float, float]) -> set:
    """Rank-based pruning (``make_delete_lists_camera.py:230-260``):
    sort ascending by score; delete the [lo, hi] fraction of the ranking
    (1.0 = strongest motion). Returns the set of deleted keys."""
    order = sorted(scores, key=lambda x: x[0])
    n = len(order)
    lo = int(delete_range[0] * n)
    hi = int(delete_range[1] * n)
    return {key for _, key in order[lo:hi]}


DEFAULT_DELETE_RANGES = {           # reference defaults (``:139-146``)
    "rotation": (0.6, 1.0),
    "translation": (0.6, 1.0),
    "focal": (0.85, 1.0),
}


def make_camera_delete_list(camera_infos: Dict[str, Dict],
                            delete_ranges: Dict = None) -> set:
    """{clip_key: camera_info} -> keys to delete, union of the three
    rankings, matching the reference's step-5 pruning."""
    delete_ranges = delete_ranges or DEFAULT_DELETE_RANGES
    rot, tra, foc = [], [], []
    for key, info in camera_infos.items():
        r, t, f = calculate_camera_motion(info)
        rot.append((r, key))
        tra.append((t, key))
        foc.append((f, key))
    return (percentile_delete_set(rot, delete_ranges["rotation"])
            | percentile_delete_set(tra, delete_ranges["translation"])
            | percentile_delete_set(foc, delete_ranges["focal"]))


# ---------------------------------------------------------------------------
# Pose-matrix helpers (pluggable 3D-tracker output, [T,4,4])
# ---------------------------------------------------------------------------

def pose_translation_stats(poses: np.ndarray) -> Tuple[float, float]:
    """poses: [T, 4, 4] camera-to-world. Returns (total_path_length,
    max_per_frame_jerk)."""
    t = np.asarray(poses, np.float64)[:, :3, 3]
    step = np.linalg.norm(np.diff(t, axis=0), axis=-1)
    jerk = np.abs(np.diff(step)) if len(step) > 1 else np.zeros(1)
    return float(step.sum()), float(jerk.max(initial=0.0))


def prune_by_pose_error(poses: np.ndarray, min_path: float = 0.0,
                        max_path: float = np.inf,
                        max_jerk: float = np.inf) -> bool:
    """True if the clip should be KEPT."""
    path, jerk = pose_translation_stats(poses)
    return (min_path <= path <= max_path) and jerk <= max_jerk


# ---------------------------------------------------------------------------
# Built-in two-view estimator (essential matrix + recoverPose)
# ---------------------------------------------------------------------------

def _grid_flow(gray0, gray1, grid: int, H: int, W: int):
    import cv2
    from frameino_tpu_torch.preprocess.lk_tracker import _LK_PARAMS
    ys, xs = np.meshgrid(np.linspace(H * 0.1, H * 0.9, grid),
                         np.linspace(W * 0.1, W * 0.9, grid),
                         indexing="ij")
    p0 = np.stack([xs.ravel(), ys.ravel()], -1).astype(
        np.float32).reshape(-1, 1, 2)
    p1, st, _ = cv2.calcOpticalFlowPyrLK(gray0, gray1, p0, None,
                                         **_LK_PARAMS)
    ok = st.reshape(-1).astype(bool)
    return p0.reshape(-1, 2)[ok], p1.reshape(-1, 2)[ok]


def estimate_relative_poses(frames: np.ndarray, focal: float = None,
                            grid: int = 12, flow_only: bool = False) -> Dict:
    """Two-view camera estimation per adjacent pair. Returns the
    SpaTrackV2-format ``camera_info`` dict (accumulated rotations, unit
    -baseline translations scaled by the flow-derived magnitude proxy)
    plus per-pair diagnostics:

    - ``flow_px``: median flow magnitude (px);
    - ``flow_vec``: per-axis median flow vector [dx, dy] (px) — the
      shake/reversal signal, so callers never re-run the LK flow;
    - ``h_residual_px``: median reprojection error of the best RANSAC
      homography — LOW means the flow is explained by a planar/rotation
      model (no parallax), HIGH means real translation parallax;
    - ``rot_deg``: recoverPose rotation angle per pair.

    A pure 2D homography cannot make this split (VERDICT r2 missing #4):
    rotation and distant-scene translation both fit H, but only
    translation leaves parallax residuals that E explains and H cannot.

    ``flow_only=True`` skips the two RANSAC solves per pair (homography
    + essential matrix) and returns identity poses with flow
    diagnostics only — the fast path for flow-threshold pruning
    (``keep_by_camera_motion``), where the LK flow dominates cost and
    the pose estimates are never read.
    """
    import cv2
    T, H, W = frames.shape[:3]
    f = float(focal if focal is not None else max(H, W))
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]],
                 np.float64)
    gray = [cv2.cvtColor(fr, cv2.COLOR_RGB2GRAY) for fr in frames]
    Rs = [np.eye(3)]
    ts = [np.zeros(3)]
    flow_px: List[float] = []
    flow_vec: List[List[float]] = []
    h_res: List[float] = []
    rot_deg: List[float] = []
    R_acc = np.eye(3)
    t_acc = np.zeros(3)
    for i in range(T - 1):
        p0, p1 = _grid_flow(gray[i], gray[i + 1], grid, H, W)
        if len(p0) < 8:
            flow_px.append(0.0)
            flow_vec.append([0.0, 0.0])
            h_res.append(0.0)
            rot_deg.append(0.0)
            Rs.append(R_acc.copy())
            ts.append(t_acc.copy())
            continue
        med_flow = float(np.median(np.linalg.norm(p1 - p0, axis=-1)))
        flow_px.append(med_flow)
        flow_vec.append(np.median(p1 - p0, axis=0).tolist())
        if flow_only:
            h_res.append(0.0)
            rot_deg.append(0.0)
            Rs.append(R_acc.copy())
            ts.append(t_acc.copy())
            continue
        # homography residual = parallax signal
        Hm, hmask = cv2.findHomography(p0, p1, cv2.RANSAC, 3.0)
        if Hm is not None:
            proj = cv2.perspectiveTransform(
                p0.reshape(-1, 1, 2).astype(np.float64), Hm).reshape(-1, 2)
            h_res.append(float(np.median(
                np.linalg.norm(proj - p1, axis=-1))))
        else:
            h_res.append(float("inf"))
        # essential matrix -> R, unit t
        R_pair = np.eye(3)
        t_pair = np.zeros(3)
        if med_flow > 1e-3:
            E, emask = cv2.findEssentialMat(p0, p1, K, cv2.RANSAC, 0.999,
                                            1.0)
            if E is not None and E.shape == (3, 3):
                _, R_pair, t_unit, _ = cv2.recoverPose(E, p0, p1, K,
                                                       mask=emask)
                # unit baseline scaled by the flow-over-focal proxy
                # (monocular scale is unobservable; this keeps the
                # ranking monotone in apparent motion)
                t_pair = t_unit.reshape(3) * (med_flow / f)
        c = np.clip((np.trace(R_pair) - 1.0) / 2.0, -1.0, 1.0)
        rot_deg.append(float(np.degrees(np.arccos(c))))
        R_acc = R_pair @ R_acc
        t_acc = t_acc + t_pair
        Rs.append(R_acc.copy())
        ts.append(t_acc.copy())
    return {
        "rotation": [R.tolist() for R in Rs],
        "translation": [t.tolist() for t in ts],
        "focal_x": [f] * T,
        "focal_y": [f] * T,
        "flow_px": flow_px,
        "flow_vec": flow_vec,
        "h_residual_px": h_res,
        "rot_deg": rot_deg,
    }


def classify_camera_motion(frames: np.ndarray, focal: float = None,
                           static_px: float = 0.5,
                           shake_reversal: float = 0.6,
                           parallax_px: float = 1.5) -> Dict:
    """Classify the dominant camera motion of a clip:

    - ``static``: negligible background flow;
    - ``shake``: flow direction keeps reversing (handheld jitter);
    - ``pan``: smooth motion fully explained by a homography (camera
      rotation / distant scene — no parallax);
    - ``translate``: smooth motion with parallax (homography residual
      above ``parallax_px``).
    """
    info = estimate_relative_poses(frames, focal)
    flow = np.asarray(info["flow_px"])
    hres = np.asarray(info["h_residual_px"])
    stats = {
        "mean_flow_px": float(flow.mean()) if len(flow) else 0.0,
        "mean_h_residual_px": float(np.nan_to_num(hres, posinf=99.0)
                                    .mean()) if len(hres) else 0.0,
        "mean_rot_deg": float(np.mean(info["rot_deg"]))
        if info["rot_deg"] else 0.0,
    }
    if stats["mean_flow_px"] < static_px:
        stats["class"] = "static"
        return stats
    # direction-reversal fraction of the dominant flow axis
    # (camera_info translations are too noisy at small baselines; raw
    # flow sign flips are the robust shake signal) — read from the
    # estimator's per-pair flow vectors, no second LK pass
    dxs = np.asarray([d[int(np.argmax(np.abs(d)))]
                      for d in np.asarray(info["flow_vec"])])
    moving = dxs[np.abs(dxs) > static_px]
    reversals = (np.mean(np.sign(moving[1:]) != np.sign(moving[:-1]))
                 if len(moving) > 1 else 0.0)
    stats["reversal_frac"] = float(reversals)
    if reversals >= shake_reversal:
        stats["class"] = "shake"
    elif stats["mean_h_residual_px"] > parallax_px:
        stats["class"] = "translate"
    else:
        stats["class"] = "pan"
    return stats


def camera_motion_stats(frames: np.ndarray) -> dict:
    """Summary stats driving static/shaky pruning (kept for backward
    compatibility; flow-only — the pose solves would be discarded)."""
    info = estimate_relative_poses(frames, flow_only=True)
    flow = np.asarray(info["flow_px"])
    jerk = np.abs(np.diff(flow)) if len(flow) > 1 else np.zeros(1)
    return {"path_px": float(flow.sum()),
            "mean_step_px": float(flow.mean()) if len(flow) else 0.0,
            "max_jerk_px": float(jerk.max(initial=0.0))}


def keep_by_camera_motion(frames: np.ndarray,
                          max_mean_step_px: float = 15.0,
                          max_jerk_px: float = 20.0) -> bool:
    """KEEP unless the camera is too shaky (large jerk) or the whole
    frame moves so fast that object motion can't be separated."""
    s = camera_motion_stats(frames)
    return (s["mean_step_px"] <= max_mean_step_px
            and s["max_jerk_px"] <= max_jerk_px)
