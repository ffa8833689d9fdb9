"""FrameINO training dataset — CSV schema + condition synthesis (the
port's own copy of ``frameino_tpu/data/frameino_dataset.py``).

Reference ``data_loader/video_dataset_motion_FrameINO.py`` (Stage-2) and
``video_dataset_motion.py`` (Stage-1). Reproduced per-sample logic:

- CSV columns: video_path, height, width, valid_duration,
  Panoptic_Segmentation, Structured_Text_Prompt, Track_Traj, Obj_Info,
  ID_info (``:225-235``); only the first panoptic choice is used
  (``:260-264``).
- FrameIn drop (prob ``drop_FrameIn_prob`` or FrameOut_only) -> black ID
  placeholder and no main-object motion (``:276-279, 437-439, 480-482``).
- Region box: choose among the 5 largest (or the largest under
  strict_validation_match); coordinates rescaled to the target
  resolution (``:302-319``).
- Clip sampling: start at the panoptic frame, stride
  ``sample_accelerate_factor`` (optionally +1 with faster_motion_prob),
  trimmed to 4N+1 frames (``:343-361``).
- Unbounded-canvas first frame: everything outside the region box
  blacked out (``:371-382``).
- Tracking-point keep rules (``:421-442``): non-main objects keep points
  with prob ``point_keep_ratio_regular`` and only those starting inside
  the region box; the main ID object keeps with
  ``point_keep_ratio_ID`` or drops all points when drop_FrameIn.
- ID reference aspect-resized + zero-padded to the canvas (``:484-508``).
- Trajectory rasterized via ``rasterize_trajectories`` (shared with the
  demo app for train/infer parity).

This class is a plain-Python iterable (torch-free); wrap with any loader
or the MixedBatchSampler.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
import random
import sys
from typing import Dict, List, Optional

import cv2
import numpy as np
from PIL import Image

from frameino_tpu_torch.data.traj import rasterize_trajectories
from frameino_tpu_torch.data.video_io import decode_video

csv.field_size_limit(sys.maxsize)

CSV_COLUMNS = ("video_path", "height", "width", "valid_duration",
               "Panoptic_Segmentation", "Structured_Text_Prompt",
               "Track_Traj", "Obj_Info", "ID_info")


@dataclasses.dataclass
class FrameINODatasetConfig:
    target_height: int = 704
    target_width: int = 1280
    sample_accelerate_factor: int = 2
    train_frame_num_range: tuple = (81, 81)
    min_train_frame_num: int = 49
    dot_radius: int = 7
    point_keep_ratio_regular: float = 0.33
    point_keep_ratio_ID: float = 0.33
    faster_motion_prob: float = 0.0
    drop_FrameIn_prob: float = 0.15
    text_mask_ratio: float = 0.0
    empty_text_prompt: bool = False


def _to_tensor_range(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32) / 255.0 * 2.0 - 1.0


class FrameINODataset:
    def __init__(self, cfg: FrameINODatasetConfig,
                 download_folder_path: str,
                 csv_relative_path: str,
                 video_relative_path: str,
                 ID_relative_path: str,
                 FrameOut_only: bool = False,
                 one_point_one_obj: bool = False,
                 strict_validation_match: bool = False,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.FrameOut_only = FrameOut_only
        self.one_point_one_obj = one_point_one_obj
        self.strict = strict_validation_match
        self.video_folder = os.path.join(download_folder_path,
                                         video_relative_path)
        self.id_folder = os.path.join(download_folder_path, ID_relative_path)
        self.rng = random.Random(seed)

        csv_folder = os.path.join(download_folder_path, csv_relative_path)
        self.rows: List[List[str]] = []
        self.col: Dict[str, int] = {}
        for name in sorted(os.listdir(csv_folder)):
            if not name.endswith(".csv"):
                continue
            with open(os.path.join(csv_folder, name)) as f:
                for i, row in enumerate(csv.reader(f)):
                    if i == 0:
                        self.col = {k: j for j, k in enumerate(row)}
                        continue
                    self.rows.append(row)

    def __len__(self):
        return len(self.rows)

    def _field(self, row, key):
        return row[self.col[key]]

    def __getitem__(self, idx: int) -> Dict:
        # retry-on-exception loop (reference :219, 549-558)
        for _ in range(len(self.rows)):
            try:
                return self._get(idx)
            except Exception:
                idx = (idx + 1) % len(self.rows)
        raise RuntimeError("no valid sample found")

    def _get(self, idx: int) -> Dict:
        cfg = self.cfg
        row = self.rows[idx]
        video_path = os.path.join(self.video_folder,
                                  self._field(row, "video_path"))
        original_height = int(self._field(row, "height"))
        original_width = int(self._field(row, "width"))
        valid_duration = json.loads(self._field(row, "valid_duration"))
        text_prompt = json.loads(
            self._field(row, "Structured_Text_Prompt"))[0]
        Track_Traj = json.loads(self._field(row, "Track_Traj"))[0]
        Obj_Info = json.loads(self._field(row, "Obj_Info"))[0]
        ID_info = json.loads(self._field(row, "ID_info"))[0]

        tw, th = cfg.target_width, cfg.target_height
        frame_start_idx = Obj_Info[0][1]

        # --- FrameIn ID selection -----------------------------------------
        drop_FrameIn = self.FrameOut_only or \
            self.rng.random() < cfg.drop_FrameIn_prob
        if not self.strict:
            effective = [i for i, o in enumerate(ID_info) if o != []]
            main_idx = self.rng.choice(effective)
        else:
            main_idx = 0
        segmentation_info, region_boxes = ID_info[main_idx]
        ref_path = None
        if not self.FrameOut_only:
            _, ref_rel, _ = segmentation_info
            ref_path = os.path.join(self.id_folder, ref_rel)
            if not os.path.exists(ref_path):
                raise FileNotFoundError(ref_path)

        # --- region box ----------------------------------------------------
        region_boxes = sorted(region_boxes, key=lambda x: x[0])
        if not self.strict:
            mask_region = self.rng.choice(region_boxes[-5:])[1:]
        else:
            mask_region = region_boxes[-1][1:]
        (tlx_raw, tly_raw), (brx_raw, bry_raw) = mask_region
        tlx = int(tlx_raw * tw / original_width)
        tly = int(tly_raw * th / original_height)
        brx = int(brx_raw * tw / original_width)
        bry = int(bry_raw * th / original_height)
        resized_box = ((tlx, tly), (brx, bry))

        # --- decode + clip sampling ---------------------------------------
        video_np_full = decode_video(video_path, tw, th)
        video_np = video_np_full[valid_duration[0]:valid_duration[1]]
        valid_num = len(video_np)

        n_raw = self.rng.randint(*cfg.train_frame_num_range)
        accel = cfg.sample_accelerate_factor
        if frame_start_idx + 3 * n_raw < valid_num and \
                self.rng.random() < cfg.faster_motion_prob:
            accel += 1
        frame_end = min(valid_num, frame_start_idx + accel * n_raw)
        frame_end = frame_start_idx + 4 * math.floor(
            ((frame_end - frame_start_idx) - 1) / 4) + 1
        selected = video_np[frame_start_idx:frame_end:accel]
        if len(selected) < cfg.min_train_frame_num:
            raise ValueError("clip too short")
        F = len(selected)

        video_tensor = _to_tensor_range(selected).transpose(0, 3, 1, 2)

        # --- unbounded canvas first frame ---------------------------------
        masked = np.zeros_like(selected)
        masked[:, tly:bry, tlx:brx] = selected[:, tly:bry, tlx:brx]
        first_frame_np = masked[0]
        first_frame_tensor = _to_tensor_range(first_frame_np
                                              ).transpose(2, 0, 1)

        # --- text ----------------------------------------------------------
        if cfg.empty_text_prompt or self.rng.random() < cfg.text_mask_ratio:
            text_prompt = ""

        # --- tracking points ----------------------------------------------
        full_pred_tracks = [[] for _ in range(F)]
        for obj_idx in range(len(Obj_Info)):
            tracks = Track_Traj[obj_idx][frame_start_idx:frame_end:accel]
            if len(tracks) != F:
                raise ValueError("track/video length mismatch")
            n_pts = len(tracks[0])
            if obj_idx != main_idx or self.FrameOut_only:
                keep = [self.rng.random() < cfg.point_keep_ratio_regular
                        for _ in range(n_pts)]
                for p, (x, y) in enumerate(tracks[0]):
                    if x < tlx_raw or x >= brx_raw or y < tly_raw or \
                            y >= bry_raw:
                        keep[p] = False
            elif drop_FrameIn:
                keep = [False] * n_pts
            else:
                keep = [self.rng.random() < cfg.point_keep_ratio_ID
                        for _ in range(n_pts)]
            for t in range(F):
                full_pred_tracks[t].append(
                    [tracks[t][p] for p in range(n_pts) if keep[p]])

        if self.one_point_one_obj:
            target_tracks = [[[fr[0][0]]] for fr in full_pred_tracks]
        else:
            target_tracks = full_pred_tracks

        # --- ID reference --------------------------------------------------
        if drop_FrameIn:
            ID_img = np.zeros((th, tw, 3), np.uint8)
        else:
            ID_img = np.asarray(Image.open(ref_path).convert("RGB"))
            rh, rw = ID_img.shape[:2]
            scale_h = th / max(rh, rw)
            scale_w = tw / max(rh, rw)
            ID_img = cv2.resize(ID_img, (int(rw * scale_w), int(rh * scale_h)),
                                interpolation=cv2.INTER_AREA)
            ph1 = (th - ID_img.shape[0]) // 2
            ph2 = th - ID_img.shape[0] - ph1
            pw1 = (tw - ID_img.shape[1]) // 2
            pw2 = tw - ID_img.shape[1] - pw1
            ID_img = np.pad(ID_img, ((ph1, ph2), (pw1, pw2), (0, 0)))
        ID_tensor = _to_tensor_range(ID_img).transpose(2, 0, 1)

        # --- trajectory raster --------------------------------------------
        traj_tensor, traj_imgs_np, merge_frames = rasterize_trajectories(
            target_tracks, original_height, original_width, cfg.dot_radius,
            tw, th, selected_frames=selected, region_box=resized_box)
        if len(traj_tensor) != len(video_tensor):
            raise ValueError("traj/video length mismatch")

        return {
            "video_tensor": video_tensor,
            "traj_tensor": traj_tensor,
            "first_frame_tensor": first_frame_tensor,
            "ID_tensor": ID_tensor,
            "text_prompt": text_prompt,
            "video_gt_np": selected,
            "first_frame_np": first_frame_np,
            "ID_np": ID_img,
            "traj_imgs_np": traj_imgs_np,
            "merge_frames": merge_frames,
            "gt_video_path": video_path,
            "processed_meta_data": {
                "full_pred_tracks": full_pred_tracks,
                "original_width": original_width,
                "original_height": original_height,
                "mask_region": mask_region,
                "resized_mask_region_box": resized_box,
            },
        }
