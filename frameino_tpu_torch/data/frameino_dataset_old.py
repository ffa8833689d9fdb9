"""Old-schema (paper v1.0) FrameINO evaluation dataset (the port's own
copy of ``frameino_tpu/data/frameino_dataset_old.py``).

Reference: ``data_loader/video_dataset_motion_FrameINO_old.py`` — the
CSV contract the paper-v1.0 CogVideoX benchmark drivers consume
(``test_code/run_cogvideox_Frame{In,Out}_mass_evaluation.py``).

Differences from the new-schema ``FrameINODataset``:
- CSV columns: ``video_path, height, width, num_frames, fps,
  FrameIN_info, Track_Traj, Improved_Text_Prompt, ID_info`` — each a
  JSON list over panoptic candidates (reference ``:214-231``).
- The video is decoded at a fixed ``preset_decode_fps`` (reference
  ``:305-312`` ffmpeg fps filter) and the clip is a fixed
  ``train_frame_num`` window starting at the FrameIN_info start index
  scaled by its fps_scale (``:337-349``).
- ``video_tensor`` is the FULL (unmasked) frames; only the first frame
  is region-masked (``:425-478``) — the new schema masks every frame.
- The ID crop is returned as ``main_reference_tensor``/``_np``
  (``:518-537``) — the key the benchmark drivers dump as
  ``Main_Reference.png``.
"""

from __future__ import annotations

import csv
import json
import os
import random
from typing import Dict, List, Optional

import cv2
import numpy as np
from PIL import Image

from frameino_tpu_torch.data.traj import rasterize_trajectories
from frameino_tpu_torch.data.video_io import decode_video


def _to_tensor_range(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32) / 255.0 * 2.0 - 1.0


def _decode_at_fps(path: str, tw: int, th: int, src_fps: float,
                   target_fps: float) -> np.ndarray:
    """Decode + resample to ``target_fps`` by nearest-index mapping
    (behavioral equivalent of the reference's ffmpeg
    ``filter('fps', fps=..., round='up')``, ``:305-312``)."""
    frames = decode_video(path, tw, th)
    if src_fps <= 0 or abs(src_fps - target_fps) < 1e-6:
        return frames
    n_out = int(len(frames) * target_fps / src_fps)
    idx = np.clip(np.round(np.arange(n_out) * src_fps / target_fps
                           ).astype(int), 0, len(frames) - 1)
    return frames[idx]


class FrameINODatasetOld:
    """Deterministic under ``strict_validation_match`` (panoptic idx 0,
    main object 0, largest region box, all points kept — reference
    strict branches at ``:254-261, 281-287``)."""

    def __init__(self, config: Dict,
                 csv_folder_path: str,
                 FrameOut_only: bool = False,
                 one_point_one_obj: bool = False,
                 strict_validation_match: bool = False,
                 seed: Optional[int] = None):
        self.config = config
        self.dataset_folder_path = config["dataset_folder_path"]
        self.ID_folder_path = config.get("ID_folder_path")
        self.target_height = int(config["height"])
        self.target_width = int(config["width"])
        self.preset_decode_fps = float(config.get("preset_decode_fps", 16))
        self.train_frame_num = int(config["train_frame_num"])
        self.empty_text_prompt = bool(config.get("empty_text_prompt", False))
        self.start_skip = int(config.get("start_skip", 0))
        self.end_skip = int(config.get("end_skip", 0))
        self.dot_radius = int(config.get("dot_radius", 6))
        self.point_keep_ratio_ID = float(config.get("point_keep_ratio_ID",
                                                    1.0))
        self.point_keep_ratio_regular = float(
            config.get("point_keep_ratio_regular", 1.0))
        self.faster_motion_prob = float(config.get("faster_motion_prob",
                                                   0.0))
        self.FrameOut_only = FrameOut_only
        self.one_point_one_obj = one_point_one_obj
        self.strict = strict_validation_match
        self.rng = random.Random(seed)

        self.rows: List[List[str]] = []
        self.col: Dict[str, int] = {}
        for name in sorted(os.listdir(csv_folder_path)):
            with open(os.path.join(csv_folder_path, name)) as f:
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
        # retry loop (reference :205-515 while True / random re-pick;
        # deterministic next-index walk here so strict eval stays stable)
        for _ in range(len(self.rows)):
            try:
                return self._get(idx)
            except Exception:
                if self.strict:
                    raise
                idx = (idx + 1) % len(self.rows)
        raise RuntimeError("no valid sample found")

    def _get(self, idx: int) -> Dict:
        row = self.rows[idx]
        tw, th = self.target_width, self.target_height
        video_path = os.path.join(self.dataset_folder_path,
                                  self._field(row, "video_path"))
        original_height = int(self._field(row, "height"))
        original_width = int(self._field(row, "width"))
        num_frames = int(self._field(row, "num_frames"))
        fps = float(self._field(row, "fps"))

        FrameIN_info_all = json.loads(self._field(row, "FrameIN_info"))
        Track_Traj_all = json.loads(self._field(row, "Track_Traj"))
        text_all = json.loads(self._field(row, "Improved_Text_Prompt"))
        ID_info_all = json.loads(self._field(row, "ID_info"))

        pidx = 0 if self.strict else self.rng.randrange(len(FrameIN_info_all))
        FrameIN_info = FrameIN_info_all[pidx]
        Track_Traj = Track_Traj_all[pidx]
        text_prompt = text_all[pidx]
        ID_info_panoptic = ID_info_all[pidx]

        fps_scale = self.preset_decode_fps / fps
        downsample_num_frames = int(num_frames * fps_scale)

        drop_FrameIn = self.FrameOut_only or \
            self.rng.random() < float(self.config.get("drop_FrameIn_prob",
                                                      0.0))

        if not self.strict:
            effective = [i for i, o in enumerate(ID_info_panoptic)
                         if o != []]
            main_idx = self.rng.choice(effective)
        else:
            main_idx = 0

        segmentation_info, region_boxes = ID_info_panoptic[main_idx]
        ref_path = None
        if not self.FrameOut_only:
            _, ref_rel, _ = segmentation_info
            ref_path = os.path.join(self.ID_folder_path, ref_rel)
            if not os.path.exists(ref_path):
                raise FileNotFoundError(ref_path)

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

        video_np_raw = _decode_at_fps(video_path, tw, th, fps,
                                      self.preset_decode_fps)
        if len(video_np_raw) - self.start_skip - self.end_skip \
                < self.train_frame_num:
            raise ValueError("not enough frames")
        video_np_masked = np.zeros_like(video_np_raw)
        video_np_masked[:, tly:bry, tlx:brx] = \
            video_np_raw[:, tly:bry, tlx:brx]

        if self.empty_text_prompt or self.rng.random() < float(
                self.config.get("text_mask_ratio", 0.0)):
            text_prompt = ""

        # clip window (reference :337-349)
        _, original_start, fi_fps_scale = FrameIN_info[main_idx]
        start = max(0, int(original_start * fi_fps_scale))
        avail = min(downsample_num_frames, len(video_np_raw))
        max_step_num = (avail - start) // self.train_frame_num
        if max_step_num == 0:
            raise ValueError("video too short")
        if max_step_num >= 2 and self.rng.random() < self.faster_motion_prob:
            iter_gap = 2
        else:
            iter_gap = 1

        F = self.train_frame_num
        full_pred_tracks = [[] for _ in range(F)]
        for obj_idx in range(len(ID_info_panoptic)):
            tracks = Track_Traj[obj_idx][start:start + iter_gap * F:iter_gap]
            if len(tracks) != F:
                raise ValueError("track length mismatch")
            n_pts = len(tracks[0])
            if obj_idx != main_idx or self.FrameOut_only:
                keep = [self.rng.random() < self.point_keep_ratio_regular
                        for _ in range(n_pts)]
                for p, (x, y) in enumerate(tracks[0]):
                    if x < tlx_raw or x >= brx_raw or \
                            y < tly_raw or y >= bry_raw:
                        keep[p] = False
            elif drop_FrameIn:
                keep = [False] * n_pts
            else:
                keep = [self.rng.random() < self.point_keep_ratio_ID
                        for _ in range(n_pts)]
            for t in range(F):
                full_pred_tracks[t].append(
                    [tracks[t][p] for p in range(n_pts) if keep[p]])

        if self.one_point_one_obj:
            target_tracks = [[[fr[0][0]]] for fr in full_pred_tracks]
        else:
            target_tracks = full_pred_tracks

        # video tensor: UNMASKED frames in this schema (reference :425)
        selected = video_np_raw[start:start + iter_gap * F:iter_gap]
        if len(selected) != F:
            raise ValueError("frame count mismatch")
        video_tensor = _to_tensor_range(selected).transpose(0, 3, 1, 2)

        # main reference (ID) image, aspect-resized + zero-padded
        if drop_FrameIn:
            main_reference_img = np.zeros((th, tw, 3), np.uint8)
        else:
            main_reference_img = np.asarray(
                Image.open(ref_path).convert("RGB"))
            rh, rw = main_reference_img.shape[:2]
            s_h = th / max(rh, rw)
            s_w = tw / max(rh, rw)
            main_reference_img = cv2.resize(
                main_reference_img, (int(rw * s_w), int(rh * s_h)),
                interpolation=cv2.INTER_AREA)
            ph1 = (th - main_reference_img.shape[0]) // 2
            ph2 = th - main_reference_img.shape[0] - ph1
            pw1 = (tw - main_reference_img.shape[1]) // 2
            pw2 = tw - main_reference_img.shape[1] - pw1
            main_reference_img = np.pad(
                main_reference_img, ((ph1, ph2), (pw1, pw2), (0, 0)))
        main_reference_tensor = _to_tensor_range(main_reference_img
                                                 ).transpose(2, 0, 1)

        first_frame_np = video_np_masked[start]
        first_frame_tensor = _to_tensor_range(first_frame_np
                                              ).transpose(2, 0, 1)

        traj_tensor, traj_imgs_np, merge_frames = rasterize_trajectories(
            target_tracks, original_height, original_width,
            self.dot_radius, tw, th, selected_frames=selected,
            region_box=resized_box)

        return {
            "video_tensor": video_tensor,
            "traj_tensor": traj_tensor,
            "first_frame_tensor": first_frame_tensor,
            "main_reference_tensor": main_reference_tensor,
            "text_prompt": text_prompt,
            "video_gt_np": selected,
            "first_frame_np": first_frame_np,
            "main_reference_np": main_reference_img,
            "processed_meta_data": {
                "full_pred_tracks": full_pred_tracks,
                "original_width": original_width,
                "original_height": original_height,
                "mask_region": mask_region,
                "resized_mask_region_box": resized_box,
            },
            "traj_imgs_np": traj_imgs_np,
            "merge_frames": merge_frames,
            "gt_video_path": video_path,
        }
