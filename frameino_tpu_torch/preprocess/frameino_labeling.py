"""Step 8: FrameINO labeling — region boxes + ID reference crops (the
port's own copy of ``frameino_tpu/preprocess/frameino_labeling.py``).

Reference ``preprocess/track_FrameINO.py``: SAM2-refined object masks,
then region boxes are searched such that the ID object STARTS OUTSIDE
the box (the Frame-In premise, reference docstring ``:1-4``); the
largest N candidates become the ``ID_info`` CSV column together with
the cropped ID reference image path. The mask refiner is pluggable; the
box search and crop logic is implemented.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def object_bbox(mask: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


def boxes_exclude_bbox(height: int, width: int,
                       obj_box: Tuple[int, int, int, int],
                       grid: int = 8, min_frac: float = 0.3
                       ) -> List[Tuple[int, Tuple[int, int], Tuple[int, int]]]:
    """Candidate region boxes that DON'T contain the object's first-frame
    bbox (so the object frames-in from outside). Returns
    [area, (tlx, tly), (brx, bry)] entries like ``ID_info``."""
    ox0, oy0, ox1, oy1 = obj_box
    xs = np.linspace(0, width, grid + 1).astype(int)
    ys = np.linspace(0, height, grid + 1).astype(int)
    out = []
    for i in range(grid):
        for j in range(i + 1, grid + 1):
            for k in range(grid):
                for l in range(k + 1, grid + 1):
                    tlx, brx = xs[i], xs[j]
                    tly, bry = ys[k], ys[l]
                    if (brx - tlx) < min_frac * width or \
                            (bry - tly) < min_frac * height:
                        continue
                    # object bbox must be fully outside the box
                    overlap_x = max(0, min(brx, ox1) - max(tlx, ox0))
                    overlap_y = max(0, min(bry, oy1) - max(tly, oy0))
                    if overlap_x > 0 and overlap_y > 0:
                        continue
                    out.append([(brx - tlx) * (bry - tly),
                                (tlx, tly), (brx, bry)])
    return out


def find_region_boxes(first_frame_mask: np.ndarray, keep_n: int = 5,
                      grid: int = 8, min_frac: float = 0.3):
    """Largest ``keep_n`` region boxes excluding the object's start bbox
    (reference keeps the <=N largest, ``track_FrameINO.py:679-682``)."""
    h, w = first_frame_mask.shape
    box = object_bbox(first_frame_mask)
    if box is None:
        return []
    candidates = boxes_exclude_bbox(h, w, box, grid, min_frac)
    candidates.sort(key=lambda x: x[0])
    return candidates[-keep_n:]


def crop_id_reference(frame: np.ndarray, mask: np.ndarray,
                      pad: int = 2) -> Optional[np.ndarray]:
    """Background-zeroed tight crop of the object (the ID reference
    image saved per object)."""
    box = object_bbox(mask)
    if box is None:
        return None
    x0, y0, x1, y1 = box
    h, w = mask.shape
    x0, y0 = max(0, x0 - pad), max(0, y0 - pad)
    x1, y1 = min(w, x1 + pad), min(h, y1 + pad)
    crop = frame[y0:y1, x0:x1] * (mask[y0:y1, x0:x1, None] > 0)
    return crop.astype(np.uint8)


def label_step(first_frame: np.ndarray, mask: np.ndarray,
               keep_n: int = 5, grid: int = 8, min_frac: float = 0.3):
    """Step-8 convenience: object mask on frame 0 -> (ID_info entry,
    ID crop image) or (None, None) when no valid region box exists.

    The entry is ``[segmentation_info, region_boxes]`` shaped like the
    dataset's ``ID_info`` column (segmentation_info =
    [bbox, <crop filename to be filled by the caller>, []]).
    """
    boxes = find_region_boxes(mask, keep_n=keep_n, grid=grid,
                              min_frac=min_frac)
    if not boxes:
        return None, None
    crop = crop_id_reference(first_frame, mask)
    if crop is None or crop.size == 0:
        return None, None
    bbox = object_bbox(mask)
    entry = [[list(bbox), None, []],
             [[int(b[0]), list(b[1]), list(b[2])] for b in boxes]]
    return entry, crop


def sam2_refine(frames: np.ndarray,
                tracks,
                segmenter,
                region_boxes,
                start_frame_idx: int = 0,
                min_area_ratio: float = 0.1,
                max_skip_ratio: float = 0.33,
                num_other_refs: int = 3,
                rng=None):
    """The reference's ``SAM2_Refine`` (``track_FrameINO.py:215-398``):
    video-propagated object masks from the track points, then

    - main ID reference = first-frame mask crop at its bbox (must be
      >= ``min_area_ratio`` of the frame area);
    - auxiliary references: per-frame mask crops sorted by area, the
      smallest 25% discarded, up to ``num_other_refs`` sampled;
    - track points falling OUTSIDE the SAM mask in any frame are marked
      invalid; the clip is rejected when the invalid ratio exceeds
      ``max_skip_ratio``;
    - region boxes overlapping the first-frame mask are dropped.

    ``segmenter(frames, points) -> [T, H, W]`` is the SAM2
    video-propagation contract (``evaluation.perception.load_sam2`` or
    the port's ``load_sam2_checkpoint``; the offline tests use the naive
    color segmenter).

    Returns (segmentation_info, useful_region_boxes, point_valid_status,
    crops) with segmentation_info = [first_bbox, main_crop_index,
    other_crop_indices] indexing into ``crops`` — the caller writes the
    crop files and substitutes paths — or ([], [], [], []) on
    rejection.
    """
    import random as _random
    rng = rng or _random.Random(0)
    T, H, W = frames.shape[:3]
    sub = frames[start_frame_idx:]
    start_points = np.asarray(tracks[start_frame_idx], np.float32)
    masks = np.asarray(segmenter(sub, start_points))      # [T', H, W]
    min_area = min_area_ratio * H * W

    point_valid = [True] * len(start_points)
    infos = []                                 # (crop, area)
    first_mask = None
    for fi, mask in enumerate(masks):
        mask = (mask > 0).astype(np.uint8)
        # invalidate tracked points outside the SAM mask (reference
        # point_valid_status loop)
        t_idx = start_frame_idx + fi
        if t_idx < len(tracks):
            for pi, (x, y) in enumerate(tracks[t_idx]):
                xi, yi = int(x), int(y)
                if 0 <= yi < H and 0 <= xi < W and mask[yi, xi] == 0:
                    point_valid[pi] = False
        bbox = object_bbox(mask.astype(bool))
        if fi == 0:
            first_mask = mask
            if bbox is None:
                return [], [], [], []
            x0, y0, x1, y1 = bbox
            if (x1 - x0) * (y1 - y0) < min_area:
                return [], [], [], []
        if bbox is None:
            continue
        x0, y0, x1, y1 = bbox
        if (x1 - x0) * (y1 - y0) < min_area:
            continue
        seg_img = sub[fi] * mask[..., None]
        infos.append((seg_img[y0:y1, x0:x1], (x1 - x0) * (y1 - y0),
                      bbox, fi == 0))

    skip_ratio = 1.0 - sum(point_valid) / max(len(point_valid), 1)
    if skip_ratio > max_skip_ratio or not infos:
        return [], [], [], []

    crops = [infos[0][0]]                      # main reference (frame 0)
    first_bbox = infos[0][2]
    # auxiliary refs: area-sorted, smallest quartile discarded, sampled
    pool = sorted(infos, key=lambda e: e[1])
    pool = pool[int(len(pool) * 0.25):]
    picked = rng.sample(pool, min(num_other_refs, len(pool)))
    other_idx = []
    for crop, _, _, _ in picked:
        other_idx.append(len(crops))
        crops.append(crop)
    seg_info = [list(first_bbox), 0, other_idx]

    useful = []
    for rb in region_boxes:
        _, (x0, y0), (x1, y1) = rb
        if np.all(first_mask[y0:y1, x0:x1] == 0):
            useful.append(rb)
    if not useful:
        return [], [], [], []
    return seg_info, useful, point_valid, crops
