"""Step-4 semantic panoptic segmentation with the port's OneFormer
(counterpart of ``frameino_tpu/preprocess/panoptic_oneformer.py``;
reference ``preprocess/filter_panoptic_multi.py:133-218``, which runs
OneFormer Swin-L COCO-133 through detectron2's DefaultPredictor and reads
``metadata.stuff_classes[category_id]`` for each segment).

``OneFormerSegmenter`` wraps ``models/oneformer`` into the pipeline's
``panoptic_model(frame) -> [(label, mask)]`` contract with semantic labels
("person_1", "dog_2", ...) that flow into ``Obj_Info``; the
MOTIONABLE_OBJECT gate reproduces the reference's curation subset
(``filter_panoptic_multi.py:97-106``). The forward runs on the device of
the model's state dict (the card by default: the six deformable encoder
layers on K13); resizing, padding and the panoptic fusion are host-side,
as in JAX.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

# COCO panoptic contiguous classes, detectron2 builtin-meta order: the
# 80 things (category ids 1-90) then the 53 panoptic stuff classes
# (ids 92-200). ``panoptic_inference`` category_id indexes this list
# (reference reads ``metadata.stuff_classes[category_id]``,
# ``filter_panoptic_multi.py:451``). Checkpoint/dataset fact.
COCO_PANOPTIC_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog",
    "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe",
    "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat",
    "baseball glove", "skateboard", "surfboard", "tennis racket",
    "bottle", "wine glass", "cup", "fork", "knife", "spoon", "bowl",
    "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop",
    "mouse", "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
    # 53 stuff (ids 92..200)
    "banner", "blanket", "bridge", "cardboard", "counter", "curtain",
    "door-stuff", "floor-wood", "flower", "fruit", "gravel", "house",
    "light", "mirror-stuff", "net", "pillow", "platform",
    "playingfield", "railroad", "river", "road", "roof", "sand", "sea",
    "shelf", "snow", "stairs", "tent", "towel", "wall-brick",
    "wall-stone", "wall-tile", "wall-wood", "water-other",
    "window-blind", "window-other", "tree-merged", "fence-merged",
    "ceiling-merged", "sky-other-merged", "cabinet-merged",
    "table-merged", "floor-other-merged", "pavement-merged",
    "mountain-merged", "grass-merged", "dirt-merged", "paper-merged",
    "food-other-merged", "building-other-merged", "rock-merged",
    "wall-other-merged", "rug-merged",
]
COCO_THING_IDS = tuple(range(80))

# Reference curation subset (``filter_panoptic_multi.py:97-106``):
# only these classes become Frame-In/Out object candidates.
MOTIONABLE_OBJECT = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "sports ball",
    "kite", "flower", "snowboard", "surfboard", "skateboard",
)

# detectron2 defaults the reference predictor runs with
PIXEL_MEAN = np.array([123.675, 116.280, 103.530], np.float32)
PIXEL_STD = np.array([58.395, 57.120, 57.375], np.float32)


def _resize_shortest_edge(image: np.ndarray, min_size: int,
                          max_size: int) -> np.ndarray:
    """detectron2 ResizeShortestEdge test-time policy."""
    import cv2
    H, W = image.shape[:2]
    scale = min_size / min(H, W)
    if max(H, W) * scale > max_size:
        scale = max_size / max(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    return cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)


class OneFormerSegmenter:
    """image uint8 RGB [H, W, 3] -> [(\"{class}_{segment_id}\", mask)]
    with COCO semantic class names; the reference step-4 model. ``sd`` is
    the released state dict (``models/oneformer.oneformer_param_table``'s
    names) on the device the forward runs on."""

    def __init__(self, sd, cfg=None, min_size: int = 800,
                 max_size: int = 1333, motionable_only: bool = False,
                 object_mask_threshold: float = 0.8,
                 overlap_threshold: float = 0.8):
        from frameino_tpu_torch.models.oneformer import ONEFORMER_COCO_SWIN_L
        self.cfg = cfg or ONEFORMER_COCO_SWIN_L
        self.sd = sd
        self.device = next(iter(sd.values())).device
        self.min_size = min_size
        self.max_size = max_size
        self.motionable_only = motionable_only
        self.object_mask_threshold = object_mask_threshold
        self.overlap_threshold = overlap_threshold

    def panoptic(self, image: np.ndarray):
        """Full result: (panoptic_seg [H, W] int32, segments_info)."""
        import cv2
        import torch

        from frameino_tpu_torch.models.oneformer import (oneformer_forward,
                                                         panoptic_inference,
                                                         task_tokens)
        H0, W0 = image.shape[:2]
        resized = _resize_shortest_edge(image, self.min_size,
                                        self.max_size)
        rh, rw = resized.shape[:2]
        div = self.cfg.size_divisibility
        ph = (rh + div - 1) // div * div
        pw = (rw + div - 1) // div * div
        x = (resized.astype(np.float32) - PIXEL_MEAN) / PIXEL_STD
        x = np.pad(x, ((0, ph - rh), (0, pw - rw), (0, 0)))
        task = task_tokens("panoptic", self.cfg.task_seq_len)[None]
        cls, masks = oneformer_forward(
            self.cfg, self.sd, torch.from_numpy(x[None]).to(self.device),
            torch.from_numpy(task).to(self.device))
        cls = cls[0].float().cpu().numpy()                # [Q, K+1]
        masks = masks[0].float().cpu().numpy()            # [Q, ph/4, pw/4]
        # upsample to padded size, crop the pad, resize to the original
        # (reference sem_seg_postprocess, oneformer_model.py:306-330)
        up = np.stack([
            cv2.resize(m, (pw, ph),
                       interpolation=cv2.INTER_LINEAR)[:rh, :rw]
            for m in masks])
        up = np.stack([cv2.resize(m, (W0, H0),
                                  interpolation=cv2.INTER_LINEAR)
                       for m in up])
        return panoptic_inference(
            cls, up, COCO_THING_IDS,
            object_mask_threshold=self.object_mask_threshold,
            overlap_threshold=self.overlap_threshold)

    def __call__(self, image: np.ndarray) -> List[Tuple[str, np.ndarray]]:
        seg, info = self.panoptic(image)
        out = []
        for s in info:
            name = COCO_PANOPTIC_CLASSES[s["category_id"]]
            if self.motionable_only and name not in MOTIONABLE_OBJECT:
                continue
            out.append((f"{name}_{s['id']}", seg == s["id"]))
        return out


# the released checkpoint's keys that the inference graph does not read
# (JAX's loader drops the same ones): the relative-position index buffers,
# the training-only text encoder, projector, prompt context and criterion
SKIPPED_PREFIXES = ("text_encoder.", "text_projector.", "prompt_ctx.",
                    "criterion.")


def released_state_dict(sd) -> dict:
    """A released checkpoint's ``"model"`` dict without the keys JAX's
    ``load_oneformer_segmenter`` skips."""
    return {k: v for k, v in sd.items()
            if "relative_position_index" not in k
            and not k.startswith(SKIPPED_PREFIXES)}


def load_oneformer_segmenter(checkpoint_path: str, cfg=None,
                             device: str = "cuda",
                             **kwargs) -> OneFormerSegmenter:
    """Load released OneFormer COCO Swin-L weights (detectron2 ``.pth`` -
    a torch pickle with a \"model\" state dict) onto ``device``. The
    checkpoint is read with ``weights_only=True``; keys the graph does not
    read are ignored, a missing one raises."""
    import torch

    from frameino_tpu_torch.models.oneformer import (ONEFORMER_COCO_SWIN_L,
                                                     oneformer_param_table)
    if not os.path.isfile(checkpoint_path):
        raise FileNotFoundError(f"no OneFormer checkpoint at "
                                f"{checkpoint_path}")
    cfg = cfg or ONEFORMER_COCO_SWIN_L
    ckpt = torch.load(checkpoint_path, map_location="cpu",
                      weights_only=True)
    sd = ckpt.get("model", ckpt)
    sd = oneformer_param_table(cfg).take(released_state_dict(sd),
                                         "OneFormer")
    sd = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
    return OneFormerSegmenter(sd, cfg=cfg, **kwargs)
