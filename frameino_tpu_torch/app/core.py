"""Interactive demo core logic, UI-framework-free (the port's counterpart
of ``frameino_tpu/app/core.py``; reference Gradio demo ``app.py``), so the
geometry and condition logic is unit-testable and reusable from any front
end (the Gradio wrapper is ``gradio_app.py``; the HTTP server,
``server.py``, uses the condition helpers):

- ``build_canvas`` (reference ``app.py:270-350``): place the resized
  input image at user offsets inside a larger canvas whose dims must be
  multiples of 32; the INFERENCE canvas is black outside the image, the
  VISUAL canvas paper-white.
- trajectory capture: per-object click polylines, arc-length-uniform
  resampling to the frame count (reference ``app.py:487-501``),
  rasterized with the SAME function as training (``app.py:616-620``
  parity).
- ID reference: segmentation-masked object (any segmenter; SAM in the
  reference, ``app.py:634-692``) background-zeroed, aspect-resized and
  zero-padded to the canvas; black placeholder when absent.
- ``crop_padding`` (``app.py:736-750``): cut the generated video back to
  the user's visible canvas region.
- ``InteractiveSession``: the Gradio event flow (canvas -> clicks -> ID ->
  generation) around the port's Wan pipeline, on the pipeline's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import cv2
import numpy as np
import torch

from frameino_tpu_torch.data.traj import (ALL_COLOR_CODES,
                                          rasterize_trajectories,
                                          resample_track_by_length)


@dataclasses.dataclass
class CanvasSpec:
    canvas_height: int
    canvas_width: int
    image_height: int
    image_width: int
    offset_x: int
    offset_y: int

    def validate(self):
        if self.canvas_height % 32 or self.canvas_width % 32:
            raise ValueError("canvas dims must be multiples of 32 "
                             f"(got {self.canvas_height}x{self.canvas_width})")
        if self.offset_x < 0 or self.offset_y < 0 or \
                self.offset_x + self.image_width > self.canvas_width or \
                self.offset_y + self.image_height > self.canvas_height:
            raise ValueError("image placement exceeds canvas bounds")

    @staticmethod
    def round_dims(height: int, width: int) -> Tuple[int, int, str]:
        """x32 auto-rounding hint (the reference hard-errors,
        ``app.py:323-326``; here the UI rounds up and tells the user).
        Returns (h32, w32, hint-or-empty)."""
        h32 = max(32, (int(height) + 31) // 32 * 32)
        w32 = max(32, (int(width) + 31) // 32 * 32)
        hint = ""
        if (h32, w32) != (int(height), int(width)):
            hint = (f"canvas dims must be multiples of 32 — rounded "
                    f"{int(height)}x{int(width)} up to {h32}x{w32}")
        return h32, w32, hint


def build_canvas(image: np.ndarray, spec: CanvasSpec
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (inference_canvas black-padded, visual_canvas white-padded),
    both [H, W, 3] uint8."""
    spec.validate()
    resized = cv2.resize(image, (spec.image_width, spec.image_height))
    inference = np.zeros((spec.canvas_height, spec.canvas_width, 3),
                         np.uint8)
    visual = np.full((spec.canvas_height, spec.canvas_width, 3), 255,
                     np.uint8)
    sl = (slice(spec.offset_y, spec.offset_y + spec.image_height),
          slice(spec.offset_x, spec.offset_x + spec.image_width))
    inference[sl] = resized
    visual[sl] = resized
    return inference, visual


def prepare_id_reference(image: np.ndarray, mask: Optional[np.ndarray],
                         canvas_height: int, canvas_width: int
                         ) -> np.ndarray:
    """Background-zeroed, aspect-resized + zero-padded ID reference
    (reference ``app.py:642-692``); black placeholder when image None."""
    if image is None:
        return np.zeros((canvas_height, canvas_width, 3), np.uint8)
    obj = image.copy()
    if mask is not None:
        obj = obj * (mask[..., None] > 0)
    rh, rw = obj.shape[:2]
    scale_h = canvas_height / max(rh, rw)
    scale_w = canvas_width / max(rh, rw)
    obj = cv2.resize(obj.astype(np.uint8),
                     (int(rw * scale_w), int(rh * scale_h)),
                     interpolation=cv2.INTER_AREA)
    ph1 = (canvas_height - obj.shape[0]) // 2
    ph2 = canvas_height - obj.shape[0] - ph1
    pw1 = (canvas_width - obj.shape[1]) // 2
    pw2 = canvas_width - obj.shape[1] - pw1
    return np.pad(obj, ((ph1, ph2), (pw1, pw2), (0, 0)))


def tracks_to_traj_tensor(polylines: Sequence[Sequence[Tuple[float, float]]],
                          num_frames: int, canvas_height: int,
                          canvas_width: int, dot_radius: int = 7
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Click polylines (one per object) -> rasterized trajectory video
    using the training rasterizer (train/infer parity,
    ``app.py:599-620``). Returns (traj [-1,1] [F,3,H,W], uint8)."""
    resampled = [resample_track_by_length(p, num_frames) for p in polylines]
    full_tracks = [[[tuple(resampled[obj][t])] for obj in
                    range(len(resampled))] for t in range(num_frames)]
    traj, raw, _ = rasterize_trajectories(
        full_tracks, canvas_height, canvas_width, dot_radius,
        canvas_width, canvas_height)
    return traj, raw


def crop_padding(video: np.ndarray, spec: CanvasSpec) -> np.ndarray:
    """[F, H, W, 3] -> visible region (the user's placed image box)."""
    return video[:, spec.offset_y:spec.offset_y + spec.image_height,
                 spec.offset_x:spec.offset_x + spec.image_width]


def visualize_trajectories(canvas: np.ndarray,
                           polylines: Sequence[Sequence[Tuple[float, float]]],
                           dot_radius: int = 5,
                           object_ids: Optional[Sequence[int]] = None
                           ) -> np.ndarray:
    """Realtime trajectory preview (reference ``fn_vis_realtime_traj``,
    ``app.py:401-422``): per-object colored polylines with a filled dot
    at every click and an arrowhead at the last segment. ``object_ids``
    maps each polyline to its object (multiple lines per object share
    one color, reference ``traj_point_update``); defaults to one object
    per line."""
    out = canvas.copy()
    for line_idx, line in enumerate(polylines):
        obj_idx = (object_ids[line_idx] if object_ids is not None
                   else line_idx)
        color = tuple(int(c) for c in
                      ALL_COLOR_CODES[obj_idx % len(ALL_COLOR_CODES)])
        pts = [(int(x), int(y)) for (x, y) in line]
        for a, b in zip(pts[:-1], pts[1:]):
            cv2.line(out, a, b, color, 2)
        for p in pts:
            cv2.circle(out, p, dot_radius, color, -1)
        if len(pts) >= 2:
            cv2.arrowedLine(out, pts[-2], pts[-1], color, 2,
                            tipLength=0.5)
    return out


def color_legend_html(num_objects: int) -> str:
    """Per-object color legend (swatch + label) for the UI."""
    rows = []
    for i in range(num_objects):
        r, g, b = ALL_COLOR_CODES[i % len(ALL_COLOR_CODES)]
        rows.append(
            f'<span style="display:inline-flex;align-items:center;'
            f'margin-right:12px"><span style="width:14px;height:14px;'
            f'background:rgb({r},{g},{b});display:inline-block;'
            f'margin-right:4px;border:1px solid #888"></span>'
            f'object {i + 1}</span>')
    return "<div>" + "".join(rows) + "</div>" if rows else ""


def segment_at_point(image: np.ndarray, segmenter: Callable,
                     point: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """SAM-style point-prompt segmentation of the ID object (reference
    ``app.py:634-660``: SAM prompted at the image center). ``segmenter``
    takes (image [H, W, 3], points [1, 2] xy) or just (image); returns a
    [H, W] binary mask. A 3-D result is read as [T, H, W] and its first
    frame kept, as JAX does. A video segmenter (frames [T, H, W, 3], such
    as ``models/sam2_video.make_segmenter_adapter``) must be wrapped to
    take one image, ``lambda image, pts: seg(image[None], pts)``: handed
    the image itself it reads H frames of [W, 3] (ROADMAP queue 3)."""
    h, w = image.shape[:2]
    if point is None:
        point = (w // 2, h // 2)
    pts = np.asarray([point], np.float32)
    try:
        mask = segmenter(image, pts)
    except TypeError:
        mask = segmenter(image)
    mask = np.asarray(mask)
    if mask.ndim == 3:          # video-segmenter contract [T, H, W]
        mask = mask[0]
    return (mask > 0).astype(np.uint8)


def _pixels_to_tensor(img: np.ndarray, device) -> torch.Tensor:
    """[H, W, 3] uint8 -> [3, H, W] fp32 in [-1, 1] on ``device``."""
    x = torch.from_numpy(img.astype(np.float32) / 255.0 * 2 - 1)
    return x.permute(2, 0, 1).to(device)


class InteractiveSession:
    """State machine mirroring the Gradio event flow: canvas -> click
    trajectories -> optional ID -> inference through ``pipeline`` (the
    port's ``WanImageToVideoPipeline``, or any callable with its arguments
    and a ``device``)."""

    def __init__(self, pipeline, num_frames: int = 81,
                 num_inference_steps: int = 50, guidance_scale: float = 5.0,
                 segmenter: Optional[Callable] = None):
        self.pipeline = pipeline
        self.num_frames = num_frames
        self.steps = num_inference_steps
        self.guidance = guidance_scale
        self.segmenter = segmenter
        self.spec: Optional[CanvasSpec] = None
        self.inference_canvas: Optional[np.ndarray] = None
        self.polylines: List[List[Tuple[float, float]]] = []
        # object index per polyline (reference data model: instances ->
        # trajectory lines -> points, ``app.py:424-486``)
        self.line_obj: List[int] = []

    @property
    def num_objects(self) -> int:
        return (max(self.line_obj) + 1) if self.line_obj else 0

    def set_canvas(self, image: np.ndarray, spec: CanvasSpec):
        self.spec = spec
        self.inference_canvas, visual = build_canvas(image, spec)
        self.clear_traj_points()
        return visual

    def add_traj_point(self, x: float, y: float, new_object: bool = False):
        if new_object or not self.polylines:
            self.new_object()
        self.polylines[-1].append((x, y))

    def new_object(self):
        """Start a new object instance (reference
        ``traj_instance_update``: errors past the color-code limit)."""
        if self.num_objects >= len(ALL_COLOR_CODES):
            raise ValueError("trajectory instance number is over the "
                             f"limit ({len(ALL_COLOR_CODES)})")
        self.polylines.append([])
        self.line_obj.append(self.num_objects)

    def new_line(self):
        """Start another trajectory line for the CURRENT object
        (reference ``traj_point_update``: e.g. several limbs of one
        person moving together)."""
        if not self.polylines:
            return self.new_object()
        self.polylines.append([])
        self.line_obj.append(self.line_obj[-1])

    def clear_traj_points(self):
        self.polylines = []
        self.line_obj = []

    def run(self, prompt_embeds, negative_prompt_embeds=None,
            id_image: Optional[np.ndarray] = None,
            id_mask: Optional[np.ndarray] = None,
            generator: Optional[torch.Generator] = None,
            **pipe_kwargs) -> np.ndarray:
        """Generate from the canvas, the clicked trajectories and the
        optional ID image (segmented with ``segmenter`` when no mask is
        given): the canvas [1, 3, H, W] in [-1, 1], the rasterized
        trajectories [F, 3, H, W] and the ID frame [1, 3, 1, H, W] go to
        the pipeline on its device with ``pipe_kwargs``; returns the uint8
        frames [F, h, w, 3] cropped to the placed image."""
        spec = self.spec
        H, W = spec.canvas_height, spec.canvas_width
        traj, _ = tracks_to_traj_tensor(self.polylines or [[(0.0, 0.0)]],
                                        self.num_frames, H, W)
        if id_image is not None and id_mask is None and self.segmenter:
            id_mask = segment_at_point(id_image, self.segmenter)
        id_np = prepare_id_reference(id_image, id_mask, H, W) \
            if id_image is not None else None

        dev = self.pipeline.device
        image = _pixels_to_tensor(self.inference_canvas, dev)[None]
        traj_t = torch.from_numpy(np.asarray(traj, np.float32)).to(dev)
        id_t = None
        if id_np is not None:
            id_t = _pixels_to_tensor(id_np, dev)[None, :, None]

        video = self.pipeline(
            image, prompt_embeds=prompt_embeds,
            negative_prompt_embeds=negative_prompt_embeds,
            traj_tensor=traj_t, id_tensor=id_t, height=H, width=W,
            num_frames=self.num_frames, num_inference_steps=self.steps,
            guidance_scale=self.guidance, generator=generator, **pipe_kwargs)
        if torch.is_tensor(video):
            video = video.float().cpu().numpy()
        frames = ((np.asarray(video)[0].transpose(1, 2, 3, 0) + 1) / 2 * 255
                  ).clip(0, 255).astype(np.uint8)
        return crop_padding(frames, spec)
