"""Serving-shape bucketing: round request dims UP to a bucket grid, pad
the conditioning inputs, crop the generated video back.

A numpy copy of ``frameino_tpu/core/shape_buckets.py`` (that package's
``__init__`` imports jax). The JAX server buckets to avoid an XLA compile
per new shape; the port keeps the same policy so that both servers run a
given request at the same bucket and answer with the same ``bucket``
field.

Policy: round H and W up to multiples of ``grid`` (default 64; must be
a multiple of 32, the reference canvas rule), frames up to the VAE's
``(F - 1) % temporal == 0`` constraint (optionally a coarser frame
grid). Trailing padded frames carry no trajectory dots and are cropped,
same as the spatial padding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def bucket_hw(height: int, width: int, *, grid: int = 64,
              min_side: int = 64) -> Tuple[int, int]:
    """Round (height, width) UP to multiples of ``grid``."""
    if grid % 32:
        raise ValueError(f"bucket grid must be a multiple of 32, got {grid}")

    def up(v):
        return max(min_side, ((int(v) + grid - 1) // grid) * grid)

    return up(height), up(width)


def bucket_frames(num_frames: int, *, temporal: int = 4,
                  frame_grid: Optional[int] = None) -> int:
    """Smallest F' >= num_frames with (F' - 1) % temporal == 0 (the
    causal-VAE constraint), optionally also (F' - 1) % frame_grid == 0
    to coarsen the frame-count lattice (frame_grid must be a multiple
    of temporal)."""
    step = temporal
    if frame_grid:
        if frame_grid % temporal:
            raise ValueError(f"frame_grid {frame_grid} must be a multiple "
                             f"of temporal {temporal}")
        step = frame_grid
    f = max(1, int(num_frames))
    rem = (f - 1) % step
    return f if rem == 0 else f + (step - rem)


def pad_hwc(img: np.ndarray, height: int, width: int,
            fill: int = 0) -> np.ndarray:
    """Pad an [H, W, C] uint8 image bottom/right to (height, width) —
    black outside the canvas, matching the reference's inference-canvas
    padding (app.py:322-333)."""
    h, w = img.shape[:2]
    if h > height or w > width:
        raise ValueError(f"image {h}x{w} exceeds bucket {height}x{width}")
    if (h, w) == (height, width):
        return img
    out = np.full((height, width) + img.shape[2:], fill, img.dtype)
    out[:h, :w] = img
    return out


def crop_video(frames: np.ndarray, num_frames: int, height: int,
               width: int) -> np.ndarray:
    """[F, H, W, C] generated at bucket dims -> the requested dims."""
    return frames[:num_frames, :height, :width]
