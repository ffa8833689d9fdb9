"""Step 1: validity filter (the port's own copy of
``frameino_tpu/preprocess/basic_filter.py``; reference
``preprocess/filter_basic.py``).

Frame count / aspect ratio / resolution checks; no models involved.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def filter_basic(rows: Sequence[Dict], min_frames: int = 49,
                 min_height: int = 480, min_width: int = 480,
                 max_aspect_ratio: float = 2.5) -> Tuple[List[Dict], List[Dict]]:
    """rows: dicts with height/width/num_frames. -> (kept, rejected)."""
    kept, rejected = [], []
    for r in rows:
        h, w = int(r["height"]), int(r["width"])
        n = int(r["num_frames"])
        aspect = max(h, w) / max(min(h, w), 1)
        ok = (n >= min_frames and h >= min_height and w >= min_width
              and aspect <= max_aspect_ratio)
        (kept if ok else rejected).append(r)
    return kept, rejected
