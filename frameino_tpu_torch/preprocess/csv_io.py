"""CSV folder IO of the preprocess steps (the port's own copy of the writer
side of ``frameino_tpu/preprocess/csv_io.py``, the reference schema). The
reader is the port's ``data/csv_io.py``, re-exported here."""

from __future__ import annotations

import csv
import os
from typing import Iterable, Sequence

from frameino_tpu_torch.data.csv_io import (read_csv_folder,  # noqa: F401
                                            row_dict)


def write_csv(path: str, header: Sequence[str],
              rows: Iterable[Sequence]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for r in rows:
            w.writerow(r)


def build_initial_csv(video_folder: str, out_path: str) -> int:
    """Step 0: initial CSV with video_path/height/width/num_frames
    (reference ``preprocess/dataset_download/csv_prepare_openvid.py``)."""
    from frameino_tpu_torch.data.video_io import decode_video
    rows = []
    for name in sorted(os.listdir(video_folder)):
        if not name.endswith((".mp4", ".avi", ".mkv", ".webm")):
            continue
        v = decode_video(os.path.join(video_folder, name))
        rows.append([name, v.shape[1], v.shape[2], v.shape[0]])
    write_csv(out_path, ["video_path", "height", "width", "num_frames"],
              rows)
    return len(rows)
