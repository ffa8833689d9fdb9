"""Reading a dataset's CSV folder (the port's own copy of the reader side
of ``frameino_tpu/preprocess/csv_io.py``, the reference schema)."""

from __future__ import annotations

import csv
import os
import sys
from typing import Dict, Sequence

csv.field_size_limit(sys.maxsize)


def read_csv_folder(folder: str):
    """Every ``*.csv`` of ``folder`` in name order -> (header of the last
    file read, rows of all of them)."""
    header, rows = None, []
    for name in sorted(os.listdir(folder)):
        if not name.endswith(".csv"):
            continue
        with open(os.path.join(folder, name)) as f:
            for i, row in enumerate(csv.reader(f)):
                if i == 0:
                    header = row
                    continue
                rows.append(row)
    return header, rows


def row_dict(header: Sequence[str], row: Sequence[str]) -> Dict[str, str]:
    return dict(zip(header, row))
