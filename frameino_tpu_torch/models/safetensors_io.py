"""Reader and writer of the safetensors format, without the ``safetensors``
package (the port does not depend on it).

A file is an 8-byte little-endian header length N, then N bytes of JSON,
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings, then the raw little-endian buffer
that the offsets index. ``load_file`` memory-maps the file (copy on write)
and returns views of it: nothing is copied until a tensor is moved or
cast.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}


def read_header(path: str):
    """(header dict without ``__metadata__``, metadata, data start)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None) or {}
    return header, meta, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU views of a private
    memory map of the file."""
    header, _, start = read_header(path)
    size = os.path.getsize(path)
    buf = torch.from_file(path, shared=False, size=size, dtype=torch.uint8)
    out = {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"which this reader does not take")
        begin, end = info["data_offsets"]
        shape = list(info["shape"])
        raw = buf[start + begin:start + end]
        item = torch.empty((), dtype=dtype).element_size()
        if raw.numel() != item * int(torch.Size(shape).numel()):
            raise ValueError(f"{path}: {name} holds {raw.numel()} bytes for "
                             f"shape {shape} of {info['dtype']}")
        if (start + begin) % item:
            raw = raw.clone()            # a misaligned view cannot retype
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None):
    """Write ``tensors`` (moved to the CPU, made contiguous) as one
    safetensors file, the widest dtypes first so that every tensor starts
    aligned to its element size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset, blobs = {}, 0, []
    for name in order:
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        blobs.append(t)
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)      # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for t in blobs:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
