"""Building the CUDA C++ sources (``csrc/*.cu``) with nvcc into ``build/``
and binding them with ctypes.

Each source has a plain C interface: its functions take device pointers,
ints and floats and the CUDA stream, launch on that stream, and return
``cudaGetLastError()``. Nothing here runs at import: a source is compiled
(for sm_90a, one nvcc per source, all started together) and loaded at its
first use, once per source content.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_REPO_ROOT = Path(__file__).resolve().parents[2]
_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _REPO_ROOT / "build"

# source -> {C function: argtypes}; every function returns a CUDA error code
_VP, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CUDA_SOURCES = {
    "flash_fwd": {"flash_fwd_bf16": [_VP] * 5 + [_INT] * 5 + [_F32, _VP]},
    "flash_attn_train": {
        "attn_train_fwd_bf16": [_VP] * 5 + [_INT] * 4 + [_F32, _VP],
        "attn_train_bwd_bf16": [_VP] * 11 + [_INT] * 5 + [_F32, _VP],
        "attn_train_smem_bytes": [_INT] * 2},
    "dyn_quant": {"dyn_quant_rows_bf16": [_VP] * 3 + [_INT] * 2 + [_VP]},
    "flash_variants": {
        "flash_variant_bf16": [_VP] * 5 + [_INT] * 5 + [_F32, _VP],
        "flash_variant_int8": [_VP] * 7 + [_INT] * 5 + [_VP]},
    "flash_packed": {"flash_packed_bf16": [_VP] * 4 + [_INT] * 3
                     + [_F32, _VP]},
}

_lib_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}      # source -> nvcc's output (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _source_bytes(path: Path, seen: set) -> bytes:
    """A source and, after it, every header of ``csrc/`` that it includes
    with quotes (transitively, each once)."""
    seen.add(path)
    data = path.read_bytes()
    for inc in _LOCAL_INCLUDE.findall(data):
        header = _CSRC / inc.decode()
        if header not in seen:
            data += _source_bytes(header, seen)
    return data


def _so_path(name: str) -> Path:
    # the digest covers the included headers too, so that an edit to a
    # shared header never loads a stale library
    digest = hashlib.sha256(_source_bytes(_CSRC / f"{name}.cu", set())
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_cuda_libs(names=None) -> dict:
    """Compile the CUDA sources for sm_90a into ``build/`` (once per source
    content; one nvcc per source, all started together) and load them with
    ctypes. nvcc's defaults are kept: IEEE division and square root, no
    flush to zero. Returns {source: CDLL}."""
    names = list(_CUDA_SOURCES) if names is None else list(names)
    with _lib_lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        for n in todo:
            so = _so_path(n)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas=-v", "-shared",
                   "-Xcompiler", "-fPIC", "-o", str(tmp),
                   str(_CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp, so)
        failed = []
        for n, (proc, tmp, so) in procs.items():
            BUILD_LOG[n] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n"
                              f"{BUILD_LOG[n]}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        for n in todo:
            lib = ctypes.CDLL(str(_so_path(n)))
            for fn_name, argtypes in _CUDA_SOURCES[n].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[n] = lib
        return {n: _libs[n] for n in names}


def lib(name: str):
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    found = _libs.get(name)
    return found if found is not None else build_cuda_libs([name])[name]


def check_cuda_bf16(name: str, *tensors):
    """Raise unless every tensor is a contiguous, 16-byte aligned bf16
    CUDA tensor: what the kernels take."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: mixed devices ({t.device})")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor must be 16-byte aligned")
