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
_I64 = ctypes.c_int64
_CUDA_SOURCES = {
    "flash_fwd": {"flash_fwd_bf16": [_VP] * 5 + [_INT] * 5 + [_F32, _VP],
                  "flash_fwd_config": [_INT] * 2},
    "flash_attn_train": {
        "attn_train_fwd_bf16": [_VP] * 5 + [_INT] * 4 + [_F32, _VP],
        "attn_train_bwd_bf16": [_VP] * 11 + [_INT] * 5 + [_F32, _VP],
        "attn_train_smem_bytes": [_INT] * 2},
    "dyn_quant": {"dyn_quant_rows_bf16": [_VP] * 3 + [_INT] * 2 + [_VP]},
    "flash_variants": {
        "flash_variant_bf16": [_VP] * 5 + [_INT] * 5 + [_F32, _VP],
        "flash_variants_config": [_INT] * 2},
    "flash_int8": {"flash_variant_int8": [_VP] * 7 + [_INT] * 5 + [_VP],
                   "flash_int8_config": [_INT] * 2},
    "flash_packed": {"flash_packed_bf16": [_VP] * 4 + [_INT] * 3
                     + [_F32, _VP],
                     "flash_packed_config": [_INT]},
    "qk_producers": {
        "qk_norm_rope_bf16": [_VP] * 6 + [_INT] * 4 + [_F32] + [_INT] * 4
        + [_VP],
        "qk_ln_rope_bf16": [_VP] * 6 + [_INT] * 4 + [_F32] + [_INT] * 4
        + [_VP],
        "qk_producer_blocks_per_sm": [_INT] * 3},
    "ms_deform_attn": {"ms_deform_attn_fp32": [_VP] * 5 + [_INT] * 7
                       + [_VP]},
    "conv_int8": {"conv_int8_absmax": [_VP, _I64, _VP, _VP],
                  "conv_int8_quantize": [_VP] * 3 + [_INT] * 3
                  + [_I64, _VP],
                  "conv_int8_igemm": [_VP] * 7 + [_INT] * 20 + [_VP],
                  "conv_int8_igemm_smem_bytes": [_INT]},
    # a measurement kernel on no path: K13's L2 yardstick
    "l2_read_probe": {"l2_read_probe_fp32": [_VP] + [_INT] * 2 + [_VP]
                      + [_INT, _VP]},
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
    """A source and, after it, every header that it includes with quotes
    (transitively, each once), found as nvcc finds it: beside the file
    that includes it, else in ``csrc/``."""
    seen.add(path)
    data = path.read_bytes()
    for inc in _LOCAL_INCLUDE.findall(data):
        header = path.parent / inc.decode()
        if not header.exists():
            header = _CSRC / inc.decode()
        if header not in seen:
            data += _source_bytes(header, seen)
    return data


def _so_path(name: str, src: Path | None = None) -> Path:
    # the digest covers the included headers too, so that an edit to a
    # shared header never loads a stale library
    src = _CSRC / f"{name}.cu" if src is None else Path(src)
    digest = hashlib.sha256(_source_bytes(src, set())).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _load(so: Path, source: str, partial: bool = False):
    """The library at ``so``, with the C functions of ``csrc/<source>.cu``
    typed; with ``partial`` (an alternative version of the source) those
    it lacks are left out."""
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes in _CUDA_SOURCES[source].items():
        if partial and not hasattr(lib, fn_name):
            continue
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_cuda_libs(names=None, alts=None) -> dict:
    """Compile the CUDA sources for sm_90a into ``build/`` (once per source
    content; one nvcc per source, all started together) and load them with
    ctypes. nvcc's defaults are kept: IEEE division and square root, no
    flush to zero. nvcc's output (ptxas's registers and spills) is kept
    beside each library and read into ``BUILD_LOG`` whether the library is
    built now or was built before.

    ``alts`` ({key: (source, path)}) builds other files with the C
    interface of ``csrc/<source>.cu`` beside them, such as an older
    version of it, under their own keys (not kept for ``lib``). Returns
    {source or key: CDLL}."""
    names = list(_CUDA_SOURCES) if names is None else list(names)
    alts = dict(alts or {})
    if set(alts) & set(_CUDA_SOURCES):
        raise ValueError(f"an alternative takes a source's name: {alts}")
    with _lib_lock:
        jobs = {n: (n, _CSRC / f"{n}.cu") for n in names if n not in _libs}
        jobs.update({key: (source, Path(path))
                     for key, (source, path) in alts.items()})
        procs = {}
        for key, (_, src) in jobs.items():
            so = _so_path(key, src)
            log = so.with_suffix(".log")
            # a library without its log (an older build/) is built again
            if so.exists() and log.exists():
                BUILD_LOG[key] = log.read_text()
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas=-v", "-shared",
                   "-Xcompiler", "-fPIC", f"-I{_CSRC}", "-o", str(tmp),
                   str(src)]
            procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, so, log)
        failed = []
        for key, (proc, tmp, so, log) in procs.items():
            BUILD_LOG[key] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc {jobs[key][1].name} failed "
                              f"({proc.returncode}):\n{BUILD_LOG[key]}")
            else:
                # the log first, so that a library always has one
                log.write_text(BUILD_LOG[key])
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        built = {key: _load(_so_path(key, src), source, key in alts)
                 for key, (source, src) in jobs.items()}
        _libs.update({n: built[n] for n in names if n in built})
        return {**{n: _libs[n] for n in names},
                **{key: built[key] for key in alts}}


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
