#!/usr/bin/env python
"""K13, multi-scale deformable attention (``csrc/ms_deform_attn.cu``), timed
against other versions of its source on one NVIDIA GPU, in one run.

``--alt [NAME=]PATH`` adds a file with the same C entry point
(``ms_deform_attn_fp32``): an edited copy of ``ms_deform_attn.cu`` that
tries one design choice, or an older version of it unpacked with ``git
archive`` (NAME defaults to the file's stem). Every version is built by
``ops/cuda_build.py`` (one nvcc each, all started together; ptxas's
registers, spills and shared memory printed) and launched on the same
inputs at OneFormer's shape ([1, 21168, 8, 32], levels 96x168, 48x84,
24x42, 4 points) under each ``--pattern``:

- ``uniform``: locations uniform in [-0.1, 1.1], the worst case (no two
  queries read the same value rows);
- ``encoder``: the locations OneFormer's encoder samples at
  (``encoder_sampling_locations``: each query near its own pixel,
  neighbours reading overlapping rows).

Each version's output is held to the plain version's within 1e-5 max abs
(printed; a version over it is flagged), and the versions are timed with
CUDA events in turns (each once, then again in reverse order; mean of
``--iters`` launches after warm-up), beside the L2 floor: the pattern's
in-bounds corner reads (128-byte value rows) over the L2 read rate that
``csrc/l2_read_probe.cu`` measures in the same run on a 21.7 MB buffer
read in random 128-byte rows. The kernel's bound is ``chip_smoke.py``'s.
This module is also the one home of K13's timing inputs and L2 floor:
``chip_smoke.py`` draws its inputs from ``make_inputs``.

Usage: python -m frameino_tpu_torch.scripts.tune_ms_deform_attn
       [--alt [NAME=]PATH ...] [--pattern uniform|encoder ...]
       [--iters 20] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from frameino_tpu_torch.ops import cuda_build
from frameino_tpu_torch.ops import ms_deform_attn as M
from frameino_tpu_torch.scripts.tune_flash_fwd import event_ms

PORT = "port"   # the version of csrc/ms_deform_attn.cu in this checkout
PATTERNS = ("uniform", "encoder")
# OneFormer's deformable sampling at a 720x1280 clip (padded to 768x1344)
LEVELS = ((96, 168), (48, 84), (24, 42))
BATCH, HEADS, CHANNELS, POINTS = 1, 8, 32, 4
# the value tensor at that shape in 128-byte rows (21.7 MB): the L2 probe's
# buffer
VALUE_ROWS = sum(h * w for h, w in LEVELS) * HEADS * CHANNELS // 32
MAX_ABS = 1e-5


def parse_alt(text: str):
    """``NAME=PATH`` or ``PATH`` (named by its stem): (name, path)."""
    name, sep, path = text.partition("=")
    return (name, path) if sep else (Path(text).stem, text)


def encoder_sampling_locations(spatial_shapes, batch: int, heads: int,
                               points: int, seed: int = 0) -> np.ndarray:
    """The locations OneFormer's deformable encoder samples at when its
    offsets are at their initial bias: the queries are the value rows
    (Q = S), each query's reference point is the centre of its own pixel
    at its own level (the same normalized point at every level, as
    ``models.oneformer._encoder_reference_points``), and head h, level l,
    point p moves it by Deformable DETR's initial offset in pixels of level
    l (``MSDeformAttn._reset_parameters``): (cos t, sin t), t = 2 pi h / H,
    scaled so that its larger component is 1, times p + 1, plus N(0, 1)
    noise drawn with numpy from ``seed``. Neighbouring queries read
    overlapping value rows. Returns [B, S, H, L, P, 2] float32 (x, y)."""
    shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    ref = []
    for h, w in shapes:
        ry, rx = np.meshgrid((np.arange(h) + 0.5) / h,
                             (np.arange(w) + 0.5) / w, indexing="ij")
        ref.append(np.stack([rx.ravel(), ry.ravel()], -1))
    ref = np.concatenate(ref)                                  # [S, 2]
    theta = 2 * np.pi * np.arange(heads) / heads
    dirs = np.stack([np.cos(theta), np.sin(theta)], -1)
    dirs = dirs / np.abs(dirs).max(-1, keepdims=True)          # [H, 2]
    offsets = (dirs[:, None, None, :]
               * (np.arange(points) + 1)[None, None, :, None])  # [H, 1, P, 2]
    noise = np.random.RandomState(seed).randn(
        batch, len(ref), heads, len(shapes), points, 2)
    pixel = np.array([[w, h] for h, w in shapes], np.float64)  # [L, 2]
    loc = (ref[None, :, None, None, None, :]
           + (offsets + noise) / pixel[:, None, :])
    return loc.astype(np.float32)


def make_inputs(pattern: str, seed: int = 0, levels=LEVELS, batch=BATCH,
                heads=HEADS, channels=CHANNELS, points=POINTS, queries=None,
                lo=-0.1, hi=1.1, device="cuda"):
    """value [B, S, H, D] unit normal, the pattern's locations [B, Q, H, L,
    P, 2] (``uniform``: in [lo, hi]; ``encoder``: Q = S) and weights [B, Q,
    H, L, P] (a softmax over each query and head's L * P samples, as the
    encoder's), seeded; Q defaults to S (the encoder's queries are its
    value rows)."""
    if pattern not in PATTERNS:
        raise ValueError(f"pattern {pattern!r} is not one of {PATTERNS}")
    g = torch.Generator(device).manual_seed(seed)
    S = sum(h * w for h, w in levels)
    Q = S if queries is None else queries
    L = len(levels)
    value = torch.randn(batch, S, heads, channels, device=device,
                        generator=g)
    if pattern == "uniform":
        loc = lo + (hi - lo) * torch.rand(batch, Q, heads, L, points, 2,
                                          device=device, generator=g)
    elif Q != S:
        raise ValueError(f"the encoder's {S} queries are its value rows, "
                         f"not {Q}")
    else:
        loc = torch.from_numpy(encoder_sampling_locations(
            levels, batch, heads, points, seed)).to(device)
    w = torch.softmax(torch.randn(batch, Q, heads, L * points,
                                  device=device, generator=g), -1)
    return value, loc, w.reshape(batch, Q, heads, L, points)


def corner_reads(levels, loc) -> int:
    """The bilinear corners inside their levels: the value rows a kernel
    must read (a corner outside is zero padding)."""
    n = 0
    for lvl, (h, w) in enumerate(levels):
        x = torch.floor(loc[:, :, :, lvl, :, 0] * w - 0.5)
        y = torch.floor(loc[:, :, :, lvl, :, 1] * h - 0.5)
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            n += int(((x + dx >= 0) & (x + dx < w) & (y + dy >= 0)
                      & (y + dy < h)).sum())
    return n


def l2_read_rate(rows: int = VALUE_ROWS, reads: int = 128,
                 iters: int = 20) -> float:
    """Bytes a second that ``csrc/l2_read_probe.cu`` reads from a [rows,
    32] fp32 buffer (warmed into L2) in random 128-byte rows, 16 blocks of
    256 threads an SM, each quarter-warp ``reads`` rows."""
    lib = cuda_build.lib("l2_read_probe")
    buf = torch.randn(rows, 32, device="cuda")
    blocks = 16 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.l2_read_probe_fp32(buf.data_ptr(), rows, reads,
                                     out.data_ptr(), blocks, stream)
        if err:
            raise RuntimeError(f"l2_read_probe_fp32: CUDA error {err}")
    ms = event_ms(run, iters)
    return blocks * 32 * reads * 128 / (ms * 1e-3)


def build(alts):
    """{version: CDLL}: the port's ``csrc/ms_deform_attn.cu`` and each
    alternative (and the L2 probe), with ptxas's report of each kernel."""
    built = cuda_build.build_cuda_libs(
        ["ms_deform_attn", "l2_read_probe"],
        {n: ("ms_deform_attn", p) for n, p in alts.items()})
    libs = {PORT: built["ms_deform_attn"], **{n: built[n] for n in alts}}
    for name, key in ((PORT, "ms_deform_attn"), *((n, n) for n in alts)):
        print(f"# {name}:")
        for line in cuda_build.BUILD_LOG.get(key, "").splitlines():
            if "Compiling entry" in line:
                m = re.search(r"([a-z_]+kernel)(?:I((?:L[ib]\d+E)+)E)?", line)
                print("  " + (f"{m[1]}<" + ", ".join(re.findall(
                    r"L[ib](\d+)E", m[2] or "")) + ">" if m else line))
            elif "registers" in line or "spill" in line:
                print("    " + line.strip())
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alt", action="append", default=[], type=parse_alt,
                    metavar="[NAME=]PATH")
    ap.add_argument("--pattern", action="append", choices=PATTERNS)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    alts = dict(args.alt)
    if PORT in alts:
        raise ValueError(f"--alt {PORT}= names the port's own source")
    if not torch.cuda.is_available():
        raise RuntimeError("tune_ms_deform_attn needs an NVIDIA GPU")
    libs = build(alts)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi})")
    rate = l2_read_rate()
    print(f"L2 read rate (random 128-byte rows of "
          f"{VALUE_ROWS * 128 / 1e6:.1f} MB): {rate / 1e12:.3f} TB/s")
    report = {"device": smi, "l2_bytes_per_s": rate, "patterns": {}}
    for pattern in args.pattern or PATTERNS:
        value, loc, w = make_inputs(pattern, args.seed)
        want = M.ms_deform_attn_ref(value, LEVELS, loc, w)
        runs = {v: (lambda lib=lib: M.ms_deform_attn_cuda(
            value, LEVELS, loc, w, library=lib)) for v, lib in libs.items()}
        err = {v: (run() - want).abs().max().item() for v, run in runs.items()}
        times = {v: [] for v in runs}
        for v in list(runs) + list(reversed(runs)):
            times[v].append(event_ms(runs[v], args.iters))
        corners = corner_reads(LEVELS, loc)
        floor = 1e3 * corners * CHANNELS * 4 / rate
        report["patterns"][pattern] = dict(
            corner_reads=corners, l2_floor_ms=floor,
            versions={v: dict(ms=times[v], max_abs=err[v]) for v in runs})
        print(f"{pattern}: {corners * CHANNELS * 4 / 1e9:.3f} GB of "
              f"corners, L2 floor {floor:.4f} ms")
        for v in runs:
            flag = "" if err[v] <= MAX_ABS else f"  OVER {MAX_ABS:g}"
            print(f"  {v}: " + " / ".join(f"{t:.4f}" for t in times[v])
                  + f" ms, max abs {err[v]:.3e}{flag}")
        del value, loc, w, want
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
