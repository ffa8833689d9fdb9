#!/usr/bin/env python
"""The qk-norm + RoPE producers K2, K5 and K4 (``csrc/qk_producers.cu``)
timed at the serving shapes on one NVIDIA GPU: at the port's launch
geometry, at other team shapes and in other versions of the source, in
one run.

``--geometry TEAM:VPT`` adds a launch geometry (threads a team, 16-byte
vectors a thread) wherever the kernel takes it for the shape; ``--alt
NAME=PATH`` adds a file with the same C interface (an edited copy of the
source), built beside it by ``ops/cuda_build.py``. The port also runs
through its public wrapper (``ops/attention``), whose host work (checks,
allocation, the ctypes call) bounds the small shapes. The versions run in
turns (each once, then again in reverse order; CUDA events, mean of
``--iters`` launches after warm-up) beside a device copy of the input,
the bandwidth yardstick. Each output is held within one bf16 ulp of the
port's at its own geometry (the count of those over it is printed).

Usage: python -m frameino_tpu_torch.scripts.tune_qk_producers
       [--geometry 128:3 ...] [--alt NAME=PATH ...] [--shapes k2_wan,...]
       [--iters 20]
"""

from __future__ import annotations

import argparse
import json

import torch

from frameino_tpu_torch.ops import attention as A
from frameino_tpu_torch.ops import cuda_build

PORT = "port"   # csrc/qk_producers.cu of this checkout at its geometry
WRAPPER = "wrapper"   # the same through ops/attention's public wrapper
# name: (kernel, batch, tokens, heads, head_dim): K2 at the Wan rows, K5
# at the Wan tp = 2 and tp = 4 shards, K4 at the CogVideoX rows
SHAPES = {
    "k2_wan": ("qk_norm_rope", 2, 5460, 24, 128),
    "k5_tp2": ("qk_norm_rope_rstd", 2, 5460, 12, 128),
    "k5_tp4": ("qk_norm_rope_rstd", 2, 5460, 6, 128),
    "k4_cog": ("qk_ln_rope", 2, 19126, 48, 64),
}


def parse_geometry(text: str):
    team, vpt = (int(x) for x in text.split(":"))
    return team, vpt


def takes(geometry, heads, head_dim) -> bool:
    """Whether the kernel takes this (team, vpt) for rows of ``heads``
    heads of ``head_dim`` (the C side's checks)."""
    team, vpt = geometry
    per_head = head_dim // 8
    return (team % per_head == 0 and team * vpt >= heads * per_head
            and 1 <= vpt <= A._PRODUCER_MAX_VPT
            and team <= A._PRODUCER_THREADS
            and (team % 32 == 0 if team > 32 else team & (team - 1) == 0))


def _inputs(kind, batch, seq, heads, head_dim, g):
    hd = heads * head_dim
    raw = torch.randn(batch, seq, hd, device="cuda", dtype=torch.bfloat16,
                      generator=g)
    ang = torch.rand(seq, head_dim // 2, device="cuda", generator=g) * 6.3
    cos, sin = ang.cos().contiguous(), ang.sin().contiguous()
    if kind == "qk_ln_rope":
        gain = 1 + 0.1 * torch.randn(head_dim, device="cuda", generator=g)
        ptrs = (gain, 0.1 * torch.randn(head_dim, device="cuda",
                                        generator=g), cos, sin)
    else:
        gain = 1 + 0.1 * torch.randn(hd, device="cuda", generator=g)
        rstd = (torch.rsqrt(raw.float().square().mean(-1) + 1e-6)
                if kind == "qk_norm_rope_rstd" else None)
        ptrs = (rstd, gain, cos, sin)
    return raw, ptrs


def launcher(lib, kind, raw, ptrs, heads, geometry):
    """A closure launching ``kind`` from ``lib`` at ``geometry`` into its
    own output."""
    B, S, HD = raw.shape
    D = HD // heads
    team, vpt = geometry
    tpb = A._PRODUCER_THREADS // team
    per_sm = lib.qk_producer_blocks_per_sm(A._PRODUCER_KINDS[kind], vpt,
                                           team * tpb)
    grid = A._producer_grid(B * S, tpb, per_sm * torch.cuda.
                            get_device_properties(0).multi_processor_count)
    out = torch.empty(B * heads, S, D, device="cuda", dtype=raw.dtype)
    fn = lib.qk_ln_rope_bf16 if kind == "qk_ln_rope" else lib.qk_norm_rope_bf16
    args = [0 if t is None else t.data_ptr() for t in ptrs]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(raw.data_ptr(), *args, out.data_ptr(), B, S, heads, D,
                 1e-6, team, vpt, tpb, grid, stream)
        if err:
            raise RuntimeError(f"{kind} at {geometry}: CUDA error {err}")
        return out
    return run, dict(grid=grid, blocks_per_sm=per_sm)


def wrapper(kind, raw, ptrs, heads):
    """A closure calling the port's wrapper of ``kind`` on the inputs."""
    a, b, cos, sin = ptrs
    if kind == "qk_ln_rope":
        return lambda: A.qk_ln_rope(raw, a, b, cos, sin, heads, 1e-6)
    if kind == "qk_norm_rope_rstd":
        return lambda: A.qk_norm_rope_rstd(raw, a, b, cos, sin, heads)
    return lambda: A.qk_norm_rope(raw, b, cos, sin, heads, 1e-6)


def time_ms(fn, iters):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometry", action="append", default=[],
                    type=parse_geometry)
    ap.add_argument("--alt", action="append", default=[])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    alts = dict(a.split("=", 1) for a in args.alt)
    if PORT in alts:
        raise ValueError(f"--alt {PORT}= names the port's own source")
    if not torch.cuda.is_available():
        raise RuntimeError("tune_qk_producers needs an NVIDIA GPU")
    built = cuda_build.build_cuda_libs(
        ["qk_producers"], {n: ("qk_producers", p) for n, p in alts.items()})
    libs = {PORT: built["qk_producers"], **{n: built[n] for n in alts}}
    print(torch.cuda.get_device_name(0))
    g = torch.Generator("cuda").manual_seed(0)
    rows = {}
    for name in args.shapes.split(","):
        kind, batch, seq, heads, head_dim = SHAPES[name]
        raw, ptrs = _inputs(kind, batch, seq, heads, head_dim, g)
        own = A._producer_geometry(heads, head_dim)[:2]
        versions = {f"{v}": (lib, own) for v, lib in libs.items()}
        versions.update({f"{PORT} {t}:{p}": (libs[PORT], (t, p))
                         for t, p in args.geometry
                         if (t, p) != own and takes((t, p), heads, head_dim)})
        runs, info = {}, {}
        for label, (lib, geometry) in versions.items():
            runs[label], info[label] = launcher(lib, kind, raw, ptrs, heads,
                                                geometry)
            info[label]["geometry"] = list(geometry)
        # the port through its public wrapper: its checks and launch on the
        # host on top of the same kernel
        runs[WRAPPER] = wrapper(kind, raw, ptrs, heads)
        info[WRAPPER] = dict(info[PORT])
        want = runs[PORT]().float().clone()
        for label, run in runs.items():
            got = run().float()
            ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(
                torch.maximum(got.abs(), want.abs()), min=2.0 ** -126))) - 7)
            info[label]["over_one_ulp"] = int(((got - want).abs() > ulp).sum())
        times = {label: [] for label in runs}
        order = list(runs) + list(reversed(runs))
        for label in order:
            times[label].append(time_ms(runs[label], args.iters))
        copy_ms = time_ms(lambda: torch.empty_like(raw).copy_(raw),
                          args.iters)
        rows[name] = dict(copy_ms=copy_ms, versions={
            label: dict(info[label], ms=times[label]) for label in runs})
        print(f"{name} {list(raw.shape)}: copy of raw {copy_ms:.4f} ms; "
              + "; ".join(f"{label} {info[label]['geometry']} "
                          + "/".join(f"{t:.4f}" for t in times[label])
                          + f" ms ({info[label]['over_one_ulp']} over one "
                          f"ulp)" for label in runs))
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
