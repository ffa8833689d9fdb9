#!/usr/bin/env python
"""The serving flash forwards K1 and K3 (``csrc/flash_fwd.cu``) timed
against other versions of their source on one NVIDIA GPU, in one run.

``--alt NAME=PATH`` adds a file with the same C interface, for example
an older ``flash_fwd.cu`` unpacked with ``git archive`` or an edited copy
of the current one. Every version is built by ``ops/cuda_build.py`` (one
nvcc each, all started together) and timed with CUDA events at the
serving shapes, in turns (each version once, then again in reverse
order), beside one ``scaled_dot_product_attention`` call on the same
inputs. Each version's output is held to the port's within 5e-3 relative
L2. The kernels' bounds are ``chip_smoke.py``'s.

Usage: python -m frameino_tpu_torch.scripts.tune_flash_fwd
       [--alt NAME=PATH ...] [--shapes k1_wan,...] [--iters 10]
       (``--shapes`` also takes the PROBES of K3)
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch
import torch.nn.functional as F

from frameino_tpu_torch.ops import cuda_build

LOG2E = 1.4426950408889634
PORT = "port"   # the version of csrc/flash_fwd.cu in this checkout
# name: (static bound, batch*heads, Sq, Skv, head_dim): K1 at the Wan and
# CogVideoX self-attention shapes, K3 at the Wan cross-attention shape and
# at the CogVideoX protocol shape of the experiment scripts (their v0)
SHAPES = {
    "k1_wan": (True, 48, 5460, 5460, 128),
    "k1_cog": (True, 96, 19126, 19126, 64),
    "k3_wan": (False, 48, 5460, 512, 128),
    "k3_cog": (False, 96, 15906, 15906, 64),
}
# shapes that take K3 at the Wan cross shape apart (not in the default
# run): more text keys (the cost a q tile pays whatever its key count is
# the intercept), the self-attention shape (K3's online softmax against
# K1's static one), and K3 handed a pre-scaled q (q_scale 1: the rescale
# pass skipped)
PROBES = {
    "k3_wan_1024": (False, 48, 5460, 1024, 128),
    "k3_wan_2048": (False, 48, 5460, 2048, 128),
    "k3_wan_self": (False, 48, 5460, 5460, 128),
    "k3_wan_prescaled": (False, 48, 5460, 512, 128),
}
REL_L2 = 5e-3


def build(alts):
    """{version: CDLL}: the port's source and each alternative. Prints
    any kernel whose wgmmas ptxas serialises (a 1.5-2x loss)."""
    built = cuda_build.build_cuda_libs(
        ["flash_fwd"], {n: ("flash_fwd", p) for n, p in alts.items()})
    libs = {PORT: built["flash_fwd"], **{n: built[n] for n in alts}}
    for name, key in ((PORT, "flash_fwd"), *((n, n) for n in alts)):
        serial = [line for line in cuda_build.BUILD_LOG.get(key, "")
                  .splitlines() if "serialized" in line]
        print(f"# {name}: " + ("\n  ".join(["wgmma serialised in"] + serial)
                               if serial else "no serialised wgmma"))
    return libs


def launcher(lib, q, k, v, bound, static, q_scale):
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), bound.data_ptr() if static
                                 else 0, bh, sq, k.shape[1], d, int(static),
                                 q_scale, stream)
        if err:
            raise RuntimeError(f"flash_fwd_bf16: CUDA error {err}")
        return o
    return run


def event_ms(fn, iters):
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--alt", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    alts = dict(a.split("=", 1) for a in args.alt)
    if PORT in alts:
        raise ValueError(f"--alt: {PORT!r} names the port's own source")
    if not torch.cuda.is_available():
        raise RuntimeError("this script times CUDA kernels and needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# {smi}")
    libs = build(alts)
    names = list(libs)
    g = torch.Generator("cuda").manual_seed(0)
    rows = []
    for shape in args.shapes.split(","):
        static, bh, sq, skv, d = {**SHAPES, **PROBES}[shape]
        q, k, v = (torch.randn(bh, n, d, device="cuda", dtype=torch.bfloat16,
                               generator=g) for n in (sq, skv, skv))
        c = float(torch.tensor(d ** -0.5 * LOG2E, dtype=torch.bfloat16))
        if static:
            q = q * torch.tensor(c, dtype=torch.bfloat16)
            bound = (torch.linalg.vector_norm(q, dim=-1, dtype=torch.float32)
                     .amax() * torch.linalg.vector_norm(
                         k, dim=-1, dtype=torch.float32).amax()).reshape(1)
            q_scale, sdpa_scale = 1.0, math.log(2)
        elif shape.endswith("_prescaled"):
            q = q * torch.tensor(c, dtype=torch.bfloat16)
            bound, q_scale, sdpa_scale = None, 1.0, math.log(2)
        else:
            bound, q_scale, sdpa_scale = None, c, d ** -0.5
        runs = {n: launcher(libs[n], q, k, v, bound, static, q_scale)
                for n in names}
        want = runs[PORT]().clone()
        rel = {}
        for n in names:
            got = runs[n]()
            rel[n] = ((got.float() - want.float()).norm()
                      / want.float().norm()).item()
            if not (rel[n] <= REL_L2 and bool(torch.isfinite(got).all())):
                raise RuntimeError(f"{shape} {n}: {rel[n]:.3e} relative L2 "
                                   f"from {PORT}")
        ms = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                ms[n].append(event_ms(runs[n], args.iters))
        sdpa = event_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], scale=sdpa_scale), args.iters)
        print(f"{shape} [{bh}, {sq}|{skv}, {d}]: SDPA {sdpa:.3f} ms")
        for n in names:
            mean = sum(ms[n]) / len(ms[n])
            each = ", ".join(f"{x:.3f}" for x in ms[n])
            print(f"  {n:12s} {mean:8.3f} ms ({each})  rel L2 {rel[n]:.2e}")
            rows.append(dict(shape=shape, version=n, ms=ms[n], mean_ms=mean,
                             sdpa_ms=sdpa, rel_l2_from_port=rel[n]))
        del q, k, v, runs, want
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
