#!/usr/bin/env python
"""The int8-QK^T flash forwards K11 and K12 (``csrc/flash_int8.cu``) timed
against other versions of their source on one NVIDIA GPU, in one run.

``--alt NAME=PATH`` adds a file with the same C entry point
(``flash_variant_int8``): an edited copy of ``flash_int8.cu`` to try a
design choice (stages, warpgroups), or the parent's ``mma.sync``
``flash_variants.cu`` unpacked with ``git archive`` beside its
``flash_common.cuh``. Every version is built by ``ops/cuda_build.py`` (one
nvcc each, all started together; ptxas's registers and spills printed) and
launched on the same int8 codes, scales and bound at the experiment shapes,
kernel alone, timed with CUDA events in turns (each version once, then
again in reverse order), beside the bf16 kernels of the same design, K3
(``v0``, online softmax) and K1 (static bound, on q pre-scaled and its
bound), and one ``scaled_dot_product_attention`` call on the bf16 inputs. Each version's
output is held to the port's within 5e-3 relative L2, except a
``--probe NAME=PATH``'s: a copy that computes something else on purpose
(the key scales left out, say), timed to tell what a piece costs.

Usage: python -m frameino_tpu_torch.scripts.tune_flash_int8
       [--alt NAME=PATH ...] [--probe NAME=PATH ...] [--shapes wan,cog]
       [--iters 10]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import torch
import torch.nn.functional as F

from frameino_tpu_torch.ops import attention as A
from frameino_tpu_torch.ops import cuda_build
from frameino_tpu_torch.ops import flash_variants as FV
from frameino_tpu_torch.scripts.tune_flash_fwd import event_ms

PORT = "port"   # the version of csrc/flash_int8.cu in this checkout
# name: (batch, heads, S, head_dim): the experiment scripts' shapes
SHAPES = {"wan": (2, 24, 5590, 128), "cog": (2, 48, 15906, 64)}
REL_L2 = 5e-3


def build(alts, source="flash_int8"):
    """{version: CDLL}: the port's ``csrc/<source>.cu`` and each
    alternative, with ptxas's report of each kernel (registers, spills,
    serialised wgmma)."""
    built = cuda_build.build_cuda_libs(
        [source], {n: (source, p) for n, p in alts.items()})
    libs = {PORT: built[source], **{n: built[n] for n in alts}}
    for name, key in ((PORT, source), *((n, n) for n in alts)):
        print(f"# {name}:")
        for line in cuda_build.BUILD_LOG.get(key, "").splitlines():
            if "Compiling entry" in line:
                m = re.search(r"([a-z_]+kernel)I((?:L[ib]\d+E)+)E", line)
                print("  " + (f"{m[1]}<" + ", ".join(
                    re.findall(r"L[ib](\d+)E", m[2])) + ">" if m else line))
            elif "registers" in line or "spill" in line or "serial" in line:
                print("    " + line.strip())
    return libs


def int8_bodies(q, k, v, scale):
    """{body: launch(library)}: K12 and K11 on the codes of q and k."""
    codes = FV.quantize_qk(q, k, scale)
    bound = FV.int8_bound(*codes).reshape(1)
    return {body: (lambda lib, bnd=bnd: FV.int8_flash(*codes, v, bnd,
                                                     library=lib))
            for body, bnd in (("k12", None), ("k11", bound))}


def run_versions(argv, source, bodies, shapes=",".join(SHAPES)):
    """The command line of the tuning scripts: every version of
    ``csrc/<source>.cu`` built, and each of ``bodies(q, k, v, scale)``
    ({body: launch(library)}) run on each version at the experiment
    shapes (``shapes``: the default of ``--shapes``), held to the port's
    output and timed in turns beside K3, K1 and SDPA."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--alt", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--probe", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--shapes", default=shapes)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    alts = dict(a.split("=", 1) for a in args.alt)
    probes = dict(a.split("=", 1) for a in args.probe)
    alts.update(probes)
    if PORT in alts:
        raise ValueError(f"--alt: {PORT!r} names the port's own source")
    if not torch.cuda.is_available():
        raise RuntimeError("this script times CUDA kernels and needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# {smi}")
    libs = build(alts, source)
    names = list(libs)
    g = torch.Generator("cuda").manual_seed(0)
    rows = []
    for shape in args.shapes.split(","):
        b, h, s, d = SHAPES[shape]
        q, k, v = (torch.randn(b, h, s, d, device="cuda",
                               dtype=torch.bfloat16, generator=g)
                   for _ in range(3))
        scale = d ** -0.5
        flat = [t.reshape(-1, s, d) for t in (q, k, v)]
        v0 = event_ms(lambda: A.flash_attention_inference(q, k, v, scale),
                      args.iters)
        qp = (flat[0].float() * (scale * A.LOG2E)).to(torch.bfloat16)
        k1_bound = A._rowmax_norm(qp) * A._rowmax_norm(flat[1])
        k1 = event_ms(lambda: A.flash_fwd_static(qp, flat[1], flat[2],
                                                 k1_bound), args.iters)
        sdpa = event_ms(lambda: F.scaled_dot_product_attention(
            *(t[None] for t in flat), scale=scale), args.iters)
        print(f"{shape} [{b * h}, {s}, {d}]: K3 (v0) {v0:.3f} ms, K1 "
              f"{k1:.3f} ms, SDPA {sdpa:.3f} ms")
        for body, launch in bodies(q, k, v, scale).items():
            runs = {n: (lambda lib=libs[n]: launch(lib)) for n in names}
            want = runs[PORT]().clone()
            rel = {}
            for n in names:
                got = runs[n]()
                rel[n] = ((got.float() - want.float()).norm()
                          / want.float().norm()).item()
                if n not in probes and not (
                        rel[n] <= REL_L2 and bool(torch.isfinite(got).all())):
                    raise RuntimeError(f"{shape} {body} {n}: {rel[n]:.3e} "
                                       f"relative L2 from {PORT}")
            ms = {n: [] for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    ms[n].append(event_ms(runs[n], args.iters))
            for n in names:
                mean = sum(ms[n]) / len(ms[n])
                each = ", ".join(f"{x:.3f}" for x in ms[n])
                print(f"  {body} {n:12s} {mean:8.3f} ms ({each})  rel L2 "
                      f"{rel[n]:.2e}")
                rows.append(dict(shape=shape, body=body, version=n, ms=ms[n],
                                 mean_ms=mean, v0_ms=v0, k1_ms=k1,
                                 sdpa_ms=sdpa,
                                 rel_l2_from_port=rel[n]))
            del want
        del q, k, v, flat, qp
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "rows": rows}))
    return rows


def main(argv=None):
    return run_versions(argv, "flash_int8", int8_bodies)


if __name__ == "__main__":
    main()
