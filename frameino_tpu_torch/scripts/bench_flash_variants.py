#!/usr/bin/env python
"""Flash-attention kernel-variant experiments on one NVIDIA GPU.

Counterpart of ``scripts/bench_flash_variants.py``. Against the port's
online-softmax forward K3 (``v0``) three levers, alone and combined, each
measured at both production shapes:

v1   ``ones-col``      the softmax normalizer l as one more column of the
     P.V product (one extra mma tile against a constant fragment), in
     place of the per-tile lane sums;
v2   ``static-bound``  |q.k| <= max||q_i|| * max||k_j||, computed outside
     and passed in: exp2(s - bound) needs no running max and no rescale of
     the accumulator;
v12  both;
v3   ``int8 QK^T``     per-row symmetric int8 quantization of q and k
     (tensor ops outside the kernel), the QK^T product on the int8 tensor
     cores; P.V stays bf16;
v123 all three.

Each variant is first checked against K3 on a ``--check_s`` slice (max
absolute difference), then timed with CUDA events over ``--iters``
launches after a warm-up. The kernels and their plain versions are in
``frameino_tpu_torch/ops/flash_variants.py``; the tiles are the kernels'
own (64 x 64), so there is no block sweep here.

Usage: python -m frameino_tpu_torch.scripts.bench_flash_variants
       [--shape cog,wan] [--variants v0,v1,v2,v12,v3,v123] [--iters 8]
       [--check_s 2048] [--check_only] [--device cuda|cpu]

Runs on the card and raises without one; ``--device cpu`` runs the plain
versions (at whatever size it is given) and times with the host's clock.
"""

from __future__ import annotations

import argparse

import torch

from frameino_tpu_torch.ops import flash_variants as FV
from frameino_tpu_torch.ops.attention import flash_attention_inference
from frameino_tpu_torch.scripts import clock_tag, pick_device, timed

ITERS = 8         # the default of --iters
# q rows a tile of K3 (csrc/flash_fwd.cu: 64 a consumer warpgroup, three
# at head_dim 64 and two at 128; its flash_fwd_config(D, 2)) x 128 keys
K3_Q_ROWS = {64: 192, 128: 128}

SHAPES = {
    # CogVideoX-5B FrameIn published protocol: 226 text + 14x28x40
    "cog": dict(B=2, H=48, D=64, S=226 + 14 * 28 * 40),
    # Wan2.2-5B FrameINO eval shape: (13+1) latent frames x 15x26
    "wan": dict(B=2, H=24, D=128, S=(13 + 1) * 15 * 26 + 130),
}

VARIANTS = {
    "v0": lambda q, k, v, scale: flash_attention_inference(q, k, v, scale),
    "v1": lambda q, k, v, scale: FV.flash_v1(q, k, v, scale=scale),
    "v2": lambda q, k, v, scale: FV.flash_v2(q, k, v, scale=scale),
    "v12": lambda q, k, v, scale: FV.flash_v2(q, k, v, scale=scale,
                                              ones_col=True),
    "v3": lambda q, k, v, scale: FV.flash_v3(q, k, v, scale=scale),
    "v123": lambda q, k, v, scale: FV.flash_v3(q, k, v, scale=scale,
                                               static_ones=True),
}


def tile(name: str, head_dim: int):
    """(q rows, keys) of a tile of the kernel behind variant ``name`` at
    ``head_dim``: K3 (``v0``), K9/K10 (``csrc/flash_variants.cu``) or
    K11/K12 (``csrc/flash_int8.cu``), as their layouts give them."""
    if name == "v0":
        return K3_Q_ROWS[head_dim], 128
    lay = (FV.int8_smem_layout if name in ("v3", "v123")
           else FV.variants_smem_layout)(head_dim)
    return lay["q_rows"], lay["keys"]


def main(argv=None, shapes=None):
    """Run the experiments and return the rows printed: dicts with
    ``shape``, ``variant`` and either ``max_abs`` / ``rel`` (check) or
    ``ms`` / ``tflops`` (timing). ``shapes`` replaces ``SHAPES``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="cog,wan")
    ap.add_argument("--variants", default="v0,v1,v2,v12,v3,v123")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--check_s", type=int, default=2048,
                    help="sequence slice for the numerics check")
    ap.add_argument("--check_only", action="store_true",
                    help="numerics check only, no timing")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = pick_device(args.device)
    shapes = SHAPES if shapes is None else shapes
    names = args.variants.split(",")
    rows = []

    for shape_name in args.shape.split(","):
        cfg = shapes[shape_name]
        B, H, D, S = cfg["B"], cfg["H"], cfg["D"], cfg["S"]
        scale = D ** -0.5
        # qk-norm-conditioned inputs: unit-RMS rows (what the producers
        # emit after RMS/LayerNorm)
        gen = torch.Generator(device).manual_seed(0)
        q, k, v = (torch.randn(B, H, S, D, device=device,
                               dtype=torch.bfloat16, generator=gen)
                   for _ in range(3))
        fl = 4 * B * H * S * S * D
        print(f"=== {shape_name}: B={B} H={H} D={D} S={S}", flush=True)

        # numerics check on a slice vs the reference kernel
        Sc = args.check_s
        qs_, ks_, vs_ = (t[:, :2, :Sc].contiguous() for t in (q, k, v))
        ref = VARIANTS["v0"](qs_, ks_, vs_, scale).float()
        for name in names:
            if name == "v0":
                continue
            got = VARIANTS[name](qs_, ks_, vs_, scale).float()
            err = (got - ref).abs().max().item()
            rel = err / max(ref.abs().max().item(), 1e-9)
            print(f"  {name}: max|diff| {err:.3e} (rel {rel:.3e})",
                  flush=True)
            rows.append(dict(shape=shape_name, variant=name, max_abs=err,
                             rel=rel))

        if args.check_only:
            continue
        for name in names:
            t, first = timed(lambda: VARIANTS[name](q, k, v, scale),
                             args.iters, device)
            bq, bk = tile(name, D)
            print(f"  {name} (tile {bq}x{bk}): {t * 1e3:8.2f} ms  "
                  f"{fl / t / 1e12:6.1f} TFLOP/s  (first call {first:.1f}s)"
                  f"{clock_tag(device)}", flush=True)
            rows.append(dict(shape=shape_name, variant=name, ms=t * 1e3,
                             tflops=fl / t / 1e12))
    return rows


if __name__ == "__main__":
    main()
