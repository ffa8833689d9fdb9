#!/usr/bin/env python
"""head_dim-64 (CogVideoX) flash-attention experiments on one NVIDIA GPU.

Counterpart of ``scripts/bench_attn_d64.py``. The CogVideoX DiT spends
more than half of its forward in the flash forward at head_dim 64. Three
experiments at the protocol shape (B=2, H=48, D=64, S=15,906 joint
tokens):

1. ``sweep``    the online-softmax forward K3 at each tile it is compiled
   for. The CUDA source has one at head_dim 64 (192 q rows, three
   consumer warpgroups of 64, x 128 keys, ``csrc/flash_fwd.cu``), so
   today this is one line: the baseline the other two are read against.
2. ``packed``   head-pair packing (K8, ``ops/flash_variants.packed_flash``,
   ``csrc/flash_packed.cu``: 128 packed rows, two consumer warpgroups of
   64, x 128 keys): two heads a row, checked against K3 on a slice and
   timed against it.
3. ``int8rate`` raw matrix-product rate outside any kernel of the port:
   ``torch.matmul`` in bf16 against ``torch._int_mm`` in int8 at M=2048,
   N=4096 and the depths K=64 and K=128 that the flash kernel runs per
   tile. Sizes the prize of int8 logits.

Usage: python -m frameino_tpu_torch.scripts.bench_attn_d64
       [--exp sweep,packed,int8rate] [--device cuda|cpu]

Runs on the card and raises without one; ``--device cpu`` runs the plain
versions and times with the host's clock.
"""

from __future__ import annotations

import argparse

import torch

from frameino_tpu_torch.ops.attention import flash_attention_inference
from frameino_tpu_torch.ops.flash_variants import packed_flash
from frameino_tpu_torch.scripts import clock_tag, pick_device, timed

# CogVideoX-5B FrameIn protocol joint sequence: 226 text + 14 latent
# frames x 28x40 patches @448x640
B, H, D = 2, 48, 64
S = 226 + 14 * 28 * 40
ITERS = 8                       # timed launches of an attention
# the (q rows, keys) tiles csrc/flash_fwd.cu is compiled for at head_dim 64
# (its flash_fwd_config(64, 2) q rows)
K3_TILES = [(192, 128)]
# the (packed q rows, keys) tile of csrc/flash_packed.cu (its
# flash_packed_config(2) q rows)
PACKED_TILE = (128, 128)
PACKED_CHECK = (4, 1024)        # heads and tokens of the numerics slice
INT8RATE = dict(M=2048, N=4096, iters=50)


def attn_args(device, shape):
    b, h, s = shape
    gen = torch.Generator(device).manual_seed(0)
    return tuple(torch.randn(b, h, s, D, device=device, dtype=torch.bfloat16,
                             generator=gen) for _ in range(3))


def _time_attention(fn, shape, device):
    b, h, s = shape
    t, _ = timed(fn, ITERS, device)
    return t, 4 * b * h * s * s * D / t / 1e12


def exp_sweep(device, shape):
    q, k, v = attn_args(device, shape)
    print(f"# sweep: B={shape[0]} H={shape[1]} D={D} S={shape[2]}")
    rows = []
    for bq, bk in K3_TILES:
        t, rate = _time_attention(
            lambda: flash_attention_inference(q, k, v, D ** -0.5), shape,
            device)
        print(f"bq={bq:5d} bk={bk:5d} {t * 1e3:7.2f} ms {rate:6.1f} TFLOP/s"
              f"{clock_tag(device)}")
        rows.append(dict(exp="sweep", bq=bq, bk=bk, ms=t * 1e3, tflops=rate))
    return rows


def exp_packed(device, shape):
    q, k, v = attn_args(device, shape)
    # correctness vs the reference kernel first (small slice)
    hc, sc = PACKED_CHECK
    qs, ks, vs = (t[:, :hc, :sc].contiguous() for t in (q, k, v))
    got = packed_flash(qs, ks, vs)
    ref = flash_attention_inference(qs, ks, vs, D ** -0.5)
    err = (got.float() - ref.float()).abs().max().item()
    print(f"# packed-vs-reference max|diff| (S={qs.shape[2]} slice): "
          f"{err:.3e}")
    if not err < 5e-2:
        raise RuntimeError("packed kernel numerics diverged")
    rows = [dict(exp="packed", check_max_abs=err)]

    t, rate = _time_attention(lambda: packed_flash(q, k, v), shape, device)
    bq, bk = PACKED_TILE
    print(f"packed bq={bq:4d} bk={bk:5d} {t * 1e3:7.2f} ms {rate:6.1f} "
          f"useful-TFLOP/s{clock_tag(device)}")
    rows.append(dict(exp="packed", ms=t * 1e3, tflops=rate))
    bq, bk = K3_TILES[0]
    t_ref, rate_ref = _time_attention(
        lambda: flash_attention_inference(q, k, v, D ** -0.5), shape, device)
    print(f"direct D=64 ({bq},{bk}): {t_ref * 1e3:7.2f} ms {rate_ref:6.1f} "
          f"TFLOP/s{clock_tag(device)}")
    rows.append(dict(exp="packed", direct_ms=t_ref * 1e3,
                     direct_tflops=rate_ref))
    return rows


def exp_int8rate(device, shape=None):
    """Raw matrix-product rate: bf16 vs int8 at K=64 and K=128, the depth
    class the flash kernel runs per tile; library calls, not kernels of
    the port. M and N are large enough (2048 x 4096) that launch overhead
    is small against the product."""
    M, N, iters = INT8RATE["M"], INT8RATE["N"], INT8RATE["iters"]
    rows = []
    for name, dtype, unit, mm in (
            ("bf16", torch.bfloat16, "TFLOP/s", torch.matmul),
            ("int8", torch.int8, "TOP/s", torch._int_mm)):
        for K in (64, 128):
            a = torch.ones(M, K, dtype=dtype, device=device)
            b = torch.ones(K, N, dtype=dtype, device=device)
            t, _ = timed(lambda: mm(a, b), iters, device)
            rate = 2 * M * N * K / t / 1e12
            print(f"dot {name} K={K:4d}: {t * 1e6:7.1f} us {rate:6.1f} "
                  f"{unit}{clock_tag(device)}")
            rows.append(dict(exp="int8rate", dtype=name, K=K, us=t * 1e6,
                             rate=rate))
    return rows


EXPERIMENTS = {"sweep": exp_sweep, "packed": exp_packed,
               "int8rate": exp_int8rate}


def main(argv=None, shape=None):
    """Run the experiments and return the rows printed. ``shape`` replaces
    the protocol's (B, H, S)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default="sweep,packed,int8rate")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = pick_device(args.device)
    shape = (B, H, S) if shape is None else tuple(shape)
    rows = []
    for name in args.exp.split(","):
        print(f"=== {name} ===")
        rows += EXPERIMENTS[name](device, shape)
    return rows


if __name__ == "__main__":
    main()
