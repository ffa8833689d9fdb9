#!/usr/bin/env python3
"""Smoke run of the PyTorch port (frameino_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --profile  # also profile one full-depth train
                                     # step (build/train_profile.json)

Phases (any failure exits non-zero; there is no CPU path):
 1. device: the card's name and `nvidia-smi` name, power limit;
 2. build: compile the two CUDA sources (nvcc, sm_90a, both at once: the
    serving flash kernels and K6) and the two Triton producers
    (qk-norm/RoPE, qk-LayerNorm/RoPE) from the sources in the checkout;
 3. kernels: each kernel against its plain PyTorch version at the shapes
    the Wan serving path gives it (Wan2.2-TI2V-5B, 49 frames at 480x832:
    CFG batch 2, 24 heads of 128, 5,460 tokens, 512 text tokens), with
    CUDA event times of both (the flash kernels also within FLASH_REL_L2
    relative L2);
 4. serve: the full-width Wan2.2-TI2V-5B-motion pipeline with seeded
    random weights behind the HTTP server; three POST /generate requests;
    each must return 200 with the requested frames and size, and must
    launch the kernels exactly 30 (K1), 60 (K2), 30 (K3) and 0 (K4) times
    per denoise step;
 5. reference: a small Wan pipeline (2 blocks at head_dim 128) in bf16 on
    the card against the same weights in fp32 on the CPU's plain path;
 6. CogVideoX kernels: K4 and K1 at head_dim 64 against their plain
    versions at the CogVideoX-5B shapes (49 frames at 480x720 plus the ID
    frame: CFG batch 2, 48 heads of 64, 226 + 18,900 = 19,126 tokens);
    K1's plain version runs on 4 of the 96 batch-head rows;
 7. serve CogVideoX: the full-width CogVideoX-5B-I2V-FrameINO pipeline
    (bf16 DiT and VAE, seeded random weights) behind the HTTP server; two
    requests, each 42 (K1) and 84 (K4) launches per step, none of K2/K3;
 8. reference CogVideoX: a small pipeline (2 blocks at head_dim 64) in
    bf16 on the card against fp32 on the CPU;
 9. train kernels: K6 forward and backward against the plain version's
    fp32 autograd at the Wan training shapes (self [1, 24, 5460, 128],
    cross [1, 24, 5460, 128] x [1, 24, 512, 128]) and a ragged head_dim-64
    shape, within FLASH_REL_L2 (forward) and GRAD_REL_L2 (gradients); the
    limits are shown to reject three planted faults each run;
10. train entry: ``frameino_tpu_torch.train.main`` at full width, 2
    blocks, 49 frames at 480x832 from a synthetic dataset in build/: 3
    steps and a checkpoint, then a rerun that resumes and takes one more
    step; exactly 8 K6 forward and 4 backward launches per step;
11. train: the full-width, full-depth Wan2.2-TI2V-5B-motion trainer (bf16
    parameters and Adam moments, remat), 3 steps through the same
    functions, exactly 120 forward and 60 backward K6 launches per step;
12. train reference: a small bf16 train step on the card against fp32 on
    the CPU (loss and every gradient).

Each serving or training phase sets the launch counts to 0 just before
its requests or steps and reads them just after. The line before the
last is one JSON object with each kernel's launches on its path, error,
times and bound; the last line is {"ok": true, "device": {...}}. The
full summary, with each request's and step's seconds and peak memory,
goes to build/chip_smoke.json.
"""

import base64
import contextlib
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    "flash_fwd_static": dict(
        label="K1", route="cuda", source="frameino_tpu_torch/csrc/flash_fwd.cu",
        replaces="frameino_tpu/ops/attention.py:120"),
    "qk_norm_rope": dict(
        label="K2", route="triton",
        source="frameino_tpu_torch/ops/qk_norm_rope_triton.py",
        replaces="frameino_tpu/ops/attention.py:420"),
    "flash_fwd": dict(
        label="K3", route="cuda", source="frameino_tpu_torch/csrc/flash_fwd.cu",
        replaces="frameino_tpu/ops/attention.py:70"),
    "qk_ln_rope": dict(
        label="K4", route="triton",
        source="frameino_tpu_torch/ops/qk_ln_rope_triton.py",
        replaces="frameino_tpu/ops/attention.py:704"),
    # K1 again, at head_dim 64 on the CogVideoX path
    "flash_fwd_static_d64": dict(
        label="K1", route="cuda", source="frameino_tpu_torch/csrc/flash_fwd.cu",
        replaces="frameino_tpu/ops/attention.py:120"),
    # K6, the training path's attention: JAX's bundled Pallas flash
    # forward + backward, called at :927
    "flash_attn_train_fwd": dict(
        label="K6", route="cuda",
        source="frameino_tpu_torch/csrc/flash_attn_train.cu",
        replaces="frameino_tpu/ops/attention.py:893"),
    "flash_attn_train_bwd": dict(
        label="K6", route="cuda",
        source="frameino_tpu_torch/csrc/flash_attn_train.cu",
        replaces="frameino_tpu/ops/attention.py:893"),
}
NO_TRAIN = {"flash_attn_train_fwd": 0, "flash_attn_train_bwd": 0}
# launches per denoise step of the 30-block Wan DiT at CFG batch 2
PER_STEP = {"flash_fwd_static": 30, "qk_norm_rope": 60, "flash_fwd": 30,
            "qk_ln_rope": 0, **NO_TRAIN}
# ... and of the 42-block CogVideoX DiT at CFG batch 2
PER_STEP_COG = {"flash_fwd_static": 42, "qk_norm_rope": 0, "flash_fwd": 0,
                "qk_ln_rope": 84, **NO_TRAIN}
# launches per train step of an n-block Wan DiT with remat, at B = 1: each
# block's self- and cross-attention run forward, again when the block is
# recomputed in the backward, and backward once
NO_SERVE = {"flash_fwd_static": 0, "qk_norm_rope": 0, "flash_fwd": 0,
            "qk_ln_rope": 0}


def per_train_step(blocks):
    return {**NO_SERVE, "flash_attn_train_fwd": 4 * blocks,
            "flash_attn_train_bwd": 2 * blocks}


# H100 SXM data-sheet peaks (the bound of every kernel below)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the serving shape of bench.py: 49 frames at 480x832 -> latents 13x30x52,
# plus one ID frame, patch 2x2: (13 + 1) * 15 * 26 = 5,460 tokens
B, H, S, D, L_TEXT = 2, 24, 5460, 128, 512
# CogVideoX-5B at its sample shape, 49 frames at 480x720 -> latents
# 13x60x90 plus the ID frame, patch 2x2, after 226 text tokens:
# 226 + 14 * 30 * 45 = 19,126 tokens
COG_H, COG_D, COG_L_TEXT, COG_GRID = 48, 64, 226, (13, 30, 45)
COG_S = COG_L_TEXT + (COG_GRID[0] + 1) * COG_GRID[1] * COG_GRID[2]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, iters):
    """Mean CUDA-event milliseconds of fn over iters launches (warmed)."""
    import torch
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


def bf16_ulp(x):
    import torch
    return torch.exp2(torch.floor(torch.log2(torch.clamp(x.abs(),
                                                         min=2.0 ** -126)))
                      - 7)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(f"device: {name} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(smi[0])
    return name, smi[0]


def phase_build():
    """nvcc of both CUDA sources (one process each, all at once) on a
    thread while the Triton producers compile here."""
    import torch
    from frameino_tpu_torch.ops import attention as A
    errors = []

    def nvcc():
        try:
            A.build_cuda_libs()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t0 = time.time()
    th = threading.Thread(target=nvcc)
    th.start()
    x = torch.randn(1, 4, 2 * D, device="cuda", dtype=torch.bfloat16)
    A.qk_norm_rope(x, torch.ones(2 * D, device="cuda"),
                   torch.ones(4, D // 2, device="cuda"),
                   torch.zeros(4, D // 2, device="cuda"), 2, 1e-6)
    A.qk_ln_rope(x, torch.ones(D // 4, device="cuda"),
                 torch.zeros(D // 4, device="cuda"),
                 torch.ones(4, D // 8, device="cuda"),
                 torch.zeros(4, D // 8, device="cuda"), 8, 1e-6)
    torch.cuda.synchronize()
    t_triton = time.time() - t0
    th.join()
    check(not errors, f"nvcc: {errors[0] if errors else ''}")
    print(f"build: nvcc flash_fwd.cu + flash_attn_train.cu and triton "
          f"qk_norm_rope + qk_ln_rope {time.time() - t0:.1f} s (triton "
          f"{t_triton:.1f} s)")
    for src, log in A.BUILD_LOG.items():
        print(src + ":\n" + "\n".join(
            line for line in log.splitlines()
            if "registers" in line or "spill" in line))


def bound_ms(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    """The least time the card could take: (ms, "operations" | "bytes")."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def attn_bound(bh, sq, skv, d, passes=4, extra_bytes=0):
    """Bound of softmax attention over [bh, sq|skv, d] bf16: ``passes``
    flops per (q, k, d) triple (4 forward: QK^T and PV; 10 backward),
    q/o and k/v read or written once each, plus ``extra_bytes``."""
    return bound_ms(passes * bh * sq * skv * d,
                    2 * 2 * bh * d * (sq + skv) + extra_bytes)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _report(results, name, err, rel, ms, plain_ms, bound, library_ms,
            **extra):
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=library_ms, **extra)
    lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
    print(f"{KERNELS[name]['label']} {name}: max_abs {err:.3e} "
          f"max_rel {rel:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
          f"bound {bound[0]:.3f} ms ({bound[1]})  library {lib}"
          + "".join(f"  {k} {v:.4g}" for k, v in extra.items()))


def _check_ulp(label, got, ref):
    """Every element within one bf16 ulp (of either side); returns the
    max abs and max relative difference."""
    import torch
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    over = int((diff > torch.maximum(bf16_ulp(got), bf16_ulp(ref))).sum())
    check(over == 0, f"{label} differs from its plain version by more than "
                     f"one bf16 ulp at {over} elements (max abs "
                     f"{diff.max().item():.3e})")
    return diff.max().item(), (diff / ref.abs().clamp(min=1e-6)).max().item()


# Relative L2 limit of a flash kernel against its plain version. The
# outputs average thousands of keys (std ~1e-2 at S = 19,126), so the
# elementwise atol alone is larger than most outputs; this limit is what
# rejects a dropped ragged key tile or a bf16 P.V accumulator (PERF.md).
FLASH_REL_L2 = 5e-3


def _check_close(label, out, want):
    """atol 2e-2 + rtol 2e-2 elementwise, FLASH_REL_L2 in relative L2,
    finite; returns max abs, max rel and relative L2."""
    import torch
    out, want = out.float(), want.float()
    d = (out - want).abs()
    check(bool(torch.all(d <= 2e-2 + 2e-2 * want.abs())),
          f"{label} differs from its plain version beyond atol 2e-2 / "
          f"rtol 2e-2 (max abs {d.max().item():.3e})")
    rel_l2 = (d.norm() / want.norm()).item()
    check(rel_l2 <= FLASH_REL_L2,
          f"{label} differs from its plain version by {rel_l2:.3e} relative "
          f"L2 (limit {FLASH_REL_L2:g})")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    return (d.max().item(), (d / want.abs().clamp(min=1e-6)).max().item(),
            rel_l2)


def _sdpa(scale):
    """The library yardstick: one scaled_dot_product_attention call on
    [BH, S, D] inputs (timed only; the port never calls it)."""
    import torch.nn.functional as F
    return lambda q, k, v: F.scaled_dot_product_attention(
        q[None], k[None], v[None], scale=scale)[0]


def phase_kernels():
    """Each kernel vs its plain version at the Wan slice's shapes."""
    import torch
    from frameino_tpu_torch.ops import attention as A
    from frameino_tpu_torch.ops.rope import wan_rope_table
    g = torch.Generator("cuda").manual_seed(1234)
    dev = "cuda"
    results = {}

    # K2 on the raw to_q / to_k outputs [B, S, H*D]; the tables of the
    # 14 x 15 x 26 token grid, q's carrying softmax scale * log2(e)
    q_raw, k_raw = (torch.randn(B, S, H * D, device=dev, dtype=torch.bfloat16,
                                generator=g) for _ in range(2))
    w_q, w_k = (1 + 0.1 * torch.randn(H * D, device=dev, generator=g)
                for _ in range(2))
    cos_np, sin_np = wan_rope_table(D, 14, 15, 26)
    cos = torch.from_numpy(cos_np).to(dev)
    sin = torch.from_numpy(sin_np).to(dev)
    gain = D ** -0.5 * A.LOG2E
    cq, sq = (cos * gain).contiguous(), (sin * gain).contiguous()
    out = A.qk_norm_rope(q_raw, w_q, cq, sq, H, 1e-6)
    err, rel = _check_ulp("K2", out,
                          A.qk_norm_rope_ref(q_raw, w_q, cq, sq, H, 1e-6))
    # ~12 fp32 operations per output element (square-sum, scale, rotate)
    _report(results, "qk_norm_rope", err, rel,
            cuda_ms(lambda: A.qk_norm_rope(q_raw, w_q, cq, sq, H, 1e-6), 20),
            cuda_ms(lambda: A.qk_norm_rope_ref(q_raw, w_q, cq, sq, H, 1e-6),
                    5),
            bound_ms(12 * out.numel(), _nbytes(q_raw, w_q, cq, sq, out),
                     PEAK_FP32_FLOPS), None)
    del out

    def compare(name, kernel, plain, library, bound):
        err, rel, rel_l2 = _check_close(name, kernel(), plain())
        _report(results, name, err, rel, cuda_ms(kernel, 10),
                cuda_ms(plain, 3), bound, cuda_ms(library, 10),
                rel_l2=rel_l2)

    # K1: self-attention over the normed, roped q/k (unit-scale rows); the
    # exp2 softmax of pre-scaled q is SDPA's softmax at scale ln 2
    qh = A.qk_norm_rope_ref(q_raw, w_q, cq, sq, H, 1e-6)
    kh = A.qk_norm_rope_ref(k_raw, w_k, cos, sin, H, 1e-6)
    vh = torch.randn(B * H, S, D, device=dev, dtype=torch.bfloat16,
                     generator=g)
    bound = A._rowmax_norm(qh) * A._rowmax_norm(kh)
    compare("flash_fwd_static", lambda: A.flash_fwd_static(qh, kh, vh, bound),
            lambda: A.flash_fwd_static_ref(qh, kh, vh, bound),
            lambda: _sdpa(math.log(2))(qh, kh, vh), attn_bound(B * H, S, S, D))
    del qh, kh, vh, q_raw, k_raw

    # K3: cross-attention of the RMS-normed video q to 512 text tokens
    def normed(n):
        x = torch.randn(B * H, n, D, device=dev, dtype=torch.float32,
                        generator=g)
        return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))
                ).to(torch.bfloat16)

    q, k = normed(S), normed(L_TEXT)
    v = torch.randn(B * H, L_TEXT, D, device=dev, dtype=torch.bfloat16,
                    generator=g)
    c = D ** -0.5 * A.LOG2E
    compare("flash_fwd", lambda: A.flash_fwd(q, k, v, c),
            lambda: A.flash_fwd_ref(q, k, v, c),
            lambda: _sdpa(D ** -0.5)(q, k, v),
            attn_bound(B * H, S, L_TEXT, D))
    del q, k, v
    torch.cuda.empty_cache()
    return results


def phase_kernels_cog():
    """K4 and K1 at head_dim 64 vs their plain versions at the CogVideoX-5B
    shapes: raw q/k [2, 19126, 3072] with a 226-row text prefix whose RoPE
    rows are identity (q's tables times softmax scale * log2(e))."""
    import torch
    from frameino_tpu_torch.ops import attention as A
    from frameino_tpu_torch.ops.rope import cogvideox_rope_table
    g = torch.Generator("cuda").manual_seed(4321)
    dev = "cuda"
    Hc, Dc, Sc = COG_H, COG_D, COG_S
    results = {}
    raw_q, raw_k = (torch.randn(B, Sc, Hc * Dc, device=dev,
                                dtype=torch.bfloat16, generator=g)
                    for _ in range(2))
    w_q, b_q, w_k, b_k = (s + 0.1 * torch.randn(Dc, device=dev, generator=g)
                          for s in (1.0, 0.0, 1.0, 0.0))
    cos_np, sin_np = cogvideox_rope_table(Dc, *COG_GRID,
                                          duplicate_first_frame_for_id=True)
    half = Dc // 2
    cos = torch.cat([torch.ones(COG_L_TEXT, half),
                     torch.from_numpy(cos_np)]).to(dev)
    sin = torch.cat([torch.zeros(COG_L_TEXT, half),
                     torch.from_numpy(sin_np)]).to(dev)
    gain = Dc ** -0.5 * A.LOG2E
    cq, sq = (cos * gain).contiguous(), (sin * gain).contiguous()
    out_q = A.qk_ln_rope(raw_q, w_q, b_q, cq, sq, Hc, 1e-6)
    err_q, rel_q = _check_ulp("K4 (q)", out_q,
                              A.qk_ln_rope_ref(raw_q, w_q, b_q, cq, sq, Hc,
                                               1e-6))
    err_k, rel_k = _check_ulp("K4 (k)", A.qk_ln_rope(raw_k, w_k, b_k, cos,
                                                     sin, Hc, 1e-6),
                              A.qk_ln_rope_ref(raw_k, w_k, b_k, cos, sin, Hc,
                                               1e-6))
    # ~14 fp32 operations per output element (moments, normalize, rotate)
    _report(results, "qk_ln_rope", max(err_q, err_k), max(rel_q, rel_k),
            cuda_ms(lambda: A.qk_ln_rope(raw_q, w_q, b_q, cq, sq, Hc, 1e-6),
                    20),
            cuda_ms(lambda: A.qk_ln_rope_ref(raw_q, w_q, b_q, cq, sq, Hc,
                                             1e-6), 3),
            bound_ms(14 * out_q.numel(),
                     _nbytes(raw_q, w_q, b_q, cq, sq, out_q),
                     PEAK_FP32_FLOPS), None)
    del out_q

    # K1 at [96, 19126, 64]; the plain version's [rows, S, S] fp32 logits
    # only fit for a few rows, so both are compared and timed on 4 rows
    qh = A.qk_ln_rope_ref(raw_q, w_q, b_q, cq, sq, Hc, 1e-6)
    kh = A.qk_ln_rope_ref(raw_k, w_k, b_k, cos, sin, Hc, 1e-6)
    del raw_q, raw_k
    vh = torch.randn(B * Hc, Sc, Dc, device=dev, dtype=torch.bfloat16,
                     generator=g)
    bound = A._rowmax_norm(qh) * A._rowmax_norm(kh)
    rows = torch.tensor([0, 31, 64, 95], device=dev)
    qs, ks, vs = (t[rows].contiguous() for t in (qh, kh, vh))

    def kernel():
        return A.flash_fwd_static(qs, ks, vs, bound)

    def plain():
        return A.flash_fwd_static_ref(qs, ks, vs, bound)

    err, rel, rel_l2 = _check_close("K1 (D=64)", kernel(), plain())
    all_out = A.flash_fwd_static(qh, kh, vh, bound)
    check(bool(torch.isfinite(all_out).all()), "K1 (D=64): non-finite "
                                               "output on the 96 rows")
    check(bool(torch.equal(all_out[rows], kernel())),
          "K1 (D=64): the 4-row launch differs from the same rows of the "
          "96-row launch")
    del all_out
    _report(results, "flash_fwd_static_d64", err, rel, cuda_ms(kernel, 10),
            cuda_ms(plain, 2), attn_bound(4, Sc, Sc, Dc),
            cuda_ms(lambda: _sdpa(math.log(2))(qs, ks, vs), 10),
            rel_l2=rel_l2,
            ms_96_rows=cuda_ms(lambda: A.flash_fwd_static(qh, kh, vh, bound),
                               5),
            bound_ms_96_rows=attn_bound(B * Hc, Sc, Sc, Dc)[0])
    del qh, kh, vh, qs, ks, vs
    torch.cuda.empty_cache()
    return results


# Relative L2 limit of K6's dQ, dK and dV against the plain version's fp32
# autograd. The kernel reads ~2.4e-3 (bf16 P and dS in the products, bf16
# outputs); each run also shows that three planted faults exceed it: the
# D_i term dropped, the ragged key tile's dK/dV dropped, and dK without
# its softmax scale (PERF.md).
GRAD_REL_L2 = 1e-2


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _planted_faults(q, k, v, do, ref_grads, scale):
    """Relative L2 of three faulty backward passes against the reference
    gradients, computed in fp32 from the same inputs ([BH, S, D])."""
    import torch
    q, k, v, do = (t.float() for t in (q, k, v, do))
    p = torch.softmax(q @ k.transpose(1, 2) * scale, dim=-1)
    dp = do @ v.transpose(1, 2)
    di = (do * (p @ v)).sum(-1, keepdim=True)
    dq_ref, dk_ref, dv_ref = ref_grads
    ds_no_di = p * dp
    del dp
    out = {"no_D_i": max(_rel_l2(scale * ds_no_di @ k, dq_ref),
                         _rel_l2(scale * ds_no_di.transpose(1, 2) @ q,
                                 dk_ref))}
    del ds_no_di
    tail = k.shape[1] // 64 * 64
    if tail < k.shape[1]:
        dk_cut, dv_cut = dk_ref.clone(), dv_ref.clone()
        dk_cut[:, tail:] = 0
        dv_cut[:, tail:] = 0
        out["no_ragged_tile"] = min(_rel_l2(dk_cut, dk_ref),
                                    _rel_l2(dv_cut, dv_ref))
    out["dK_unscaled"] = _rel_l2(dk_ref / scale, dk_ref)
    del p, di
    return out


def phase_kernels_train():
    """K6 forward and backward against the plain version's fp32 autograd
    at the Wan training shapes (B = 1, 24 heads of 128: self-attention
    over 5,460 tokens, cross-attention to 512 text tokens) and at a
    ragged head_dim-64 shape; the planted faults must fail the limit."""
    import torch
    from frameino_tpu_torch.ops import attention as A
    g = torch.Generator("cuda").manual_seed(777)
    results, shapes = {}, {}
    for tag, (bh, sq, skv, d) in (("self", (H, S, S, D)),
                                  ("cross", (H, S, L_TEXT, D)),
                                  ("ragged_d64", (6, 1111, 1111, 64))):
        q, do = (torch.randn(bh, sq, d, device="cuda", dtype=torch.bfloat16,
                             generator=g) for _ in range(2))
        k, v = (torch.randn(bh, skv, d, device="cuda", dtype=torch.bfloat16,
                            generator=g) for _ in range(2))
        scale = d ** -0.5
        o, lse = A.flash_attn_train_fwd(q, k, v, scale)
        grads = A.flash_attn_train_bwd(q, k, v, o, lse, do, scale)
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        o_ref = A.flash_attention_train_ref(*(t[None] for t in leaves),
                                            scale)[0]
        ref = torch.autograd.grad(o_ref, leaves, do.float(),
                                  retain_graph=True)
        err, rel, rel_o = _check_close(f"K6 forward ({tag})", o,
                                       o_ref.detach())
        lse_err = (lse - torch.logsumexp(
            leaves[0].detach() @ leaves[1].detach().transpose(1, 2) * scale,
            -1)).abs().max().item()
        check(lse_err <= 1e-3, f"K6 forward ({tag}): lse off by {lse_err}")
        rel_g = {n: _rel_l2(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                     grads, ref)}
        check(all(torch.isfinite(t).all() for t in grads),
              f"K6 backward ({tag}): non-finite gradient")
        check(max(rel_g.values()) <= GRAD_REL_L2,
              f"K6 backward ({tag}): relative L2 {rel_g} over the limit "
              f"{GRAD_REL_L2:g}")
        faults = _planted_faults(q, k, v, do, ref, scale)
        check(min(faults.values()) > GRAD_REL_L2,
              f"K6 ({tag}): a planted fault passes the gradient limit "
              f"{GRAD_REL_L2:g}: {faults}")
        grad_err = max((a.float() - b).abs().max().item()
                       for a, b in zip(grads, ref))
        row = dict(fwd_err=err, fwd_rel=rel, fwd_rel_l2=rel_o,
                   bwd_err=grad_err, bwd_rel_l2=rel_g, faults=faults,
                   lse_max_abs=lse_err,
                   fwd_ms=cuda_ms(lambda: A.flash_attn_train_fwd(
                       q, k, v, scale), 10),
                   bwd_ms=cuda_ms(lambda: A.flash_attn_train_bwd(
                       q, k, v, o, lse, do, scale), 10),
                   fwd_plain_ms=cuda_ms(lambda: A.flash_attention_train_ref(
                       *(t[None] for t in leaves), scale), 3),
                   bwd_plain_ms=cuda_ms(lambda: torch.autograd.grad(
                       o_ref, leaves, do.float(), retain_graph=True), 3),
                   fwd_bound=attn_bound(bh, sq, skv, d, 4, 4 * bh * sq),
                   bwd_bound=attn_bound(bh, sq, skv, d, 10,
                                        2 * 2 * bh * d * (sq + skv)
                                        + 4 * bh * sq))
        del o_ref, ref, leaves
        # the library yardstick: SDPA's forward, and its backward alone
        lq, lk, lv = (t[None].detach().requires_grad_() for t in (q, k, v))
        lo = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)
        row["fwd_library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv), 10)
        row["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do[None], retain_graph=True), 10)
        del lo, lq, lk, lv
        shapes[tag] = row
        print(f"K6 {tag} [{bh}, {sq}|{skv}, {d}]: forward {row['fwd_ms']:.3f}"
              f" ms (plain {row['fwd_plain_ms']:.3f}, SDPA "
              f"{row['fwd_library_ms']:.3f}, bound {row['fwd_bound'][0]:.3f})"
              f" rel L2 {rel_o:.3e}; backward {row['bwd_ms']:.3f} ms (plain "
              f"{row['bwd_plain_ms']:.3f}, SDPA {row['bwd_library_ms']:.3f}, "
              f"bound {row['bwd_bound'][0]:.3f}) rel L2 "
              + ", ".join(f"{n} {x:.3e}" for n, x in rel_g.items())
              + " | planted faults " + ", ".join(
                  f"{n} {x:.3e}" for n, x in faults.items()))
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    me, cr = shapes["self"], shapes["cross"]
    for name, dirn in (("flash_attn_train_fwd", "fwd"),
                       ("flash_attn_train_bwd", "bwd")):
        err = me["fwd_err"] if dirn == "fwd" else me["bwd_err"]
        results[name] = dict(
            max_abs_err=err, ms=me[f"{dirn}_ms"],
            plain_ms=me[f"{dirn}_plain_ms"],
            bound_ms=me[f"{dirn}_bound"][0], bound_by=me[f"{dirn}_bound"][1],
            library_ms=me[f"{dirn}_library_ms"],
            cross_ms=cr[f"{dirn}_ms"], cross_plain_ms=cr[f"{dirn}_plain_ms"],
            cross_bound_ms=cr[f"{dirn}_bound"][0],
            cross_library_ms=cr[f"{dirn}_library_ms"])
    return results, shapes


def _b64_png(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _b64_npy(arr):
    import numpy as np
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode()


def make_request(rng, height, width, frames, steps, text_dim, with_id,
                 text_len=L_TEXT):
    import numpy as np
    img = rng.integers(0, 255, (height, width, 3), dtype=np.uint8)
    req = {"image_b64": _b64_png(img),
           "prompt_embeds_b64": _b64_npy(rng.standard_normal(
               (text_len, text_dim)).astype(np.float32)),
           "trajectories": [[[0.2 * width, 0.3 * height],
                             [0.7 * width, 0.6 * height]],
                            [[0.8 * width, 0.2 * height],
                             [0.4 * width, 0.8 * height]]],
           "height": height, "width": width, "num_frames": frames,
           "num_inference_steps": steps, "guidance_scale": 5.0, "seed": 0}
    if with_id:
        req["id_image_b64"] = _b64_png(img[: height // 3, : width // 3]
                                       .copy())
    return req


def post(port, req, timeout=900):
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(req).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def read_mp4(path):
    """[F, H, W, 3] uint8 frames of an mp4."""
    import cv2
    import numpy as np
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        ok, frame = cap.read()
        while ok:
            frames.append(frame)
            ok, frame = cap.read()
    finally:
        cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)


def serve_requests(port, requests, per_step=None):
    """POST each (tag, request); check status, frames, size, the decoded
    mp4 and, with ``per_step``, the kernel launches of each request."""
    import numpy as np
    import torch
    from frameino_tpu_torch.ops import attention as A
    cuda = torch.cuda.is_available()
    rows = []
    for tag, req in requests:
        before = A.launch_counts()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        status, out = post(port, req)
        seconds = time.time() - t0
        check(status == 200, f"request {tag}: HTTP {status}: "
                             f"{out.get('error')}")
        F, Hh, Ww = req["num_frames"], req["height"], req["width"]
        check((out["num_frames"], out["height"], out["width"]) == (F, Hh, Ww),
              f"request {tag}: got {out['num_frames']}x{out['height']}x"
              f"{out['width']}, asked {F}x{Hh}x{Ww}")
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"chip_smoke_{os.getpid()}_{tag}.mp4")
        with open(path, "wb") as f:
            f.write(base64.b64decode(out["video_b64"]))
        try:
            frames = read_mp4(path)
        finally:
            os.remove(path)
        check(frames.shape == (F, Hh, Ww, 3),
              f"request {tag}: mp4 decodes to {frames.shape}")
        launches = {k: v - before[k] for k, v in A.launch_counts().items()}
        if per_step is not None:
            want = {k: n * req["num_inference_steps"]
                    for k, n in per_step.items()}
            check(launches == want, f"request {tag}: kernel launches "
                                    f"{launches}, expected {want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
        row = dict(request=tag, shape=f"{Hh}x{Ww}x{F}",
                   steps=req["num_inference_steps"],
                   id_image="id_image_b64" in req, seconds=seconds,
                   peak_gib=peak, bucket=out["bucket"], launches=launches,
                   frames_mean=float(np.mean(frames)))
        print(f"request {tag}: {row['shape']} steps={row['steps']} "
              f"id={row['id_image']} {seconds:.2f} s, peak "
              f"{peak:.2f} GiB, launches {launches}")
        rows.append(row)
    return rows


SERVE = {
    # family: (label, per-step launches, text tokens, requests as
    # (tag, height, width, frames, steps, with ID image))
    "wan": ("Wan2.2-TI2V-5B-motion", PER_STEP, L_TEXT,
            [("a", 480, 832, 49, 4, True), ("b", 256, 448, 17, 2, True),
             ("c", 256, 448, 17, 2, False)]),
    # (d): the x32 canvas rule serves 480x720 at 480x736, 226 + 14*30*46
    # = 19,546 tokens; (e): a patch grid below the 30x45 sample grid, so
    # the position-table resize downsamples
    "cogvideox": ("CogVideoX-5B-I2V-FrameINO", PER_STEP_COG, COG_L_TEXT,
                  [("d", 480, 720, 49, 2, True),
                   ("e", 256, 448, 17, 2, False)]),
}


def phase_serve(family):
    import numpy as np
    import torch
    from frameino_tpu_torch import serve
    from frameino_tpu_torch.app.server import PipelineServer
    from frameino_tpu_torch.ops import attention as A
    label, per_step, text_len, specs = SERVE[family]
    t0 = time.time()
    pipe = serve.build_pipeline(smoke=False, random_init=True, family=family)
    torch.cuda.synchronize()
    print(f"serve: {label} pipeline, seeded random weights, "
          f"{time.time() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB resident")
    # the x32 canvas rule only (480x832 stays 480x832: 5,460 Wan tokens)
    server = PipelineServer(pipe, bucket_grid=32)
    httpd, port = server.start_background()
    try:
        rng = np.random.default_rng(0)
        text_dim = (pipe.dit_cfg.text_dim if family == "wan"
                    else pipe.dit_cfg.text_embed_dim)
        requests = [(tag, make_request(rng, h, w, f, steps, text_dim, idi,
                                       text_len))
                    for tag, h, w, f, steps, idi in specs]
        A.reset_launch_counts()
        rows = serve_requests(port, requests, per_step)
        totals = A.launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
    if family == "cogvideox":
        check(rows[0]["bucket"] == [49, 480, 736],
              f"request d: bucket {rows[0]['bucket']}, expected "
              f"[49, 480, 736]")
    for kname, n in per_step.items():
        if n:
            check(totals[kname] > 0, f"kernel {kname} was not launched on "
                                     f"the {family} serving path")
    del pipe, server, httpd
    gc.collect()
    torch.cuda.empty_cache()
    return rows, totals


def _load(cls, cfg, sd, device, dtype=None):
    import torch
    m = cls(cfg, device="meta", dtype=dtype)
    m.load_state_dict({k: v.to(device, dtype or v.dtype)
                       for k, v in sd.items()}, assign=True)
    return m.eval()


def _randn_args(rs):
    import numpy as np
    import torch

    def arr(*shape, tanh=True):
        a = rs.randn(*shape)
        return torch.from_numpy((np.tanh(a) if tanh else a)
                                .astype(np.float32))
    return arr


def _hold_against_cpu(label, fp32, cpu16, card, args):
    """bf16 arithmetic alone already moves the result: the CPU's own bf16
    run is measured against the fp32 reference, and the card may be off by
    at most twice that (relative L2 over the latents)."""
    import torch
    want = fp32(**args)

    def rel_l2(x):
        return ((x - want).norm() / want.norm()).item()

    got = card(**args).cpu()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite latents")
    err_card, err_cpu16 = rel_l2(got), rel_l2(cpu16(**args))
    print(f"{label}: small pipeline vs fp32 CPU, relative L2: card bf16 "
          f"{err_card:.3e}, CPU bf16 {err_cpu16:.3e} (limit 2x the CPU's); "
          f"card max_abs {(got - want).abs().max().item():.3e}")
    check(err_card <= 2 * err_cpu16,
          f"{label}: card error {err_card:.3e} exceeds twice the CPU "
          f"bf16 error {err_cpu16:.3e}")
    return err_card


def phase_reference():
    """A small Wan pipeline (head_dim 128, so the kernels run) in bf16 on
    the card, held against the same weights in fp32 on the CPU's plain
    path."""
    import numpy as np
    import torch
    from frameino_tpu_torch.models import wan_dit, wan_vae
    from frameino_tpu_torch.pipelines.wan_i2v import WanImageToVideoPipeline
    from frameino_tpu_torch.serve import smoke_configs
    _, vae_cfg = smoke_configs()
    dit_cfg = wan_dit.tiny_config(num_attention_heads=2,
                                  attention_head_dim=128, ffn_dim=512,
                                  text_dim=64, in_channels=8,
                                  out_channels=4)
    gen = torch.Generator().manual_seed(5)
    dit16 = wan_dit.init_wan_dit(dit_cfg, gen, dtype=torch.bfloat16)
    vae = wan_vae.init_wan_vae(vae_cfg, gen)
    sd16 = dit16.state_dict()
    fp32 = WanImageToVideoPipeline(
        _load(wan_dit.WanDiT, dit_cfg, sd16, "cpu", torch.float32), vae)
    cpu16 = WanImageToVideoPipeline(dit16, vae)
    card = WanImageToVideoPipeline(
        _load(wan_dit.WanDiT, dit_cfg, sd16, "cuda"),
        _load(wan_vae.WanVAE, vae_cfg, vae.state_dict(), "cuda"))
    arr = _randn_args(np.random.RandomState(0))
    Hs, Ws, Fs = 32, 48, 9
    args = dict(image=arr(1, 3, Hs, Ws), prompt_embeds=arr(1, 16, 64,
                                                           tanh=False),
                traj_tensor=arr(1, 3, Fs, Hs, Ws),
                id_tensor=arr(1, 3, 1, Hs, Ws),
                latents=arr(1, 4, 5, Hs // 2, Ws // 2, tanh=False),
                height=Hs, width=Ws, num_frames=Fs, num_inference_steps=3,
                guidance_scale=5.0, output_type="latent")
    return _hold_against_cpu("reference", fp32, cpu16, card, args)


def phase_reference_cog():
    """A small CogVideoX FrameINO pipeline (2 blocks at head_dim 64, so K4
    and K1 run) in bf16 on the card against the same weights in fp32 on
    the CPU's plain path; the VAE is fp32 on both sides. The encoder's
    logvar bias is driven to -100 (std 3e-7 after the -30 clip), so the
    two sides' different posterior noise does not count."""
    import numpy as np
    import torch
    from frameino_tpu_torch.models import cogvideox_dit, cogvideox_vae
    from frameino_tpu_torch.ops import attention as A
    from frameino_tpu_torch.pipelines.cogvideox_i2v import \
        CogVideoXImageToVideoPipeline as Pipe
    vae_cfg = cogvideox_vae.tiny_vae_config()
    dit_cfg = cogvideox_dit.tiny_config(attention_head_dim=64,
                                        text_embed_dim=64, use_frame_in=True)
    gen = torch.Generator().manual_seed(6)
    dit16 = cogvideox_dit.init_cogvideox_dit(dit_cfg, gen,
                                             dtype=torch.bfloat16)
    vae = cogvideox_vae.init_cogvideox_vae(vae_cfg, gen)
    with torch.no_grad():
        vae.encoder.conv_out.conv.bias[vae_cfg.latent_channels:] = -100.0
    sd16 = dit16.state_dict()
    fp32 = Pipe(_load(cogvideox_dit.CogVideoXDiT, dit_cfg, sd16, "cpu",
                      torch.float32), vae)
    cpu16 = Pipe(dit16, vae)
    card = Pipe(_load(cogvideox_dit.CogVideoXDiT, dit_cfg, sd16, "cuda"),
                _load(cogvideox_vae.CogVideoXVAE, vae_cfg, vae.state_dict(),
                      "cuda"))
    arr = _randn_args(np.random.RandomState(1))
    # 9 frames -> 3 latent frames + the ID frame; 32x48 -> an 8x12 latent,
    # a 4x6 patch grid against the 4x4 sample grid
    Hs, Ws, Fs = 32, 48, 9
    args = dict(image=arr(1, 3, Hs, Ws), prompt_embeds=arr(1, 8, 64,
                                                           tanh=False),
                traj_tensor=arr(1, 3, Fs, Hs, Ws), id_tensor=arr(1, 3, Hs, Ws),
                latents=arr(1, 3, 4, Hs // 4, Ws // 4, tanh=False),
                height=Hs, width=Ws, num_frames=Fs, num_inference_steps=3,
                guidance_scale=6.0, output_type="latent")
    A.reset_launch_counts()
    err = _hold_against_cpu("reference CogVideoX", fp32, cpu16, card, args)
    counts = A.launch_counts()
    check(counts["qk_ln_rope"] == 3 * 2 * 2
          and counts["flash_fwd_static"] == 3 * 2,
          f"reference CogVideoX: launches {counts}, expected K4 12 and "
          f"K1 6 over 3 steps of 2 blocks")
    return err


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# the reference's train shape on one card (scripts/bench_train.py:63-66):
# 49 frames at 480x832, B = 1, plus one ID frame -> 14 * 15 * 26 = 5,460
# DiT tokens, 512 text tokens
TRAIN_H, TRAIN_W, TRAIN_F = 480, 832, 49


def _train_dataset():
    """A synthetic dataset in build/: a 49-frame 480x832 mp4, an ID crop
    and two CSV rows (the layout of tests/test_train_cli.py)."""
    from frameino_tpu_torch.data.fixture import write_fixture_dataset
    root = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    return root, write_fixture_dataset(root, TRAIN_H, TRAIN_W, TRAIN_F)


def _train_config(data, out, steps):
    return {"experiment_name": "chip_smoke", "download_folder_path": data,
            "train_csv_relative_path": "csvs",
            "train_video_relative_path": "videos",
            "train_ID_relative_path": "ids",
            "target_height": TRAIN_H, "target_width": TRAIN_W,
            "sample_accelerate_factor": 1,
            "train_frame_num_range": [TRAIN_F, TRAIN_F],
            "min_train_frame_num": TRAIN_F, "dot_radius": 7,
            "drop_FrameIn_prob": 0.0, "max_train_steps": steps,
            "train_batch_size": 1, "checkpointing_steps": 1000,
            "checkpoints_total_limit": 1, "gradient_checkpointing": True,
            "learning_rate": 1e-4, "lr_warmup_steps": 1,
            "resume_from_checkpoint": "latest", "output_folder": out,
            "max_text_seq_length": L_TEXT, "first_iter_validation": False,
            "validation_step": 0, "seed": 0}


def _timed_steps(rows, per_step):
    """Wrap trainer.train_step (as the entry point imports it) so that each
    step is timed, its launches counted from 0 and checked, and one weight
    of block 0 watched."""
    import torch
    from frameino_tpu_torch.ops import attention as A
    from frameino_tpu_torch.training import trainer
    orig = trainer.train_step

    def step(state, *args, **kw):
        watched = state.model.blocks[0].attn1.to_q.weight
        before = watched.detach().clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        t0 = time.time()
        metrics = orig(state, *args, **kw)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        counts = A.launch_counts()
        row = dict(step=state.step, seconds=seconds,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   loss=float(metrics["loss"]),
                   grad_norm=float(metrics["grad_norm"]), launches=counts,
                   weight_changed=not torch.equal(before, watched))
        rows.append(row)
        print(f"train step {row['step']}: {seconds:.3f} s, peak "
              f"{row['peak_gib']:.2f} GiB, loss {row['loss']:.5f}, "
              f"grad_norm {row['grad_norm']:.4f}, K6 "
              f"{counts['flash_attn_train_fwd']}/"
              f"{counts['flash_attn_train_bwd']}")
        check(counts == per_step, f"train step {row['step']}: launches "
                                  f"{counts}, expected {per_step}")
        check(math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])
              and row["grad_norm"] > 0,
              f"train step {row['step']}: loss {row['loss']} grad_norm "
              f"{row['grad_norm']}")
        return metrics

    return orig, step


def phase_train_entry(data):
    """``frameino_tpu_torch.train.main`` in this process at full width and
    2 blocks: 3 steps and a checkpoint, then a rerun that resumes and
    takes one more step."""
    import dataclasses
    import torch
    from frameino_tpu_torch import train
    from frameino_tpu_torch.models import wan_dit
    from frameino_tpu_torch.training import trainer
    cfg = dataclasses.replace(wan_dit.WAN22_TI2V_5B_MOTION, num_layers=2)
    out = os.path.join(REPO, "build", "chip_smoke_train", "ckpts")
    cfg_path = os.path.join(REPO, "build", "chip_smoke_train", "train.yaml")
    rows = []
    orig, step = _timed_steps(rows, per_train_step(2))
    trainer.train_step = step
    runs = []
    try:
        for steps in (3, 4):
            # JSON text: valid YAML for the JAX CLI and the port alike
            with open(cfg_path, "w") as f:
                json.dump(_train_config(data, out, steps), f)
            buf = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                summary = train.main(["--config_path", cfg_path], dit_cfg=cfg)
            print(buf.getvalue(), end="")
            runs.append(dict(summary, seconds=time.time() - t0,
                             said_resumed="resumed from" in buf.getvalue()))
    finally:
        trainer.train_step = orig
    first, rerun = runs
    check(first["step"] == 3 and first["resumed_from"] is None
          and len(rows) == 4,
          f"train entry: first run {first['step']} steps, resumed from "
          f"{first['resumed_from']}, {len(rows)} steps timed")
    check(rerun["said_resumed"] and rerun["resumed_from"].endswith(
        "checkpoint-3") and rerun["step"] == 4,
          f"train entry: the rerun did not resume from checkpoint-3 and "
          f"take one step ({rerun['resumed_from']}, step {rerun['step']})")
    check(not rows[0]["weight_changed"],
          "train entry: a weight moved on step 1, where the warmup lr is 0")
    check(rows[1]["weight_changed"],
          "train entry: the weight did not move on step 2")
    shutil.rmtree(out, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": rows, "run_seconds": [r["seconds"] for r in runs]}


def _profile_step(state, vae, tcfg, batch):
    """One more full-depth step, its phases timed apart (synchronized) and
    its device time by kind from torch.profiler; written to
    build/train_profile.json."""
    import torch
    from torch.autograd import DeviceType
    from frameino_tpu_torch.training import trainer
    from frameino_tpu_torch.training.optim import global_norm

    def kind(name):
        n = name.lower()
        if "attn_fwd_kernel" in n or "attn_bwd_" in n:
            return "K6"
        if any(w in n for w in ("conv", "fprop", "dgrad", "wgrad", "cudnn")):
            return "convolution"
        if any(w in n for w in ("gemm", "xmma", "nvjet", "cutlass")):
            return "GEMM"
        if "memcpy" in n or "memset" in n:
            return "copy"
        return "elementwise, reductions"

    phases = {}
    model = state.model
    params = state.params()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_all = t0 = time.time()
        enc = trainer.encode_training_batch(vae, batch)
        torch.cuda.synchronize()
        phases["vae_encode"] = time.time() - t0
        t0 = time.time()
        gen = trainer.step_generator(0, state.step, "cuda")
        loss = trainer.wan_fm_loss(model, tcfg, *enc, batch["prompt_embeds"],
                                   gen)
        torch.cuda.synchronize()
        phases["forward"] = time.time() - t0
        t0 = time.time()
        loss.backward()
        torch.cuda.synchronize()
        phases["backward"] = time.time() - t0
        t0 = time.time()
        grads = {n: p.grad for n, p in params.items()}
        global_norm(grads.values())
        state.optimizer.step(params, grads)
        torch.cuda.synchronize()
        phases["optimizer"] = time.time() - t0
        wall = time.time() - t_all
    for p in params.values():
        p.grad = None
    by_kind = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            k = kind(e.key)
            by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
    busy = sum(by_kind.values()) / 1e3
    out = {"wall_s": wall, "phases_s": phases, "device_ms_by_kind": by_kind,
           "device_busy_s": busy, "idle_share": 1 - busy / wall}
    with open(os.path.join(REPO, "build", "train_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("train profile: " + json.dumps(out))
    return out


def phase_train(data, profile):
    """The full-width, full-depth trainer (bf16 parameters, gradients and
    Adam moments, fp32 VAE, remat): 3 steps through the functions the
    entry point calls, on the entry point's dataset."""
    import numpy as np
    import torch
    from frameino_tpu_torch.data.frameino_dataset import (
        FrameINODataset, FrameINODatasetConfig)
    from frameino_tpu_torch.models import wan_dit, wan_vae
    from frameino_tpu_torch.serve import configure_cuda_numerics
    from frameino_tpu_torch.train import collate
    from frameino_tpu_torch.training import trainer
    from frameino_tpu_torch.training.optim import OptimizerConfig
    configure_cuda_numerics()
    ds = FrameINODataset(
        FrameINODatasetConfig(target_height=TRAIN_H, target_width=TRAIN_W,
                              sample_accelerate_factor=1,
                              train_frame_num_range=(TRAIN_F, TRAIN_F),
                              min_train_frame_num=TRAIN_F,
                              drop_FrameIn_prob=0.0),
        data, "csvs", "videos", "ids", seed=0)
    rs = np.random.RandomState(0)
    text = rs.standard_normal((1, L_TEXT, 4096)).astype(np.float32)
    batch = collate([ds[0]], lambda prompts: torch.from_numpy(text))
    t0 = time.time()
    gen = torch.Generator("cuda").manual_seed(0)
    model = wan_dit.init_wan_dit(wan_dit.WAN22_TI2V_5B_MOTION, gen,
                                 dtype=torch.bfloat16)
    vae = wan_vae.init_wan_vae(wan_vae.WAN22_VAE_CONFIG, gen)
    vae.requires_grad_(False)
    state = trainer.init_train_state(model, OptimizerConfig())
    tcfg = trainer.TrainerConfig(compute_dtype=torch.bfloat16, remat=True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    resident = torch.cuda.memory_allocated() / 2 ** 30
    print(f"train: Wan2.2-TI2V-5B-motion, {n_params / 1e9:.3f} B bf16 "
          f"parameters and Adam moments, {resident:.2f} GiB resident, built "
          f"in {time.time() - t0:.1f} s")
    rows = []
    _, step = _timed_steps(rows, per_train_step(wan_dit.WAN22_TI2V_5B_MOTION
                                                .num_layers))
    for _ in range(3):
        step(state, vae, tcfg, batch, 0)
    prof = _profile_step(state, vae, tcfg, batch) if profile else None
    del state, model, vae, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": rows, "resident_gib": resident, "params": n_params,
            "profile": prof}


def phase_train_reference():
    """One train step's loss and gradients of a small DiT (2 blocks at
    head_dim 128, so K6 runs) in bf16 on the card, held against the same
    weights in fp32 on the CPU's plain path, with the same draws; the
    CPU's own bf16 run says how far bf16 alone moves them."""
    import numpy as np
    import torch
    from frameino_tpu_torch.models import wan_dit
    from frameino_tpu_torch.ops import attention as A
    from frameino_tpu_torch.training.trainer import TrainerConfig, wan_fm_loss
    cfg = wan_dit.tiny_config(num_attention_heads=2, attention_head_dim=128,
                              ffn_dim=512, text_dim=64, in_channels=8,
                              out_channels=4)
    m16 = wan_dit.init_wan_dit(cfg, torch.Generator().manual_seed(7),
                               dtype=torch.bfloat16)
    sd16 = m16.state_dict()
    models = {"fp32": _load(wan_dit.WanDiT, cfg, sd16, "cpu", torch.float32),
              "cpu16": m16,
              "card": _load(wan_dit.WanDiT, cfg, sd16, "cuda")}
    rs = np.random.RandomState(3)

    def arr(*shape):
        return torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    lat = (arr(1, 4, 5, 8, 12), arr(1, 4, 1, 8, 12), arr(1, 4, 5, 8, 12),
           arr(1, 4, 1, 8, 12))
    text, noise = arr(1, 16, 64), arr(1, 4, 5, 8, 12)
    idx = torch.tensor([412])
    got = {}
    for tag, m in models.items():
        dev = "cuda" if tag == "card" else "cpu"
        dtype = torch.float32 if tag == "fp32" else torch.bfloat16
        m.train()
        params = dict(m.named_parameters())
        A.reset_launch_counts()
        loss = wan_fm_loss(m, TrainerConfig(compute_dtype=dtype,
                                            remat=tag == "card"),
                           *(t.to(dev) for t in lat), text.to(dev), idx=idx,
                           noise=noise)
        grads = torch.autograd.grad(loss, list(params.values()))
        got[tag] = (loss.item(), {n: g.float().cpu()
                                  for n, g in zip(params, grads)})
        if tag == "card":
            counts = A.launch_counts()
    check(counts == per_train_step(2), f"train reference: launches {counts}, "
                                       f"expected {per_train_step(2)}")
    loss32, g32 = got["fp32"]

    def rel(gs):
        num = sum(float((gs[n] - g32[n]).norm() ** 2) for n in g32)
        return math.sqrt(num / sum(float(g.norm() ** 2)
                                   for g in g32.values()))

    def per_param(gs):
        return {n: float((gs[n] - g).norm() / g.norm().clamp(min=1e-30))
                for n, g in g32.items()}
    err = {tag: dict(loss=abs(got[tag][0] - loss32) / abs(loss32),
                     grads=rel(got[tag][1]), params=per_param(got[tag][1]))
           for tag in ("card", "cpu16")}
    for e in err.values():
        e["worst"] = max((x, n) for n, x in e["params"].items())
    print(f"train reference: vs fp32 CPU, card bf16 loss "
          f"{err['card']['loss']:.3e} "
          f"grads {err['card']['grads']:.3e} (worst {err['card']['worst']}); "
          f"CPU bf16 loss {err['cpu16']['loss']:.3e} grads "
          f"{err['cpu16']['grads']:.3e} (worst {err['cpu16']['worst']})")
    check(err["card"]["grads"] <= 2 * err["cpu16"]["grads"],
          f"train reference: card gradient error {err['card']['grads']:.3e} "
          f"exceeds twice the CPU bf16 error {err['cpu16']['grads']:.3e}")
    check(err["card"]["loss"] <= 2 * err["cpu16"]["loss"] + 1e-3,
          f"train reference: card loss error {err['card']['loss']:.3e} "
          f"exceeds twice the CPU bf16 error {err['cpu16']['loss']:.3e} "
          f"+ 1e-3")
    # per parameter the same, with 2e-2 of slack for the few whose
    # gradients are near zero (the k biases: a softmax row does not see a
    # shift common to all its logits)
    over = {n: (x, err["cpu16"]["params"][n])
            for n, x in err["card"]["params"].items()
            if x > 2 * err["cpu16"]["params"][n] + 2e-2}
    check(not over, f"train reference: card gradient error over twice the "
                    f"CPU bf16 error + 2e-2 for {over}")
    check(all(math.isfinite(g.sum()) for g in got["card"][1].values()),
          "train reference: non-finite gradient on the card")
    return err


def main():
    import torch
    profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        import frameino_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"frameino_tpu_torch is not importable from {REPO}: {e}")

    t_start = time.time()
    name, _ = phase_device()
    phase_build()
    kernel_results = phase_kernels()
    rows, totals = phase_serve("wan")
    ref_err = phase_reference()
    kernel_results.update(phase_kernels_cog())
    rows_cog, totals_cog = phase_serve("cogvideox")
    ref_err_cog = phase_reference_cog()
    k6_results, k6_shapes = phase_kernels_train()
    kernel_results.update(k6_results)
    _, data = _train_dataset()
    entry = phase_train_entry(data)
    train = phase_train(data, profile)
    train_ref = phase_train_reference()

    # each kernel's launches on its path (K1 twice: Wan at head_dim 128,
    # CogVideoX at 64; K6 over the 3 full-depth train steps)
    steps = train["steps"]
    launches = dict(totals, qk_ln_rope=totals_cog["qk_ln_rope"],
                    flash_fwd_static_d64=totals_cog["flash_fwd_static"],
                    **{k: sum(r["launches"][k] for r in steps)
                       for k in NO_TRAIN})
    summary = {"kernels": [
        dict(name=k, route=KERNELS[k]["route"], source=KERNELS[k]["source"],
             replaces=KERNELS[k]["replaces"], launches=launches[k],
             **kernel_results[k])
        for k in KERNELS],
        "requests": rows + rows_cog, "reference_rel_l2": ref_err,
        "reference_cog_rel_l2": ref_err_cog, "k6_shapes": k6_shapes,
        "train_entry": entry, "train": train, "train_reference": train_ref,
        "seconds": time.time() - t_start}
    out_dir = os.path.join(REPO, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"chip_smoke: all phases passed in {summary['seconds']:.1f} s")
    print(json.dumps({"kernels": summary["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
