#!/usr/bin/env python3
"""Smoke run of the PyTorch port (frameino_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure exits non-zero; there is no CPU path):
 1. device: the card's name and `nvidia-smi` name, power limit;
 2. build: compile the CUDA flash kernels (nvcc, sm_90a) and the two
    Triton producers (qk-norm/RoPE, qk-LayerNorm/RoPE) from the sources in
    the checkout;
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
    bf16 on the card against fp32 on the CPU.

Each serving phase sets the launch counts to 0 just before its requests
and reads them just after. The line before the last is one JSON object
with each kernel's launches on its serving path, error, and times; the
last line is {"ok": true, "device": {...}}. The full summary, with each
request's seconds and peak memory, goes to build/chip_smoke.json.
"""

import base64
import gc
import io
import json
import os
import subprocess
import sys
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
}
# launches per denoise step of the 30-block Wan DiT at CFG batch 2
PER_STEP = {"flash_fwd_static": 30, "qk_norm_rope": 60, "flash_fwd": 30,
            "qk_ln_rope": 0}
# ... and of the 42-block CogVideoX DiT at CFG batch 2
PER_STEP_COG = {"flash_fwd_static": 42, "qk_norm_rope": 0, "flash_fwd": 0,
                "qk_ln_rope": 84}

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
    import torch
    from frameino_tpu_torch.ops import attention as A
    t0 = time.time()
    A.build_flash_lib()
    t_nvcc = time.time() - t0
    x = torch.randn(1, 4, 2 * D, device="cuda", dtype=torch.bfloat16)
    t0 = time.time()
    A.qk_norm_rope(x, torch.ones(2 * D, device="cuda"),
                   torch.ones(4, D // 2, device="cuda"),
                   torch.zeros(4, D // 2, device="cuda"), 2, 1e-6)
    torch.cuda.synchronize()
    t_triton = time.time() - t0
    t0 = time.time()
    A.qk_ln_rope(x, torch.ones(D // 4, device="cuda"),
                 torch.zeros(D // 4, device="cuda"),
                 torch.ones(4, D // 8, device="cuda"),
                 torch.zeros(4, D // 8, device="cuda"), 8, 1e-6)
    torch.cuda.synchronize()
    t_triton_ln = time.time() - t0
    print(f"build: nvcc flash_fwd.cu {t_nvcc:.1f} s, triton "
          f"qk_norm_rope {t_triton:.1f} s, triton qk_ln_rope "
          f"{t_triton_ln:.1f} s")
    print("\n".join(line for line in A.BUILD_LOG.splitlines()
                    if "registers" in line or "spill" in line))


def _report(results, name, err, rel, ms, plain_ms, **extra):
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **extra)
    print(f"{KERNELS[name]['label']} {name}: max_abs {err:.3e} "
          f"max_rel {rel:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
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
    err, rel = _check_ulp("K2", A.qk_norm_rope(q_raw, w_q, cq, sq, H, 1e-6),
                          A.qk_norm_rope_ref(q_raw, w_q, cq, sq, H, 1e-6))
    _report(results, "qk_norm_rope", err, rel,
            cuda_ms(lambda: A.qk_norm_rope(q_raw, w_q, cq, sq, H, 1e-6), 20),
            cuda_ms(lambda: A.qk_norm_rope_ref(q_raw, w_q, cq, sq, H, 1e-6),
                    5))

    def compare(name, kernel, plain):
        err, rel, rel_l2 = _check_close(name, kernel(), plain())
        _report(results, name, err, rel, cuda_ms(kernel, 10),
                cuda_ms(plain, 3), rel_l2=rel_l2)

    # K1: self-attention over the normed, roped q/k (unit-scale rows)
    qh = A.qk_norm_rope_ref(q_raw, w_q, cq, sq, H, 1e-6)
    kh = A.qk_norm_rope_ref(k_raw, w_k, cos, sin, H, 1e-6)
    vh = torch.randn(B * H, S, D, device=dev, dtype=torch.bfloat16,
                     generator=g)
    bound = A._rowmax_norm(qh) * A._rowmax_norm(kh)
    compare("flash_fwd_static", lambda: A.flash_fwd_static(qh, kh, vh, bound),
            lambda: A.flash_fwd_static_ref(qh, kh, vh, bound))
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
            lambda: A.flash_fwd_ref(q, k, v, c))
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
    err_q, rel_q = _check_ulp("K4 (q)", A.qk_ln_rope(raw_q, w_q, b_q, cq, sq,
                                                     Hc, 1e-6),
                              A.qk_ln_rope_ref(raw_q, w_q, b_q, cq, sq, Hc,
                                               1e-6))
    err_k, rel_k = _check_ulp("K4 (k)", A.qk_ln_rope(raw_k, w_k, b_k, cos,
                                                     sin, Hc, 1e-6),
                              A.qk_ln_rope_ref(raw_k, w_k, b_k, cos, sin, Hc,
                                               1e-6))
    _report(results, "qk_ln_rope", max(err_q, err_k), max(rel_q, rel_k),
            cuda_ms(lambda: A.qk_ln_rope(raw_q, w_q, b_q, cq, sq, Hc, 1e-6),
                    20),
            cuda_ms(lambda: A.qk_ln_rope_ref(raw_q, w_q, b_q, cq, sq, Hc,
                                             1e-6), 3))

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
            cuda_ms(plain, 2), rel_l2=rel_l2,
            ms_96_rows=cuda_ms(lambda: A.flash_fwd_static(qh, kh, vh, bound),
                               5))
    del qh, kh, vh, qs, ks, vs
    torch.cuda.empty_cache()
    return results


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


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        import frameino_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"frameino_tpu_torch is not importable from {REPO}: {e}")

    name, _ = phase_device()
    phase_build()
    kernel_results = phase_kernels()
    rows, totals = phase_serve("wan")
    ref_err = phase_reference()
    kernel_results.update(phase_kernels_cog())
    rows_cog, totals_cog = phase_serve("cogvideox")
    ref_err_cog = phase_reference_cog()

    # each kernel's launches on its serving path (K1 twice: Wan at
    # head_dim 128, CogVideoX at 64)
    launches = dict(totals, qk_ln_rope=totals_cog["qk_ln_rope"],
                    flash_fwd_static_d64=totals_cog["flash_fwd_static"])
    summary = {"kernels": [
        dict(name=k, route=KERNELS[k]["route"], source=KERNELS[k]["source"],
             replaces=KERNELS[k]["replaces"], launches=launches[k],
             **kernel_results[k])
        for k in KERNELS],
        "requests": rows + rows_cog, "reference_rel_l2": ref_err,
        "reference_cog_rel_l2": ref_err_cog}
    out_dir = os.path.join(REPO, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"kernels": summary["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
