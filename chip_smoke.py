#!/usr/bin/env python3
"""Smoke run of the PyTorch port (frameino_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure exits non-zero; there is no CPU path):
 1. device: the card's name and `nvidia-smi` name, power limit;
 2. build: compile the CUDA flash kernels (nvcc, sm_90a) and the Triton
    qk-norm/RoPE kernel from the sources in the checkout;
 3. kernels: each kernel against its plain PyTorch version at the shapes
    the serving path gives it (Wan2.2-TI2V-5B, 49 frames at 480x832: CFG
    batch 2, 24 heads of 128, 5,460 tokens, 512 text tokens), with CUDA
    event times of both;
 4. serve: the full-width Wan2.2-TI2V-5B-motion pipeline with seeded
    random weights behind the HTTP server; three POST /generate requests;
    each must return 200 with the requested frames and size, and must
    launch the kernels exactly 30 (K1), 60 (K2) and 30 (K3) times per
    denoise step;
 5. reference: a small pipeline (2 blocks at head_dim 128) in bf16 on
    the card against the same weights in fp32 on the CPU's plain path.

The line before the last is one JSON object with each kernel's launches
in phase 4, error, and times; the last line is
{"ok": true, "device": {...}}. The full summary, with each request's
seconds and peak memory, goes to build/chip_smoke.json.
"""

import base64
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
}
# launches per denoise step of the 30-block DiT at CFG batch 2
PER_STEP = {"flash_fwd_static": 30, "qk_norm_rope": 60, "flash_fwd": 30}

# the serving shape of bench.py: 49 frames at 480x832 -> latents 13x30x52,
# plus one ID frame, patch 2x2: (13 + 1) * 15 * 26 = 5,460 tokens
B, H, S, D, L_TEXT = 2, 24, 5460, 128, 512


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
    print(f"build: nvcc flash_fwd.cu {t_nvcc:.1f} s, triton "
          f"qk_norm_rope {t_triton:.1f} s")
    print("\n".join(line for line in A.BUILD_LOG.splitlines()
                    if "registers" in line or "spill" in line))


def phase_kernels():
    """Each kernel vs its plain version at the slice's shapes."""
    import torch
    from frameino_tpu_torch.ops import attention as A
    from frameino_tpu_torch.ops.rope import wan_rope_table
    g = torch.Generator("cuda").manual_seed(1234)
    dev = "cuda"
    results = {}

    def report(name, err, rel, ms, plain_ms):
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(f"{KERNELS[name]['label']} {name}: max_abs {err:.3e} "
              f"max_rel {rel:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} "
              f"ms")

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
    got = A.qk_norm_rope(q_raw, w_q, cq, sq, H, 1e-6).float()
    ref = A.qk_norm_rope_ref(q_raw, w_q, cq, sq, H, 1e-6).float()
    diff = (got - ref).abs()
    over = int((diff > torch.maximum(bf16_ulp(got), bf16_ulp(ref))).sum())
    check(over == 0, f"K2 differs from its plain version by more than one "
                     f"bf16 ulp at {over} elements (max abs "
                     f"{diff.max().item():.3e})")
    report("qk_norm_rope", diff.max().item(),
           (diff / ref.abs().clamp(min=1e-6)).max().item(),
           cuda_ms(lambda: A.qk_norm_rope(q_raw, w_q, cq, sq, H, 1e-6), 20),
           cuda_ms(lambda: A.qk_norm_rope_ref(q_raw, w_q, cq, sq, H, 1e-6),
                   5))
    del got, ref, diff

    def compare(name, kernel, plain):
        out, want = kernel().float(), plain().float()
        d = (out - want).abs()
        check(bool(torch.all(d <= 2e-2 + 2e-2 * want.abs())),
              f"{name} differs from its plain version beyond atol 2e-2 / "
              f"rtol 2e-2 (max abs {d.max().item():.3e})")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err, rel = d.max().item(), (d / want.abs().clamp(min=1e-6)).max()
        del out, want, d
        report(name, err, rel.item(), cuda_ms(kernel, 10),
               cuda_ms(plain, 3))

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


def phase_serve():
    import numpy as np
    import torch
    from frameino_tpu_torch import serve
    from frameino_tpu_torch.app.server import PipelineServer
    from frameino_tpu_torch.ops import attention as A
    t0 = time.time()
    pipe = serve.build_pipeline(smoke=False, random_init=True)
    torch.cuda.synchronize()
    print(f"serve: Wan2.2-TI2V-5B-motion pipeline, seeded random weights, "
          f"{time.time() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB resident")
    # the x32 canvas rule only: 480x832 stays 480x832 (5,460 tokens)
    server = PipelineServer(pipe, bucket_grid=32)
    httpd, port = server.start_background()
    try:
        rng = np.random.default_rng(0)
        text_dim = pipe.dit_cfg.text_dim
        requests = [
            ("a", make_request(rng, 480, 832, 49, 4, text_dim, True)),
            ("b", make_request(rng, 256, 448, 17, 2, text_dim, True)),
            ("c", make_request(rng, 256, 448, 17, 2, text_dim, False)),
        ]
        A.reset_launch_counts()
        rows = serve_requests(port, requests, PER_STEP)
        totals = A.launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
    del pipe, server
    torch.cuda.empty_cache()
    return rows, totals


def phase_reference():
    """A small pipeline (head_dim 128, so the kernels run) in bf16 on the
    card, held against the same weights in fp32 on the CPU's plain path.
    bf16 arithmetic alone already moves the result: the CPU's own bf16 run
    is measured against the same fp32 reference, and the card may be off
    by at most twice that (relative L2 over the latents)."""
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

    def load(cls, cfg, sd, device, dtype=None):
        m = cls(cfg, device="meta", dtype=dtype)
        m.load_state_dict({k: v.to(device, dtype or v.dtype)
                           for k, v in sd.items()}, assign=True)
        return m.eval()

    sd16 = dit16.state_dict()
    fp32 = WanImageToVideoPipeline(
        load(wan_dit.WanDiT, dit_cfg, sd16, "cpu", torch.float32), vae)
    cpu16 = WanImageToVideoPipeline(dit16, vae)
    card = WanImageToVideoPipeline(
        load(wan_dit.WanDiT, dit_cfg, sd16, "cuda"),
        load(wan_vae.WanVAE, vae_cfg, vae.state_dict(), "cuda"))
    rs = np.random.RandomState(0)
    Hs, Ws, Fs = 32, 48, 9

    def arr(*shape, tanh=True):
        a = rs.randn(*shape)
        return torch.from_numpy((np.tanh(a) if tanh else a)
                                .astype(np.float32))

    args = dict(image=arr(1, 3, Hs, Ws), prompt_embeds=arr(1, 16, 64,
                                                           tanh=False),
                traj_tensor=arr(1, 3, Fs, Hs, Ws),
                id_tensor=arr(1, 3, 1, Hs, Ws),
                latents=arr(1, 4, 5, Hs // 2, Ws // 2, tanh=False),
                height=Hs, width=Ws, num_frames=Fs, num_inference_steps=3,
                guidance_scale=5.0, output_type="latent")
    want = fp32(**args)

    def rel_l2(x):
        return ((x - want).norm() / want.norm()).item()

    got = card(**args).cpu()
    check(bool(torch.isfinite(got).all()), "reference: non-finite latents")
    err_card, err_cpu16 = rel_l2(got), rel_l2(cpu16(**args))
    print(f"reference: small pipeline vs fp32 CPU, relative L2: card bf16 "
          f"{err_card:.3e}, CPU bf16 {err_cpu16:.3e} (limit 2x the CPU's); "
          f"card max_abs {(got - want).abs().max().item():.3e}")
    check(err_card <= 2 * err_cpu16,
          f"reference: card error {err_card:.3e} exceeds twice the CPU "
          f"bf16 error {err_cpu16:.3e}")
    return err_card


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
    rows, totals = phase_serve()
    for kname, n in totals.items():
        check(n > 0, f"kernel {kname} was not launched on the main path")
    ref_err = phase_reference()

    summary = {"kernels": [
        dict(name=k, route=KERNELS[k]["route"], source=KERNELS[k]["source"],
             replaces=KERNELS[k]["replaces"], launches=totals[k],
             **kernel_results[k])
        for k in KERNELS],
        "requests": rows, "reference_rel_l2": ref_err}
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
