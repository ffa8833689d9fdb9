"""Serving entry point of the PyTorch port: build a FrameINO pipeline
(Wan2.2 or CogVideoX) and start the HTTP API (counterpart of
``scripts/serve.py``).

    python -m frameino_tpu_torch.serve --transformer <dir> --vae <dir> \\
        [--text_encoder <dir>] [--family wan|cogvideox] [--quantize int8] \\
        [--warmup HxWxF[:steps],... [--warmup_only]]      # CUDA
    python -m frameino_tpu_torch.serve --smoke                # tiny, CPU
    python -m frameino_tpu_torch.serve --random_init          # 5B, CUDA
    python -m frameino_tpu_torch.serve --family cogvideox --smoke

``--transformer`` and ``--vae`` are diffusers checkpoint directories
(config.json + safetensors, ``models/pretrained.py``); the DiT serves in
bf16, the Wan VAE in fp32 and the CogVideoX VAE in bf16.
``--text_encoder`` is the UMT5 (Wan) or T5 (CogVideoX) directory of the
same release: requests may then carry a ``prompt`` string, tokenized by
``transformers.AutoTokenizer`` from that directory (``transformers`` must
be installed; without it send ``prompt_embeds_b64``, or build the text
encoder with a tokenizer of your own, ``build_text_encoder_fn``).
``--warmup`` serves one synthetic request a shape before binding the port
(the CUDA libraries load and cuDNN picks its convolution algorithms);
``--warmup_only`` then prints one ``WARMSTART_JSON: {...}`` line of
per-shape seconds and exits.

``--random_init`` serves the family's 5B FrameINO model at full width with
weights drawn from seed 0 (outputs are noise, for latency and memory
measurement); ``--smoke`` the tiny models on the CPU. ``--quantize int8``
serves the DiT's block matmuls as int8 w8a8 (either family).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import time

import torch

# the Wan recipe's prompt length (reference pipeline :226-243)
WAN_TEXT_LEN = 512


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--smoke", action="store_true",
                      help="tiny random models on the CPU")
    mode.add_argument("--random_init", action="store_true",
                      help="the family's full-width 5B FrameINO model with "
                           "seeded random weights on CUDA (outputs are "
                           "noise)")
    p.add_argument("--transformer", default=None,
                   help="DiT checkpoint directory (diffusers layout)")
    p.add_argument("--vae", default=None,
                   help="VAE checkpoint directory (diffusers layout)")
    p.add_argument("--family", choices=["wan", "cogvideox"], default="wan")
    p.add_argument("--text_encoder", default=None,
                   help="UMT5 / T5 encoder directory with its tokenizer "
                        "files (needs transformers for the tokenizer)")
    p.add_argument("--quantize", choices=["int8"], default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu for --smoke)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8188)
    p.add_argument("--bucket_grid", type=int, default=64,
                   help="round request H/W up to this grid (multiple of "
                        "32); 0 keeps the x32 canvas rule only")
    p.add_argument("--frame_grid", type=int, default=None,
                   help="optional frame-count lattice (multiple of the VAE "
                        "temporal ratio)")
    p.add_argument("--warmup", default=None,
                   help="comma-separated HxWxF[:steps] shapes to serve once "
                        "before binding the port, e.g. "
                        "'480x832x81,704x1280x81:50'")
    p.add_argument("--warmup_only", action="store_true",
                   help="exit after --warmup, printing one "
                        "'WARMSTART_JSON: {...}' line of per-shape "
                        "first-request seconds")
    return p.parse_args(argv)


def smoke_configs():
    """The tiny Wan configs the CPU smoke server and tests use."""
    from frameino_tpu_torch.models import wan_dit, wan_vae
    vae_cfg = wan_vae.WanVAEConfig(
        base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
        temperal_downsample=(True,), is_residual=False,
        scale_factor_temporal=2, scale_factor_spatial=2,
        latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4)
    dit_cfg = wan_dit.tiny_config(in_channels=8, out_channels=4)
    return dit_cfg, vae_cfg


def configure_cuda_numerics():
    """The port's numerics on CUDA, set explicitly rather than inherited:
    fp32 matmuls in full fp32 (no TF32), bf16 GEMMs reduce in fp32, and
    cuDNN convolutions of the fp32 Wan VAE in TF32, PyTorch's default
    (the bf16 CogVideoX VAE's accumulate in fp32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = True


def _serving_device(device) -> torch.device:
    """``device`` (default CUDA); CUDA must be there when asked for."""
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("serving runs on CUDA; no CUDA device is "
                               "available (pass device='cpu' to ask for the "
                               "CPU)")
        configure_cuda_numerics()
    return device


def _auto_tokenizer(path: str):
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError(
            f"--text_encoder needs a tokenizer: install transformers (it "
            f"reads the tokenizer files of {path}), or pass tokenizer= to "
            f"build_text_encoder_fn, or send prompt_embeds_b64 instead of "
            f"a prompt") from e
    return AutoTokenizer.from_pretrained(path)


def make_text_encoder_fn(model, tokenizer, max_length: int = WAN_TEXT_LEN):
    """prompts -> [B, max_length, d_model] fp32 embeddings from the T5 /
    UMT5 ``model``: tokenized to ``max_length`` with padding and
    truncation, encoded on the model's device, zero-filled past each
    prompt (``t5_encoder.encode_and_mask``). ``tokenizer`` is called as
    transformers' tokenizers are and returns numpy ``input_ids`` and
    ``attention_mask``."""
    from frameino_tpu_torch.models import t5_encoder
    device = model.shared.weight.device

    def text_fn(prompts):
        tok = tokenizer(list(prompts), padding="max_length",
                        max_length=max_length, truncation=True,
                        return_tensors="np")
        ids = torch.as_tensor(tok["input_ids"]).to(device)
        mask = torch.as_tensor(tok["attention_mask"]).to(device)
        return t5_encoder.encode_and_mask(model, ids, mask,
                                          max_sequence_length=max_length
                                          ).float()
    text_fn.model = model
    return text_fn


def build_text_encoder_fn(path: str, tokenizer=None, device=None,
                          max_length: int = WAN_TEXT_LEN):
    """``make_text_encoder_fn`` on the UMT5 / T5 encoder of the checkpoint
    directory ``path`` (bf16 on CUDA, fp32 on the CPU); without a
    ``tokenizer``, ``transformers.AutoTokenizer`` reads ``path``."""
    from frameino_tpu_torch.models import pretrained, t5_encoder
    device = _serving_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    _, model = pretrained.from_pretrained(path, device=device, dtype=dtype)
    if not isinstance(model, t5_encoder.T5Encoder):
        raise ValueError(f"{path} holds a {type(model).__name__}, not a "
                         f"T5 / UMT5 encoder")
    if tokenizer is None:
        tokenizer = _auto_tokenizer(path)
    return make_text_encoder_fn(model, tokenizer, max_length)


def _random_models(family, smoke, device, dit_dtype):
    gen = torch.Generator(device).manual_seed(0)
    if family == "cogvideox":
        from frameino_tpu_torch.models import cogvideox_dit, cogvideox_vae
        if smoke:
            dit_cfg = cogvideox_dit.tiny_config()
            vae_cfg = cogvideox_vae.tiny_vae_config()
        else:
            dit_cfg = cogvideox_dit.COGVIDEOX_5B_I2V_FRAMEINO
            vae_cfg = cogvideox_vae.COGVIDEOX_VAE_CONFIG
        dit = cogvideox_dit.init_cogvideox_dit(dit_cfg, gen, dtype=dit_dtype)
        # the VAE in the DiT's dtype, as the JAX server keeps it for this
        # family (bf16 at full width)
        return dit, cogvideox_vae.init_cogvideox_vae(vae_cfg, gen,
                                                     dtype=dit_dtype)
    from frameino_tpu_torch.models import wan_dit, wan_vae
    if smoke:
        dit_cfg, vae_cfg = smoke_configs()
    else:
        dit_cfg = wan_dit.WAN22_TI2V_5B_MOTION
        vae_cfg = wan_vae.WAN22_VAE_CONFIG
    return (wan_dit.init_wan_dit(dit_cfg, gen, dtype=dit_dtype),
            wan_vae.init_wan_vae(vae_cfg, gen))


def _checkpoint_models(family, transformer, vae, device, dit_dtype):
    from frameino_tpu_torch.models import pretrained
    from frameino_tpu_torch.models.cogvideox_dit import CogVideoXDiT
    from frameino_tpu_torch.models.cogvideox_vae import CogVideoXVAE
    from frameino_tpu_torch.models.wan_dit import WanDiT
    from frameino_tpu_torch.models.wan_vae import WanVAE
    want = {"wan": (WanDiT, WanVAE, torch.float32),
            "cogvideox": (CogVideoXDiT, CogVideoXVAE, dit_dtype)}[family]
    _, dit = pretrained.from_pretrained(transformer, device=device,
                                        dtype=dit_dtype)
    _, vae_m = pretrained.from_pretrained(vae, device=device, dtype=want[2])
    for m, cls, path in ((dit, want[0], transformer), (vae_m, want[1], vae)):
        if not isinstance(m, cls):
            raise ValueError(f"{path} holds a {type(m).__name__}; the "
                             f"{family} pipeline needs a {cls.__name__}")
    return dit, vae_m


def build_pipeline(*, smoke: bool = False, random_init: bool = False,
                   family: str = "wan", transformer: str = None,
                   vae: str = None, text_encoder: str = None,
                   tokenizer=None, quantize=None, device=None):
    """The port's FrameINO pipeline of ``family``: from the checkpoint
    directories ``transformer`` and ``vae``, or with random weights from
    seed 0 (``smoke``: the tiny models; ``random_init``: full width), its
    DiT quantized when ``quantize="int8"``. ``text_encoder``: a UMT5 / T5
    directory whose encoder becomes the pipeline's ``text_encoder_fn``
    (``build_text_encoder_fn``, with ``tokenizer``). ``device``: CUDA
    unless asked otherwise, the CPU for ``smoke``; the DiT runs in bf16
    on CUDA and fp32 on the CPU."""
    if family not in ("wan", "cogvideox"):
        raise ValueError(f"family must be 'wan' or 'cogvideox', got "
                         f"{family!r}")
    from_dirs = transformer is not None or vae is not None
    if smoke + random_init + from_dirs != 1:
        raise ValueError("serve from checkpoints (--transformer and --vae), "
                         "or with random weights (--smoke or --random_init): "
                         "exactly one of them")
    if from_dirs and (transformer is None or vae is None):
        raise ValueError("checkpoint serving needs both --transformer and "
                         "--vae")
    device = torch.device("cpu") if smoke and device is None \
        else _serving_device(device)
    dit_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if from_dirs:
        dit, vae_m = _checkpoint_models(family, transformer, vae, device,
                                        dit_dtype)
    else:
        dit, vae_m = _random_models(family, smoke, device, dit_dtype)
    text_fn = None
    if text_encoder:
        text_fn = build_text_encoder_fn(
            text_encoder, tokenizer, device,
            max_length=(dit.cfg.max_text_seq_length if family == "cogvideox"
                        else WAN_TEXT_LEN))
    if family == "cogvideox":
        from frameino_tpu_torch.pipelines.cogvideox_i2v import (
            CogPipelineConfig, CogVideoXImageToVideoPipeline)
        return CogVideoXImageToVideoPipeline(
            dit, vae_m, CogPipelineConfig(), text_encoder_fn=text_fn,
            quantize=quantize)
    from frameino_tpu_torch.pipelines.wan_i2v import (WanImageToVideoPipeline,
                                                      WanPipelineConfig)
    return WanImageToVideoPipeline(dit, vae_m, WanPipelineConfig(),
                                   text_encoder_fn=text_fn,
                                   quantize=quantize)


def _warmup_request(server, h: int, w: int, f: int, steps: int) -> dict:
    """A synthetic request at one shape, as the JAX entry's warm-up sends:
    a black canvas, a trajectory (the FrameINO DiTs take trajectory latents
    on channels) and, without a text encoder, zero prompt embeddings."""
    import numpy as np
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(buf, format="PNG")
    req = {"image_b64": base64.b64encode(buf.getvalue()).decode(),
           "height": h, "width": w, "num_frames": f,
           "num_inference_steps": steps,
           "trajectories": [[(w * 0.3, h * 0.3), (w * 0.7, h * 0.6)]]}
    if server.text_encoder_fn is None:
        cfg = server.pipeline.dit_cfg
        dim = getattr(cfg, "text_dim", None) or cfg.text_embed_dim
        length = getattr(cfg, "max_text_seq_length", 8)
        ebuf = io.BytesIO()
        np.save(ebuf, np.zeros((length, dim), np.float32))
        req["prompt_embeds_b64"] = base64.b64encode(ebuf.getvalue()).decode()
    return req


def warmup_shapes(server, shapes: str, default_steps: int):
    """Serve one synthetic request at each HxWxF[:steps] shape through
    ``handle_generate`` (the request path itself). Returns [(shape, steps,
    seconds)]."""
    timings = []
    for spec in shapes.split(","):
        spec, steps = spec.strip(), default_steps
        if ":" in spec:
            spec, s = spec.split(":")
            steps = int(s)
        h, w, f = (int(v) for v in spec.split("x"))
        t0 = time.time()
        server.handle_generate(_warmup_request(server, h, w, f, steps))
        dt = time.time() - t0
        print(f"warmup {h}x{w}x{f} steps={steps}: {dt:.1f}s")
        timings.append((f"{h}x{w}x{f}", steps, dt))
    return timings


def main(argv=None):
    args = parse_args(argv)
    from frameino_tpu_torch.app.server import PipelineServer
    pipe = build_pipeline(smoke=args.smoke, random_init=args.random_init,
                          family=args.family, transformer=args.transformer,
                          vae=args.vae, text_encoder=args.text_encoder,
                          quantize=args.quantize, device=args.device)
    if args.random_init:
        print("WARNING: --random_init serves RANDOM weights; outputs are "
              "noise")
    server = PipelineServer(pipe, bucket_grid=args.bucket_grid,
                            frame_grid=args.frame_grid)
    if args.warmup:
        timings = warmup_shapes(server, args.warmup, server.default_steps)
        if args.warmup_only:
            print("WARMSTART_JSON: " + json.dumps(
                {"shapes": [{"shape": s, "steps": st,
                             "first_request_s": round(dt, 2)}
                            for s, st, dt in timings]}))
            return
    server.serve(args.host, args.port)


if __name__ == "__main__":
    main()
