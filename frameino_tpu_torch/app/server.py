"""HTTP serving API around the port's FrameINO pipelines, Wan2.2 or
CogVideoX (counterpart of ``frameino_tpu/app/server.py``; same request
and response schema).

    POST /generate   JSON request -> {"video_b64": <mp4>, ...}
    GET  /healthz    liveness + model and device info

Request schema (all condition fields optional except the image):
    {
      "image_b64": <base64 PNG/JPEG, the canvas first frame>,
      "prompt": <str, needs a text_encoder_fn on the pipeline> |
      "prompt_embeds_b64": <base64 .npy [L, text_dim]>,
      "trajectories": [[[x, y], ...] per object],   # click polylines
      "id_image_b64": <base64 PNG/JPEG>,
      "height": int, "width": int, "num_frames": int,
      "num_inference_steps": int, "guidance_scale": float,
      "seed": int, "decode_mode": str
    }

Generation is serialized with a lock (one card); concurrent requests
queue. A Wan request without ``decode_mode`` decodes "hybrid", the JAX
server's default (``frameino_tpu/app/server.py:161``); a CogVideoX request
without one keeps its pipeline's default, the tiled streaming walk, which
the JAX CogVideoX pipeline takes for every mode but "full".
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from frameino_tpu_torch.core import shape_buckets as SB
from frameino_tpu_torch.models.wan_vae import WanVAEConfig

# the largest legitimate request is a base64 first frame + trajectory json
# (~10 MB); 256 MB rejects pathological bodies without reading them
MAX_REQUEST_BYTES = 256 * 1024 * 1024


def _decode_image(b64: str) -> np.ndarray:
    from PIL import Image
    img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    return np.asarray(img)


def _encode_video_mp4(frames: np.ndarray, fps: int = 16) -> str:
    import os
    import tempfile

    from frameino_tpu_torch.data.video_io import write_video
    fd, path = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    try:
        write_video(path, frames, fps=fps)
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()
    finally:
        if os.path.exists(path):
            os.remove(path)


def _to_unit_range(img_u8: np.ndarray) -> torch.Tensor:
    """[H, W, 3] uint8 -> [3, H, W] fp32 in [-1, 1]."""
    return torch.from_numpy(img_u8.astype(np.float32) / 255.0 * 2 - 1
                            ).permute(2, 0, 1)


class PipelineServer:
    """Wraps a ``WanImageToVideoPipeline`` or a
    ``CogVideoXImageToVideoPipeline`` behind the HTTP API."""

    def __init__(self, pipeline, text_encoder_fn=None,
                 default_steps: int = 50, default_guidance: float = 5.0,
                 fps: int = 16, bucket_grid: int = 64,
                 frame_grid: Optional[int] = None):
        self.pipeline = pipeline
        self.text_encoder_fn = text_encoder_fn or getattr(
            pipeline, "text_encoder_fn", None)
        self.default_steps = default_steps
        self.default_guidance = default_guidance
        self.fps = fps
        # requests land on a grid x grid x frame lattice; odd dims pay
        # padded pixels that are cropped from the output. 0 keeps the
        # hard x32 canvas rule only.
        self.bucket_grid = bucket_grid
        self.frame_grid = frame_grid
        self.lock = threading.Lock()
        self.generations = 0

    def handle_generate(self, req: dict) -> dict:
        from frameino_tpu_torch.app.core import (prepare_id_reference,
                                                 tracks_to_traj_tensor)

        image = _decode_image(req["image_b64"])
        H = int(req.get("height", image.shape[0]))
        W = int(req.get("width", image.shape[1]))
        F = int(req.get("num_frames", 81))

        # Wan's VAE config names the ratio scale_factor_temporal,
        # CogVideoX's temporal_compression_ratio
        vae_cfg = self.pipeline.vae_cfg
        temporal = getattr(vae_cfg, "scale_factor_temporal", None) \
            or getattr(vae_cfg, "temporal_compression_ratio", 4)
        if self.bucket_grid:
            Hb, Wb = SB.bucket_hw(H, W, grid=self.bucket_grid)
            Fb = SB.bucket_frames(F, temporal=temporal,
                                  frame_grid=self.frame_grid)
        else:
            Hb, Wb = SB.bucket_hw(H, W, grid=32)    # hard x32 canvas rule
            Fb = SB.bucket_frames(F, temporal=temporal)

        if "prompt_embeds_b64" in req:
            emb = np.load(io.BytesIO(
                base64.b64decode(req["prompt_embeds_b64"])))
            prompt_embeds = torch.from_numpy(emb)
            if prompt_embeds.ndim == 2:
                prompt_embeds = prompt_embeds[None]
        elif self.text_encoder_fn is not None:
            prompt_embeds = self.text_encoder_fn([req.get("prompt", "")])
        else:
            raise ValueError("provide prompt_embeds_b64 or configure a "
                             "text encoder")

        traj = None
        if req.get("trajectories"):
            # rasterize at the requested dims (user coordinates), then
            # zero-pad to the bucket
            traj_np, _ = tracks_to_traj_tensor(req["trajectories"], F, H, W)
            traj = torch.from_numpy(np.pad(
                traj_np, ((0, Fb - F), (0, 0), (0, Hb - H), (0, Wb - W))))

        id_t = None
        if req.get("id_image_b64"):
            id_np = prepare_id_reference(_decode_image(req["id_image_b64"]),
                                         None, Hb, Wb)
            id_t = _to_unit_range(id_np)[None, :, None]

        import cv2
        img = SB.pad_hwc(cv2.resize(image, (W, H)), Hb, Wb)
        image_t = _to_unit_range(img)[None]

        gen = torch.Generator(self.pipeline.device).manual_seed(
            int(req.get("seed", 0)))
        extra = {}
        if "decode_mode" in req:
            extra["decode_mode"] = req["decode_mode"]
        elif isinstance(vae_cfg, WanVAEConfig):
            extra["decode_mode"] = "hybrid"
        with self.lock:
            video = self.pipeline(
                image_t, prompt_embeds=prompt_embeds,
                traj_tensor=traj, id_tensor=id_t,
                height=Hb, width=Wb, num_frames=Fb,
                num_inference_steps=int(req.get("num_inference_steps",
                                                self.default_steps)),
                guidance_scale=float(req.get("guidance_scale",
                                             self.default_guidance)),
                generator=gen, **extra)
            self.generations += 1

        if not np.isfinite(video).all():
            raise FloatingPointError("generated video has non-finite values")
        frames = ((video[0].transpose(1, 2, 3, 0) + 1) / 2
                  * 255).clip(0, 255).astype(np.uint8)
        frames = SB.crop_video(frames, F, H, W)
        return {"video_b64": _encode_video_mp4(frames, self.fps),
                "num_frames": int(frames.shape[0]),
                "height": int(frames.shape[1]),
                "width": int(frames.shape[2]),
                "bucket": [Fb, Hb, Wb]}

    def health(self) -> dict:
        """JAX's keys (``backend`` named as ``jax.default_backend()`` names
        the platform: "gpu" for a CUDA card) and the torch device."""
        dev = self.pipeline.device
        info = {"status": "ok", "generations": self.generations,
                "backend": "gpu" if dev.type == "cuda" else dev.type,
                "device": str(dev),
                "pipeline": type(self.pipeline).__name__}
        if dev.type == "cuda":
            info["device_name"] = torch.cuda.get_device_name(dev)
        return info

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, server.health())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/generate":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > MAX_REQUEST_BYTES:
                        self._send(413, {"error": "request too large"})
                        return
                    req = json.loads(self.rfile.read(n))
                    self._send(200, server.handle_generate(req))
                except Exception as e:  # noqa: BLE001 - report to client
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8188):
        """Loopback by default — there is no auth layer; bind 0.0.0.0
        explicitly (behind a proxy) to expose it."""
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        print(f"FrameINO serving on {host}:{port} "
              f"({self.pipeline.device})")
        httpd.serve_forever()

    def start_background(self, host: str = "127.0.0.1", port: int = 0):
        """Start on a thread; returns (server, actual_port). Stop it with
        ``server.shutdown(); server.server_close()``."""
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd, httpd.server_address[1]
