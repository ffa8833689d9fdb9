"""Perception-model backends for the evaluation metrics (counterpart of
``frameino_tpu/evaluation/perception.py``).

The reference scores with four external models (CoTracker3 via
torch.hub, SAM2 ``facebook/sam2.1-hiera-large``, DINOv2-vitb14,
Qwen2.5-VL-32B-Instruct — reference ``evaluation/evaluate_INO_*.py``).
This module provides, as the JAX one does:

- ``load_default_backends()``: builds the real adapters from local
  weights, raising a clear error otherwise. The ``--*_checkpoint`` paths
  run the port's own models (``models/cotracker.py``, ``models/sam2*.py``,
  ``models/dinov2.py``, and the Qwen2.5-VL judge of ``models/qwen_vl.py``)
  on the card;
- deterministic fallbacks (``naive_*``) with the same callable contracts,
  so ``mass_evaluation`` runs offline;
- ``random_init_backends()``: the three perception models at their
  released widths on seeded random weights, for timing (JAX's
  ``random_init_jax_backends``).

Differences from the JAX module: the torch.hub, ``sam2``-package and
transformers loaders read only what is already on disk (the hub cache,
``local_files_only``), so a missing model fails at once instead of
reaching for the network; JAX's ``load_qwen_judge_jax`` is
``load_qwen_judge_checkpoint`` here, and runs in bf16, which JAX's
generator cannot (ROADMAP queue 3).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import cv2
import numpy as np


def _offline() -> None:
    """Keep the Hugging Face hub off the network in this process, and
    transformers off its TensorFlow and JAX backends (the port uses
    neither; importing them costs seconds)."""
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")


def _hf_local(model_path: str) -> None:
    """Raise unless ``model_path`` is a directory or a repository already
    in the Hugging Face cache: checked before transformers is imported."""
    if os.path.isdir(model_path):
        return
    from huggingface_hub import try_to_load_from_cache
    if not isinstance(try_to_load_from_cache(model_path, "config.json"),
                      str):
        raise FileNotFoundError(
            f"{model_path} is neither a directory nor in the Hugging Face "
            f"cache; pass a checkpoint directory")


def _hub_local(repo: str, model: str):
    """``torch.hub.load`` from the hub cache only (``source="local"``)."""
    import torch
    path = os.path.join(torch.hub.get_dir(), repo.replace("/", "_") + "_main")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{repo} is not in the torch.hub cache "
                                f"({path}); pass a checkpoint path instead")
    return torch.hub.load(path, model, source="local")


# ---------------------------------------------------------------------------
# Naive offline backends (deterministic; used in tests/smoke runs)
# ---------------------------------------------------------------------------

def naive_tracker(frames: np.ndarray, queries: np.ndarray,
                  patch: int = 7) -> np.ndarray:
    """Greedy local patch matching from frame to frame. frames
    [T,H,W,3] uint8; queries [N,2] (x,y) on frame 0 -> [T,N,2]."""
    T, H, W = frames.shape[:3]
    gray = frames.mean(axis=-1).astype(np.float32)
    r = patch // 2
    pts = np.asarray(queries, np.float32).copy()
    out = [pts.copy()]
    for t in range(1, T):
        prev, cur = gray[t - 1], gray[t]
        new_pts = []
        for (x, y) in pts:
            xi = int(np.clip(x, r, W - r - 1))
            yi = int(np.clip(y, r, H - r - 1))
            tmpl = prev[yi - r:yi + r + 1, xi - r:xi + r + 1]
            best, best_xy = None, (xi, yi)
            for dy in range(-3, 4):
                for dx in range(-3, 4):
                    x2 = int(np.clip(xi + dx, r, W - r - 1))
                    y2 = int(np.clip(yi + dy, r, H - r - 1))
                    cand = cur[y2 - r:y2 + r + 1, x2 - r:x2 + r + 1]
                    err = float(np.abs(cand - tmpl).sum())
                    if best is None or err < best:
                        best, best_xy = err, (x2, y2)
            new_pts.append(best_xy)
        pts = np.asarray(new_pts, np.float32)
        out.append(pts.copy())
    return np.stack(out)


def naive_segmenter(frames: np.ndarray, queries: np.ndarray,
                    tol: float = 40.0) -> np.ndarray:
    """Color-similarity flood from the query points' mean color."""
    T = frames.shape[0]
    q = np.asarray(queries, np.int32)
    ref_colors = frames[0][np.clip(q[:, 1], 0, frames.shape[1] - 1),
                           np.clip(q[:, 0], 0, frames.shape[2] - 1)]
    ref = ref_colors.mean(axis=0)
    masks = []
    for t in range(T):
        d = np.linalg.norm(frames[t].astype(np.float32) - ref, axis=-1)
        masks.append((d < tol).astype(np.uint8))
    return np.stack(masks)


def naive_embedder(image: np.ndarray, size: int = 16) -> np.ndarray:
    """Downsampled normalized pixels as a feature vector."""
    img = cv2.resize(image, (size, size)).astype(np.float32) / 255.0
    v = img.ravel()
    return v / (np.linalg.norm(v) + 1e-8)


def naive_judge(frames: np.ndarray, prompt: str,
                is_frame_in: bool) -> str:
    """Motion heuristic: did content appear/disappear over the clip?"""
    first = frames[0].astype(np.float32)
    last = frames[-1].astype(np.float32)
    changed = np.abs(last - first).mean() > 5.0
    return "Yes" if changed else "No"


def lk_tracker(frames: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Pyramidal-LK cycle-consistent tracker (shared with preprocess
    step 7) — a real optical-flow tracker, the offline default for the
    INO_Traj metric (better than greedy patch matching)."""
    from frameino_tpu_torch.preprocess.lk_tracker import make_lk_tracker
    return make_lk_tracker()(frames, queries)


def naive_backends() -> Dict[str, Callable]:
    return {"tracker": lk_tracker, "segmenter": naive_segmenter,
            "embedder": naive_embedder, "judge": naive_judge}


def random_init_backends(seed: int = 0, device: str = "cuda"
                         ) -> Dict[str, Callable]:
    """TIMING-ONLY backends: CoTracker3-offline, SAM2.1-hiera-large and
    DINOv2-ViT-B/14 at their released widths on seeded RANDOM weights, on
    ``device``; the judge stays ``naive_judge``. Scores are meaningless;
    the work per call is the released models' (JAX's
    ``random_init_jax_backends``)."""
    import warnings

    import torch

    from frameino_tpu_torch.models.cotracker import (COTRACKER3_OFFLINE,
                                                     init_cotracker,
                                                     make_tracker_adapter)
    from frameino_tpu_torch.models.dinov2 import (DINOV2_VITB14,
                                                  init_dinov2,
                                                  make_embedder_adapter)
    from frameino_tpu_torch.models.sam2 import SAM21_HIERA_LARGE, init_sam2
    from frameino_tpu_torch.models.sam2_video import make_segmenter_adapter

    warnings.warn("random_init_backends: RANDOM weights — metric VALUES are "
                  "meaningless; use for timing only", stacklevel=2)

    def gen(i):
        return torch.Generator(device).manual_seed(seed * 1000 + i)
    return {
        "tracker": make_tracker_adapter(
            init_cotracker(COTRACKER3_OFFLINE, gen(0))),
        "segmenter": make_segmenter_adapter(
            init_sam2(SAM21_HIERA_LARGE, gen(1))),
        "embedder": make_embedder_adapter(
            init_dinov2(DINOV2_VITB14, gen(2))),
        "judge": naive_judge}


# ---------------------------------------------------------------------------
# Real backends (require weights on disk)
# ---------------------------------------------------------------------------

def load_cotracker(device: str = "cpu") -> Callable:
    """CoTracker3-offline through torch.hub (reference
    ``evaluate_INO_Traj.py:79``), from the hub cache."""
    import torch
    model = _hub_local("facebookresearch/co-tracker",
                       "cotracker3_offline").to(device)

    def track(frames: np.ndarray, queries: np.ndarray) -> np.ndarray:
        video = torch.tensor(frames).permute(0, 3, 1, 2)[None].float()
        q = torch.tensor(
            [[0.0, float(x), float(y)] for (x, y) in queries])[None]
        with torch.no_grad():
            tracks, _ = model(video.to(device), queries=q.to(device),
                              backward_tracking=False)
        return tracks[0].long().cpu().numpy()

    return track


def load_cotracker_checkpoint(checkpoint_path: str,
                              backward_tracking: bool = False,
                              device: str = "cuda") -> Callable:
    """The port's CoTracker3-offline from released weights
    (``models/cotracker.py``; ``load_cotracker``'s contract)."""
    from frameino_tpu_torch.models.cotracker import load_cotracker_torch
    return load_cotracker_torch(checkpoint_path,
                                backward_tracking=backward_tracking,
                                device=device)


def load_sam2(model_id: str = "facebook/sam2.1-hiera-large",
              device: str = "cpu") -> Callable:
    """SAM2 video propagation through the ``sam2`` package (reference
    ``evaluate_INO_VSeg_MAE.py:33-48,160-196``), from local files."""
    import torch
    _offline()
    from sam2.sam2_video_predictor import SAM2VideoPredictor
    predictor = SAM2VideoPredictor.from_pretrained(model_id).to(device)

    def segment(frames: np.ndarray, queries: np.ndarray) -> np.ndarray:
        """frames [T,H,W,3] uint8 RGB; queries [N,2] (x,y) on frame 0
        -> [T,H,W] uint8 {0,1} masks."""
        import contextlib
        import shutil
        import tempfile
        tmp = tempfile.mkdtemp(prefix="sam2_frames_")
        try:
            for i, fr in enumerate(frames):
                # SAM2's JPEG loader expects zero-padded numeric names
                cv2.imwrite(os.path.join(tmp, f"{i:04d}.jpg"),
                            cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
            autocast = (torch.autocast("cuda", dtype=torch.bfloat16)
                        if device == "cuda" else contextlib.nullcontext())
            with torch.inference_mode(), autocast:
                state = predictor.init_state(tmp)
                predictor.reset_state(state)
                pts = np.asarray(queries, np.float32)
                labels = np.ones((len(pts),), np.int32)
                predictor.add_new_points_or_box(
                    state, frame_idx=0, obj_id=1, points=pts, labels=labels)
                masks_by_frame = {}
                for frame_idx, object_ids, masks in \
                        predictor.propagate_in_video(state,
                                                     start_frame_idx=0):
                    # single object (reference keeps only obj 0)
                    m = (masks[0] > 0.0).cpu().numpy().astype(np.uint8)
                    masks_by_frame[int(frame_idx)] = m[0]
            T = frames.shape[0]
            blank = np.zeros(frames.shape[1:3], np.uint8)
            return np.stack([masks_by_frame.get(t, blank)
                             for t in range(T)])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    return segment


QWEN_FRAME_IN_PROMPT = ("Please check if the object enter the frame. "
                        "Return a Yes/No as the only response.")
QWEN_FRAME_OUT_PROMPT = ("Please check if the object leave the frame. "
                         "Return a Yes/No as the only response.")


def load_qwen_vl(model_path: str = "Qwen/Qwen2.5-VL-32B-Instruct",
                 device_map: str = "auto", load_in_4bit: bool = True):
    """Shared Qwen2.5-VL loader (judge + preprocess captioner): returns
    ``(processor, model)``, nf4 4-bit quantized when bitsandbytes is
    present."""
    import torch
    _offline()
    _hf_local(model_path)
    from transformers import AutoProcessor
    from transformers import Qwen2_5_VLForConditionalGeneration
    processor = AutoProcessor.from_pretrained(model_path,
                                              local_files_only=True)
    kwargs = dict(torch_dtype="auto", device_map=device_map,
                  local_files_only=True)
    if load_in_4bit:
        try:
            from transformers import BitsAndBytesConfig
            kwargs["quantization_config"] = BitsAndBytesConfig(
                load_in_4bit=True,
                bnb_4bit_compute_dtype=torch.float16,
                bnb_4bit_use_double_quant=True,
                bnb_4bit_quant_type="nf4")
        except Exception:
            pass
    model = Qwen2_5_VLForConditionalGeneration.from_pretrained(
        model_path, **kwargs)
    return processor, model


def load_qwen_judge(model_path: str = "Qwen/Qwen2.5-VL-32B-Instruct",
                    device_map: str = "auto", load_in_4bit: bool = True,
                    llm_fps: int = 1) -> Callable:
    """Qwen2.5-VL judge (reference ``evaluate_INO_VLM.py:36-49,74-88``):
    14 sampled frames as a video message, yes/no instruction, nf4
    4-bit quantized weights."""
    processor, model = load_qwen_vl(model_path, device_map, load_in_4bit)

    def judge(frames: np.ndarray, prompt: str, is_frame_in: bool) -> str:
        instruction = (QWEN_FRAME_IN_PROMPT if is_frame_in
                       else QWEN_FRAME_OUT_PROMPT)
        messages = [{
            "role": "user",
            "content": [
                {"type": "video", "video": [fr for fr in frames],
                 "max_pixels": 360 * 420, "fps": llm_fps},
                {"type": "text", "text": instruction},
            ],
        }]
        text = processor.apply_chat_template(messages, tokenize=False,
                                             add_generation_prompt=True)
        import torch as _t
        frames_t = _t.tensor(np.stack(frames)).permute(0, 3, 1, 2)
        inputs = processor(text=[text], videos=[frames_t],
                           return_tensors="pt").to(model.device)
        with _t.no_grad():
            out = model.generate(**inputs, max_new_tokens=8)
        ans = processor.batch_decode(
            out[:, inputs["input_ids"].shape[1]:],
            skip_special_tokens=True)[0]
        return "Yes" if "yes" in ans.lower() else "No"

    return judge


def load_qwen_judge_checkpoint(model_dir: str, device: str = "cuda",
                               llm_fps: int = 1, dtype=None,
                               processor=None) -> Callable:
    """The port's Qwen2.5-VL judge (``models/qwen_vl.py``) from a local
    checkpoint directory, on ``device`` in bf16 (or ``dtype``):
    ``load_qwen_judge``'s yes/no contract (8 new tokens, the video at
    ``llm_fps``), as JAX's ``load_qwen_judge_jax``. The directory's
    processor comes through ``transformers`` unless ``processor`` is
    given."""
    import torch

    from frameino_tpu_torch.models.qwen_vl import load_qwen_vl_torch
    run = load_qwen_vl_torch(model_dir, max_new_tokens=8,
                             dtype=dtype or torch.bfloat16, device=device,
                             processor=processor)

    def judge(frames: np.ndarray, prompt: str, is_frame_in: bool) -> str:
        instruction = (QWEN_FRAME_IN_PROMPT if is_frame_in
                       else QWEN_FRAME_OUT_PROMPT)
        ans = run(frames, instruction, fps=llm_fps)
        return "Yes" if "yes" in ans.lower() else "No"

    return judge


def load_vlm_judge_http(endpoint: str, model: str = "qwen2.5-vl",
                        timeout: float = 120.0) -> Callable:
    """OpenAI-compatible HTTP judge (serving-stack deployment): frames
    as base64 JPEG images, same yes/no instruction contract."""
    import base64
    import json
    import urllib.request

    def judge(frames: np.ndarray, prompt: str, is_frame_in: bool) -> str:
        instruction = (QWEN_FRAME_IN_PROMPT if is_frame_in
                       else QWEN_FRAME_OUT_PROMPT)
        content = []
        for fr in frames:
            ok, buf = cv2.imencode(".jpg", cv2.cvtColor(fr,
                                                        cv2.COLOR_RGB2BGR))
            b64 = base64.b64encode(buf.tobytes()).decode()
            content.append({"type": "image_url", "image_url": {
                "url": f"data:image/jpeg;base64,{b64}"}})
        content.append({"type": "text", "text": instruction})
        req = urllib.request.Request(
            endpoint.rstrip("/") + "/chat/completions",
            data=json.dumps({
                "model": model, "max_tokens": 8,
                "messages": [{"role": "user", "content": content}],
            }).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            ans = json.load(resp)["choices"][0]["message"]["content"]
        return "Yes" if "yes" in ans.lower() else "No"

    return judge


def load_dinov2(device: str = "cpu") -> Callable:
    """DINOv2 ViT-B/14 through torch.hub (reference
    ``evaluate_INO_DINO.py``), from the hub cache."""
    import torch
    model = _hub_local("facebookresearch/dinov2",
                       "dinov2_vitb14").to(device).eval()
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)

    def embed(image: np.ndarray) -> np.ndarray:
        img = cv2.resize(image, (224, 224)).astype(np.float32) / 255.0
        img = (img - mean) / std
        t = torch.tensor(img).permute(2, 0, 1)[None].to(device)
        with torch.no_grad():
            f = model(t)
        return f[0].cpu().numpy()

    return embed


def load_sam2_checkpoint(checkpoint_path: str,
                         device: str = "cuda") -> Callable:
    """The port's SAM2.1 video predictor from released weights
    (``models/sam2.py`` + ``models/sam2_video.py``; ``load_sam2``'s
    contract without the ``sam2`` package)."""
    from frameino_tpu_torch.models.sam2_video import load_sam2_torch
    return load_sam2_torch(checkpoint_path, device=device)


def load_oneformer_checkpoint(checkpoint_path: str, device: str = "cuda",
                              **kwargs) -> Callable:
    """The port's OneFormer COCO Swin-L from released weights (detectron2
    ``.pth`` with its ``"model"`` dict; ``preprocess/panoptic_oneformer``):
    ``segment(image) -> [(label, mask)]``, the curation step-4 model."""
    from frameino_tpu_torch.preprocess.panoptic_oneformer import \
        load_oneformer_segmenter
    return load_oneformer_segmenter(checkpoint_path, device=device, **kwargs)


def load_vggt_checkpoint(checkpoint_path: str,
                         device: str = "cuda") -> Callable:
    """The port's VGGT-1B (VGGT4Track) camera estimator from released
    weights (``.pt`` or ``.safetensors``; ``models/vggt.py``):
    ``estimate(frames) -> camera_info``, the curation step-5 model."""
    from frameino_tpu_torch.models.vggt import load_vggt_camera
    return load_vggt_camera(checkpoint_path, device=device)


def load_dinov2_checkpoint(checkpoint_path: str,
                           device: str = "cuda") -> Callable:
    """The port's DINOv2 ViT-B/14 from released weights
    (``models/dinov2.py``; ``load_dinov2``'s contract)."""
    from frameino_tpu_torch.models.dinov2 import load_dinov2_torch
    return load_dinov2_torch(checkpoint_path, device=device)


def load_default_backends(device: str = "cpu",
                          vlm_endpoint: Optional[str] = None,
                          cotracker_checkpoint: Optional[str] = None,
                          dinov2_checkpoint: Optional[str] = None,
                          sam2_checkpoint: Optional[str] = None,
                          qwen_checkpoint: Optional[str] = None
                          ) -> Dict[str, Callable]:
    """Load ALL four real adapters or fail loudly.

    Never silently substitutes a naive fallback — use
    ``naive_backends()`` explicitly for offline smoke runs.
    ``vlm_endpoint`` switches the judge to an OpenAI-compatible server;
    the ``*_checkpoint`` paths switch the tracker, embedder, segmenter and
    judge to the port's models on ``device``.
    """
    backends: Dict[str, Callable] = {}
    errors = []
    loaders = {
        "tracker": (lambda: load_cotracker_checkpoint(
            cotracker_checkpoint, device=device))
        if cotracker_checkpoint else (lambda: load_cotracker(device)),
        "segmenter": (lambda: load_sam2_checkpoint(sam2_checkpoint,
                                                   device=device))
        if sam2_checkpoint else (lambda: load_sam2(device=device)),
        "embedder": (lambda: load_dinov2_checkpoint(dinov2_checkpoint,
                                                    device=device))
        if dinov2_checkpoint else (lambda: load_dinov2(device)),
        "judge": (lambda: load_vlm_judge_http(vlm_endpoint))
        if vlm_endpoint
        else (lambda: load_qwen_judge_checkpoint(qwen_checkpoint,
                                                 device=device))
        if qwen_checkpoint else (lambda: load_qwen_judge()),
    }
    for name, loader in loaders.items():
        try:
            backends[name] = loader()
        except Exception as e:  # noqa: BLE001 - collect and re-raise
            errors.append(f"{name}: {type(e).__name__}: {e}")
    if errors:
        raise RuntimeError(
            "real perception backends unavailable (no silent naive "
            "substitution; pass naive_backends() explicitly for smoke "
            "runs):\n  " + "\n  ".join(errors))
    return backends
